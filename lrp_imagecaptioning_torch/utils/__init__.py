"""Small helpers: file IO and profiling."""
