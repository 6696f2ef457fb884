"""Caption decoding."""
