"""Small helpers: file IO and profiling."""

from .. import lazy_exports

# the JAX package's exports, loaded on first use
_EXPORTS = {
    "logging_ts": ".io_utils",
    "mkdir_p": ".io_utils",
    "read_text_file": ".io_utils",
    "write_yaml_file": ".io_utils",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
