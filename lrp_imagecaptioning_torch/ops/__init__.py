"""LRP primitives, conv/pool rules and the hand-written CUDA kernels."""

from .. import lazy_exports

# the JAX package's exports, loaded on first use
_EXPORTS = {
    "lrp_linear": ".lrp_core",
    "lrp_identity": ".lrp_core",
    "sign_stabilizer": ".lrp_core",
    "safe_divide": ".lrp_core",
    "lrp_conv_alpha_beta": ".lrp_conv",
    "lrp_conv_epsilon": ".lrp_conv",
    "lrp_maxpool_wta": ".lrp_conv",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
