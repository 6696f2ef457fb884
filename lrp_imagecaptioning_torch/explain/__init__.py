"""Decoder-side and CNN-side LRP, the gradient methods and the Explainer."""

from .. import lazy_exports

# the JAX package's exports, loaded on first use
_EXPORTS = {
    "explain_word_adaptive": ".decoder_lrp",
    "explain_word_gridtd": ".decoder_lrp",
    "vgg_lrp_preset_a": ".cnn_lrp",
    "vgg_lrp_preset_b": ".cnn_lrp",
    "vgg_gradient": ".cnn_gradient",
    "vgg_guided_backprop": ".cnn_gradient",
    "Explainer": ".engine",
    "Explanation": ".engine",
    "METHODS": ".engine",
    "grad_word_adaptive": ".decoder_grad",
    "grad_word_gridtd": ".decoder_grad",
    "grad_cam": ".cnn_gradient",
    "vgg_input_times_gradient": ".cnn_gradient",
    "vgg_guided_gradcam": ".cnn_gradient",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
