"""The encoders, the LSTM cell, the three decoders and the captioner."""

from .. import lazy_exports

# the JAX package's exports, loaded on first use
_EXPORTS = {
    "init_vgg_params": ".vgg",
    "vgg_apply": ".vgg",
    "vgg_apply_with_acts": ".vgg",
    "vgg_layers": ".vgg",
    "load_keras_vgg_h5": ".vgg",
    "build_captioner": ".captioner",
    "Captioner": ".captioner",
    "load_reference_checkpoint_h5": ".weights_io",
    "load_reference_decoder_h5": ".weights_io",
    "Fasttext": ".word_vectors",
    "Glove": ".word_vectors",
    "init_embedding": ".word_vectors",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
