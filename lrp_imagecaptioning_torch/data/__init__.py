"""Data: dataset parsers, the batch provider, the caption tokenizer, the image
preprocessing (PIL or the native loader) and background prefetch."""

from .. import lazy_exports

# the JAX package's exports, loaded on first use
_EXPORTS = {
    "KerasCompatTokenizer": ".tokenizer",
    "CaptionPreprocessor": ".tokenizer",
    "ImagePreprocessor": ".images",
    "vgg_preprocess": ".images",
    "Datum": ".datasets",
    "Flickr30kDataset": ".datasets",
    "COCODataset": ".datasets",
    "COCODatasetKarpathy": ".datasets",
    "SyntheticDataset": ".datasets",
    "DatasetProvider": ".provider",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
