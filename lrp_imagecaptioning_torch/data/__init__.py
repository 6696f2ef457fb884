"""Data: dataset parsers, the batch provider, the caption tokenizer, the image
preprocessing (PIL or the native loader) and background prefetch."""
