"""Data helpers: the training path's prefetch, the caption tokenizer and the
image preprocessing of the Explainer and the parity command."""
