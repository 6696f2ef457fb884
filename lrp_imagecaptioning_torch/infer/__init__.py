"""Caption decoding, the inference API and serving."""
