"""Caption metrics (the port's copies of the JAX package's ``evalx``): BLEU,
CIDEr-D, ROUGE-L, METEOR and SPICE (jar or Python fallback), BERTScore."""

from .metrics import BERT, BLEU, CIDEr, METEOR, ROUGE, SPICE, default_metrics  # noqa: F401
