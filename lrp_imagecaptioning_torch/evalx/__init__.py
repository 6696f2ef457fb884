"""Caption metrics (the port's copies of the JAX package's ``evalx``): BLEU,
CIDEr-D, ROUGE-L, METEOR and SPICE (jar or Python fallback), BERTScore; the
bbox and per-word explanation evaluations."""

from .. import lazy_exports

# the JAX package's exports, loaded on first use
_EXPORTS = {
    "BLEU": ".metrics",
    "CIDEr": ".metrics",
    "ROUGE": ".metrics",
    "METEOR": ".metrics",
    "SPICE": ".metrics",
    "BERT": ".metrics",
    "default_metrics": ".metrics",
    "EvaluationBbox": ".bbox",
    "analyze_results": ".bbox",
    "correctness": ".bbox",
    "evaluate_dataset": ".bbox",
    "COCO_CATEGORY": ".words",
    "COCO_FREQUENT_OBJECT": ".words",
    "FLICKR_CATEGORY": ".words",
    "FREQUENT_OBJECT": ".words",
    "beta_roc_auc": ".words",
    "collect_word_stats": ".words",
    "frequent_object_map": ".words",
    "mean_roc_auc": ".words",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
