"""The training path: optimizer, train and eval steps, LRP-inference
fine-tuning and checkpoints."""

from .. import lazy_exports

# the JAX package's exports, loaded on first use
_EXPORTS = {
    "get_learning_rate": ".optimizer",
    "make_optimizer": ".optimizer",
    "set_learning_rate": ".optimizer",
    "make_eval_step": ".step",
    "make_multi_train_step": ".step",
    "make_sharded_multi_train_step": ".step",
    "make_sharded_train_step": ".step",
    "make_train_step": ".step",
    "MODELTYPE": ".trainer",
    "Trainer": ".trainer",
    "main_attention": ".trainer",
    "LRPFinetuner": ".lrp_finetune",
    "lrp_weights": ".lrp_finetune",
    "make_lrp_finetune_step": ".lrp_finetune",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
