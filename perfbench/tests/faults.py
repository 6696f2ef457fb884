"""Faults planted in the program under a run, for the test that sees
``correct`` come out false: each patches the port where the fault would
be, and returns a function that takes the patch away."""

from __future__ import annotations


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def state_unchanged():
    """Every step returns the params and moments it was given."""
    import torch

    from lrp_imagecaptioning_torch.train import optimizer
    from lrp_imagecaptioning_torch.weights import tree_map

    def moments(self, grads, mu, nu, *scalars):
        return tree_map(torch.zeros_like, grads), mu, nu

    return _patch(optimizer.Adam, "moments", moments)


def half_batch():
    """The loss (and so the gradient) of the first half of the rows, their
    mean taken as the batch's."""
    from lrp_imagecaptioning_torch.models import captioner
    from lrp_imagecaptioning_torch.train import lrp_finetune

    undo = []
    ce, dual = captioner.masked_ce_from_logits, lrp_finetune.dual_loss

    def half_ce(logits, y):
        n = logits.shape[0] // 2
        return ce(logits[:n], y[:n])

    def half_dual(logits, w, y):
        n = logits.shape[0] // 2
        return dual(logits[:n], w[:n], y[:n])

    undo.append(_patch(captioner.Captioner, "loss_fn", lambda self: half_ce))
    undo.append(_patch(lrp_finetune, "dual_loss", half_dual))
    return lambda: [u() for u in undo]


def no_exchange():
    """The gradients are not summed over the processes."""
    from lrp_imagecaptioning_torch.train import step

    return _patch(step, "all_reduce_sum", lambda flat, mesh: flat)


def map_altered():
    """The CNN side hands back one word's heatmap negated."""
    from lrp_imagecaptioning_torch.explain import engine

    orig = engine.vgg_lrp_per_image

    def altered(*args, **kwargs):
        maps = orig(*args, **kwargs).clone()
        maps[:, 0] = -maps[:, 0]
        return maps

    return _patch(engine, "vgg_lrp_per_image", altered)


def token_altered():
    """The decoder's LRP explains the next word in place of each word."""
    from lrp_imagecaptioning_torch.explain import engine

    relevance, gradient = engine._BACKWARDS["adaptiveattention"]

    def shifted(params, consts, caches, words0, positions):
        return relevance(params, consts, caches, words0.roll(1, dims=1), positions)

    engine._BACKWARDS["adaptiveattention"] = (shifted, gradient)
    return lambda: engine._BACKWARDS.__setitem__("adaptiveattention", (relevance, gradient))


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "map_altered": map_altered,
          "token_altered": token_altered}
