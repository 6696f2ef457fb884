"""Train and eval steps on one device.

One step: the teacher-forced forward with dropout, the loss, its gradient
by autograd (through the ``lstm_gates`` kernel's Function on the card), the
clipped Adam update.

Params and optimizer state are plain dicts of tensors; a step returns new
ones and leaves its arguments as they were.
"""

from __future__ import annotations

import torch

from ..models.captioner import masked_accuracy
from ..weights import tree_leaves, tree_map, tree_unflatten
from .optimizer import apply_updates


def value_and_grad(loss_of_params, params):
    """(loss, aux, grads): ``loss_of_params(p) -> (scalar, aux)`` on copies
    of ``params`` that require grad; grads in ``params``' structure."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, aux = loss_of_params(p)
        grads = torch.autograd.grad(loss, tree_leaves(p), materialize_grads=True)
    return loss.detach(), aux, tree_unflatten(params, grads)


def make_train_step(captioner, optimizer):
    """-> step(params, opt_state, images, captions_in, y_onehot, generator)
    -> (params, opt_state, metrics): loss -> grad -> optimizer update.
    ``generator`` (a ``torch.Generator`` on the params' device) draws the
    dropout masks; None runs without dropout."""
    loss_fn = captioner.loss_fn()

    def step(params, opt_state, images, captions_in, y_onehot, generator):
        def loss(p):
            logits = captioner.forward_train(p, images, captions_in, generator)
            return loss_fn(logits, y_onehot), logits.detach()

        loss_value, logits, grads = value_and_grad(loss, params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss_value,
                                   "accuracy": masked_accuracy(logits, y_onehot)}

    return step


def metric_accumulator(keys=("loss", "accuracy")):
    """``record(m)`` keeps each call's metric sums on the device (no host sync
    a step); ``finalize(steps)`` reads them once and returns host floats
    averaged over ``steps``."""
    acc = {k: [] for k in keys}

    def record(m):
        for k in acc:
            acc[k].append(m[k].sum())

    def finalize(steps):
        return {k: (float(torch.stack(vs).sum()) if vs else 0.0) / max(steps, 1)
                for k, vs in acc.items()}

    return record, finalize


def run_stepped_steps(batches, steps, place, step_fn, generator, params, opt_state, record):
    """Pulls ``steps`` batches ``((captions_in, images), y_onehot)`` from
    ``batches`` and runs ``step_fn`` on each, in order. ``place(arr)`` moves a
    host array to the device, ``generator`` draws every step's dropout,
    ``record(metrics)`` takes each step's metrics. Returns the updated
    (params, opt_state)."""
    for _ in range(steps):
        (cap_in, imgs), y = next(batches)
        params, opt_state, m = step_fn(params, opt_state, place(imgs), place(cap_in), place(y),
                                       generator)
        record(m)
    return params, opt_state


def make_eval_step(captioner):
    """-> eval_step(params, images, captions_in, y_onehot) -> metrics, without
    dropout and without a gradient."""
    loss_fn = captioner.loss_fn()

    @torch.no_grad()
    def eval_step(params, images, captions_in, y_onehot):
        logits = captioner.forward_train(params, images, captions_in, None)
        return {"loss": loss_fn(logits, y_onehot), "accuracy": masked_accuracy(logits, y_onehot)}

    return eval_step
