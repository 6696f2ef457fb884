"""Adam with element-wise gradient clipping, the reference's Keras config.

Adam(lr, clipvalue=0.1) for adaptive attention (and AOA) and Adam(lr,
beta_1=0.8, clipvalue=0.1) for grid-TD (model.py:468-470, :662-664). Keras ``clipvalue`` clips
each gradient element to [-c, c] before the moments (optax's ``clip``, not a
clip of the norm).

A small functional Adam over a params dict, step for step optax's ``adam``
as the JAX package chains it (``chain(clip(c), inject_hyperparams(adam))``):
eps 1e-8 outside the square root, eps_root 0, bias correction by the step
count, every constant in float32. The state is a plain dict ``{"count",
"mu", "nu", "learning_rate"}``; ``set_learning_rate`` rescales it without
rebuilding the step, as the ReduceLROnPlateau callback does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..weights import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class Adam:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clipvalue: float = 0.1

    def init(self, params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "learning_rate": _f32(self.learning_rate)}

    def update(self, grads, state, params=None):
        """(grads, state) -> (updates, new state); ``params + updates`` is the
        step (``apply_updates``)."""
        del params
        count = state["count"] + 1
        # float32 constants as 0-d CPU tensors: they enter a kernel on the
        # card as scalars and keep every product in float32
        b1, b2, eps, lr = (torch.tensor(v, dtype=torch.float32)
                           for v in (self.b1, self.b2, self.eps, state["learning_rate"]))
        # beta ** count rounded once to float32, as XLA's pow gives it: 1 - beta ** count
        # cancels (1 - 0.999 ** 3 ~ 3e-3), so one ulp of the power moves the update by 2e-5
        bc1, bc2 = (1 - torch.tensor(b.item() ** count, dtype=torch.float32) for b in (b1, b2))

        def one(g, mu, nu):
            g = torch.clamp(g, -self.clipvalue, self.clipvalue)
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * g ** 2 + b2 * nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            return u * -lr, mu, nu

        out = [one(*leaves) for leaves in zip(*map(tree_leaves, (grads, state["mu"], state["nu"])))]
        updates, mu, nu = (tree_unflatten(grads, [o[i] for o in out]) for i in range(3))
        return updates, {"count": count, "mu": mu, "nu": nu,
                         "learning_rate": state["learning_rate"]}


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


ADAM_BETAS = {"adaptiveattention": (0.9, 0.999), "gridTD": (0.8, 0.999)}


def make_optimizer(model_type: str, learning_rate: float, clipvalue: float = 0.1) -> Adam:
    """Adam with ``model_type``'s betas; a model without its own (AOA) takes
    Keras's defaults, 0.9 and 0.999, as the JAX package's ``ADAM_BETAS.get``."""
    b1, b2 = ADAM_BETAS.get(model_type, (0.9, 0.999))
    return Adam(learning_rate, b1=b1, b2=b2, clipvalue=clipvalue)


def get_learning_rate(opt_state) -> float:
    return float(opt_state["learning_rate"])


def set_learning_rate(opt_state, lr: float):
    """A new state with the learning rate ``lr``; the moments are shared."""
    return dict(opt_state, learning_rate=_f32(lr))


def _f32(lr: float) -> float:
    """The learning rate as the float32 the step uses (optax keeps it as a
    float32 array): ``get_learning_rate`` then reads what the JAX package's does."""
    return float(torch.tensor(lr, dtype=torch.float32))
