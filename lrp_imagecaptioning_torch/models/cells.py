"""LSTM cell and the initializers shared by the decoder.

Gate layout follows Keras: z = [i, f, g, o] concatenated on the last axis;
recurrent activation sigmoid, activation tanh; ``unit_forget_bias`` adds +1
to the forget-gate bias at init. The two adds of the gate pre-activations
and the gate tail run in the ``lstm_gates`` kernel (ops/kernels.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.kernels import lstm_gates


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


class LSTMCache(NamedTuple):
    """Everything a backward pass needs from one step."""

    z_pre: torch.Tensor  # (..., 4H) gate pre-activations [i, f, g, o]
    c: torch.Tensor      # (..., H) new cell state


def _uniform(gen: torch.Generator, shape, limit: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def glorot_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """glorot_uniform over (fan_in, ..., fan_out) = (shape[0], shape[-1])."""
    return _uniform(gen, shape, math.sqrt(6.0 / (shape[0] + shape[-1])))


def orthogonal(gen: torch.Generator, shape) -> torch.Tensor:
    """Keras/JAX-style orthogonal init for a 2-D (rows, cols) matrix."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q if rows >= cols else q.T).contiguous()


def lstm_init(gen: torch.Generator, in_dim: int, hidden: int):
    """glorot_uniform kernel, orthogonal recurrent, zeros(+forget 1) bias."""
    b = torch.zeros(4 * hidden)
    b[hidden:2 * hidden] = 1.0
    return {"wi": glorot_uniform(gen, (in_dim, 4 * hidden)),
            "wh": orthogonal(gen, (hidden, 4 * hidden)),
            "b": b}


def lstm_step(params, x: torch.Tensor, state: LSTMState, dropout_masks=None):
    """One LSTM step. Returns (new_state, cache).

    ``dropout_masks``, when given, is ``(x_masks (4, [B,] in_dim), h_masks
    (4, [B,] H))``: Keras LSTM dropout, one inverted-dropout mask per gate for
    the input and one for the recurrent state, constant across timesteps."""
    h, c = state
    if dropout_masks is None:
        zx, zh = x @ params["wi"], h @ params["wh"]
    else:
        # gate by gate, as the JAX cell: (x xm[g]) @ wi_g and (h hm[g]) @ wh_g
        x_masks, h_masks = dropout_masks
        wi, wh = params["wi"].chunk(4, dim=-1), params["wh"].chunk(4, dim=-1)
        zx = torch.cat([(x * x_masks[g]) @ wi[g] for g in range(4)], dim=-1)
        zh = torch.cat([(h * h_masks[g]) @ wh[g] for g in range(4)], dim=-1)
    # z = zx + zh + b: the two adds are in the kernel, in this order
    z, h_new, c_new = lstm_gates(zx, zh, params["b"], c)
    return LSTMState(h_new, c_new), LSTMCache(z_pre=z, c=c_new)


def bernoulli_keep(gen: torch.Generator, keep: float, shape, dtype=torch.float32) -> torch.Tensor:
    """Inverted-dropout mask on ``gen``'s device: 1/keep with probability
    ``keep``, else 0."""
    return (torch.rand(shape, generator=gen, device=gen.device) < keep).to(dtype) / keep


def lstm_dropout_masks(gen: torch.Generator, in_dim: int, hidden: int, rate: float,
                       batch: int | None = None):
    """Per-gate inverted-dropout masks, shared across timesteps.

    Returns (x_masks, h_masks) with shapes (4, [B,] in_dim) / (4, [B,] H)."""
    keep = 1.0 - rate
    lead = (4,) if batch is None else (4, batch)
    return bernoulli_keep(gen, keep, (*lead, in_dim)), bernoulli_keep(gen, keep, (*lead, hidden))


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int):
    return {"kernel": glorot_uniform(gen, (in_dim, out_dim)), "bias": torch.zeros(out_dim)}


def dense(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["kernel"] + params["bias"]


def attn_weight_init(gen: torch.Generator, shape) -> torch.Tensor:
    """glorot_uniform, the attention wrapper's weight initializer."""
    return glorot_uniform(gen, shape)
