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


def lstm_step(params, x: torch.Tensor, state: LSTMState):
    """One LSTM step (no dropout). Returns (new_state, cache)."""
    h, c = state
    # z = x @ wi + h @ wh + b: the two adds are in the kernel, in this order
    z, h_new, c_new = lstm_gates(x @ params["wi"], h @ params["wh"], params["b"], c)
    return LSTMState(h_new, c_new), LSTMCache(z_pre=z, c=c_new)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int):
    return {"kernel": glorot_uniform(gen, (in_dim, out_dim)), "bias": torch.zeros(out_dim)}


def dense(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["kernel"] + params["bias"]


def attn_weight_init(gen: torch.Generator, shape) -> torch.Tensor:
    """glorot_uniform, the attention wrapper's weight initializer."""
    return glorot_uniform(gen, shape)
