"""Core LRP primitives (epsilon rule with bias_factor=0).

    matrix weight:   rel = x * ((r / stab(z)) @ W^T)
    identity weight: rel = x * r / stab(z)

``stab(z) = z + sign(z) * eps`` with sign(0) = +1 and eps = K.epsilon().
"""

from __future__ import annotations

import torch

EPS_KERAS = 1e-7  # K.epsilon() default used by the reference rule


def sign_stabilizer(z: torch.Tensor) -> torch.Tensor:
    """z + sign(z)*eps with sign(0) = +1."""
    return z + torch.where(z >= 0, EPS_KERAS, -EPS_KERAS)


def safe_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b with exact zeros in b replaced by eps (iNNvestigate SafeDivide)."""
    return a / (b + (b == 0).to(b.dtype) * EPS_KERAS)


def lrp_linear(r: torch.Tensor, x: torch.Tensor, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """epsilon-LRP through ``z = x @ w (+ b)``.

    r, z: (..., Dout); x: (..., Din); w: (Din, Dout) -> relevance (..., Din).
    The plain version of the ``lrp_linear`` kernel (ops/kernels.py).
    """
    s = r / sign_stabilizer(z)
    return x * (s @ w.T)


def lrp_identity(r: torch.Tensor, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """lrp_linear with an identity weight: rel_j = x_j * r_j / stab(z_j)."""
    return x * r / sign_stabilizer(z)
