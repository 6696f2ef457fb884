"""SmoothGrad's noise draws, shared by the Explainer (``explain/engine.py``)
and the serving artifact's loader (``infer/export.py``), which hands them to
an exported SmoothGrad program as its input: one module, so that the
exported maps use the live Explainer's noise. It imports torch alone, so
loading an artifact needs no explain module.
"""

from __future__ import annotations

import torch


def smoothgrad_noise(n_words: int, samples: int, image_shape) -> torch.Tensor:
    """Standard-normal noise, (n_words, samples, *image_shape) on the CPU.
    Word position p draws from its own generator (seed p), so a position's
    noise does not depend on the bucket or the batch (as the JAX package
    keys it per position); the generic encoders' one set an image is
    position 0's. A CPU generator: its bits are not ``jax.random``'s."""
    out = []
    for p in range(n_words):
        gen = torch.Generator().manual_seed(p)
        out.append(torch.randn((samples, *image_shape), generator=gen))
    return torch.stack(out)
