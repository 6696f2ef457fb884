"""Device selection shared by the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is visible;
only an explicit ``device="cpu"`` runs on the host (the tests do that).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent.

    Also turns TF32 off for matmuls and cuDNN convolutions: the JAX reference
    computes in full f32, and cuDNN's default TF32 keeps ~3 decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the plain CPU versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
