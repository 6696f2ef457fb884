"""Checkpoints of params + Adam state, in the port's own format: one flat
``.npz`` per checkpoint through the ``weights.py`` codec, with the keys
``params/...`` and ``opt_state/{count,learning_rate,mu/...,nu/...}``.

Names encode the epoch and the monitored metric as the JAX package's do
(``ckpt_{epoch:02d}_{metric:.4f}``); its orbax checkpoints need JAX to read
and are not read here.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from ..weights import load_params_npz, save_params_npz


def ckpt_name(epoch: int, metric: float | None) -> str:
    if metric is None:
        return f"ckpt_{epoch:02d}"
    return f"ckpt_{epoch:02d}_{metric:.4f}"


def save_checkpoint(directory: str, epoch: int, params, opt_state=None,
                    metric: float | None = None) -> str:
    """Write ``<directory>/<ckpt_name>.npz``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, ckpt_name(epoch, metric) + ".npz"))
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = dict(opt_state, count=np.int32(opt_state["count"]),
                                  learning_rate=np.float32(opt_state["learning_rate"]))
    save_params_npz(path, state)
    return path


def latest_checkpoint(directory: str) -> str | None:
    """The checkpoint with the highest epoch in its name, or None."""
    best, best_epoch = None, -1
    for c in glob.glob(os.path.join(directory, "ckpt_*.npz")):
        m = re.match(r"ckpt_(\d+)", os.path.basename(c))
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = c, int(m.group(1))
    return best


def restore_checkpoint(path: str, device="cuda"):
    """-> (params, opt_state or None), tensors on ``device``."""
    state = load_params_npz(path, device)
    opt_state = state.get("opt_state")
    if opt_state is not None:
        opt_state = dict(opt_state, count=int(opt_state["count"]),
                         learning_rate=float(opt_state["learning_rate"]))
    return state["params"], opt_state
