"""Checkpoints of params + Adam state, in the port's own format: one flat
``.npz`` per checkpoint through the ``weights.py`` codec, with the keys
``params/...`` and ``opt_state/{count,learning_rate,mu/...,nu/...}``.

Names encode the epoch and the monitored metric as the JAX package's do
(``ckpt_{epoch:02d}_{metric:.4f}``); its orbax checkpoints (directories)
need JAX to read: ``restore_checkpoint`` refuses them. ``save_params_npz``
/ ``load_params_npz`` are the flat format both packages read.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from ..weights import check_tree_like, load_params_npz, save_params_npz, tree_like


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


def restore_checkpoint(path: str, params_template=None, opt_state_template=None, *,
                       device=None):
    """-> (params, opt_state or None). With ``params_template`` (and
    ``opt_state_template``) the checkpoint's trees must match the templates'
    (``ValueError`` otherwise) and each tensor lands on its template's device
    in its dtype; without, on ``device`` (default "cuda"). A checkpoint
    without optimizer state gives None for it, template or not."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX package): "
                         "write it there with save_params_npz and load the .npz")
    for name, t in (("params_template", params_template),
                    ("opt_state_template", opt_state_template)):
        if t is not None and not isinstance(t, dict):
            raise TypeError(f"{name} must be a params dict, got {type(t).__name__} "
                            "(device is keyword-only: restore_checkpoint(path, device=...))")
    if device is None:
        device = "cpu" if params_template is not None else "cuda"
    state = load_params_npz(path, device=device)
    params, opt_state = state["params"], state.get("opt_state")
    if opt_state is not None:
        opt_state = dict(opt_state, count=int(opt_state["count"]),
                         learning_rate=float(opt_state["learning_rate"]))
    if params_template is not None:
        check_tree_like(params, params_template, "params")
        params = tree_like(params, params_template)
    if opt_state is not None and opt_state_template is not None:
        check_tree_like(opt_state, opt_state_template, "opt_state")
        opt_state = tree_like(opt_state, opt_state_template)
    return params, opt_state
