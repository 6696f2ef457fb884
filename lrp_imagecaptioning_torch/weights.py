"""Carry parameters into the port.

* ``params_from_jax`` takes a nested dict/list of arrays (numpy arrays, or
  anything ``np.asarray`` reads, e.g. the JAX package's params) and returns
  the same tree of float32 torch tensors on ``device``.
* ``load_params_npz`` reads the flat ``.npz`` that the JAX package's
  ``save_params_npz`` writes: keys are ``/``-joined paths; lists and tuples
  are ``#<index>`` segments with ``#tuple`` / ``#emptylist`` / ``#emptydict``
  sentinels.

Layouts are kept as they are (HWIO conv kernels, (in, out) dense kernels):
nothing is transposed at the boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from .runtime import resolve_device


def tree_to(tree, device=None, dtype=None):
    """Move every tensor of a nested dict/list/tuple to ``device`` and/or
    cast it to ``dtype`` (a tensor already there is returned as it is)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device, dtype) for v in tree)
    return tree.to(device=device, dtype=dtype)


def _to_tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def params_from_jax(tree, device="cuda"):
    """Nested dict/list of arrays -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _to_tensor(node).to(dev)

    return walk(tree)


def load_params_npz(path: str, device="cuda"):
    """Inverse of the JAX package's ``save_params_npz`` -> tree of tensors."""
    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = f[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if "#emptydict" in node:
            return {}
        is_tuple = node.pop("#tuple", None) is not None
        if node and all(k.startswith("#") for k in node):
            seq = [] if "#emptylist" in node else [node[f"#{i}"] for i in range(len(node))]
            return tuple(seq) if is_tuple else seq
        if is_tuple:
            return ()
        return node

    return params_from_jax(listify(out), device)
