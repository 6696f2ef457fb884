"""Carry parameters into the port.

* ``params_from_jax`` takes a nested dict/list of arrays (numpy arrays, or
  anything ``np.asarray`` reads, e.g. the JAX package's params) and returns
  the same tree of float32 torch tensors on ``device``.
* ``load_params_npz`` reads the flat ``.npz`` that the JAX package's
  ``save_params_npz`` writes, and ``save_params_npz`` writes it: keys are
  ``/``-joined paths; lists and tuples are ``#<index>`` segments with
  ``#tuple`` / ``#emptylist`` / ``#emptydict`` sentinels.
* ``opt_state_from_jax`` takes the Adam moments of an optax state (numpy
  trees) and returns the port's Adam state (``train/optimizer.py``).

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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict/list/tuple and of ``rest``,
    trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def check_tree_like(tree, template, what: str = "tree") -> None:
    """Raise ``ValueError`` unless ``tree`` has ``template``'s structure (the
    same dict keys, list lengths and tensor shapes; other leaves as they are)."""
    def walk(a, b, path):
        if isinstance(b, dict):
            if not isinstance(a, dict) or set(a) != set(b):
                raise ValueError(f"{what}{path}: keys {_keys(a)} != the template's {sorted(b)}")
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (list, tuple)):
            if not isinstance(a, (list, tuple)) or len(a) != len(b):
                raise ValueError(f"{what}{path}: not a sequence of the template's {len(b)}")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/#{i}")
        elif hasattr(b, "shape") and tuple(getattr(a, "shape", ())) != tuple(b.shape):
            raise ValueError(f"{what}{path}: shape {tuple(getattr(a, 'shape', ()))} != "
                             f"the template's {tuple(b.shape)}")

    walk(tree, template, "")


def _keys(node):
    return sorted(node) if isinstance(node, dict) else type(node).__name__


def tree_like(tree, template):
    """``tree``'s tensors on ``template``'s devices and in its dtypes (leaves
    that are not tensors in the template stay as they are)."""
    if isinstance(template, dict):
        return {k: tree_like(tree[k], template[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(tree_like(a, b) for a, b in zip(tree, template))
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(tree).to(device=template.device, dtype=template.dtype)
    return tree


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple, dict keys in sorted order (so
    that two dicts with the same keys line up, whatever their insertion order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


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


def opt_state_from_jax(count, mu, nu, learning_rate, device="cuda"):
    """The port's Adam state from an optax one, read as numpy: ``count``,
    ``mu`` and ``nu`` of its ``ScaleByAdamState`` and the injected
    ``learning_rate``; a run can then go on from that step."""
    return {"count": int(np.asarray(count)), "mu": params_from_jax(mu, device),
            "nu": params_from_jax(nu, device),
            "learning_rate": float(np.asarray(learning_rate))}


def save_params_npz(path: str, params) -> None:
    """A nested dict/list/tuple of tensors or arrays -> flat ``.npz`` (the
    format ``load_params_npz`` and the JAX package read)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            if not node:
                flat[f"{prefix}/#emptydict"] = np.zeros(0, np.float32)
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            if isinstance(node, tuple):
                flat[f"{prefix}/#tuple"] = np.zeros(0, np.float32)
            if not node:
                flat[f"{prefix}/#emptylist"] = np.zeros(0, np.float32)
            for i, v in enumerate(node):
                walk(f"{prefix}/#{i}", v)
        elif isinstance(node, torch.Tensor):
            flat[prefix] = node.detach().cpu().numpy()
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    np.savez(path, **flat)


def load_params_npz(path: str, *, device="cuda"):
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
