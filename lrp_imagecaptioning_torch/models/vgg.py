"""The VGG16 / VGG19 encoders (NHWC activations, HWIO kernels), Keras layer names.

The forward convs run through ``F.conv2d`` (ops/lrp_conv.py:conv2d), as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.lrp_conv import conv2d, maxpool2d
from .cells import _uniform

# (block, n_convs, channels)
_VGG_CFG = {
    "vgg16": [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)],
    "vgg19": [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512)],
}


def check_arch_until(arch, until) -> None:
    """Raise ``ValueError`` unless ``arch`` is a VGG name and ``until`` one of
    its conv layers (or None, the whole stack): every VGG function takes
    (arch, until) in that order, as the JAX package does, and a call with the
    two swapped, or with a layer in ``arch``'s place, fails here."""
    if not isinstance(arch, str) or arch not in _VGG_CFG:
        raise ValueError(f"arch must be one of {sorted(_VGG_CFG)}, got {arch!r} "
                         "(the order is (arch, until))")
    if until is not None and until not in _conv_names(arch):
        raise ValueError(f"layer {until!r} not in {arch}")


def _conv_names(arch: str) -> set[str]:
    return {f"block{b}_conv{i}" for b, n, _ in _VGG_CFG[arch] for i in range(1, n + 1)}


def vgg_layers(arch: str = "vgg16", until: str = "block5_conv3"):
    """Ordered op list [('conv', name, cin, cout) | ('pool', name)] of
    ``arch`` cut at ``until``."""
    check_arch_until(arch, until)
    ops = []
    cin = 3
    for block, n_convs, ch in _VGG_CFG[arch]:
        for i in range(1, n_convs + 1):
            name = f"block{block}_conv{i}"
            ops.append(("conv", name, cin, ch))
            cin = ch
            if name == until:
                return ops
        ops.append(("pool", f"block{block}_pool"))
    return ops


def init_vgg_params(gen: torch.Generator, arch: str = "vgg16", until: str = "block5_conv3",
                    dtype=torch.float32):
    """Glorot-uniform init (Keras default) for each conv layer, on the CPU, in
    ``dtype``."""
    params = {}
    for op in vgg_layers(arch, until):
        if op[0] != "conv":
            continue
        _, name, cin, cout = op
        limit = math.sqrt(6.0 / (9 * cin + 9 * cout))
        params[name] = {"kernel": _uniform(gen, (3, 3, cin, cout), limit).to(dtype),
                        "bias": torch.zeros(cout, dtype=dtype)}
    return params


def _apply_op(op, params, x: torch.Tensor, compute_dtype=None, relu_fn=None) -> torch.Tensor:
    if op[0] == "pool":
        return maxpool2d(x)
    p = params[op[1]]
    if compute_dtype is not None:
        y = conv2d(x.to(compute_dtype), p["kernel"].to(compute_dtype)).float()
    else:
        y = conv2d(x, p["kernel"])
    return (relu_fn or torch.relu)(y + p["bias"].to(y.dtype))


def vgg_apply(params, x: torch.Tensor, arch: str = "vgg16", until: str = "block5_conv3",
              compute_dtype=None, relu_fn=None):
    """Forward pass -> feature map at ``until`` (B, 14, 14, 512 for 224x224).

    ``compute_dtype`` (``torch.bfloat16``) casts both conv operands to it and
    upcasts each conv output to f32, so bias, ReLU and pooling run in f32.
    ``relu_fn`` replaces every ReLU (the gradient methods' guided and
    deconvnet ReLUs, explain/cnn_gradient.py); None is ``torch.relu``."""
    for op in vgg_layers(arch, until):
        x = _apply_op(op, params, x, compute_dtype, relu_fn)
    return x


def vgg_apply_with_acts(params, x: torch.Tensor, arch: str = "vgg16",
                        until: str = "block5_conv3"):
    """Forward pass that also returns each op's input activation. It runs in
    the dtype of ``params`` and ``x`` (bf16 under the CNN LRP's storage_dtype).

    Returns (features, inputs) with inputs[i] = input of vgg_layers(...)[i]."""
    inputs = []
    for op in vgg_layers(arch, until):
        inputs.append(x)
        x = _apply_op(op, params, x)
    return x, inputs


def load_keras_vgg_h5(path: str, arch: str = "vgg16", until: str = "block5_conv3") -> dict:
    """VGG16 / VGG19 conv params (numpy) from a Keras HDF5 file: keras.applications
    weight files (``f[name][name + '_W_1:0']``) and reference checkpoints
    (``f['model_weights'][name][...]``) alike. ``weights.params_from_jax``
    places them on a device."""
    import h5py

    params = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def find_layer(name):
            if name in root:
                return root[name]
            for k in root:  # nested (e.g. model_1/block1_conv1)
                g = root[k]
                if isinstance(g, h5py.Group) and name in g:
                    return g[name]
            return None

        for op in vgg_layers(arch, until):
            if op[0] != "conv":
                continue
            name = op[1]
            g = find_layer(name)
            if g is None:
                raise KeyError(f"layer {name} not found in {path}")
            while isinstance(g, h5py.Group) and name in g:  # name/name/kernel:0
                g = g[name]
            found: dict = {}

            def walk(group):
                for k, v in group.items():
                    if isinstance(v, h5py.Group):
                        walk(v)
                        continue
                    # 'kernel:0' / 'bias:0' (checkpoints) or '<layer>_W_1:0' /
                    # '<layer>_b_1:0' (keras.applications): match underscore tokens
                    toks = k.split(":")[0].split("_")
                    if "kernel" in toks or "W" in toks:
                        found["kernel"] = np.asarray(v)
                    elif "bias" in toks or "b" in toks:
                        found["bias"] = np.asarray(v)

            if isinstance(g, h5py.Group):
                walk(g)
            if set(found) != {"kernel", "bias"}:
                raise KeyError(f"kernel/bias not found under layer {name}")
            params[name] = found
    return params
