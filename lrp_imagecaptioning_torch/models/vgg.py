"""The VGG16 / VGG19 encoders (NHWC activations, HWIO kernels), Keras layer names.

The forward convs run through ``F.conv2d`` (ops/lrp_conv.py:conv2d), as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch

from ..ops.lrp_conv import conv2d, maxpool2d
from .cells import _uniform

# (block, n_convs, channels)
_VGG_CFG = {
    "vgg16": [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)],
    "vgg19": [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512)],
}


def vgg_layers(until: str = "block5_conv3", arch: str = "vgg16"):
    """Ordered op list [('conv', name, cin, cout) | ('pool', name)] of
    ``arch`` cut at ``until``."""
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
    if until is not None:
        raise ValueError(f"layer {until!r} not in {arch}")
    return ops


def init_vgg_params(gen: torch.Generator, until: str = "block5_conv3", arch: str = "vgg16"):
    """Glorot-uniform init (Keras default) for each conv layer, on the CPU."""
    params = {}
    for op in vgg_layers(until, arch):
        if op[0] != "conv":
            continue
        _, name, cin, cout = op
        limit = math.sqrt(6.0 / (9 * cin + 9 * cout))
        params[name] = {"kernel": _uniform(gen, (3, 3, cin, cout), limit),
                        "bias": torch.zeros(cout)}
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


def vgg_apply(params, x: torch.Tensor, until: str = "block5_conv3", compute_dtype=None,
              relu_fn=None, arch: str = "vgg16"):
    """Forward pass -> feature map at ``until`` (B, 14, 14, 512 for 224x224).

    ``compute_dtype`` (``torch.bfloat16``) casts both conv operands to it and
    upcasts each conv output to f32, so bias, ReLU and pooling run in f32.
    ``relu_fn`` replaces every ReLU (the gradient methods' guided and
    deconvnet ReLUs, explain/cnn_gradient.py); None is ``torch.relu``."""
    for op in vgg_layers(until, arch):
        x = _apply_op(op, params, x, compute_dtype, relu_fn)
    return x


def vgg_apply_with_acts(params, x: torch.Tensor, until: str = "block5_conv3",
                        arch: str = "vgg16"):
    """Forward pass that also returns each op's input activation. It runs in
    the dtype of ``params`` and ``x`` (bf16 under the CNN LRP's storage_dtype).

    Returns (features, inputs) with inputs[i] = input of vgg_layers(...)[i]."""
    inputs = []
    for op in vgg_layers(until, arch):
        inputs.append(x)
        x = _apply_op(op, params, x)
    return x, inputs
