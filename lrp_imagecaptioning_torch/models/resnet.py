"""The ResNet-50 / ResNet-101 encoders (Keras-applications v1), NHWC.

The port of the JAX package's ``models/resnet.py``: a 7x7/2 conv ('conv1')
+ BN + ReLU over the input zero-padded by 3, a 3x3/2 VALID max pool, then
bottleneck stages [3, 4, 6, 3] (ResNet-101: [3, 4, 23, 3]) of filters
(64, 64, 256) / (128, 128, 512) / (256, 256, 1024) / (512, 512, 2048). A
stage's first block carries a projection shortcut ('branch1'); the stride of
a downsampling block sits on its 1x1 '2a' conv and on 'branch1', as in
Keras. Layer names follow Keras (``res{stage}{block}_branch2a``,
``bn{stage}{block}_branch2a``), so published checkpoints import one to one.
The convs have no bias; BatchNorm runs in inference mode (moving
statistics). The tap is the last block's ReLU ('activation_49'): 7x7x2048
for a 224x224 input.
"""

from __future__ import annotations

import math

import torch

from ..ops.lrp_conv import conv2d, maxpool2d

BN_EPS = 1.001e-5  # keras.applications resnet epsilon


def _block_names(n: int):
    """Keras/caffe block naming: 'a'..'f' for <= 6 blocks, else 'a', 'b1',
    'b2', ... (ResNet-101's 23-block stage)."""
    if n <= 6:
        return ["abcdef"[i] for i in range(n)]
    return ["a"] + [f"b{i}" for i in range(1, n)]


def _stages(depth: str):
    """[(stage, block names, filters, stride of the first block)]."""
    counts = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}[depth]
    filters = [(64, 64, 256), (128, 128, 512), (256, 256, 1024), (512, 512, 2048)]
    return [(i + 2, _block_names(counts[i]), filters[i], 1 if i == 0 else 2) for i in range(4)]


def conv_names(depth: str = "resnet50"):
    """Ordered (conv name, BN name, HWIO kernel shape, stride)."""
    out = [("conv1", "bn_conv1", (7, 7, 3, 64), 2)]
    cin = 64
    for stage, blocks, (f1, f2, f3), stage_stride in _stages(depth):
        for bi, block in enumerate(blocks):
            s = stage_stride if bi == 0 else 1
            base, bn = f"res{stage}{block}_branch", f"bn{stage}{block}_branch"
            if bi == 0:
                out.append((base + "1", bn + "1", (1, 1, cin, f3), s))
            out.append((base + "2a", bn + "2a", (1, 1, cin if bi == 0 else f3, f1), s))
            out.append((base + "2b", bn + "2b", (3, 3, f1, f2), 1))
            out.append((base + "2c", bn + "2c", (1, 1, f2, f3), 1))
            cin = f3
    return out


def init_resnet50_params(gen: torch.Generator, dtype=torch.float32, depth: str = "resnet50"):
    """He-normal conv kernels and the identity BatchNorm (gamma 1, beta 0,
    mean 0, variance 1), the JAX package's init laws, on the CPU, in ``dtype``."""
    if depth not in ("resnet50", "resnet101"):
        raise ValueError(f"depth must be 'resnet50' or 'resnet101', got {depth!r}")
    params = {}
    for conv_name, bn_name, kshape, _ in conv_names(depth):
        std = math.sqrt(2.0 / (kshape[0] * kshape[1] * kshape[2]))
        params[conv_name] = {"kernel": (torch.randn(kshape, generator=gen) * std).to(dtype)}
        cout = kshape[-1]
        params[bn_name] = {"gamma": torch.ones(cout, dtype=dtype),
                           "beta": torch.zeros(cout, dtype=dtype),
                           "moving_mean": torch.zeros(cout, dtype=dtype),
                           "moving_var": torch.ones(cout, dtype=dtype)}
    return params


def bn(p, x: torch.Tensor) -> torch.Tensor:
    """Inference-mode BatchNorm."""
    inv = torch.rsqrt(p["moving_var"] + BN_EPS)
    return (x - p["moving_mean"]) * inv * p["gamma"] + p["beta"]


def conv(p, x: torch.Tensor, stride: int, padding: str, compute_dtype=None) -> torch.Tensor:
    """The bias-free conv; ``compute_dtype`` casts both operands and upcasts
    the output, so BN, ReLU and the residual adds run in f32."""
    if compute_dtype is None:
        return conv2d(x, p["kernel"], stride, padding)
    return conv2d(x.to(compute_dtype), p["kernel"].to(compute_dtype), stride, padding).float()


def _bottleneck(params, x, stage: int, block: str, first: bool, stride: int, relu_fn,
                compute_dtype=None):
    base, bnn = f"res{stage}{block}_branch", f"bn{stage}{block}_branch"

    def conv_bn(name, x, stride, padding):
        return bn(params[bnn + name], conv(params[base + name], x, stride, padding, compute_dtype))

    shortcut = conv_bn("1", x, stride, "VALID") if first else x
    y = relu_fn(conv_bn("2a", x, stride, "VALID"))
    y = relu_fn(conv_bn("2b", y, 1, "SAME"))
    return relu_fn(conv_bn("2c", y, 1, "VALID") + shortcut)


def stem_pad(x: torch.Tensor) -> torch.Tensor:
    """Keras's ZeroPadding2D(3) before conv1."""
    return torch.nn.functional.pad(x, (0, 0, 3, 3, 3, 3))


def resnet50_apply(params, x: torch.Tensor, compute_dtype=None, depth: str = "resnet50",
                   relu_fn=None) -> torch.Tensor:
    """(B, 224, 224, 3) preprocessed -> (B, 7, 7, 2048) at 'activation_49'.
    ``relu_fn`` replaces every ReLU (the gradient methods' guided and
    deconvnet ReLUs); None is ``torch.relu``."""
    relu_fn = relu_fn or torch.relu
    x = relu_fn(bn(params["bn_conv1"], conv(params["conv1"], stem_pad(x), 2, "VALID",
                                             compute_dtype)))
    x = maxpool2d(x, 3, 2)
    for stage, blocks, _, stage_stride in _stages(depth):
        for bi, block in enumerate(blocks):
            x = _bottleneck(params, x, stage, block, bi == 0, stage_stride if bi == 0 else 1,
                            relu_fn, compute_dtype)
    return x


def load_keras_resnet50_h5(path: str, depth: str = "resnet50") -> dict:
    """Conv and BN weights (numpy) from a Keras ResNet-50/101 HDF5 file."""
    import h5py
    import numpy as np

    params = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def find(name):
            if name in root:
                return root[name]
            for k in root:
                g = root[k]
                if hasattr(g, "keys") and name in g:
                    return g[name]
            raise KeyError(name)

        def datasets(group, out):
            for k, v in group.items():
                if hasattr(v, "keys"):
                    datasets(v, out)
                else:
                    out[k] = np.asarray(v)

        for conv_name, bn_name, _, _ in conv_names(depth):
            cw: dict = {}
            datasets(find(conv_name), cw)
            params[conv_name] = {"kernel": next(
                v for k, v in cw.items() if "kernel" in k or k.endswith("W:0") or "_W" in k)}
            bw: dict = {}
            datasets(find(bn_name), bw)

            def pick(*subs):
                return next(v for k, v in bw.items() if any(s in k for s in subs))

            params[bn_name] = {"gamma": pick("gamma"), "beta": pick("beta"),
                               "moving_mean": pick("moving_mean", "running_mean"),
                               "moving_var": pick("moving_var", "running_var",
                                                  "moving_variance")}
    return params
