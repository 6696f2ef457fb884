"""The InceptionV3 encoder (keras.applications topology), NHWC.

The port of the JAX package's ``models/inception.py``: the network is a
declarative op list in Keras's creation order, so the numbered Keras layers
(conv2d_1..94 / batch_normalization_1..94) map one to one onto its names for
the H5 import. Every conv is bias-free + BatchNorm (inference mode, eps
1e-3) + ReLU; the SAME average pools divide by their in-image taps. The tap
'mixed10' is 8x8x2048 for a 299x299 input, scaled to [-1, 1].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.lrp_conv import avgpool2d, conv2d, maxpool2d

BN_EPS = 1e-3  # keras.applications inception_v3 BN epsilon


def _spec():
    """[('conv', name, src, filters, (kh, kw), stride, padding) |
    ('pool', name, src, 'max' | 'avg', window, stride, padding) |
    ('concat', name, [sources])] in Keras's creation order; branches are
    wired by name."""
    ops = []

    def conv(name, src, f, kh, kw, s=1, p="VALID"):
        ops.append(("conv", name, src, f, (kh, kw), s, p))

    def pool(name, src, kind, w, s, p):
        ops.append(("pool", name, src, kind, w, s, p))

    def concat(name, srcs):
        ops.append(("concat", name, srcs))

    conv("stem1", "input", 32, 3, 3, 2)
    conv("stem2", "stem1", 32, 3, 3)
    conv("stem3", "stem2", 64, 3, 3, 1, "SAME")
    pool("stem_pool1", "stem3", "max", 3, 2, "VALID")
    conv("stem4", "stem_pool1", 80, 1, 1)
    conv("stem5", "stem4", 192, 3, 3)
    pool("stem_pool2", "stem5", "max", 3, 2, "VALID")

    prev = "stem_pool2"
    for i, pf in enumerate([32, 64, 64]):          # inception-A (mixed0..2)
        m = f"mixed{i}"
        conv(f"{m}_b1x1", prev, 64, 1, 1, 1, "SAME")
        conv(f"{m}_b5x5_1", prev, 48, 1, 1, 1, "SAME")
        conv(f"{m}_b5x5_2", f"{m}_b5x5_1", 64, 5, 5, 1, "SAME")
        conv(f"{m}_b3x3dbl_1", prev, 64, 1, 1, 1, "SAME")
        conv(f"{m}_b3x3dbl_2", f"{m}_b3x3dbl_1", 96, 3, 3, 1, "SAME")
        conv(f"{m}_b3x3dbl_3", f"{m}_b3x3dbl_2", 96, 3, 3, 1, "SAME")
        pool(f"{m}_pool", prev, "avg", 3, 1, "SAME")
        conv(f"{m}_bpool", f"{m}_pool", pf, 1, 1, 1, "SAME")
        concat(m, [f"{m}_b1x1", f"{m}_b5x5_2", f"{m}_b3x3dbl_3", f"{m}_bpool"])
        prev = m

    conv("mixed3_b3x3", prev, 384, 3, 3, 2)          # reduction-A
    conv("mixed3_b3x3dbl_1", prev, 64, 1, 1, 1, "SAME")
    conv("mixed3_b3x3dbl_2", "mixed3_b3x3dbl_1", 96, 3, 3, 1, "SAME")
    conv("mixed3_b3x3dbl_3", "mixed3_b3x3dbl_2", 96, 3, 3, 2)
    pool("mixed3_pool", prev, "max", 3, 2, "VALID")
    concat("mixed3", ["mixed3_b3x3", "mixed3_b3x3dbl_3", "mixed3_pool"])
    prev = "mixed3"

    for i, c7 in zip(range(4, 8), [128, 160, 160, 192]):   # inception-B (mixed4..7)
        m = f"mixed{i}"
        conv(f"{m}_b1x1", prev, 192, 1, 1, 1, "SAME")
        conv(f"{m}_b7x7_1", prev, c7, 1, 1, 1, "SAME")
        conv(f"{m}_b7x7_2", f"{m}_b7x7_1", c7, 1, 7, 1, "SAME")
        conv(f"{m}_b7x7_3", f"{m}_b7x7_2", 192, 7, 1, 1, "SAME")
        conv(f"{m}_b7x7dbl_1", prev, c7, 1, 1, 1, "SAME")
        conv(f"{m}_b7x7dbl_2", f"{m}_b7x7dbl_1", c7, 7, 1, 1, "SAME")
        conv(f"{m}_b7x7dbl_3", f"{m}_b7x7dbl_2", c7, 1, 7, 1, "SAME")
        conv(f"{m}_b7x7dbl_4", f"{m}_b7x7dbl_3", c7, 7, 1, 1, "SAME")
        conv(f"{m}_b7x7dbl_5", f"{m}_b7x7dbl_4", 192, 1, 7, 1, "SAME")
        pool(f"{m}_pool", prev, "avg", 3, 1, "SAME")
        conv(f"{m}_bpool", f"{m}_pool", 192, 1, 1, 1, "SAME")
        concat(m, [f"{m}_b1x1", f"{m}_b7x7_3", f"{m}_b7x7dbl_5", f"{m}_bpool"])
        prev = m

    conv("mixed8_b3x3_1", prev, 192, 1, 1, 1, "SAME")       # reduction-B
    conv("mixed8_b3x3_2", "mixed8_b3x3_1", 320, 3, 3, 2)
    conv("mixed8_b7x7x3_1", prev, 192, 1, 1, 1, "SAME")
    conv("mixed8_b7x7x3_2", "mixed8_b7x7x3_1", 192, 1, 7, 1, "SAME")
    conv("mixed8_b7x7x3_3", "mixed8_b7x7x3_2", 192, 7, 1, 1, "SAME")
    conv("mixed8_b7x7x3_4", "mixed8_b7x7x3_3", 192, 3, 3, 2)
    pool("mixed8_pool", prev, "max", 3, 2, "VALID")
    concat("mixed8", ["mixed8_b3x3_2", "mixed8_b7x7x3_4", "mixed8_pool"])
    prev = "mixed8"

    for i in (9, 10):                                        # inception-C (mixed9, 10)
        m = f"mixed{i}"
        conv(f"{m}_b1x1", prev, 320, 1, 1, 1, "SAME")
        conv(f"{m}_b3x3_1", prev, 384, 1, 1, 1, "SAME")
        conv(f"{m}_b3x3_2a", f"{m}_b3x3_1", 384, 1, 3, 1, "SAME")
        conv(f"{m}_b3x3_2b", f"{m}_b3x3_1", 384, 3, 1, 1, "SAME")
        concat(f"{m}_b3x3", [f"{m}_b3x3_2a", f"{m}_b3x3_2b"])
        conv(f"{m}_b3x3dbl_1", prev, 448, 1, 1, 1, "SAME")
        conv(f"{m}_b3x3dbl_2", f"{m}_b3x3dbl_1", 384, 3, 3, 1, "SAME")
        conv(f"{m}_b3x3dbl_3a", f"{m}_b3x3dbl_2", 384, 1, 3, 1, "SAME")
        conv(f"{m}_b3x3dbl_3b", f"{m}_b3x3dbl_2", 384, 3, 1, 1, "SAME")
        concat(f"{m}_b3x3dbl", [f"{m}_b3x3dbl_3a", f"{m}_b3x3dbl_3b"])
        pool(f"{m}_pool", prev, "avg", 3, 1, "SAME")
        conv(f"{m}_bpool", f"{m}_pool", 192, 1, 1, 1, "SAME")
        concat(m, [f"{m}_b1x1", f"{m}_b3x3", f"{m}_b3x3dbl", f"{m}_bpool"])
        prev = m
    return ops


SPEC = _spec()
CONV_ORDER = [op[1] for op in SPEC if op[0] == "conv"]  # Keras's numbering order


def _channels():
    """(name -> (cin, cout) of each conv, name -> channels of every tensor)."""
    ch, dims = {"input": 3}, {}
    for op in SPEC:
        if op[0] == "conv":
            dims[op[1]] = (ch[op[2]], op[3])
            ch[op[1]] = op[3]
        elif op[0] == "pool":
            ch[op[1]] = ch[op[2]]
        else:
            ch[op[1]] = sum(ch[s] for s in op[2])
    return dims, ch


CONV_DIMS, CHANNELS = _channels()
MIXED10_CHANNELS = CHANNELS["mixed10"]  # 2048


def init_inception_v3_params(gen: torch.Generator, dtype=torch.float32):
    """He-normal conv kernels and the identity BatchNorm, the JAX package's
    init laws, on the CPU, in ``dtype``."""
    params = {}
    for op in SPEC:
        if op[0] != "conv":
            continue
        name, (kh, kw) = op[1], op[4]
        cin, cout = CONV_DIMS[name]
        std = math.sqrt(2.0 / (kh * kw * cin))
        params[name] = {"kernel": (torch.randn((kh, kw, cin, cout), generator=gen) * std).to(dtype),
                        "bn_gamma": torch.ones(cout, dtype=dtype),
                        "bn_beta": torch.zeros(cout, dtype=dtype),
                        "bn_mean": torch.zeros(cout, dtype=dtype),
                        "bn_var": torch.ones(cout, dtype=dtype)}
    return params


def bn(pn, z: torch.Tensor) -> torch.Tensor:
    """Inference-mode BatchNorm of a conv's output."""
    inv = torch.rsqrt(pn["bn_var"] + BN_EPS)
    return (z - pn["bn_mean"]) * inv * pn["bn_gamma"] + pn["bn_beta"]


def pool(t: torch.Tensor, kind: str, w: int, s: int, p: str) -> torch.Tensor:
    """A pool of SPEC (its max pools are all VALID)."""
    return maxpool2d(t, w, s) if kind == "max" else avgpool2d(t, w, s, padding=p)


def inception_v3_apply(params, x: torch.Tensor, compute_dtype=None, until: str = "mixed10",
                       relu_fn=None) -> torch.Tensor:
    """(B, 299, 299, 3) preprocessed ([-1, 1]) -> (B, 8, 8, 2048) at 'mixed10'
    (or the tensor ``until``). ``compute_dtype`` casts both conv operands and
    upcasts the output, so BN and ReLU run in f32; ``relu_fn`` replaces every
    ReLU."""
    relu_fn = relu_fn or torch.relu
    tensors = {"input": x}
    for op in SPEC:
        if op[0] == "conv":
            _, name, src, _, _, s, p = op
            t, k = tensors[src], params[name]["kernel"]
            if compute_dtype is not None:
                z = conv2d(t.to(compute_dtype), k.to(compute_dtype), s, p).float()
            else:
                z = conv2d(t, k, s, p)
            tensors[name] = relu_fn(bn(params[name], z))
        elif op[0] == "pool":
            _, name, src, kind, w, s, p = op
            tensors[name] = pool(tensors[src], kind, w, s, p)
        else:
            tensors[op[1]] = torch.cat([tensors[s] for s in op[2]], dim=-1)
        if op[1] == until:
            break
    return tensors[until]


def inception_preprocess(img_rgb: np.ndarray) -> np.ndarray:
    """Keras inception ``preprocess_input``: RGB 0..255 -> [-1, 1]."""
    return np.asarray(img_rgb, np.float32) / 127.5 - 1.0


def load_keras_inception_v3_h5(path: str) -> dict:
    """Weights (numpy) from a keras.applications InceptionV3 HDF5: the
    numbered layers (conv2d_N / batch_normalization_N) map onto CONV_ORDER
    by creation order; a newer Keras names the first ones without '_1'."""
    import h5py

    params = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def datasets(group, out):
            for k, v in group.items():
                if hasattr(v, "keys"):
                    datasets(v, out)
                else:
                    out[k] = np.asarray(v)

        def nth(prefix, n):
            out: dict = {}
            datasets(root[prefix if n == 1 and prefix in root else f"{prefix}_{n}"], out)
            return out

        for idx, name in enumerate(CONV_ORDER, start=1):
            cw, bw = nth("conv2d", idx), nth("batch_normalization", idx)

            def pick(*subs):
                return next(v for k, v in bw.items() if any(s in k for s in subs))

            params[name] = {"kernel": next(v for k, v in cw.items() if "kernel" in k or "_W" in k),
                            "bn_gamma": pick("gamma"), "bn_beta": pick("beta"),
                            "bn_mean": pick("moving_mean"),
                            "bn_var": pick("moving_var", "moving_variance")}
    return params
