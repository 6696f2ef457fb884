#!/usr/bin/env python3
"""How far conv3x3_fused's divide pass lies from an f64 reference where
signed taps make z = conv(x, W) + b cancel. Needs a CUDA card.

    python3 scripts/k3_divide_accuracy.py [--pkg DIR]

It draws the inputs of ``tests/test_torch_kernels.py::TestOnCard::
test_conv3x3_fused[divide]`` (seed 22, three shapes, x per word and x
shared) and, over the quotients the test checks (|z| > 1e-2), reports for
the kernel, for the f32 plain version (cuDNN, TF32 off) and for the same
conv with TF32 on:

* ``f64``: the largest |q - q64| / |q64|;
* ``f64_per_cond``: the same distance over the condition number of the sum,
  kappa = (|x| * |W| summed + |b|) / |z|: the error in units of the sum of
  the terms' magnitudes, which f32 keeps near 1e-7 whatever the order;
* ``vs_plain``: the kernel's largest |q - q_plain| / (1e-5 + 1e-4 |q_plain|),
  the ratio to the tolerance the test held it to before the kernel moved to
  the tensor cores (passes at <= 1).

``--pkg DIR`` imports the port from another checkout (an earlier commit
unpacked into DIR), so two kernel designs read the same inputs. The result
is printed as one JSON line and written to
``chiprun_out/k3_divide_accuracy[-<DIR name>].json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(5, 28, 28, 64, 128), (4, 14, 14, 512, 512), (3, 13, 19, 72, 20)]


def conv_inputs(rng, n, h, w, cin, cout):
    """The draws of the test's ``_conv_inputs``, in its order."""
    x = np.abs(rng.normal(size=(n, h, w, cin))).astype(np.float32)
    k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1
    b = rng.normal(size=(cout,)).astype(np.float32) * 0.1
    r = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    return x, k, b, r


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=HERE, help="checkout whose port is measured")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.pkg))
    import torch

    from lrp_imagecaptioning_torch.ops import kernels

    if not torch.cuda.is_available():
        print("k3_divide_accuracy: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(22)
    rows = []
    for n, h, w, cin, cout in SHAPES:
        x, k, b, r = (torch.from_numpy(a).cuda() for a in conv_inputs(rng, n, h, w, cin, cout))
        for shared, xs in (("per word", x), ("shared", x[:1].contiguous())):
            got = kernels.conv3x3_fused(xs, r, k, b, mode="divide")
            plain = kernels.conv3x3_fused_plain(xs, r, k, b, mode="divide")
            torch.backends.cudnn.allow_tf32 = True
            tf32 = kernels.conv3x3_fused_plain(xs, r, k, b, mode="divide")
            torch.backends.cudnn.allow_tf32 = False
            q64 = kernels.conv3x3_fused_plain(xs.double(), r.double(), k.double(), b.double(),
                                              mode="divide")
            z64 = kernels.conv2d(xs.double(), k.double()) + b.double()
            mag = kernels.conv2d(xs.double().abs(), k.double().abs()) + b.double().abs()
            kappa = (mag / z64.abs()).expand_as(q64)
            ok = (r / plain).abs() > 1e-2
            row = dict(shape=[n, h, w, cin, cout], x=shared, checked=float(ok.double().mean()),
                       kappa_max=float(kappa[ok].max()))
            for name, q in (("kernel", got), ("plain_f32", plain), ("tf32", tf32)):
                dist = ((q.double() - q64).abs() / q64.abs())[ok]
                row[name] = dict(f64=float(dist.max()),
                                 f64_per_cond=float((dist / kappa[ok]).max()))
            row["kernel"]["vs_plain"] = float(
                ((got - plain).abs() / (1e-5 + 1e-4 * plain.abs()))[ok].max())
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = dict(card=card, pkg=os.path.abspath(args.pkg), rows=rows,
               worst={name: {key: max(row[name][key] for row in rows) for key in row[name]}
                      for name in ("kernel", "plain_f32", "tf32")})
    tag = "" if os.path.abspath(args.pkg) == HERE else "-" + os.path.basename(
        os.path.abspath(args.pkg))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"k3_divide_accuracy{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    print(json.dumps(out["worst"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
