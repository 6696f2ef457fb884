#!/usr/bin/env python3
"""How far one training step's gradient on the card lies from an f64
reference, leaf by leaf, under cuDNN's settings. Needs a CUDA card.

    python3 scripts/train_grad_accuracy.py

The step is the one smoke phase 9b starts with: adaptive attention on VGG16
at full width (224 x 224, vocab 7003, T = 21), batch 2, no dropout, params
from seed 0, images of seeded noise at the scale of VGG-preprocessed pixels.
The loss gradient is taken

* on the CPU in f64 (the reference; the card's kernels take f32 only),
* on the card in f32 with cuDNN's default algorithm choice,
* on the card in f32 with ``torch.backends.cudnn.deterministic = True``,
* on the card in f32 with ``torch.backends.cudnn.benchmark = True``,
* on the CPU in f32,

TF32 off throughout. For each it reports every VGG leaf's and the worst
decoder leaf's 2-norm distance from the reference over the reference's
2-norm, and each run's time. The result is printed as one JSON line and
written to ``chiprun_out/train_grad_accuracy.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS, VOCAB = 2, 21, 7003


def main() -> int:
    if not torch.cuda.is_available():
        print("train_grad_accuracy: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.runtime import resolve_device
    from lrp_imagecaptioning_torch.train.step import value_and_grad
    from lrp_imagecaptioning_torch.weights import tree_leaves, tree_to

    resolve_device("cuda")
    cfg = FlickrConfig(drop_rate=0.0)
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((B, 224, 224, 3), dtype=np.float32) * 50)
    caps = torch.from_numpy(rng.integers(0, VOCAB, size=(B, STEPS)))
    y = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, VOCAB, size=(B, STEPS))),
                                    VOCAB).float()
    names = []

    def walk(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], f"{prefix}/{k}")
            else:
                names.append(f"{prefix}/{k}")

    walk(params)

    def grads(device, dtype, deterministic=False, benchmark=False):
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
        p = tree_to(params, device, dtype)
        args = [t.to(device) for t in (images.to(dtype), caps, y.to(dtype))]
        for _ in range(2 if device == "cuda" else 1):   # the second call is timed
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, g = value_and_grad(lambda q: (cap.loss(q, *args), None), p)
            if device == "cuda":
                torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = False
        return [x.cpu().double() for x in tree_leaves(g)], ms

    ref, ref_ms = grads("cpu", torch.float64)
    out = {"card": torch.cuda.get_device_name(0),
           "power": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True,
                                   text=True).stdout.strip(),
           "cpu_f64_ms": ref_ms, "runs": {}}
    for label, kw in (("card_default", dict(device="cuda")),
                      ("card_deterministic", dict(device="cuda", deterministic=True)),
                      ("card_benchmark", dict(device="cuda", benchmark=True)),
                      ("cpu_f32", dict(device="cpu"))):
        g, ms = grads(dtype=torch.float32, **kw)
        dist = {n: ((a - b).norm() / b.norm().clamp(min=1e-300)).item()
                for n, a, b in zip(names, g, ref)}
        out["runs"][label] = dict(
            ms=ms, vgg={n: v for n, v in dist.items() if n.startswith("/vgg")},
            worst_decoder=max((v, n) for n, v in dist.items() if n.startswith("/decoder")))
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "train_grad_accuracy.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
