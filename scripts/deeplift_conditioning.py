#!/usr/bin/env python3
"""How far an f32 DeepLIFT walk over VGG16 lies from f64, on the CPU.

    python3 scripts/deeplift_conditioning.py [--images 12] [--size 64] [--until block4_conv3]

For each of ``--images`` random images (numpy seed 0, N(0, 60^2) pixels, the
preprocessed range) and a random seed at ``--until`` (VGG16 from the Keras
init, torch seed 0), three walks of ``explain/cnn_deeplift.py``: in f32, in
f64, and in f64 over the f32 run's own forward activations promoted exactly.
Prints, per image, the relative 2-norm of the f32 walk's distance from each
f64 one. The first moves with the forward's rounding, which DeepLIFT's divide
by the output difference y - y_ref carries into its result; the second is
the walk's own rounding. Runs on the CPU at small shapes, in a minute.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lrp_imagecaptioning_torch.explain.cnn_deeplift import (_deeplift_backward,  # noqa: E402
                                                            reference_image, vgg_deeplift)
from lrp_imagecaptioning_torch.models.vgg import (init_vgg_params,  # noqa: E402
                                                  vgg_apply_with_acts, vgg_layers)
from lrp_imagecaptioning_torch.weights import tree_to  # noqa: E402


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).norm() / ref.norm())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=12)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--until", default="block4_conv3")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    p32 = init_vgg_params(torch.Generator().manual_seed(0), until=args.until)
    p64 = tree_to(p32, dtype=torch.float64)
    ops = vgg_layers(until=args.until)
    rng = np.random.default_rng(0)
    whole, own = [], []
    for i in range(args.images):
        img = torch.from_numpy(rng.normal(0, 60, (1, args.size, args.size, 3)).astype(np.float32))
        top, acts = vgg_apply_with_acts(p32, img, until=args.until)
        top_ref, acts_ref = vgg_apply_with_acts(p32, reference_image(img, 0.0), until=args.until)
        seed = torch.from_numpy(rng.normal(0, 1, top.shape).astype(np.float32))
        m32 = vgg_deeplift(p32, img, seed, until=args.until)
        m64 = vgg_deeplift(p64, img.double(), seed.double(), until=args.until)
        m64_own = _deeplift_backward(p64, seed.double(), ops, [a.double() for a in acts],
                                     [a.double() for a in acts_ref], top.double(),
                                     top_ref.double(), True)
        whole.append(rel_l2(m32, m64))
        own.append(rel_l2(m32, m64_own))
        print(f"image {i}: f32 from f64 {whole[-1]:.3e}, from f64 over its own forward "
              f"{own[-1]:.3e}", flush=True)
    print(f"range: from f64 {min(whole):.3e} to {max(whole):.3e}; over its own forward "
          f"{min(own):.3e} to {max(own):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
