#!/usr/bin/env python3
"""The gradient methods' CNN side in four forms, timed on the card at the
shapes of ``chip_smoke.py``'s phases 8d (VGG16), 11a (ResNet-101) and 11b
(InceptionV3). Needs a CUDA card.

    python3 scripts/gradient_vjp_forms.py [--words W]

Each form gives the W word seeds' VJPs of the encoder's feature grid with
respect to one image, (W, H, W, 3):

* ``loop``: one forward of the image, then W ``torch.autograd.grad`` calls
  with ``retain_graph``;
* ``batched``: one forward, then one ``torch.autograd.grad`` over the W
  seeds with ``is_grads_batched=True`` (vmap over the backward);
* ``vmap_vjp``: one forward, then ``torch.vmap`` of ``torch.func.vjp``'s
  pullback over the W seeds (``input_gradients``' form);
* ``batch_w``: one forward of the image copied W times and one backward
  (the batch-W form).

For each encoder, with the plain ReLU (``gradient``) and with the guided
one (``guided_backprop`` / ``guided_gradcam``), and for InceptionV3's
SmoothGrad (8 noisy images, each its own forward), it reads the mean device
time of a call by CUDA events, the peak memory, and each form's largest
distance from ``loop`` over its scale. Full width (FlickrConfig, random
weights from seed 0, BatchNorm statistics drawn as ``chip_smoke.py`` draws
them). Prints one JSON line and writes it to
``chiprun_out/gradient_vjp_forms.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def loop_vjps(encode, x, seeds):
    import torch

    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        feats = encode(xg)[0]
        return torch.stack([torch.autograd.grad(feats, xg, s, retain_graph=True)[0][0]
                            for s in seeds])


def batched_vjps(encode, x, seeds):
    import torch

    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        feats = encode(xg)[0]
        return torch.autograd.grad(feats, xg, seeds, is_grads_batched=True)[0][:, 0]


def vmap_vjps(encode, x, seeds):
    import torch

    feats, pullback = torch.func.vjp(lambda im: encode(im)[0], x.detach())
    return torch.vmap(pullback)(seeds.reshape(-1, *feats.shape))[0][:, 0]


def batch_w_vjps(encode, x, seeds):
    import torch

    with torch.enable_grad():
        xw = x.expand(len(seeds), *x.shape[1:]).detach().clone().requires_grad_(True)
        return torch.autograd.grad(encode(xw), xw, seeds)[0]


FORMS = {"loop": loop_vjps, "batched": batched_vjps, "vmap_vjp": vmap_vjps,
         "batch_w": batch_w_vjps}


def compare(cs, encode, x, seeds, images=None):
    """Each form on ``images`` (default [x]): the sum of its VJPs over the
    images, its mean ms, peak GiB and distance from ``loop``."""
    import torch

    images = [x] if images is None else images
    out, ref = {}, None
    for name, form in FORMS.items():
        def call(form=form):
            return sum(form(encode, im, seeds) for im in images)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = call()
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = cs.time_ms(call, min_total_ms=200.0, max_reps=10)
        ref = got if ref is None else ref
        out[name] = dict(ms=ms, peak_gib=peak,
                         vs_loop=float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)))
        del got
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--words", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("gradient_vjp_forms: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.explain.cnn_gradient import guided_relu
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.runtime import resolve_device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = resolve_device("cuda")
    out = dict(card=card, words=args.words)
    for name in ("vgg16", "resnet101", "inception"):
        if name == "vgg16":
            cfg = FlickrConfig()
            cap = build_captioner("adaptiveattention", cfg, cs.VOCAB)
            params = cap.init_params(seed=0, device=dev)
        else:
            cfg, cap, params = cs.config_model(name, dev)
        x = cs.config_images(cfg, dev, 1)
        gen = torch.Generator(device=dev).manual_seed(3)
        seeds = torch.randn(args.words, cfg.img_feature_length, cfg.img_feature_dim,
                            generator=gen, device=dev)
        rows = {}
        for relu, fn in (("relu", None), ("guided", guided_relu)):
            def encode(im, fn=fn):
                return cap.encode(params, im, relu_fn=fn)

            rows[relu] = compare(cs, encode, x, seeds)
        if name == "inception":
            noise = torch.randn(8, *x.shape[1:], generator=gen, device=dev)
            rows["smoothgrad_8"] = compare(cs, lambda im: cap.encode(params, im), x, seeds,
                                           [x + 0.125 * noise[k:k + 1] for k in range(8)])
        out[name] = rows
        print(name, json.dumps(rows), flush=True)
        del cap, params
        torch.cuda.empty_cache()
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "gradient_vjp_forms.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
