#!/usr/bin/env python3
"""Why the Explainer's entry points differ on the card, and how far its f32
explanations lie from f64 over several images. Needs a CUDA card.

    python3 scripts/explainer_consistency.py [--images N]

At full width (FlickrConfig, vocab 7003, beam 3, T 20, random weights from
seed 0, f32, ``batch_size`` 8; the images of ``chip_smoke.py``'s natural
workload) it reads:

* ``entry_points``: each Explanation array's largest distance over its
  scale between ``analyze`` (one row) and ``analyze_batch`` (three images,
  one dispatch padded to 4), with K1's split-K as the code chooses it
  (``chosen``) and with K1 held to one split (``one``);
* ``parts``: the same by stage: the encode's feature grid at batch 1 against
  batch 4; the cached forward's caches at batch 1 against batch 4 (the
  largest distance over a cache's scale, worst cache); the eager decoder
  stage on one shared feature grid at batch 1 against batch 4, with K1's
  splits as chosen and at one; and the decoder LRP at batch 1 and 3 on one
  cached forward's caches (``chip_smoke.lrp_on_shared_caches``);
* ``gradients``: each gradient method on the first image and the first four
  words of its caption, word 0 on the card against CPU f32 and f64, the CNN
  side on the f64 run's decoder gradient (``chip_smoke.grad_vs_cpu``);
* ``f64``: for each of the first N images (default 5), its first two words
  on the card and on the CPU in f32 and in f64 (``chip_smoke.card_vs_cpu``):
  the card's and the CPU-f32 run's distance from f64, for feat_relevance and
  for the heatmaps.

Prints the result as one JSON line and writes it to
``chiprun_out/explainer_consistency.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("feat_relevance", "word_relevances", "attentions", "betas")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("explainer_consistency: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.explain.engine import _pad_rows
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.ops import _build, kernels
    from lrp_imagecaptioning_torch.runtime import resolve_device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = resolve_device("cuda")
    _build.build_all()
    cap = build_captioner("adaptiveattention", FlickrConfig(), cs.VOCAB)
    params = cap.init_params(seed=0, device=dev)
    images = torch.from_numpy(cs.natural_workload()[0][:max(args.images, 3)]).to(dev)
    chosen = kernels.lrp_linear_splits
    splits = {"chosen": chosen, "one": lambda m, n, k, sms: 1}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    out = dict(card=card, entry_points={}, parts={})
    with torch.no_grad():
        for name, fn in splits.items():
            kernels.lrp_linear_splits = fn
            try:
                ex = cs.explainer_for(cap, params, dev, batch_size=cs.B_MAIN)
                toks = ex._decode(images[:3])
                one = [ex.analyze(images[i], toks[i]) for i in range(3)]
                out["entry_points"][name] = cs.explanation_dist(ex.analyze_batch(images[:3], toks),
                                                                one)
                feat4 = ex._encode(_pad_rows(images[:3], 4))
                out["parts"]["encode"] = rel(ex._encode(images[:1])[0], feat4[0])
                toks4 = torch.as_tensor(_pad_rows(toks, 4), dtype=torch.long, device=dev)
                pos = torch.arange(cs.T, device=dev).expand(4, cs.T).contiguous()
                d4 = ex._decoder_impl(ex.params, feat4, toks4, pos)
                d1 = ex._decoder_impl(ex.params, feat4[:1], toks4[:1], pos[:1])
                out["parts"][f"decoder_{name}"] = {f: rel(a[0], b[0])
                                                    for f, a, b in zip(FIELDS, d1, d4)}
                c4 = cap.cached_forward(ex.params, feat4, toks4, cs.SOS)[1]
                c1 = cap.cached_forward(ex.params, feat4[:1], toks4[:1], cs.SOS)[1]
                out["parts"]["cached_forward"] = max(rel(a[:, 0], b[:, 0]) for a, b in zip(c1, c4))
                out["parts"][f"lrp_shared_caches_{name}"] = cs.lrp_on_shared_caches(
                    ex, images[:3], toks)
            finally:
                kernels.lrp_linear_splits = chosen
            cs.log(f"K1 splits {name}: {out['entry_points'][name]}; {out['parts']}")
            del ex
        ex = cs.explainer_for(cap, params, dev, batch_size=cs.B_MAIN)
        toks = ex._decode(images[:args.images])
        out["f64"] = [cs.card_vs_cpu(ex, cap, params, images[i], toks[i], [], f"image {i}")
                      for i in range(args.images)]
        del ex
        tokens = np.zeros(cs.T, np.int32)
        tokens[:4] = cs.natural_workload()[1][0, :4]
        tokens[4] = cs.EOS
        out["gradients"] = {}
        for method in cs.GRAD_METHODS:
            ex = cs.explainer_for(cap, params, dev, method=method)
            e = ex.analyze(images[0], tokens)
            out["gradients"][method] = cs.grad_vs_cpu(ex, cap, params, images[0], tokens, e, [])
            del ex
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "explainer_consistency.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
