#!/usr/bin/env python3
"""How far f32 runs of the Explainer's ``lrp`` lie from f64 on phase 11's
configurations of ``chip_smoke.py`` (ResNet-101, ResNet-50, InceptionV3,
AOA on VGG16, VGG19; full width), over several images and weight seeds.
Needs a CUDA card.

    python3 scripts/config_f64_spread.py [--images N] [--configs a,b]
                                         [--split CONFIG:SEED:IMAGE,...]

For each configuration and weight seed (0 and 1: random weights from that
seed, BatchNorm statistics drawn from 100 + seed) and each of the first N
images (default 3) of ``chip_smoke.config_images`` at seed 11 + 10 x the
weight seed, it explains the card's decoded caption as phase 11 does (the
first 4 words for ResNet-101 and InceptionV3, 2 for the others) on the card
in f32 and on the CPU in f32 with all threads, in f32 with one thread (a
second CPU witness, its sums in another order) and in f64. It reads each
f32 run's largest distance from f64 over the f64 run's scale, for
feat_relevance (``r_feat``) and the heatmaps (``maps``): the readings that
phase 11's floors (``chip_smoke.F64_FLOOR_CONFIGS``) rest on.

``--split`` takes VGG-encoder cases (``vgg19``, ``aoa``) instead and
splits one image's heatmap distance by its source: the CNN side alone, on
the f64 run's decoder relevance, on the card as it runs (``card``), on the
card with the forward activations computed in f64 and rounded to f32
(``card_f64_forward``), on the card with K3's plain version in place of
the kernel (``card_plain_k3``), and on the CPU in f32 (``cpu``), each
one's largest distance from the CPU-f64 CNN side over its scale.

``--analyzers`` takes phase 13's analyzer catalogue instead (VGG16 up to
block5_conv3 at 224x224, ``chip_smoke.analyzer_model`` at weight seeds 0
and 1): each of the 32 names runs as phase 13 runs it, at batch 8, and the
first N images' maps are held to CPU f32 and f64 runs of the name (or of the
name it is an alias of) as phase 13's one-image gate holds image 0: the
readings that ``chip_smoke.ANALYZER_FLOOR`` rests on
(``analyzer_f64_spread.json``).

``--phase9 RUNS`` trains phase 9's checkpoint RUNS times (9a's
``Trainer.run``, in ``build/spread9_<run>``, removed after) and, on each,
as phase 10 takes it (its EOS logit's bias at -30, the test images as
JPEGs through the provider): VGG16's decoder-map and heatmap distances from
f64 for ``deep_taylor`` (phase 10a) and ``lrp`` over the first N test
images (``chip_smoke.card_vs_cpu``, two words), and phase 12b's served
answers against the direct ones: 16 concurrent HTTP clients through the
queue (linger 5 ms), each answer's largest float16 distance from its image
explained alone, with and without one float16 spacing allowed
(``phase9_spread.json``).

Writes the readings to ``chiprun_out/config_f64_spread.json`` as each
configuration ends (``config_f64_split.json`` for ``--split``) and prints
the summary as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = {"resnet101": 4, "inception": 4, "resnet50": 2, "aoa": 2, "vgg19": 2}


def model(cs, name, dev, seed):
    """phase 11's ``config_model`` at another weight seed."""
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner

    kind, over = cs.CONFIGS[name]
    cfg = FlickrConfig(**over)
    cap = build_captioner(kind, cfg, cs.VOCAB)
    return cfg, cap, cs.draw_bn(cap.init_params(seed=seed, device=dev), 100 + seed)


def cut_caption(cs, ex, image, words):
    """The card's decode as phase 11 takes it, cut to ``words`` words ->
    (caption, n)."""
    from lrp_imagecaptioning_torch.explain.engine import _n_explained

    caption = cs.four_words(ex.predict_caption(image)[0])
    n = min(_n_explained(caption, cs.EOS), words)
    cut = np.zeros(cs.T, np.int32)
    cut[:n] = caption[:n]
    cut[n] = cs.EOS
    return cut, n


def readings(cs, ex, cap, params_c, image, words):
    """One image: the caption cut to ``words`` words, explained on the card,
    on the CPU (all threads, one thread) in f32 and in f64 -> distances."""
    import torch

    from lrp_imagecaptioning_torch.weights import tree_to

    cut, n = cut_caption(cs, ex, image, words)
    runs = {"card": ex.analyze(image, cut)}
    threads = torch.get_num_threads()
    for name, dtype, nt in (("cpu", torch.float32, threads), ("cpu_1t", torch.float32, 1),
                            ("f64", torch.float64, threads)):
        torch.set_num_threads(nt)
        cpu = cs.explainer_for(cap, tree_to(params_c, dtype=dtype), "cpu", method="lrp")
        cpu._buckets = (n,)
        runs[name] = cpu.analyze(image.cpu(), cut)
    torch.set_num_threads(threads)
    out = {}
    for key, field in (("r_feat", "feat_relevance"), ("maps", "relevance_maps")):
        ref = getattr(runs["f64"], field)
        scale = max(float(abs(ref).max()), 1e-30)
        for name in ("card", "cpu", "cpu_1t"):
            out[f"{key}_{name}"] = float(abs(getattr(runs[name], field) - ref).max()) / scale
    return out


def split(cs, ex, cap, params_c, image, words):
    """One image's VGG CNN side on the f64 run's decoder relevance, its
    heatmap distance from CPU f64 split by source (module docstring)."""
    import torch

    from lrp_imagecaptioning_torch.explain import cnn_lrp
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.weights import tree_to

    cut, n = cut_caption(cs, ex, image, words)
    cpu64 = cs.explainer_for(cap, tree_to(params_c, dtype=torch.float64), "cpu", method="lrp")
    cpu64._buckets = (n,)
    r64 = torch.from_numpy(cpu64.analyze(image.cpu(), cut).feat_relevance)[None]
    img = image[None]
    acts, k3 = cnn_lrp.vgg_apply_with_acts, cnn_lrp.lrp_conv_a1b0

    def f64_forward(params, x, until, arch):
        out, inputs = acts(tree_to(tree_to(params, "cpu"), dtype=torch.float64), x.cpu().double(),
                           until, arch)
        return out.to(x.device, x.dtype), [t.to(x.device, x.dtype) for t in inputs]

    def plain_k3(r, x, kernel, bias):
        kp = kernel * (kernel >= 0)
        s = kernels.conv3x3_fused_plain(x, r, kp, bias, "divide")
        return kernels.conv3x3_fused_plain(s, x, kernels.flip_transpose_kernel(kp), None,
                                           "multiply")

    with torch.no_grad():
        ref = cpu64._cnn(img.cpu().double(), None, r64)[0]
        cpu = cs.explainer_for(cap, params_c, "cpu", method="lrp")
        maps = {"cpu": cpu._cnn(img.cpu(), None, r64.float())[0],
                "card": ex._cnn(img, None, r64.float().to(img.device))[0]}
        for name, attr, fn in (("card_f64_forward", "vgg_apply_with_acts", f64_forward),
                               ("card_plain_k3", "lrp_conv_a1b0", plain_k3)):
            setattr(cnn_lrp, attr, fn)
            try:
                maps[name] = ex._cnn(img, None, r64.float().to(img.device))[0]
            finally:
                cnn_lrp.vgg_apply_with_acts, cnn_lrp.lrp_conv_a1b0 = acts, k3
    scale = float(ref.abs().max())
    return {k: float((v.cpu().double() - ref).abs().max()) / scale for k, v in maps.items()}


def analyzer_spread(cs, dev, n_images):
    """Phase 13's one-image gate on the first ``n_images`` images of its
    batch, at weight seeds 0 and 1 -> rows and each name's worst readings."""
    import torch

    from lrp_imagecaptioning_torch.explain.analyzers import analyzer_names, create_analyzer
    from lrp_imagecaptioning_torch.explain.patterns import compute_vgg_patterns

    rows = []
    for seed in (0, 1):
        params = cs.analyzer_model(dev, seed)
        images, seeds = cs.analyzer_inputs(dev, cs.B_MAIN, 31 + seed)
        pattern_images = [cs.analyzer_inputs(dev, cs.B_MAIN, 40 + i + 10 * seed)[0]
                          for i in range(cs.PATTERN_BATCHES)]
        patterns = compute_vgg_patterns(params, pattern_images, "relu")
        caches = [{} for _ in range(n_images)]
        for name in analyzer_names():
            with torch.no_grad():
                out = None if cs.gate_noise(name) is not None else create_analyzer(
                    name, params, **cs.analyzer_kwargs(name, patterns, dev))(images, seeds)
            for i in range(n_images):
                row = None if out is None else out[i:i + 1]
                card, cpu, _ = cs.analyzer_gate(name, params, images[i:i + 1], seeds[i:i + 1],
                                                patterns, dev, row, caches[i])
                rows.append(dict(name=name, weights=seed, image=i, card=card, cpu=cpu))
                print(json.dumps(rows[-1]), flush=True)
            del out
        del caches, params, patterns
        torch.cuda.empty_cache()
    worst = {}
    for r in rows:
        canon = cs.ALIASES.get(r["name"], r["name"])
        w = worst.setdefault(canon, {"card": 0.0, "cpu": 0.0})
        w["card"], w["cpu"] = max(w["card"], r["card"]), max(w["cpu"], r["cpu"])
    return dict(rows=rows, worst=worst)


def served_vs_direct(cs, cap, params, pp, dev, clients):
    """Phase 12b's comparison on ``params``: each client image explained
    alone (queue stopped), then all of them from concurrent HTTP clients
    through the queue -> the worst float16 distance with one spacing allowed
    (``cs.answer_dist``) and without it."""
    import numpy as np

    from lrp_imagecaptioning_torch.infer.http_server import CaptionHTTPServer
    from lrp_imagecaptioning_torch.infer.serving import CaptionService

    svc = CaptionService(cap, params, pp, batch_size=cs.B_MAIN, beam_size=cs.BEAM,
                         max_len=cs.T, device=dev).warmup(explain=True)
    direct = [svc.explain(clients[i:i + 1])[0] for i in range(len(clients))]
    server = CaptionHTTPServer(svc, port=0).start()
    svc.start_queue(linger_ms=cs.LINGER_MS)
    n0 = svc.stats["requests"]
    try:
        answers, _, _ = cs.concurrent_clients(lambda im: cs.http_explain(server.port, im)[0],
                                              clients)
    finally:
        svc.stop_queue()
        server.stop()

    def raw(a, d):
        if a["caption"] != d.caption:
            return float("inf")
        return max(float(np.abs(np.asarray(a[k], np.float32) - getattr(d, k)).max())
                   / max(float(np.abs(getattr(d, k)).max()), 1e-30)
                   for k in ("relevance_maps", "word_relevances"))

    return dict(dispatches=svc.stats["requests"] - n0,
                words=[len(d.words) for d in direct],
                worst_f16=max(cs.answer_dist(a, d) for a, d in zip(answers, direct)),
                worst_raw=max(raw(a, d) for a, d in zip(answers, direct)),
                map_scale=max(float(np.abs(d.relevance_maps).max()) for d in direct))


def phase9_spread(cs, dev, runs, n_images):
    """Phase 9's checkpoint, trained ``runs`` times, read as phase 10 takes it."""
    import torch

    from lrp_imagecaptioning_torch.data.provider import DatasetProvider
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

    rows, serve, cwd = [], [], os.getcwd()
    for run in range(runs):
        work = os.path.join(HERE, "build", f"spread9_{run}")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        os.chdir(work)
        try:
            _, _, (cfg, ds, trainer) = cs.phase_trainer(dev, [], {})
            params = restore_checkpoint(latest_checkpoint(trainer.result_dir), device=dev)[0]
            cs.write_test_jpegs(ds)
            provider = DatasetProvider(ds, cfg)
            pp = provider.caption_preprocessor
            params["decoder"]["output"]["bias"][pp.EOS_TOKEN_LABEL_ENCODED - 1] = -30.0
            cap = build_captioner("adaptiveattention", cfg, provider.vocab_size)
            images, _ = cs.provider_test_images(provider)
            for method in ("deep_taylor", "lrp"):
                ex = cs.explainer_for(cap, params, dev, pp=pp, method=method)
                for i in range(n_images):
                    image = torch.from_numpy(images[i]).to(dev)
                    toks = ex.predict_caption(image)[0]
                    r = cs.card_vs_cpu(ex, cap, params, image, toks, [],
                                       f"run {run} {method} image {i}")
                    rows.append(dict(run=run, method=method, image=i,
                                     **{k: v for k, v in r.items() if "_vs_" in k}))
                    print(json.dumps(rows[-1]), flush=True)
                del ex
            serve.append(dict(run=run, **served_vs_direct(cs, cap, params, pp, dev,
                                                          images[:cs.N_CLIENTS])))
            print(json.dumps(serve[-1]), flush=True)
        finally:
            os.chdir(cwd)
            shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    worst = {k: max(r[k] for r in rows) for k in rows[0] if "_vs_" in k}
    return dict(rows=rows, worst=worst, serve=serve)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=3)
    ap.add_argument("--configs", default=",".join(WORDS))
    ap.add_argument("--split", default="")
    ap.add_argument("--analyzers", action="store_true")
    ap.add_argument("--phase9", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("config_f64_spread: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lrp_imagecaptioning_torch.ops import _build
    from lrp_imagecaptioning_torch.runtime import resolve_device
    from lrp_imagecaptioning_torch.weights import tree_to

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = resolve_device("cuda")
    _build.build_all()
    path = os.path.join(HERE, "chiprun_out", "config_f64_spread.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    out = dict(card=card, cpu_threads=torch.get_num_threads(), configs={})
    for flag, fn, name in ((args.analyzers, analyzer_spread, "analyzer_f64_spread.json"),
                           (args.phase9, phase9_spread, "phase9_spread.json")):
        if flag:
            t0 = time.perf_counter()
            res = fn(cs, dev, args.phase9, args.images) if fn is phase9_spread else fn(
                cs, dev, args.images)
            res.update(card=card, s=time.perf_counter() - t0)
            with open(os.path.join(HERE, "chiprun_out", name), "w") as f:
                f.write(json.dumps(res) + "\n")
            print(json.dumps({k: v for k, v in res.items() if k != "rows"}), flush=True)
    if args.analyzers or args.phase9:
        return 0
    if args.split:
        for case in args.split.split(","):
            name, seed, i = case.split(":")
            cfg, cap, params = model(cs, name, dev, int(seed))
            ex = cs.explainer_for(cap, params, dev, method="lrp")
            image = cs.config_images(cfg, dev, args.images, seed=11 + 10 * int(seed))[int(i)]
            out["configs"][case] = split(cs, ex, cap, tree_to(params, "cpu"), image, WORDS[name])
            print(case, json.dumps(out["configs"][case]), flush=True)
        with open(os.path.join(HERE, "chiprun_out", "config_f64_split.json"), "w") as f:
            f.write(json.dumps(out) + "\n")
        return 0
    for name in args.configs.split(","):
        t0, rows = time.perf_counter(), []
        for seed in (0, 1):
            cfg, cap, params = model(cs, name, dev, seed)
            params_c = tree_to(params, "cpu")
            ex = cs.explainer_for(cap, params, dev, method="lrp")
            images = cs.config_images(cfg, dev, args.images, seed=11 + 10 * seed)
            for i in range(args.images):
                rows.append(dict(weights=seed, image=i,
                                 **readings(cs, ex, cap, params_c, images[i], WORDS[name])))
                print(name, json.dumps(rows[-1]), flush=True)
            del ex, params, params_c
            torch.cuda.empty_cache()
        worst = {k: max(r[k] for r in rows) for k in rows[0] if k not in ("weights", "image")}
        out["configs"][name] = dict(rows=rows, worst=worst, s=time.perf_counter() - t0)
        with open(path, "w") as f:
            f.write(json.dumps(out) + "\n")
    print(json.dumps({k: v["worst"] for k, v in out["configs"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
