#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a card. It fails (exit 1,
no result line) when ``torch.cuda.is_available()`` is false, and when the
port's package is not beside it. Phases; any failure makes the exit code 1:

1. card:    the card's name and power limit, as nvidia-smi gives them;
2. kernels: builds the three CUDA kernels (one nvcc per source, in
            parallel), then holds each against its plain PyTorch version at
            the main path's shapes and times kernel, plain version and one
            library call (torch.matmul for lrp_linear,
            aten::_thnn_fused_lstm_cell for lstm_gates, F.conv2d for
            conv3x3_fused; the port never calls these). Bounds use the H100 SXM peaks: 3.35 TB/s and
            67 TFLOP/s f32 on the CUDA cores;
3. main:    VGG16 / adaptive attention at full width (224x224 input, 14x14x512
            grid, E = H = 512, vocab 7003, beam 3, T = 20) on random weights
            from seed 0, batch 8: one warm-up pass, one per-stage pass and one
            counted pass through ``caption_and_explain``; every kernel's launch
            count must match its calls on that path;
4. card vs CPU: one image on the card and on the CPU (plain versions),
            tokens equal and maps within a stated tolerance, with the CNN LRP
            cut to the first 2 word seeds to keep the CPU time short.

Prints the ``{"kernels": [...]}`` line, then the card line, then as the last
line ``{"ok": true, "device": {...}}``. Per-shape detail goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12    # H100 SXM f32 outside the tensor cores
B_MAIN, VOCAB, BEAM, T = 8, 7003, 3, 20
E = H = D = 512
L = 196
IMAGE = 224
CPU_WORDS = 2
# tolerances, relative to the scale (max |plain|) of each output: the divides
# by stab(z) at eps = 1e-7 amplify last-ulp differences of the sums, which the
# kernels take in another order than cuBLAS/cuDNN
TOL_KERNEL = 1e-4
TOL_CPU_MAPS = 1e-3
TOL_LSTM_ABS = 1e-5
# phase 4: the card's distance from a CPU-f64 run, as a multiple of the CPU-f32
# run's own distance. An H100 80GB HBM3 at 700 W read 0.47x for the decoder-LRP
# maps (1.6e-3 against 3.5e-3 of scale) and 2.0x for the heatmaps (5.6e-4
# against 2.8e-4); the heatmaps also pass TOL_CPU_MAPS against CPU-f32.
F64_RATIO = {"r_feat": 2.0, "maps": 4.0}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, min_total_ms: float = 30.0, max_reps: int = 50) -> float:
    """Mean device time of ``fn`` over enough launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    reps = max(1, min(max_reps, math.ceil(min_total_ms / once)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    diff = (got - ref).abs().max().item()
    return diff, diff / max(ref.abs().max().item(), 1e-30)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def vgg16_conv_layers():
    from lrp_imagecaptioning_torch.models.vgg import vgg_layers

    size, out = IMAGE, []
    for op in vgg_layers("block5_conv3"):
        if op[0] == "pool":
            size //= 2
        elif op[1] != "block1_conv1":   # the signed input layer takes the plain rule
            out.append((op[1], size, op[2], op[3]))
    return out


def linear_shapes():
    R = B_MAIN * T
    return [("output", R, VOCAB, H, 1), ("gate_g", R, H, 2 * E + H, T),
            ("w_glob", R, E, D, 1), ("w_img", R * L, H, D, 1)]


def check_lrp_linear(gen, dev):
    from lrp_imagecaptioning_torch.ops import kernels

    rows = []
    for name, m, dout, din, calls in linear_shapes():
        r = torch.randn(m, dout, generator=gen, device=dev)
        z = torch.randn(m, dout, generator=gen, device=dev)
        x = torch.randn(m, din, generator=gen, device=dev)
        w = torch.randn(din, dout, generator=gen, device=dev) / math.sqrt(dout)
        got = kernels.lrp_linear(r, x, z, w)
        ref = kernels.lrp_linear_plain(r, x, z, w)
        s = r / (z + torch.where(z >= 0, 1e-7, -1e-7))
        wt = w.T
        nbytes = 4 * (2 * m * dout + 2 * m * din + din * dout)
        flops = 2 * m * din * dout + 3 * m * dout + m * din
        rows.append(dict(shape=name, M=m, Dout=dout, Din=din, calls=calls,
                         err=rel_err(got, ref),
                         ms=time_ms(lambda: kernels.lrp_linear(r, x, z, w)),
                         plain_ms=time_ms(lambda: kernels.lrp_linear_plain(r, x, z, w)),
                         library_ms=time_ms(lambda: torch.matmul(s, wt)),
                         bound=bound_ms(nbytes, flops)))
    return rows


def check_lstm_gates(gen, dev):
    from lrp_imagecaptioning_torch.ops import kernels

    rows = []
    for name, b in (("beam", B_MAIN * BEAM), ("cached_forward", B_MAIN)):
        z = torch.randn(b, 4 * H, generator=gen, device=dev) * 2
        c = torch.randn(b, H, generator=gen, device=dev)
        h1, c1 = kernels.lstm_gates(z, c)
        h0, c0 = kernels.lstm_gates_plain(z, c)
        err = max(rel_err(h1, h0), rel_err(c1, c0))
        # ATen's fused LSTM-cell tail (CUDA only), gates [i, f, g, o] from
        # input + hidden gates
        fused_cell = torch.ops.aten._thnn_fused_lstm_cell
        zero = torch.zeros_like(z)
        hl, cl, _ = fused_cell(z, zero, c)
        rows.append(dict(shape=name, B=b, H=H, calls=T, err=err,
                         library_err=max(rel_err(hl, h0), rel_err(cl, c0)),
                         ms=time_ms(lambda: kernels.lstm_gates(z, c)),
                         plain_ms=time_ms(lambda: kernels.lstm_gates_plain(z, c)),
                         library_ms=time_ms(lambda: fused_cell(z, zero, c)),
                         bound=bound_ms(4 * (b * 4 * H + 3 * b * H), 10 * b * H)))
    return rows


def check_conv3x3_fused(gen, dev):
    from lrp_imagecaptioning_torch.ops import kernels

    rows = []
    n = T
    for name, size, cin, cout in vgg16_conv_layers():
        hw = size * size
        x = torch.relu(torch.randn(1, size, size, cin, generator=gen, device=dev))
        r = torch.randn(n, size, size, cout, generator=gen, device=dev)
        kp = torch.rand(3, 3, cin, cout, generator=gen, device=dev) * math.sqrt(6.0 / (9 * (cin + cout)))
        b = torch.rand(cout, generator=gen, device=dev) * 0.01
        kt = kernels.flip_transpose_kernel(kp)
        s = kernels.conv3x3_fused(x, r, kp, b, "divide")
        passes = {
            # divide: z = conv(x, W+) + b once for the shared x, then N quotients
            "divide": (lambda: kernels.conv3x3_fused(x, r, kp, b, "divide"),
                       lambda: kernels.conv3x3_fused_plain(x, r, kp, b, "divide"),
                       x, kp,
                       4 * (hw * cin + 2 * n * hw * cout + 9 * cin * cout + cout),
                       2 * hw * 9 * cin * cout + 3 * n * hw * cout),
            # multiply: out = x * conv(s, flipT(W+)) for N seeds
            "multiply": (lambda: kernels.conv3x3_fused(s, x, kt, None, "multiply"),
                         lambda: kernels.conv3x3_fused_plain(s, x, kt, None, "multiply"),
                         s, kt,
                         4 * (n * hw * cout + hw * cin + 9 * cin * cout + n * hw * cin),
                         2 * n * hw * 9 * cin * cout + n * hw * cin),
        }
        for mode, (kern, plain, conv_in, taps, nbytes, flops) in passes.items():
            conv_nchw, taps_oihw = conv_in.permute(0, 3, 1, 2), taps.permute(3, 2, 0, 1)
            rows.append(dict(shape=f"{name}/{mode}", N=n, H=size, W=size, Cin=cin, Cout=cout,
                             calls=B_MAIN, err=rel_err(kern(), plain()),
                             ms=time_ms(kern), plain_ms=time_ms(plain),
                             library_ms=time_ms(lambda: F.conv2d(conv_nchw, taps_oihw, padding=1)),
                             bound=bound_ms(nbytes, flops)))
        del x, r, s
    return rows


KERNEL_META = {
    "lrp_linear": ("lrp_imagecaptioning_torch/csrc/lrp_linear.cu",
                   "lrp_imagecaptioning_tpu/ops/pallas_kernels.py:48", check_lrp_linear),
    "lstm_gates": ("lrp_imagecaptioning_torch/csrc/lstm_gates.cu",
                   "lrp_imagecaptioning_tpu/ops/pallas_kernels.py:107", check_lstm_gates),
    "conv3x3_fused": ("lrp_imagecaptioning_torch/csrc/conv3x3_fused.cu",
                      "lrp_imagecaptioning_tpu/ops/pallas_conv_lrp.py:77", check_conv3x3_fused),
}


def phase_kernels(dev, failures):
    gen = torch.Generator(device=dev).manual_seed(1)
    detail, summary = {}, {}
    for name, (_, _, check) in KERNEL_META.items():
        rows = check(gen, dev)
        detail[name] = rows
        for row in rows:
            lib_err = f"  library rel {row['library_err'][1]:.3e}" if "library_err" in row else ""
            log(f"  {name:14s} {row['shape']:22s} calls/batch {row['calls']:3d}  "
                f"max_abs {row['err'][0]:.3e} rel {row['err'][1]:.3e}  ms {row['ms']:.4f}  "
                f"plain {row['plain_ms']:.4f}  library {row['library_ms']:.4f}  "
                f"bound {row['bound'][0]:.4f} ({row['bound'][1]}){lib_err}")
            if name == "lstm_gates":
                ok = row["err"][0] <= TOL_LSTM_ABS
            else:
                ok = row["err"][1] <= TOL_KERNEL
            if not ok:
                failures.append(f"{name} {row['shape']} disagrees with its plain version: {row['err']}")
        per_batch = lambda key: sum(r[key] * r["calls"] for r in rows)
        by_ops = sum(r["bound"][0] * r["calls"] for r in rows if r["bound"][1] == "operations")
        total_bound = sum(r["bound"][0] * r["calls"] for r in rows)
        summary[name] = dict(
            calls_per_batch=sum(r["calls"] for r in rows),
            max_abs_err=max(r["err"][0] for r in rows),
            max_rel_err=max(r["err"][1] for r in rows),
            ms=per_batch("ms"), plain_ms=per_batch("plain_ms"),
            bound_ms=total_bound,
            bound_by="operations" if by_ops >= total_bound / 2 else "bytes",
            library_ms=per_batch("library_ms"),
        )
    return summary, detail


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def phase_main(dev, failures):
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.pipeline import build

    cfg = FlickrConfig()
    fn, cap = build(cfg, VOCAB, device=dev, beam=BEAM, T=T)
    params = cap.init_params(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(B_MAIN, IMAGE, IMAGE, 3, generator=gen, device=dev)

    t0 = time.perf_counter()
    fn(params, images)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    st = fn.stages
    t0 = time.perf_counter()
    feat, tokens = st["caption"](params, images)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r_feat = st["decoder_lrp"](params, feat, tokens)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st["cnn_lrp"](params, images, r_feat)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stage_ms = {"caption": (t1 - t0) * 1e3, "decoder_lrp": (t2 - t1) * 1e3,
                "cnn_lrp": (t3 - t2) * 1e3}
    del r_feat

    kernels.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, heatmaps = fn(params, images)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}

    log(f"  warm-up pass {warm_s * 1e3:.1f} ms (first calls included)")
    log(f"  stages ms: " + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items()))
    log(f"  counted pass {total_s * 1e3:.1f} ms = {B_MAIN / total_s:.3f} img/s at batch {B_MAIN}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches {launches}")
    log(f"  tokens[0] {tokens[0].tolist()}")
    if tuple(tokens.shape) != (B_MAIN, T):
        failures.append(f"tokens shape {tuple(tokens.shape)}")
    if tuple(heatmaps.shape) != (B_MAIN, T, IMAGE, IMAGE, 3):
        failures.append(f"heatmaps shape {tuple(heatmaps.shape)}")
    if not bool(torch.isfinite(heatmaps).all()):
        failures.append("heatmaps hold non-finite values")
    if not bool(heatmaps.abs().amax(dim=(2, 3, 4)).gt(0).all()):
        failures.append("a heatmap is all zeros")
    for k in kernels.KERNELS:
        if launches[k.__name__] == 0:
            failures.append(f"{k.__name__} was not launched on the main path")
    main = dict(batch=B_MAIN, warm_ms=warm_s * 1e3, stage_ms=stage_ms, total_ms=total_s * 1e3,
                img_per_s=B_MAIN / total_s,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del heatmaps
    return launches, main, (fn, cap, cfg, params, images)


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    return tree.double()


def phase_cpu(built, failures):
    """One image on the card, on the CPU in f32 and on the CPU in f64.

    The decoder LRP divides by stab(z) = z +- 1e-7 over signed z, so f32
    differences of ~1e-6 in the features grow where |z| is small; the f64 run
    is the anchor: the card must stay within F64_RATIO times the CPU-f32
    run's own deviation from it (floor 1e-5 of the scale), and the card and
    CPU-f32 heatmaps within TOL_CPU_MAPS of their scale."""
    from lrp_imagecaptioning_torch.pipeline import build
    from lrp_imagecaptioning_torch.weights import tree_to

    fn, cap, cfg, params, images = built
    img = images[:1]
    st = fn.stages
    feat_g, tok_g = st["caption"](params, img)
    r_g = st["decoder_lrp"](params, feat_g, tok_g).cpu()
    maps_g = st["cnn_lrp"](params, img, r_g[:, :CPU_WORDS].to(img.device)).cpu()

    fn_c, _ = build(cfg, VOCAB, device="cpu", beam=BEAM, T=T)
    st_c = fn_c.stages
    params_c, img_c, tok = tree_to(params, "cpu"), img.cpu(), tok_g.cpu()
    t0 = time.perf_counter()
    _, tok_c = st_c["caption"](params_c, img_c)
    runs = {}
    for name, p, im in (("f32", params_c, img_c), ("f64", _double(params_c), img_c.double())):
        with torch.no_grad():
            feat = cap.encode(p, im)
        r = st_c["decoder_lrp"](p, feat, tok)
        runs[name] = (r, st_c["cnn_lrp"](p, im, r[:, :CPU_WORDS]))
    cpu_s = time.perf_counter() - t0

    def worst(a, b, n):
        return max(rel_err(a[0, t].double(), b[0, t].double())[1] for t in range(n))

    (r32, m32), (r64, m64) = runs["f32"], runs["f64"]
    out = dict(tokens_equal=bool(torch.equal(tok_c, tok)), cpu_s=cpu_s,
               r_feat_card_vs_cpu=worst(r_g, r32, T), maps_card_vs_cpu=worst(maps_g, m32, CPU_WORDS),
               r_feat_card_vs_f64=worst(r_g, r64, T), r_feat_cpu_vs_f64=worst(r32, r64, T),
               maps_card_vs_f64=worst(maps_g, m64, CPU_WORDS),
               maps_cpu_vs_f64=worst(m32, m64, CPU_WORDS))
    log(f"  {out}")
    if not out["tokens_equal"]:
        failures.append(f"tokens differ: card {tok.tolist()} cpu {tok_c.tolist()}")
    if out["maps_card_vs_cpu"] > TOL_CPU_MAPS:
        failures.append(f"card and CPU heatmaps differ beyond {TOL_CPU_MAPS} of their scale")
    for key, ratio in F64_RATIO.items():
        card, cpu = out[f"{key}_card_vs_f64"], out[f"{key}_cpu_vs_f64"]
        if card > max(ratio * cpu, 1e-5):
            failures.append(f"{key}: card deviates {card:.3e} from f64, CPU f32 {cpu:.3e}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from lrp_imagecaptioning_torch.ops import _build, kernels
    from lrp_imagecaptioning_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    failures: list[str] = []
    report: dict = {}

    log("phase 1: card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card_line = card[0] if card else ""
    if not card_line:
        failures.append("nvidia-smi gave no card line")
    log(f"  {card_line} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    phases = [("phase 2: kernels vs plain versions", "kernels"),
              ("phase 3: main path at full width", "main"),
              ("phase 4: card vs CPU, one image", "cpu")]
    summary = launches = built = None
    t_start = time.perf_counter()
    for title, key in phases:
        log(title)
        t0 = time.perf_counter()
        try:
            if key == "kernels":
                _build.build_all()
                log(f"  built in {time.perf_counter() - t0:.1f} s")
                for stem, text in _build.build_log.items():
                    for line in text.splitlines():
                        if "registers" in line or "spill" in line:
                            log(f"  {stem}: {line.strip()}")
                summary, report["kernel_shapes"] = phase_kernels(dev, failures)
            elif key == "main":
                launches, report["main"], built = phase_main(dev, failures)
            elif built is not None:
                report["cpu"] = phase_cpu(built, failures)
            else:
                failures.append("phase 4 skipped: the main path did not run")
        except Exception:  # noqa: BLE001 — a phase that raises is recorded as failed
            traceback.print_exc()
            failures.append(f"{title} raised")
        log(f"  ({time.perf_counter() - t0:.1f} s)")
    report["seconds"] = time.perf_counter() - t_start

    kernels_line = []
    if summary is not None and launches is not None:
        for name, (source, replaces, _) in KERNEL_META.items():
            s = summary[name]
            if launches[name] != s["calls_per_batch"]:
                failures.append(f"{name}: {launches[name]} launches on the main path, "
                                f"{s['calls_per_batch']} expected from its shapes")
            kernels_line.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=launches[name], max_abs_err=s["max_abs_err"], ms=s["ms"],
                plain_ms=s["plain_ms"], bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                library_ms=s["library_ms"], max_rel_err=s["max_rel_err"],
                calls_per_batch=s["calls_per_batch"]))
    report.update(card=card_line, kernels=kernels_line, failures=failures)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    if failures:
        for msg in failures:
            print(f"FAILED: {msg}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels_line}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
