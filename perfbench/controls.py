"""The readings each limit of ``perfbench/limits/<cell>.json`` is set from:
for each seed, the numbers of the program's timed path (as a run checks
them), of the control (the reference put in the program's place one
precision lower) and, for a training cell, of the faults planted in the
reference. One JSON line a seed.

    python3 perfbench/controls.py --workload <cell> --seeds 1,2,3 [--seconds 12]
        [--control-seeds N] [--rehearse]

``--control-seeds N`` reads the control and the faults on the first N seeds
only (the program's numbers on every seed).

Controls: explain: the encoder and the decoder in bfloat16 and the CNN
LRP's tensors in float8 (e4m3, a scale a tensor) for the bfloat16 storage
the cell states; training: TF32 on for float32 with TF32 off. Faults of a
training cell: a step that leaves half of the batch out (its loss the
mean over the rest) and, across cards, each card's rows alone (the
exchange left out). A step that leaves its state unchanged reads 1 on the
change by the measure and needs no run. The benchmark's own runs never run
this."""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.run import cache_env  # noqa: E402


def fp8_store(t):
    """``t`` rounded to float8 e4m3 with a scale of its own (amax to 448)."""
    import torch

    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def readings(cell, seed: int, seconds: float, device, control: bool = True) -> dict:
    import importlib

    import torch

    from perfbench.harness.trace import Tracer

    module = importlib.import_module(f"perfbench.entries.{cell.traffic['entry']}")
    entry = module.Entry(cell, seed, device)
    if cell.traffic["entry"] == "explain":
        entry.window(seconds, Tracer(False))
        entry.release()
        out = {"program": entry.check()}
        if control:
            out["control"] = entry.check(store=fp8_store, dec_dtype=torch.bfloat16)
        return out
    entry.release()
    from perfbench.entries.train import compare, leaf_gaps

    want = entry.reference()
    got = entry.readings()
    med = sorted(want["g1"].values())[len(want["g1"]) // 2]
    moving = {k for k, v in want["g1"].items() if v >= 1e-3 * med}
    worst = sorted(leaf_gaps(got["delta"], want["delta"], moving).items(), key=lambda kv: -kv[1])
    worst_g = sorted(leaf_gaps(got["g1"], want["g1"]).items(), key=lambda kv: -kv[1])
    out = {"losses": {"program": got["losses"], "reference": want["losses"]},
           "worst_change_leaves": [(k, g, want["delta"][k], want["g1"][k]) for k, g in worst[:4]],
           "worst_gradient_leaves": [(k, g, want["g1"][k]) for k, g in worst_g[:4]],
           "program": compare(got, want)}
    if not control:
        return out
    out["control"] = compare(entry.reference(tf32=True), want)
    out["fault_half_batch"] = compare(entry.reference(rows=slice(0, entry.B // 2)), want)
    if cell.chips > 1:
        out["fault_no_exchange"] = compare(
            entry.reference(rows=slice(0, entry.B // cell.chips)), want)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control-seeds", type=int, default=None)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    os.environ.update(cache_env(ROOT))
    import torch

    from perfbench.harness.cell import load_cell

    cell = load_cell(args.workload, rehearsal=args.rehearse)
    dev = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        control = args.control_seeds is None or i < args.control_seeds
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(cell, seed, args.seconds, dev, control)}), flush=True)


if __name__ == "__main__":
    main()
