"""One run of a cell: set-up, the measured window (traced or not), the
program's state freed, then the check against the reference; and the
result line the contract asks for."""

from __future__ import annotations

import importlib
import math
import subprocess
import sys
import time

from perfbench.harness.cell import load_reader
from perfbench.harness.peaks import peaks_for
from perfbench.harness.trace import TraceSummary, Tracer


def device_facts(dev) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "rehearsal on the CPU", "count": 0,
                "memory_peak_bytes": 0}
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(dev.index or 0)], capture_output=True, text=True,
                             timeout=20)
        facts["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        facts["power_limit"] = "not read"
    return facts


def run_cell(cell, args, t_start: float, hooks: dict):
    """-> (result dict without its verdict, numbers compared) on rank 0 of
    a group or alone; (None, None) on the other ranks."""
    import torch
    import torch.distributed as dist

    rehearse = args.rehearse
    dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    group = None
    if args.rank is not None:
        from lrp_imagecaptioning_torch.parallel.distributed import initialize_distributed

        if not rehearse:
            torch.cuda.set_device(dev)
        initialize_distributed(f"127.0.0.1:{args.port}", args.world, args.rank,
                               backend="gloo" if rehearse else "nccl")
        group = (args.rank, args.world)
    module = importlib.import_module(f"perfbench.entries.{cell.traffic['entry']}")
    entry = hooks.get("entry", module.Entry)(cell, args.seed, dev, **(
        {"group": group} if group else {}))
    setup_s = time.time() - t_start
    tracer = Tracer(args.trace == 1 and not rehearse)
    measured = entry.window(args.seconds, tracer)
    if "call_ends_s" in measured:
        print(f"perfbench: calls ended at (s) {measured['call_ends_s']}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = entry.traced() if args.trace == 1 else None
    summary = tracer.summary.as_dict() if tracer.summary else None
    readings = entry.readings() if hasattr(entry, "readings") else None
    if group is not None:
        every = [None] * args.world
        dist.all_gather_object(every, {"peak": peak, "summary": summary, "readings": readings})
        entry.release()
        dist.barrier()
        dist.destroy_process_group()
        if args.rank != 0:
            return None, None
    else:
        every = [{"peak": peak, "summary": summary, "readings": readings}]
        entry.release()
    numbers = module.check(entry, [e["readings"] for e in every])
    facts = device_facts(dev)
    facts["count"] = cell.chips if not rehearse else 0
    facts["memory_peak_bytes"] = max(e["peak"] for e in every)
    result = {"correct": None, "attempted": measured["attempted"],
              "failed": measured.get("failed", 0), "metrics": {}, "device": facts}
    if rehearse:
        result["rehearsal"] = True
    elif args.trace == 0:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                result["metrics"]["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == cell.traffic["rate_metric"]:
                result["metrics"][m["name"]] = {"value": measured["rate"], "unit": m["unit"]}
    else:
        sums = [TraceSummary.from_dict(e["summary"]) for e in every if e["summary"]]
        ctx = {"traces": sums, "peaks": peaks_for(facts["kind"]), "chips": cell.chips,
               "sizes": cell.sizes, "traced": traced}
        for m in cell.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if sums:
            facts["busy_s"] = sum(s.busy_s for s in sums) / len(sums)
            facts["window_s"] = sums[0].window_s
            ops = sorted(sums[0].op_s.items(), key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in ops],
                                   "idle_gaps": [[w, s] for s, w in sums[0].gaps[:10]]}
    return result, numbers


def judge(result: dict, numbers: dict, limits: dict) -> None:
    """``correct`` and the ``checks`` entry (last in the line): each
    number beside its limit; a number without a limit, or not finite,
    fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    result["correct"] = bool(ok and numbers)
    result["checks"] = checks
