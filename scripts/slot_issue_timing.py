#!/usr/bin/env python3
"""What issuing a mesh's slots from one host thread each, or running one
process a card, buys over issuing them in turn from one thread, for the
sharded train and fine-tune steps. Needs a CUDA card; uses up to four.

    python3 scripts/slot_issue_timing.py [--reps 5] [--processes-only]

FlickrConfig at full width (VGG16, 224 x 224, E = H = 512, vocab 7003, T =
21), batch 32, dropout from one seeded generator, params from seed 0. Each
step runs on one device and on each mesh that the cards allow: two slots
both on cuda:0, two slots on two cards, four on four. On every mesh it runs
with the slots issued

* ``serial``: in turn, from the caller's thread, as the package issues them
  (``train.step.run_slots``);
* ``threads``: from a host thread each (``run_slots`` replaced for the run
  by one that hands each slot to a thread of a pool).

Then, on 1, 2 and 4 cards as they allow, the ``processes`` way: a NCCL
group of one process a card started by ``torchrun --nproc-per-node N``
(``tests/torch_parallel_worker.py``'s ``launch`` and ``--rank`` at the
full size), each rank's mesh from the default ``make_multihost_mesh()``,
its rows of the global batch (``process_batch_slice``), the train step a
Trainer's (``multihost=True``), the fine-tune step after it, then the
K-step calls: the Trainer's (train, K = 4) and the sharded fine-tune's
(K = 2), each step replayed from one captured rank step with its
all-reduce, timed beside the K sharded steps chained, in turn. The ranks
start each call together (a barrier) and a call's time is the slowest
rank's. ``--processes-only`` runs the groups alone.

For each it reports the median wall time of a step (every card
synchronized before and after), the median host time until the step
returns (its launches issued, the cards not waited for; for ``processes``
each rank's share of its wall time), and, against the one-device step on
the same batch, the loss's relative distance and the gradient's largest
2-norm distance of a leaf over that leaf's norm (floored at 1e-3 of the
largest leaf's: ``torch_parallel_worker.leaf_dists``), and the share of params
whose Adam step lies over lr / 2 from one device's (for ``processes``
rank 0 runs the one-device step itself, from the same params and
dropout); for ``processes`` also whether the ranks' params after a step
are bit for bit equal; for the K-step calls ms a step captured and
chained, the host's share of a call of each, the capture's s and the peak
GiB of a call (each rank's), with cuDNN's default algorithms, and the
checks against K chained one-device steps (with its deterministic ones).
In one process the runs alternate serial, threads, threads, serial; the
groups run after them. The result is printed as one JSON line and written
to ``chiprun_out/slot_issue_timing.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS, VOCAB, SOS, EOS, IMAGE = 32, 21, 7003, 1, 2, 224


class Recorder:
    """An optimizer that keeps the gradient it is handed and moves nothing."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params=None):
        from lrp_imagecaptioning_torch.weights import tree_map

        self.grads = grads
        return tree_map(torch.zeros_like, grads), state


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def threaded_slots():
    """``run_slots`` with a host thread a slot, where the steps look it up."""
    from lrp_imagecaptioning_torch.train import lrp_finetune, step

    def run_slots(mesh, fn):
        def run(i):
            with step.on_device(mesh.slots[i]):
                return fn(i)

        with ThreadPoolExecutor(len(mesh.slots)) as pool:
            return list(pool.map(run, range(len(mesh.slots))))

    saved = step.run_slots, lrp_finetune.run_slots
    step.run_slots = lrp_finetune.run_slots = run_slots
    try:
        yield
    finally:
        step.run_slots, lrp_finetune.run_slots = saved


def adam_apart(opt, params, grads_a, grads_b) -> float:
    """The share of params whose first Adam step from ``params`` on
    ``grads_a`` lies over lr / 2 from the step on ``grads_b``."""
    from lrp_imagecaptioning_torch.weights import tree_leaves

    state = opt.init(params)
    a, b = (tree_leaves(opt.update(g, state, params)[0]) for g in (grads_a, grads_b))
    apart = sum(int(((x - y.to(x.device)).abs() > opt.learning_rate / 2).sum())
                for x, y in zip(a, b))
    return apart / sum(x.numel() for x in a)


def setup(dev, rows=slice(None)):
    """(params, the batch's rows as tensors on ``dev``, the steps by name:
    (one-device maker, sharded maker, learning rate))."""
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.train.lrp_finetune import (make_lrp_finetune_step,
                                                              make_sharded_lrp_finetune_step)
    from lrp_imagecaptioning_torch.train.step import make_sharded_train_step, make_train_step

    cfg = FlickrConfig()
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device=dev)
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.standard_normal((B, IMAGE, IMAGE, 3), dtype=np.float32) * 50)
    caps = torch.from_numpy(rng.integers(0, VOCAB, size=(B, STEPS)))
    y = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, VOCAB, size=(B, STEPS))),
                                    VOCAB).float()
    stop = np.zeros(VOCAB + 1, bool)
    steps = {
        "train": (lambda o: make_train_step(cap, o),
                  lambda o, m: make_sharded_train_step(cap, o, m)[0], cfg.learning_rate),
        "finetune": (lambda o: make_lrp_finetune_step(cap, o, stop, SOS, EOS),
                     lambda o, m: make_sharded_lrp_finetune_step(cap, o, m, stop, SOS, EOS),
                     1e-6),
    }
    return params, [a[rows].to(dev) for a in (images, caps, y)], steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--processes-only", action="store_true",
                    help="only the NCCL groups of one process a card")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("slot_issue_timing: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_parallel_worker as worker
    from lrp_imagecaptioning_torch.parallel import make_mesh
    from lrp_imagecaptioning_torch.runtime import resolve_device
    from lrp_imagecaptioning_torch.train.optimizer import make_optimizer
    from lrp_imagecaptioning_torch.weights import tree_leaves

    dev = resolve_device("cuda:0")
    n_cards = torch.cuda.device_count()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    params, (images, caps, y), steps = setup(dev)
    meshes = {"2 slots on cuda:0": [dev, dev]}
    if n_cards >= 2:
        meshes["2 cards"] = [torch.device("cuda", i) for i in range(2)]
    if n_cards >= 4:
        meshes["4 cards"] = [torch.device("cuda", i) for i in range(4)]
    gen = lambda: torch.Generator(device=dev).manual_seed(7)   # noqa: E731

    def run(step, state):
        """(wall ms, host ms, metrics) of one step."""
        sync_all()
        t0 = time.perf_counter()
        out = step(params, state, images, caps, y, gen())
        host = time.perf_counter() - t0
        sync_all()
        return (time.perf_counter() - t0) * 1e3, host * 1e3, out[2]

    result = {"card": card, "cards": n_cards, "batch": B, "reps": args.reps,
              "steps": {name: {} for name in (*steps, "multi", "multi_finetune")}}
    for name, (single, sharded, lr) in ({} if args.processes_only else steps).items():
        opt = make_optimizer("adaptiveattention", lr)
        state = opt.init(params)
        one = single(opt)
        rec = Recorder()
        _, _, ref = run(single(rec), None)
        ref_grads, ref_loss = rec.grads, float(ref["loss"])
        run(one, state)
        times = [run(one, state)[:2] for _ in range(args.reps)]
        row = {"one device": {"ms": float(np.median([t[0] for t in times])),
                              "host_ms": float(np.median([t[1] for t in times]))}}
        print(f"{name} one device: {json.dumps(row['one device'])}", file=sys.stderr, flush=True)
        for label, devices in meshes.items():
            mesh = make_mesh(devices=devices)
            step = sharded(opt, mesh)
            rec = Recorder()
            _, _, m = run(sharded(rec, mesh), None)
            cell = {"loss_rel": abs(float(m["loss"]) - ref_loss) / abs(ref_loss),
                    "grad_dist": worker.leaf_dists(rec.grads, ref_grads)[0],
                    "adam_apart": adam_apart(opt, tree_leaves(params), tree_leaves(rec.grads),
                                             tree_leaves(ref_grads))}
            got = {"serial": [], "threads": []}
            for mode in ("serial", "threads"):   # warm both
                with threaded_slots() if mode == "threads" else contextlib.nullcontext():
                    run(step, state)
            for r in range(args.reps):
                for mode in (("serial", "threads") if r % 2 == 0 else ("threads", "serial")):
                    with threaded_slots() if mode == "threads" else contextlib.nullcontext():
                        got[mode].append(run(step, state)[:2])
            for mode, ts in got.items():
                cell[mode] = {"ms": float(np.median([t[0] for t in ts])),
                              "host_ms": float(np.median([t[1] for t in ts]))}
            row[label] = cell
            print(f"{name} {label}: {json.dumps(cell)}", file=sys.stderr, flush=True)
            del step
        result["steps"][name] = row
    work = os.path.join(HERE, "build", "slot_issue_timing")
    os.makedirs(work, exist_ok=True)
    torch.cuda.empty_cache()
    names = [*steps, "multi", "multi_finetune"]
    for n in (1, 2, 4):
        if n > n_cards:
            continue
        prefix = os.path.join(work, f"rank{n}_")
        (text, rc), = worker.finish(worker.launch(
            n, ["--rank", prefix, "--size", "full", "--steps", ",".join(names), "--reps",
                args.reps, "--guard", 1100], cards=n, cwd=work), timeout=1200)
        if rc != 0:
            raise RuntimeError(f"{n} processes: rc {rc}\n{text[-4000:]}")
        ranks = [worker.load_rank(f"{prefix}{r}.npz") for r in range(n)]
        for k, name in enumerate(names):
            if name.startswith("multi"):
                cell = {f: [r[f"{k}_{f}"] for r in ranks] for f in (
                    "ms_per_step", "chained_ms_per_step", "host_share", "chained_host_share",
                    "capture_s", "peak_gib", "chained_peak_gib", "captures")}
                K = ranks[0][f"{k}_K"]
                for f in ("", "chained_"):   # the slowest rank's call, a step
                    wall = np.max([r[f"{k}_{f}reps_ms"] for r in ranks], axis=0)
                    cell[f"{f}slowest_ms_per_step"] = float(np.median(wall)) / K
                cell.update(K=K, slots=[r["mesh"] for r in ranks],
                            loss_rel=ranks[0][f"{k}_loss_rel"],
                            grad_dist=ranks[0][f"{k}_grad_dist"],
                            ranks_equal=len({r[f"{k}_digest"] for r in ranks}) == 1)
                result["steps"][name][f"{n} processes"] = cell
                print(f"{name} {n} processes: {json.dumps(cell)}", file=sys.stderr, flush=True)
                continue
            wall = np.max([r[f"{k}_reps_ms"] for r in ranks], axis=0)
            cell = {"ms": float(np.median(wall)),
                    "host_share": [float(np.median(r[f"{k}_reps_host_ms"] / r[f"{k}_reps_ms"]))
                                   for r in ranks],
                    "slots": [r["mesh"] for r in ranks],
                    "loss_rel": ranks[0][f"{k}_loss_rel"],
                    "grad_dist": ranks[0][f"{k}_grad_dist"],
                    "adam_apart": ranks[0][f"{k}_apart"],
                    "ranks_equal": len({r[f"{k}_digest"] for r in ranks}) == 1}
            result["steps"][name][f"{n} processes"] = cell
            print(f"{name} {n} processes: {json.dumps(cell)}", file=sys.stderr, flush=True)
    shutil.rmtree(work, ignore_errors=True)
    line = json.dumps(result)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "slot_issue_timing.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
