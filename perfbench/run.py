"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a device trace of a few steady seconds of the
window. Every run checks what the timed path produced against the plain
reference in ``perfbench/reference`` and prints each number compared
beside its limit, on standard error and last in the result line.

``--rehearse`` runs the cell on the CPU at the tiny shapes of its
configuration's and mix's ``rehearsal`` entries, through the same entry,
traffic and metric files, with the kernels' plain versions: a check of
the path, not a measurement (it prints no metric). Without it a run that
finds no card, or fewer cards than the cell asks for, fails.

A cell on several cards starts one process a card: rank r sees entry r of
the cards the run was given (``CUDA_VISIBLE_DEVICES``, or cards 0.. where
it is unset). The ranks join in a NCCL group over a TCP store on
localhost; rank 0 prints the result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "lrp_imagecaptioning_tpu")


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout, and no
    library loading JAX on its own."""
    cache = root / "build" / "cache"
    return {"TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "CUDA_CACHE_PATH": str(cache / "nv"), "USE_FLAX": "0", "USE_JAX": "0"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_devices(environ, world: int) -> list:
    """The card of each rank: entry r of the ``CUDA_VISIBLE_DEVICES`` this
    process was given (cards 0.. where it is unset); fewer than ``world``
    entries is an error."""
    given = environ.get("CUDA_VISIBLE_DEVICES")
    cards = [str(r) for r in range(world)] if given is None else [
        c.strip() for c in given.split(",") if c.strip()]
    if len(cards) < world:
        raise ValueError(f"{world} ranks need {world} cards; CUDA_VISIBLE_DEVICES={given!r}")
    return cards[:world]


def launch_ranks(args, world: int) -> int:
    """One process a card, each on its own entry of the cards this process
    was given; rank 0's output is printed last."""
    try:
        cards = rank_devices(os.environ, world)
    except ValueError as e:
        return fail(str(e))
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards[r])
        cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
               str(args.trace), "--rank", str(r), "--world", str(world), "--port", str(port),
               "--t-start", repr(T_START)] + (["--rehearse"] if args.rehearse else [])
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate() for p in procs]
    for r in list(range(1, world)) + [0]:
        sys.stderr.write(outs[r][1])
    sys.stdout.write(outs[0][0])
    sys.stdout.flush()
    codes = [p.returncode for p in procs]
    return next((c for c in codes if c), 0)


def main(argv=None, hooks=None) -> int:
    """Runs the cell; ``hooks`` (tests) may replace the entry's class or
    observe the result: {"entry": cls, "result": callable}."""
    args = parse(argv)
    os.environ.update(cache_env(ROOT))
    import torch

    from perfbench.harness.cell import load_cell
    from perfbench.harness.outcome import judge, run_cell

    cell = load_cell(args.workload, rehearsal=args.rehearse)
    if not args.rehearse:
        if not torch.cuda.is_available():
            return fail("no CUDA device: the benchmark runs on the card only")
        need = 1 if args.rank is not None else cell.chips
        if torch.cuda.device_count() < need:
            return fail(f"{args.workload} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} visible")
    if cell.chips > 1 and args.rank is None:
        return launch_ranks(args, cell.chips)
    t_start = args.t_start if args.t_start is not None else T_START
    result, numbers = run_cell(cell, args, t_start, hooks or {})
    found = loaded_forbidden()
    if found:
        return fail(f"the run loaded {found}; nothing it runs may load JAX or the JAX package")
    if result is None:   # a rank other than 0
        return 0
    judge(result, numbers, cell.limits)
    if hooks and "result" in hooks:
        hooks["result"](result)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
