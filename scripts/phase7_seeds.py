#!/usr/bin/env python3
"""Phase 7 of chip_smoke.py over several batch and dropout-mask seeds. Needs
a CUDA card.

    python3 scripts/phase7_seeds.py [--seeds 6:7 6:8 8:9 10:11] [--k2-grad function|plain|both]

Each ``B:M`` runs one fine-tune step at batch 1 of full width on the card,
on the CPU in f32 and in f64, with the random batch from seed B and the
dropout masks (rate 0.5, drawn on the CPU) from seed M, and reports, with
and without dropout, the worst leaf of the gradients by max |diff| over its
scale and by 2-norm, for the card and for CPU f32, and the smoke's verdict.
It shows how far the worst leaf's distance from f64 moves with the seeds,
for the card and for f32 rounding on the CPU alike. The rows are printed as
one JSON line and written to ``chiprun_out/phase7_seeds.json``.

``--k2-grad`` picks what the card's decoder runs where autograd records the
LSTM step: ``function`` (the port's path: the ``lstm_gates`` kernel through
its ``LSTMGates`` Function), ``plain`` (``lstm_gates_plain``, torch ops that
autograd differentiates) or ``both``, one after the other on the same seeds.
Steps under ``no_grad`` launch the kernel either way. If the card's gap from
CPU f32 with dropout stays under ``plain``, it does not lie in the Function.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def k2_grad(mode: str):
    """The decoder's LSTM step with K2's Function (``function``) or, where an
    input requires grad, with its plain version (``plain``)."""
    from lrp_imagecaptioning_torch.models import cells
    from lrp_imagecaptioning_torch.ops import kernels

    def plain_under_grad(zx, zh, bias, c_prev):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (zx, zh, bias, c_prev)):
            return kernels.lstm_gates_plain(zx, zh, bias, c_prev)
        return kernels.lstm_gates(zx, zh, bias, c_prev)

    if mode == "plain":
        cells.lstm_gates = plain_under_grad
    try:
        yield
    finally:
        cells.lstm_gates = kernels.lstm_gates


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", nargs="+", default=["6:7", "6:8", "8:9", "10:11"])
    ap.add_argument("--k2-grad", choices=["function", "plain", "both"], default="function")
    args = ap.parse_args()
    sys.path.insert(0, HERE)

    import chip_smoke

    if not torch.cuda.is_available():
        print("phase7_seeds: needs a CUDA card", file=sys.stderr)
        return 1
    rows = []
    modes = ("function", "plain") if args.k2_grad == "both" else (args.k2_grad,)
    for pair in args.seeds:
        batch_seed, mask_seed = (int(v) for v in pair.split(":"))
        for mode in modes:
            failures: list[str] = []
            with k2_grad(mode):
                out = chip_smoke.phase_finetune_cpu(torch.device("cuda"), failures, batch_seed,
                                                    mask_seed)
            rows.append(dict(batch_seed=batch_seed, mask_seed=mask_seed, k2_grad=mode,
                             failures=failures,
                             **{k: v for k, v in out.items()
                                if "grad" in k or "leaf" in k or k == "leaves_over_dropout"}))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "phase7_seeds.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
