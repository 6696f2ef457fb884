"""The control of each cell comes out not correct: the reference put in the
program's place one precision lower (``perfbench/controls.py``) fails at
least one of the cell's numbers, while the program passes them all. On the
CPU at the rehearsal's shapes where the lower precision exists there (the
explain cell's bfloat16 and float8 rounding); at the cell's own shapes on
the card (``-m cuda``; TF32 exists only there)."""

import pytest
import torch

from perfbench.controls import readings
from perfbench.harness.cell import load_cell


def verdicts(cell, seed, device):
    got = readings(cell, seed, 14.0, device)
    limits = cell.limits

    def passes(numbers):
        return all(v <= limits[k] for k, v in numbers.items())

    return passes(got["program"]), passes(got["control"]), got


def test_explain_control_fails_on_the_cpu():
    cell = load_cell("adaptive-explain-natural", rehearsal=True)
    program, control, got = verdicts(cell, 2**32 + 3, torch.device("cpu"))
    assert program and not control, got


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["adaptive-explain-natural", "gridtd-train-k4",
                                      "adaptive-finetune-k2"])
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("the card's lower precisions (TF32) exist only on the card")
    program, control, got = verdicts(load_cell(workload), 2**32 + 7, torch.device("cuda", 0))
    assert program and not control, got
