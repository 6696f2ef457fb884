"""The model's operations in train steps: each row's VGG forward and
backward and the decoder's forward and backward (three forwards' worth)."""

from __future__ import annotations

from perfbench.work import cnn, decoder

PEAK = "tf32_flop_s"    # every format the cell computes in is float32


def row_flops(s, width: int) -> float:
    return cnn.train_flops(s.arch, s.until, s.image) + 3 * decoder.forward_flops(s, width)


def model_flops(s, traced: dict) -> float:
    return traced["steps"] * traced["batch"] * row_flops(s, traced["width"])
