"""The model's operations in LRP-inference fine-tune steps: per row, the
train step's, plus the prediction's and ``lrp_weights``' forwards and the
LRP of every position (decoder and CNN)."""

from __future__ import annotations

from perfbench.work import cnn, decoder, train

PEAK = "tf32_flop_s"    # every format the cell computes in is float32


def row_flops(s, width: int) -> float:
    fwd = cnn.forward_flops(s.arch, s.until, s.image) + decoder.forward_flops(s, width)
    lrp = (sum(decoder.lrp_word_flops(s, t) for t in range(width))
           + cnn.lrp_flops(s.arch, s.until, s.image, width))
    return train.row_flops(s, width) + 2 * fwd + lrp


def model_flops(s, traced: dict) -> float:
    return traced["steps"] * traced["batch"] * row_flops(s, traced["width"])
