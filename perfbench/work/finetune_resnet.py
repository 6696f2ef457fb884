"""The model's operations in LRP-inference fine-tune steps on a ResNet
encoder: per row, the train step's (the ResNet's forward and backward, the
decoder's three forwards), the prediction's and ``lrp_weights``' forwards,
and the LRP of every position (decoder and the ResNet walk, which runs its
own forward)."""

from __future__ import annotations

from perfbench.work import decoder, resnet

PEAK = "tf32_flop_s"    # every format the cell computes in is float32


def row_flops(s, width: int) -> float:
    fwd = resnet.forward_flops(s.arch, s.image) + decoder.forward_flops(s, width)
    lrp = (sum(decoder.lrp_word_flops(s, t) for t in range(width))
           + resnet.lrp_flops(s.arch, s.image, width))
    train = resnet.train_flops(s.arch, s.image) + 3 * decoder.forward_flops(s, width)
    return train + 2 * fwd + lrp


def model_flops(s, traced: dict) -> float:
    return traced["steps"] * traced["batch"] * row_flops(s, traced["width"])
