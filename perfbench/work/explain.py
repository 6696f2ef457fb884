"""The model's operations in an explain pass: per image, the encode, the
teacher-forced forward over T steps, the decoder LRP of each word of its
caption and the CNN LRP (PresetA) of each such word; padded bucket slots
are not counted."""

from __future__ import annotations

from perfbench.work import cnn, decoder

PEAK = "bf16_flop_s"    # the highest format the cell computes in


def model_flops(s, traced: dict) -> float:
    total = 0.0
    for n in traced["lengths"]:
        total += cnn.forward_flops(s.arch, s.until, s.image)
        total += decoder.forward_flops(s, traced["T"])
        total += sum(decoder.lrp_word_flops(s, t) for t in range(n))
        total += cnn.lrp_flops(s.arch, s.until, s.image, n)
    return total
