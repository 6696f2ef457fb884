"""Operations and bytes of the VGG encoder and of its LRP, counted from the
layer shapes (a multiply-add is two operations; elementwise work is left
out of the operations, so every count is a floor)."""

from __future__ import annotations

from perfbench.reference.model import vgg_ops


def conv_layers(arch: str, until: str, image: int) -> list:
    """(name, size, cin, cout) of every conv, at its input's size."""
    size, out = image, []
    for op in vgg_ops(arch, until):
        if op[0] == "pool":
            size //= 2
        else:
            out.append((op[1], size, op[2], op[3]))
    return out


def conv_flops(size: int, cin: int, cout: int) -> float:
    return 2.0 * size * size * 9 * cin * cout


def forward_flops(arch: str, until: str, image: int) -> float:
    """One image's forward."""
    return sum(conv_flops(s, ci, co) for _, s, ci, co in conv_layers(arch, until, image))


def train_flops(arch: str, until: str, image: int) -> float:
    """One image's forward and backward: every conv's weight gradient, and
    its input gradient except the image layer's."""
    layers = conv_layers(arch, until, image)
    f = sum(conv_flops(s, ci, co) for _, s, ci, co in layers)
    return f + f + (f - conv_flops(*layers[0][1:]))


def lrp_flops(arch: str, until: str, image: int, words: int) -> float:
    """PresetA of one image for ``words`` seeds: the forward that keeps the
    activations, each post-ReLU conv's denominator once and its transpose
    once a word, the image layer's two denominators and two transposes a
    word."""
    layers = conv_layers(arch, until, image)
    first, rest = layers[0], layers[1:]
    fwd = forward_flops(arch, until, image)
    post = sum(conv_flops(s, ci, co) * (1 + words) for _, s, ci, co in rest)
    return fwd + post + conv_flops(*first[1:]) * 2 * (1 + words)


def rule_work(arch: str, until: str, image: int, words: int, kind: str):
    """(operations, bytes) that one image's ``words`` seeds hand the
    alpha1beta0 kernel over every post-ReLU conv, each input read once and
    each output written once.

    ``k3`` (f32): the denominator conv once (its input is shared by the
    seeds) and the transposed conv once a word; reads r, x, W and b, writes
    the relevance. ``k4`` (bf16): the denominator comes in ready (cuDNN
    makes it outside the kernel), so the transposed conv a word; reads r,
    z, x and W+, writes the relevance."""
    ops = nbytes = 0.0
    for _, s, ci, co in conv_layers(arch, until, image)[1:]:
        hw, c = s * s, conv_flops(s, ci, co)
        if kind == "k3":
            ops += c * (1 + words)
            nbytes += 4.0 * (words * hw * co + hw * ci + 9 * ci * co + co + words * hw * ci)
        else:
            ops += c * words
            nbytes += 2.0 * (words * hw * co + hw * co + hw * ci + 9 * ci * co + words * hw * ci)
    return ops, nbytes
