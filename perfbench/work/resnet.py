"""Operations and bytes of the ResNet encoder and of its PresetA walk,
counted from the layer shapes (a multiply-add is two operations; the BN,
Add, ReLU and pool rules are elementwise and left out, so every count is a
floor)."""

from __future__ import annotations

from perfbench.reference.resnet import convs


def conv_layers(depth: str, image: int) -> list:
    """(name, out size, kh, cin, cout, in size) of every conv, in forward
    order: the stem's 7x7/2 over the padded image, a 3x3/2 pool after it,
    each stage's stride on its first block's '2a' and '1'."""
    out, size = [], image
    for name, _, (kh, _, ci, co), stride in convs(depth):
        if name == "conv1":
            o = (size + 6 - 7) // 2 + 1
            out.append((name, o, kh, ci, co, size + 6))
            size = (o - 3) // 2 + 1
            continue
        o = size if kh == 3 else (size - 1) // stride + 1
        out.append((name, o, kh, ci, co, size))
        if name.endswith("2a"):
            size = o
    return out


def conv_flops(out: int, kh: int, cin: int, cout: int) -> float:
    return 2.0 * out * out * kh * kh * cin * cout


def forward_flops(depth: str, image: int) -> float:
    """One image's forward."""
    return sum(conv_flops(o, k, ci, co) for _, o, k, ci, co, _ in conv_layers(depth, image))


def train_flops(depth: str, image: int) -> float:
    """One image's forward and backward: every conv's weight gradient, and
    its input gradient except the stem's."""
    layers = conv_layers(depth, image)
    f = sum(conv_flops(o, k, ci, co) for _, o, k, ci, co, _ in layers)
    return 3 * f - conv_flops(*layers[0][1:5])


def lrp_flops(depth: str, image: int, words: int) -> float:
    """PresetA of one image for ``words`` seeds: the forward that keeps the
    activations, each post-ReLU conv's denominator once and its transpose
    once a word, the stem's two denominators and two transposes a word."""
    total = forward_flops(depth, image)
    for name, o, k, ci, co, _ in conv_layers(depth, image):
        total += conv_flops(o, k, ci, co) * (1 + words) * (2 if name == "conv1" else 1)
    return total


def k3_work(depth: str, image: int, words: int):
    """(operations, bytes) that one image's ``words`` seeds hand K3 over the
    '2b' convs (3x3 SAME stride 1 over a post-ReLU input): the denominator
    conv once (its input is shared by the seeds) and the transposed conv
    once a word; reads r, x and W once, writes the relevance once. The
    convs are bias-free."""
    ops = nbytes = 0.0
    for name, o, k, ci, co, _ in conv_layers(depth, image):
        if name.endswith("2b"):
            hw = o * o
            ops += conv_flops(o, k, ci, co) * (1 + words)
            nbytes += 4.0 * (words * hw * co + hw * ci + 9 * ci * co + words * hw * ci)
    return ops, nbytes
