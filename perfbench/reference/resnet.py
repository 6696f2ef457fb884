"""Plain PyTorch reference of the ResNet-50/101 captioner and of its
LRP-inference fine-tune step.

ResNet v1 as keras.applications builds it (He et al. 2016): the image
zero-padded by 3, a 7x7/2 conv, BN, ReLU, a 3x3/2 VALID max pool, then
bottleneck stages of [3, 4, 6, 3] (ResNet-101: [3, 4, 23, 3]) blocks of
filters (64, 64, 256) ... (512, 512, 2048): 1x1 '2a' (the stage's stride on
its first block), 3x3 SAME '2b', 1x1 '2c', each conv bias-free and followed
by BN in inference mode (the moving statistics); the stage's first block
adds a projection shortcut '1' (1x1, strided, BN), every other block its
input. The captioner taps the last block's ReLU. NHWC images, HWIO kernels.

The walk is iNNvestigate's LRPSequentialPresetA over that graph
(relevance_analyzer.py): alpha1beta0 on every conv (its input post-ReLU but
for the stem's, whose signed input takes the split rule), the BN rule
R_in = x (y - beta) R / stab((x - mean) y), the Add rule
R_i = x_i R / stab(sum_j x_j), ReLU passing relevance through, the
overlapping stem pool reversed winner-take-all with ties split, the stem's
padding cropped. ``stab(z) = z + sign(z) eps`` (sign(0) = +1) and SafeDivide
(a zero denominator replaced by eps), eps = 1e-7.

Departures from the published equations, each the program's (and the JAX
package's) semantics, which the benchmark holds the program to:

* BN runs in inference mode in the update's forward too (Keras trains it
  on batch statistics), and the Adam step updates every leaf of the params
  tree, BN's gamma, beta and moving statistics among them (Keras keeps the
  moving statistics out of the trainable weights);
* one forward a image serves all its word seeds (the words are the batch of
  the walk): the same arithmetic as one walk a word.

Imports nothing of the program. Float32 with TF32 off (the caller sets the
flags).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .lrp import decoder_lrp_adaptive
from .model import decode, masked_ce, tree_map

BN_EPS = 1.001e-5            # keras.applications' ResNet
EPS = 1e-7                   # K.epsilon(): the rules' stabilizer and SafeDivide's
BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
FILTERS = ((64, 64, 256), (128, 128, 512), (256, 256, 1024), (512, 512, 2048))


def block_names(n: int) -> list:
    """Keras' names of a stage's blocks: 'a'..'f', or 'a', 'b1', 'b2', ...
    in a stage of more than six."""
    return ["abcdef"[i] for i in range(n)] if n <= 6 else ["a"] + [f"b{i}" for i in range(1, n)]


def blocks(depth: str) -> list:
    """[(stage, block, first, stride, (f1, f2, f3), cin)] in forward order."""
    out, cin = [], 64
    for i, n in enumerate(BLOCKS[depth]):
        f = FILTERS[i]
        for j, b in enumerate(block_names(n)):
            out.append((i + 2, b, j == 0, (1 if i == 0 else 2) if j == 0 else 1, f, cin))
            cin = f[2]
    return out


def convs(depth: str) -> list:
    """[(conv, bn, (kh, kw, cin, cout), stride)] of every conv, in forward
    order (the stem, then per block: shortcut '1', '2a', '2b', '2c')."""
    out = [("conv1", "bn_conv1", (7, 7, 3, 64), 2)]
    for stage, b, first, stride, (f1, f2, f3), cin in blocks(depth):
        base, bn = f"res{stage}{b}_branch", f"bn{stage}{b}_branch"
        if first:
            out.append((base + "1", bn + "1", (1, 1, cin, f3), stride))
        out += [(base + "2a", bn + "2a", (1, 1, cin, f1), stride),
                (base + "2b", bn + "2b", (3, 3, f1, f2), 1),
                (base + "2c", bn + "2c", (1, 1, f2, f3), 1)]
    return out


def conv(x, kernel, stride: int):
    """Bias-free conv, NHWC / HWIO; a 3x3 is SAME (pad 1), any other VALID."""
    pad = kernel.shape[0] // 2 if kernel.shape[0] == 3 else 0
    return F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride=stride,
                    padding=pad).permute(0, 2, 3, 1)


def conv_t(r, x_shape, kernel, stride: int):
    """The transpose of ``conv`` (its input gradient) applied to ``r``,
    batch r's, height and width x's."""
    pad = kernel.shape[0] // 2 if kernel.shape[0] == 3 else 0
    size = (r.shape[0], x_shape[3], x_shape[1], x_shape[2])
    g = torch.nn.grad.conv2d_input(size, kernel.permute(3, 2, 0, 1), r.permute(0, 3, 1, 2),
                                   stride=stride, padding=pad)
    return g.permute(0, 2, 3, 1)


def bn(p, x):
    return (x - p["moving_mean"]) / torch.sqrt(p["moving_var"] + BN_EPS) * p["gamma"] + p["beta"]


def forward(params, images, depth: str, keep: bool = False, on_conv=None):
    """images (B, H, W, 3) -> the last block's ReLU (B, H/32, W/32, 2048);
    with ``keep`` also what the walk reads: per conv its input, output and
    BN's output, per block its two summands, the stem pool's input.
    ``on_conv(bn name, conv output)`` is called before each BN (set-up's
    calibration of the moving statistics)."""
    cache = {}

    def unit(name, bn_name, x, stride, relu=True):
        z = conv(x, params[name]["kernel"], stride)
        if on_conv is not None:
            on_conv(bn_name, z)
        y = bn(params[bn_name], z)
        if keep:
            cache[name] = (x, z, y)
        return torch.relu(y) if relu else y

    x = unit("conv1", "bn_conv1", F.pad(images, (0, 0, 3, 3, 3, 3)), 2)
    cache["pool_in"] = x
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    for stage, b, first, stride, _, _ in blocks(depth):
        base, bnn = f"res{stage}{b}_branch", f"bn{stage}{b}_branch"
        short = unit(base + "1", bnn + "1", x, stride, relu=False) if first else x
        y = unit(base + "2a", bnn + "2a", x, stride)
        y = unit(base + "2b", bnn + "2b", y, 1)
        y = unit(base + "2c", bnn + "2c", y, 1, relu=False)
        cache[f"add{stage}{b}"] = (y, short)
        x = torch.relu(y + short)
    return (x, cache) if keep else x


def stab(z):
    return z + torch.where(z >= 0, EPS, -EPS).to(z.dtype)


def safe(z):
    return z + (z == 0).to(z.dtype) * EPS


def bn_rule(r, x, y, p):
    return x * (y - p["beta"]) * r / safe(stab((x - p["moving_mean"]) * y))


def add_rule(r, xs):
    s = r / safe(stab(sum(xs)))
    return [x * s for x in xs]


def a1b0(r, x, kernel, stride: int, signed: bool):
    """alpha1beta0 through a bias-free conv; ``signed`` x takes the split
    rule (x+ with W+, x- with W-), a post-ReLU x only W+."""
    kp, kn = kernel.clamp(min=0), kernel.clamp(max=0)
    if not signed:
        s = r / safe(conv(x, kp, stride))
        return x * conv_t(s, x.shape, kp, stride)
    xp, xn = x.clamp(min=0), x.clamp(max=0)
    s = r / safe(conv(xp, kp, stride) + conv(xn, kn, stride))
    return xp * conv_t(s, x.shape, kp, stride) + xn * conv_t(s, x.shape, kn, stride)


def wta_pool(r, x, window: int = 3, stride: int = 2):
    """Relevance through a VALID max pool of overlapping windows: each
    window's relevance split equally among its maxima, an input summing
    what every window over it hands back. r (N, h, w, C), x (1 or N, H, W, C)."""
    n, h, w, C = r.shape
    H, W = x.shape[1:3]
    cols = F.unfold(x.permute(0, 3, 1, 2), window, stride=stride)       # (b, C k k, h w)
    cols = cols.reshape(x.shape[0], C, window * window, h * w)
    hit = (cols == cols.amax(dim=2, keepdim=True)).to(r.dtype)
    share = r.permute(0, 3, 1, 2).reshape(n, C, 1, h * w) / hit.sum(dim=2, keepdim=True)
    back = (hit * share).reshape(n, C * window * window, h * w)
    return F.fold(back, (H, W), window, stride=stride).permute(0, 2, 3, 1)


def walk(params, image, seeds, depth: str):
    """PresetA of one image for many seeds: image (1, H, W, 3), seeds (N,
    H/32, W/32, 2048) -> (N, H, W, 3)."""
    _, cache = forward(params, image, depth, keep=True)

    def unit(r, name, bn_name, stride, signed=False):
        x, z, y = cache[name]
        r = bn_rule(r, z, y, params[bn_name])
        return a1b0(r, x, params[name]["kernel"], stride, signed)

    r = seeds
    for stage, b, first, stride, _, _ in reversed(blocks(depth)):
        base, bnn = f"res{stage}{b}_branch", f"bn{stage}{b}_branch"
        r_branch, r_short = add_rule(r, list(cache[f"add{stage}{b}"]))
        r_branch = unit(r_branch, base + "2c", bnn + "2c", 1)
        r_branch = unit(r_branch, base + "2b", bnn + "2b", 1)
        r_branch = unit(r_branch, base + "2a", bnn + "2a", stride)
        if first:
            r_short = unit(r_short, base + "1", bnn + "1", stride)
        r = r_branch + r_short
    r = wta_pool(r, cache["pool_in"])
    r = unit(r, "conv1", "bn_conv1", 2, signed=True)
    return r[:, 3:-3, 3:-3, :]


def encode(enc, images, s):
    f = forward(enc, images, s.arch)
    return f.reshape(f.shape[0], s.L, s.D)


@torch.no_grad()
def relevance_weights(params, images, captions_in, s, stop1, sos1, eos1):
    """The fine-tune's (B, T, V) weights, as ``steps.relevance_weights``
    with the ResNet walk: the teacher-forced prediction's words; each word
    that is not a stop word and comes before the first EOS is explained
    (decoder and CNN LRP, float32); its map's channel mean over its largest
    |value| gives the mean as its score; the weight is 1 + score at (step,
    word), 1 elsewhere. ``stop1`` (V + 1,) bool."""
    B, T = captions_in.shape
    enc, dec = params["vgg"], params["decoder"]
    feat = encode(enc, images, s)
    logits, _, _ = decode(dec, feat, captions_in.long(), s.model)
    words1 = logits.argmax(-1) + 1
    r_feat = decoder_lrp_adaptive(dec, feat, words1, sos1, T)[0]
    g = int(round(s.L ** 0.5))
    scores = []
    for b in range(B):
        m = walk(enc, images[b:b + 1], r_feat[b].reshape(T, g, g, s.D),
                 s.arch).mean(-1).flatten(1)
        top = m.abs().amax(dim=1, keepdim=True)
        scores.append(torch.where(top == 0, torch.zeros_like(m), m / top.clamp(min=1e-38))
                      .mean(1))
    scores = torch.stack(scores)
    valid = ~stop1.to(words1.device)[words1] & ~(torch.cumsum((words1 == eos1).int(), 1) > 0)
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    onehot = F.one_hot(words1 - 1, s.V).to(scores.dtype)
    return 1.0 + onehot * scores[:, :, None]


def finetune_step(params, state, opt, images, captions_in, y, masks, s, stop1, sos1, eos1):
    """-> (params, state, loss, clipped gradient): the dual loss
    0.5 CE(y, logits) + 0.5 CE(y, logits * weights) under dropout, then
    ``opt`` (``steps.Adam``) on every leaf."""
    from .steps import value_and_grad

    w = relevance_weights(params, images, captions_in, s, stop1, sos1, eos1)

    def loss_fn(p):
        feat = encode(p["vgg"], images, s)
        logits, _, _ = decode(p["decoder"], feat, captions_in.long(), s.model, masks)
        return 0.5 * masked_ce(logits, y) + 0.5 * masked_ce(logits * w, y)

    loss, g = value_and_grad(loss_fn, params)
    new, state = opt.step(params, g, state)
    return new, state, loss, tree_map(lambda t: t.clamp(-opt.c, opt.c), g)
