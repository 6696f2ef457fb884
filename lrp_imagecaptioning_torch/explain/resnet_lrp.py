"""Rule-based explanations through ResNet-50/101: LRP (PresetA), DeepTaylor
and DeepLIFT, word-batched.

The port of the JAX package's ``explain/resnet_lrp.py``, the reverse layers
of iNNvestigate that the VGG walk never needs (relevance_analyzer.py:
197-316):

* BatchNorm: R_in = x (y - beta) R / stab((x - mean) y) (``lrp_bn``);
* Add: R_i = x_i R / stab(sum_j x_j) (``lrp_add``);
* conv: alpha1beta0, bias-free. Each '2b' conv is 3x3 SAME stride 1 over a
  post-ReLU input, so it takes K3 (``cnn_lrp.conv_rule``); every other conv
  the plain generalized rule;
* ReLU passes relevance unchanged; the overlapping 3x3/2 stem pool reverses
  winner-take-all with ties split (``lrp_maxpool_overlapping_wta``).

Words are the batch: the PresetA walk runs one forward over its B images
and walks the W seeds of every image at once (B W rows), each image's
cached tensors broadcast against its own seeds, so that a walk launches
the same kernels for one image or a batch (the fine-tune's captured step
holds one walk, not one an image). DeepTaylor and DeepLIFT walk one image
(batch 1) against its W seeds. DeepTaylor takes the
WSquareRule on every conv (deeptaylor.py:62-67) and DeepLIFT the
LinearRule / RescaleRule (deeplift.py:44-116): neither launches K3.

Each walk records the span ``lrpic.resnet_walk.forward`` around its cached
forward (or forwards) and ``lrpic.resnet_walk.rules`` around its backward
(``utils/profiling.py::annotate``). Nothing in a walk waits for the card
or takes a shape from the data, so a walk captures whole into a CUDA graph
(the fine-tune's K-step call, ``train/lrp_finetune.py``).
"""

from __future__ import annotations

import torch

from ..models.resnet import BN_EPS, _stages, bn, conv, stem_pad
from ..ops.lrp_conv import (conv2d, conv2d_input_vjp, deeplift_conv_linear,
                            deeplift_relu_rescale, lrp_conv_wsquare,
                            lrp_maxpool_overlapping_wta, maxpool2d)
from ..ops.lrp_core import EPS_KERAS, safe_divide, sign_stabilizer
from ..utils.profiling import annotate
from .cnn_deeplift import reference_image
from .cnn_lrp import conv_rule


def lrp_bn(r, x, y, mean, beta, eps=EPS_KERAS):
    """BatchNormalizationReverseLayer.apply (relevance_analyzer.py:239-256):
    x the BN's input, y its output; ``eps`` the stabilizer and SafeDivide's."""
    return safe_divide(x * (y - beta) * r, sign_stabilizer((x - mean) * y, eps), eps)


def lrp_add(r, xs, eps=EPS_KERAS):
    """AddReverseLayer.apply: the relevance split in proportion to the summands."""
    s = safe_divide(r, sign_stabilizer(sum(xs), eps), eps)
    return [x * s for x in xs]


def _forward_cached(params, image, depth):
    """The forward, keeping what the backward walks read:
    cache[conv] = {'in': its input, 'z': its output (pre-BN), 'bn': BN's
    output}, the stem pool's input and each block's two summands."""
    cache = {}

    def conv_bn(name, bn_name, x, stride, padding, relu=True):
        z = conv(params[name], x, stride, padding)
        y = bn(params[bn_name], z)
        cache[name] = {"in": x, "z": z, "bn": y}
        return torch.relu(y) if relu else y

    x = conv_bn("conv1", "bn_conv1", stem_pad(image), 2, "VALID")
    cache["_stem_pool_in"] = x
    x = maxpool2d(x, 3, 2)
    for stage, blocks, _, stage_stride in _stages(depth):
        for bi, block in enumerate(blocks):
            s = stage_stride if bi == 0 else 1
            base, bnn = f"res{stage}{block}_branch", f"bn{stage}{block}_branch"
            shortcut = conv_bn(base + "1", bnn + "1", x, s, "VALID", relu=False) if bi == 0 else x
            y = conv_bn(base + "2a", bnn + "2a", x, s, "VALID")
            y = conv_bn(base + "2b", bnn + "2b", y, 1, "SAME")
            y = conv_bn(base + "2c", bnn + "2c", y, 1, "VALID", relu=False)
            cache[f"_add_{stage}{block}"] = (y, shortcut)
            x = torch.relu(y + shortcut)
    return x, cache


def _crop(r):
    """Back through the stem's zero padding."""
    return r[:, 3:-3, 3:-3, :]


def _blocks_reversed(depth):
    for stage, blocks, _, stage_stride in reversed(_stages(depth)):
        for bi, block in reversed(list(enumerate(blocks))):
            yield stage, block, bi, stage_stride if bi == 0 else 1


def _per_seed(t, words: int):
    """An image's tensor once for each of its seeds: (B, ...) -> (B words, ...)."""
    return t.unsqueeze(1).expand(-1, words, *t.shape[1:]).flatten(0, 1)


def _a1b0(r, x, kernel, stride, padding, nonneg=True):
    """alpha1beta0 through a bias-free conv for the W seeds of each of B
    images: r (B, W, h, w, Cout), x (B, H, W, Cin) -> (B, W, H, W, Cin). A
    3x3 SAME stride-1 conv over a post-ReLU input takes K3
    (``cnn_lrp.conv_rule``), which shares an x of batch 1 but reads any
    other per row; every other conv ``lrp_conv_alpha_beta``'s arithmetic
    with each image's z computed once for its seeds (a signed x splits:
    x+ with W+, x- with W-)."""
    B, W = r.shape[:2]
    rows = r.flatten(0, 1)
    if nonneg and stride == 1 and padding == "SAME" and kernel.shape[0] == 3:
        return conv_rule(rows, x if B == 1 else _per_seed(x, W), kernel,
                         None).unflatten(0, (B, W))
    kp = kernel * (kernel >= 0)
    xp = x if nonneg else torch.clamp(x, min=0)
    z = conv2d(xp, kp, stride, padding)
    if not nonneg:
        kn, xn = kernel * (kernel < 0), torch.clamp(x, max=0)
        z = z + conv2d(xn, kn, stride, padding)
    s = safe_divide(r, z.unsqueeze(1), EPS_KERAS).flatten(0, 1)

    def back(k, xs):
        vjp = conv2d_input_vjp(x.shape, k, s, stride, padding)
        return xs.unsqueeze(1) * vjp.unflatten(0, (B, W))

    return back(kp, xp) if nonneg else back(kp, xp) + back(kn, xn)


def _backward(params, cache, r, depth):
    """PresetA: the BN rule then alpha1beta0 per conv (input post-ReLU but
    for conv1's), the Add rule per block, WTA on the stem pool. r (B W, h,
    w, 2048) holds W seeds for each of the cache's B images, image by
    image; it is walked as (B, W, ...) against each image's (B, 1, ...)."""
    B = cache["_stem_pool_in"].shape[0]
    r = r.unflatten(0, (B, -1))
    W = r.shape[1]

    def rev_conv_bn(name, bn_name, r, stride, padding, nonneg=True):
        c, p = cache[name], params[bn_name]
        r = lrp_bn(r, c["z"].unsqueeze(1), c["bn"].unsqueeze(1), p["moving_mean"], p["beta"])
        return _a1b0(r, c["in"], params[name]["kernel"], stride, padding, nonneg)

    for stage, block, bi, s in _blocks_reversed(depth):
        base, bnn = f"res{stage}{block}_branch", f"bn{stage}{block}_branch"
        r_branch, r_short = lrp_add(r, [t.unsqueeze(1) for t in cache[f"_add_{stage}{block}"]])
        r_branch = rev_conv_bn(base + "2c", bnn + "2c", r_branch, 1, "VALID")
        r_branch = rev_conv_bn(base + "2b", bnn + "2b", r_branch, 1, "SAME")
        r_branch = rev_conv_bn(base + "2a", bnn + "2a", r_branch, s, "VALID")
        if bi == 0:
            r_short = rev_conv_bn(base + "1", bnn + "1", r_short, s, "VALID")
        r = r_branch + r_short
    pool_in = cache["_stem_pool_in"]
    r = lrp_maxpool_overlapping_wta(r.flatten(0, 1), pool_in if B == 1 else _per_seed(pool_in, W),
                                    3, 2)
    r = rev_conv_bn("conv1", "bn_conv1", r.unflatten(0, (B, W)), 2, "VALID", nonneg=False)
    return _crop(r.flatten(0, 1))


def _backward_deep_taylor(params, cache, r, depth):
    """DeepTaylor (deeptaylor.py:52-137): Keras's ResNet convs carry no fused
    activation, so every conv takes the WSquareRule; BN does nothing; ReLU,
    Add and the pool reverse by the gradient (a mask, the full relevance to
    both summands, WTA)."""

    def mask(r, y):
        return torch.where(y > 0, r, torch.zeros_like(r))

    def wsq(r, name, stride, padding):
        return lrp_conv_wsquare(r, cache[name]["in"], params[name]["kernel"], stride, padding)

    for stage, block, bi, s in _blocks_reversed(depth):
        base = f"res{stage}{block}_branch"
        y, shortcut = cache[f"_add_{stage}{block}"]
        r = mask(r, y + shortcut)
        r_branch = wsq(r, base + "2c", 1, "VALID")
        r_branch = wsq(mask(r_branch, cache[base + "2b"]["bn"]), base + "2b", 1, "SAME")
        r_branch = wsq(mask(r_branch, cache[base + "2a"]["bn"]), base + "2a", s, "VALID")
        r = r_branch + (wsq(r, base + "1", s, "VALID") if bi == 0 else r)
    r = lrp_maxpool_overlapping_wta(r, cache["_stem_pool_in"], 3, 2)
    r = mask(r, cache["conv1"]["bn"])
    return _crop(wsq(r, "conv1", 2, "VALID"))


def _backward_deeplift(params, cache, cache_ref, r, depth, approximate=True):
    """DeepLIFT-rescale (deeplift.py:120-197): the LinearRule on each conv,
    the RescaleRule on each separate ReLU; BN (a scale in inference mode),
    Add, the pool and the stem pad reverse by the gradient."""

    def rev_unit(r, name, bn_name, stride, padding, relu=True):
        c, cr = cache[name], cache_ref[name]
        if relu:
            r = deeplift_relu_rescale(r, c["bn"], cr["bn"], approximate)
        p = params[bn_name]
        r = r * (p["gamma"] * torch.rsqrt(p["moving_var"] + BN_EPS))
        return deeplift_conv_linear(r, c["in"], cr["in"], c["z"], cr["z"],
                                    params[name]["kernel"], stride, padding, approximate)

    for stage, block, bi, s in _blocks_reversed(depth):
        base, bnn = f"res{stage}{block}_branch", f"bn{stage}{block}_branch"
        y, shortcut = cache[f"_add_{stage}{block}"]
        y_ref, shortcut_ref = cache_ref[f"_add_{stage}{block}"]
        r = deeplift_relu_rescale(r, y + shortcut, y_ref + shortcut_ref, approximate)
        r_branch = rev_unit(r, base + "2c", bnn + "2c", 1, "VALID", relu=False)
        r_branch = rev_unit(r_branch, base + "2b", bnn + "2b", 1, "SAME")
        r_branch = rev_unit(r_branch, base + "2a", bnn + "2a", s, "VALID")
        r = r_branch + (rev_unit(r, base + "1", bnn + "1", s, "VALID", relu=False)
                        if bi == 0 else r)
    r = lrp_maxpool_overlapping_wta(r, cache["_stem_pool_in"], 3, 2)
    return _crop(rev_unit(r, "conv1", "bn_conv1", 2, "VALID"))


def _walk_forward(params, image, depth):
    with annotate("lrpic.resnet_walk.forward"):
        return _forward_cached(params, image, depth)[1]


def resnet_lrp_preset_a(params, image, relevance_seed, depth: str = "resnet50"):
    """PresetA LRP from the last block's ReLU back to the image, one seed
    per image: image (B, H, W, 3), seed (B, H/32, W/32, 2048) -> (B, H, W, 3)."""
    cache = _walk_forward(params, image, depth)
    with annotate("lrpic.resnet_walk.rules"):
        return _backward(params, cache, relevance_seed, depth)


def resnet_lrp_wordbatched(params, image, relevance_seeds, depth: str = "resnet50"):
    """Per-word LRP sharing one forward: image (B, H, W, 3), seeds
    (B W, H/32, W/32, 2048), the W seeds of each image in turn ->
    (B W, H, W, 3); one image (B = 1) against its W words in the Explainer,
    a batch in the fine-tune's ``lrp_weights``."""
    cache = _walk_forward(params, image, depth)
    with annotate("lrpic.resnet_walk.rules"):
        return _backward(params, cache, relevance_seeds, depth)


def resnet_deep_taylor_wordbatched(params, image, relevance_seeds, depth: str = "resnet50"):
    """Per-word DeepTaylor sharing one forward; each seed through a ReLU
    first (the reference's positive-output preparation, deeptaylor.py:144-153)."""
    cache = _walk_forward(params, image, depth)
    with annotate("lrpic.resnet_walk.rules"):
        return _backward_deep_taylor(params, cache, torch.relu(relevance_seeds), depth)


def resnet_deeplift_wordbatched(params, image, relevance_seeds, depth: str = "resnet50",
                                reference_inputs=0.0, approximate_gradient: bool = True):
    """Per-word DeepLIFT sharing one actual and one reference forward
    (``reference_inputs`` a scalar or an image, default 0, deeplift.py:123)."""
    cache = _walk_forward(params, image, depth)
    cache_ref = _walk_forward(params, reference_image(image, reference_inputs), depth)
    with annotate("lrpic.resnet_walk.rules"):
        return _backward_deeplift(params, cache, cache_ref, relevance_seeds, depth,
                                  approximate_gradient)
