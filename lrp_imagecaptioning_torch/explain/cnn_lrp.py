"""CNN-side LRP over the VGG16 / VGG19 conv stack: LRPSequentialPresetA and
the other rule walks of iNNvestigate's relevance analyzers.

The relevance seed is injected at the tapped layer (the decoder LRP's
feature-grid relevance) and propagated back to the input image: one rule on
every conv, winner-take-all on every pool, ReLU passes relevance through.
PresetA is alpha1beta0 on every conv, PresetB alpha2beta1
(relevance_analyzer.py:695-748). The convs whose input is post-ReLU (x >= 0)
go through a kernel: in f32 the K3 pair (``lrp_conv_a1b0``, or
``lrp_conv_alpha_beta_split`` where beta != 0: the inhibitor is the same
pair on W-), in bf16 storage the one-launch ``lrp_a1b0_fused``. The signed
input layer takes the plain ``lrp_conv_alpha_beta``, or a walk's own input
rule (flat, zB). DeepTaylor (``vgg_deep_taylor``) is the PresetA walk on a
ReLU'd seed, in f32. ``conv_rule`` is the one dispatch of every walk (VGG,
ResNet, Inception) for an alpha-beta conv: a 3x3 SAME stride-1 conv over a
post-ReLU f32 input at SafeDivide's own eps takes K3, any other conv (bf16
operands under ``compute_dtype`` too: K3 sums to f32 accuracy) the plain
rule. The epsilon, flat, w-square and zB rules take torch ops, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch

from ..models.vgg import vgg_apply_with_acts, vgg_layers
from ..ops.kernels import lrp_a1b0_fused, lrp_conv_a1b0, lrp_conv_alpha_beta_split
from ..ops.lrp_conv import (conv2d, conv2d_input_vjp, lrp_conv_alpha_beta, lrp_conv_bounded,
                            lrp_conv_epsilon, lrp_conv_flat, lrp_maxpool_wta)
from ..ops.lrp_core import EPS_KERAS, safe_divide
from ..weights import tree_to


def conv_rule(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor, bias, stride: int = 1,
              padding: str = "SAME", input_nonneg: bool = True, *, alpha: float = 1.0,
              beta: float = 0.0, factor: float = EPS_KERAS, compute_dtype=None) -> torch.Tensor:
    """The AlphaBetaRule through one conv: K3 (``lrp_conv_a1b0`` at alpha1beta0,
    ``lrp_conv_alpha_beta_split`` otherwise) for a 3x3 SAME stride-1 conv
    over a post-ReLU f32 input with SafeDivide's eps (K3's is fixed at 1e-7)
    and no ``compute_dtype``; the plain ``lrp_conv_alpha_beta`` otherwise.
    K3 takes contiguous tensors: a relevance sliced off a concat is copied
    first."""
    if (input_nonneg and stride == 1 and padding == "SAME" and tuple(kernel.shape[:2]) == (3, 3)
            and r.dtype == torch.float32 and x.dtype == torch.float32
            and compute_dtype is None and factor == EPS_KERAS):
        if alpha == 1.0 and not beta:
            return lrp_conv_a1b0(r.contiguous(), x, kernel, bias)
        kp = (kernel * (kernel >= 0)).contiguous()
        kn = (kernel * (kernel < 0)).contiguous() if beta else None
        return lrp_conv_alpha_beta_split(r.contiguous(), x, kp, kn, bias, alpha, beta)
    return lrp_conv_alpha_beta(r, x, kernel, bias, alpha, beta, stride, padding, factor,
                               compute_dtype, input_nonneg=input_nonneg)


def _a1b0_image(r, x, kernel, bias):
    return conv_rule(r, x, kernel, bias, input_nonneg=False)


def alpha_beta_rules(alpha: float, beta: float, bias: bool = True, compute_dtype=None):
    """(rule, input_rule) of the AlphaBetaRule on every conv, for ``_backward``;
    ``bias=False`` leaves the bias out of z (the ``*_IB`` analyzers)."""
    def rule(r, x, kernel, b):
        return conv_rule(r, x, kernel, b if bias else None, alpha=alpha, beta=beta,
                         compute_dtype=compute_dtype)

    def input_rule(r, x, kernel, b):
        return conv_rule(r, x, kernel, b if bias else None, input_nonneg=False, alpha=alpha,
                         beta=beta, compute_dtype=compute_dtype)

    return rule, input_rule


def _backward(params, inputs, r: torch.Tensor, arch: str, until: str, rule, input_rule=None,
              stats: dict | None = None):
    """Walk vgg_layers(arch, until) in reverse: ``rule(r, x, kernel, bias)`` on
    the post-ReLU convs (``conv_rule`` in f32), ``input_rule`` on the image
    layer (default the alpha1beta0 split rule: x is signed), WTA on the
    pools. ``stats``, a dict, gets each op's relevance after it, in backward
    order: sum, min, max and the count of non-finite values."""
    ops = vgg_layers(arch, until)
    for idx, (op, x) in enumerate(zip(reversed(ops), reversed(inputs))):
        if op[0] == "pool":
            r = lrp_maxpool_wta(r, x)
        else:
            p = params[op[1]]
            layer_rule = (input_rule or _a1b0_image) if idx == len(ops) - 1 else rule
            r = layer_rule(r, x, p["kernel"], p["bias"])
        if stats is not None:
            stats[op[1]] = {"sum": r.sum(), "min": r.amin(), "max": r.amax(),
                            "nonfinite_count": (~torch.isfinite(r)).sum()}
    return r


def vgg_lrp_walk(params, image: torch.Tensor, relevance_seed: torch.Tensor, rule,
                 arch: str = "vgg16", until: str = "block5_conv3", input_rule=None):
    """One forward, then ``rule`` (and ``input_rule``) walked back from the
    seed: the single-rule analyzers (LRPZ, LRPWSquare, LRPFlat, LRPAlphaBeta,
    ...: each sets one rule for the whole model, relevance_analyzer.py:428-692)."""
    _, inputs = vgg_apply_with_acts(params, image, arch, until)
    return _backward(params, inputs, relevance_seed, arch, until, rule, input_rule)


def _flat_image(r, x, kernel, bias):
    return lrp_conv_flat(r, x, kernel)


def vgg_lrp_preset_a(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                     arch: str = "vgg16", until: str = "block5_conv3") -> torch.Tensor:
    """LRPSequentialPresetA, one seed per image, f32.

    image: (B, H, W, 3) preprocessed; relevance_seed: (B, h, w, C) at
    ``until``. Returns the input-space relevance (B, H, W, 3)."""
    return vgg_lrp_walk(params, image, relevance_seed, conv_rule, arch, until)


def vgg_lrp_preset_b(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                     arch: str = "vgg16", until: str = "block5_conv3") -> torch.Tensor:
    """LRPSequentialPresetB: alpha2beta1 on every conv (relevance_analyzer.py:724-748);
    the post-ReLU convs take K3 twice over (W+ and W-) in f32."""
    rule, input_rule = alpha_beta_rules(2.0, 1.0)
    return vgg_lrp_walk(params, image, relevance_seed, rule, arch, until, input_rule)


def vgg_lrp_epsilon(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                    arch: str = "vgg16", until: str = "block5_conv3", eps: float = 0.01,
                    bias: bool = True) -> torch.Tensor:
    """The EpsilonRule on every conv (LRPEpsilon), the image layer included."""
    def rule(r, x, kernel, b):
        return lrp_conv_epsilon(r, x, kernel, b if bias else None, eps=eps)

    return vgg_lrp_walk(params, image, relevance_seed, rule, arch, until, input_rule=rule)


def vgg_lrp_preset_a_debug(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                           arch: str = "vgg16", until: str = "block5_conv3"):
    """PresetA with per-op relevance diagnostics, iNNvestigate's
    reverse_check_finite / reverse_check_min_max_values (base.py:753-802):
    returns (relevance, stats), stats[op_name] = {sum, min, max,
    nonfinite_count} (0-d tensors) of the relevance after reversing that op,
    in backward order. The relevance is ``vgg_lrp_preset_a``'s."""
    _, inputs = vgg_apply_with_acts(params, image, arch, until)
    stats = {}
    r = _backward(params, inputs, relevance_seed, arch, until, conv_rule, stats=stats)
    return r, stats


def vgg_lrp_preset_a_flat(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                          arch: str = "vgg16", until: str = "block5_conv3") -> torch.Tensor:
    """LRPSequentialPresetAFlat: PresetA with the FlatRule on the image layer
    (relevance_analyzer.py:755-762)."""
    return vgg_lrp_walk(params, image, relevance_seed, conv_rule, arch, until,
                        input_rule=_flat_image)


def vgg_lrp_preset_b_flat(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                          arch: str = "vgg16", until: str = "block5_conv3") -> torch.Tensor:
    """LRPSequentialPresetBFlat (relevance_analyzer.py:765-770)."""
    rule, _ = alpha_beta_rules(2.0, 1.0)
    return vgg_lrp_walk(params, image, relevance_seed, rule, arch, until, input_rule=_flat_image)


def vgg_lrp_preset_a_wordbatched(params, image: torch.Tensor, relevance_seeds: torch.Tensor,
                                 arch: str = "vgg16", until: str = "block5_conv3",
                                 compute_dtype=None, storage_dtype: torch.dtype | None = None,
                                 lane_pack: bool = True) -> torch.Tensor:
    """Per-word LRP with the forward pass shared across words.

    image: (1, H, W, 3); relevance_seeds: (W, h, w, C) — one seed per caption
    word, the words as the batch. The forward activations are computed once
    (batch 1) and broadcast against the W relevances. Returns (W, H, W, 3).

    ``compute_dtype=torch.bfloat16`` runs every conv of the rules on bf16
    operands with f32 sums over f32 storage (the plain rule: never K3).
    ``storage_dtype=torch.bfloat16`` holds params, activations and
    relevances in bf16: the forward runs once in bf16, the post-ReLU convs
    take ``lrp_a1b0_fused`` and the result comes back in f32
    (``compute_dtype`` is then not read, as in the JAX package).

    ``lane_pack`` is accepted and read by nothing: the JAX package's TPU
    channel packing gives the same result either way."""
    if storage_dtype is None:
        _, inputs = vgg_apply_with_acts(params, image, arch, until)
        if compute_dtype is None:
            return _backward(params, inputs, relevance_seeds, arch, until, conv_rule)
        rule, input_rule = alpha_beta_rules(1.0, 0.0, compute_dtype=compute_dtype)
        return _backward(params, inputs, relevance_seeds, arch, until, rule, input_rule)
    params = tree_to(params, dtype=storage_dtype)
    _, inputs = vgg_apply_with_acts(params, image.to(storage_dtype), arch, until)
    r = _backward(params, inputs, relevance_seeds.to(storage_dtype), arch, until, lrp_a1b0_fused)
    return r.float()


def vgg_lrp_preset_a_imgword_batched(params, images: torch.Tensor, relevance_seeds: torch.Tensor,
                                     arch: str = "vgg16", until: str = "block5_conv3",
                                     compute_dtype=None,
                                     storage_dtype: torch.dtype | None = None) -> torch.Tensor:
    """PresetA over B images and their words: images (B, H, W, 3),
    relevance_seeds (B, Wd, h, w, C) -> (B, Wd, H, W, 3).

    One ``vgg_lrp_preset_a_wordbatched`` per image: K3 and K4 share one
    batch-1 x across the seeds of a launch, so an image's Wd words are a
    launch's batch (f32: K3; ``storage_dtype=torch.bfloat16``: K4, the
    params cast once for all images)."""
    if storage_dtype is not None:
        params = tree_to(params, dtype=storage_dtype)
    return torch.stack([vgg_lrp_preset_a_wordbatched(params, images[b:b + 1], relevance_seeds[b],
                                                     arch, until, compute_dtype, storage_dtype)
                        for b in range(images.shape[0])])


def vgg_lrp_per_image(params, images: torch.Tensor, r_feat: torch.Tensor, arch: str = "vgg16",
                      until: str = "block5_conv3",
                      storage_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``vgg_lrp_preset_a_imgword_batched`` from the decoder's relevance:
    images (B, H, W, 3), r_feat (B, Tw, L, D) the feature-grid relevance of
    Tw words an image (L = h * w, a square grid) -> heatmaps (B, Tw, H, W, 3)."""
    B, Tw, L, D = r_feat.shape
    g = math.isqrt(L)
    return vgg_lrp_preset_a_imgword_batched(params, images, r_feat.reshape(B, Tw, g, g, D), arch,
                                            until, storage_dtype=storage_dtype)


def _upsample_window(w: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Nearest-neighbour window upsample (N, H, W, C) -> (N, H*k, W*k, C)."""
    n, h, wd, c = w.shape
    return w[:, :, None, :, None, :].expand(n, h, window, wd, window, c).reshape(
        n, h * window, wd * window, c)


def vgg_lrp_preset_a_wordbatched_fused(params, image: torch.Tensor, relevance_seeds: torch.Tensor,
                                       arch: str = "vgg16", until: str = "block5_conv3",
                                       storage_dtype: torch.dtype | None = None) -> torch.Tensor:
    """PresetA word-batched with the per-word elementwise chain folded into
    word-independent factors (the JAX package's second implementation of the
    walk, kept for cross-checking).

    Each post-ReLU step is r' = x * convT(W+, r / z) with x >= 0 and z, x
    word-independent. Writing r = m * w (m word-independent, w per word):

        a = safe_divide(m, z)        once an image and layer
        w' = convT(W+, w * a)        per word: one multiply and one conv
        m' = x

    and a pool's WTA factors as m' = wta(m), w' = upsample(w) (the tie mask
    rides on m). The image layer runs the exact alpha1beta0 split rule on
    m * w. Equal to ``vgg_lrp_preset_a_wordbatched`` up to float
    reassociation. image (1, H, W, 3), relevance_seeds (W, h, w, C) ->
    (W, H, W, 3), f32; ``storage_dtype`` holds every tensor in it."""
    if storage_dtype is not None:
        params = tree_to(params, dtype=storage_dtype)
        image = image.to(storage_dtype)
        relevance_seeds = relevance_seeds.to(storage_dtype)
    ops = vgg_layers(arch, until)
    _, inputs = vgg_apply_with_acts(params, image, arch, until)
    w = relevance_seeds
    m = torch.ones((1, *relevance_seeds.shape[1:]), dtype=w.dtype, device=w.device)
    for idx, (op, x) in enumerate(zip(reversed(ops), reversed(inputs))):
        if op[0] == "pool":
            m = lrp_maxpool_wta(m, x)
            w = _upsample_window(w)
            continue
        p = params[op[1]]
        kp = p["kernel"] * (p["kernel"] >= 0)
        if idx != len(ops) - 1:
            # z = conv(x, W+) + the full bias, the activator's with x >= 0
            a = safe_divide(m, conv2d(x, kp) + p["bias"])
            w = conv2d_input_vjp(x.shape, kp, w * a)
            m = x
        else:
            kn = p["kernel"] * (p["kernel"] < 0)
            bp = p["bias"] * (p["bias"] >= 0)
            bn = p["bias"] * (p["bias"] < 0)
            xp, xn = torch.clamp(x, min=0), torch.clamp(x, max=0)
            z = conv2d(xp, kp) + bp + conv2d(xn, kn) + bn
            s = safe_divide(m * w, z)
            w = xp * conv2d_input_vjp(x.shape, kp, s) + xn * conv2d_input_vjp(x.shape, kn, s)
    return w.float()


def vgg_deep_taylor(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                    arch: str = "vgg16", until: str = "block5_conv3") -> torch.Tensor:
    """DeepTaylor decomposition (reference: innvestigate/analyzer/deeptaylor.py:38-153).

    Rule wiring per the reference's conditional mappings: kernel layers with
    ReLU -> Alpha1Beta0 (deeptaylor.py:56-61), max-pooling -> gradient/WTA
    (deeptaylor.py:85-89). Every conv in the tapped VGG stack carries a ReLU,
    so the walk is alpha1beta0 throughout (``conv_rule``: K3 on the
    post-ReLU convs, the plain split rule on the image layer). The
    reference's ``_prepare_model`` clamps the model outputs through a ReLU
    so only positive relevance enters (deeptaylor.py:144-153); with a seeded
    walk that is a ReLU on the seed.

    image: (1 or B, H, W, 3); relevance_seed: (B, h, w, C), one seed per
    image or, against a single image, one per word (the words as the batch,
    the forward run once). Returns (B, H, W, 3)."""
    return vgg_lrp_walk(params, image, torch.relu(relevance_seed), conv_rule, arch, until)


def vgg_deep_taylor_bounded(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                            low: float, high: float, arch: str = "vgg16",
                            until: str = "block5_conv3") -> torch.Tensor:
    """BoundedDeepTaylor: DeepTaylor with the zB (bounded) rule on the image
    layer (deeptaylor.py:157-200); ``low`` / ``high`` are the input's value
    range and are required (deeptaylor.py:170-173)."""
    def bounded(r, x, kernel, bias):
        return lrp_conv_bounded(r, x, kernel, low=low, high=high)

    return vgg_lrp_walk(params, image, torch.relu(relevance_seed), conv_rule, arch, until,
                        input_rule=bounded)
