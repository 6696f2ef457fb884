"""CNN-side LRP: LRPSequentialPresetA over the VGG16 / VGG19 conv stack.

The relevance seed is injected at the tapped layer (the decoder LRP's
feature-grid relevance) and propagated back to the input image: alpha1beta0
on every conv, winner-take-all on every pool, ReLU passes relevance through.
The convs whose input is post-ReLU (x >= 0) go through a kernel: in f32
the ``lrp_conv_a1b0`` pair, in bf16 storage the one-launch
``lrp_a1b0_fused``. The signed input layer takes the plain
``lrp_conv_alpha_beta``. DeepTaylor (``vgg_deep_taylor``) is the same walk
on a ReLU'd seed, in f32. In f32, ``conv_rule`` is the one dispatch of every
walk (VGG, ResNet, Inception) for an alpha1beta0 conv: a 3x3 SAME stride-1
conv over a post-ReLU f32 input takes K3, any other conv the plain rule.
"""

from __future__ import annotations

import math

import torch

from ..models.vgg import vgg_apply_with_acts, vgg_layers
from ..ops.kernels import lrp_a1b0_fused, lrp_conv_a1b0
from ..ops.lrp_conv import lrp_conv_alpha_beta, lrp_maxpool_wta
from ..weights import tree_to


def conv_rule(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor, bias, stride: int = 1,
              padding: str = "SAME", input_nonneg: bool = True) -> torch.Tensor:
    """alpha1beta0 through one conv: ``lrp_conv_a1b0`` (K3) for a 3x3 SAME
    stride-1 conv over a post-ReLU f32 input, the plain
    ``lrp_conv_alpha_beta`` otherwise. K3 takes contiguous tensors: a
    relevance sliced off a concat is copied first."""
    if (input_nonneg and stride == 1 and padding == "SAME" and tuple(kernel.shape[:2]) == (3, 3)
            and r.dtype == torch.float32):
        return lrp_conv_a1b0(r.contiguous(), x, kernel, bias)
    return lrp_conv_alpha_beta(r, x, kernel, bias, input_nonneg, stride, padding)


def _backward(params, inputs, r: torch.Tensor, until: str, rule, arch: str = "vgg16"):
    """Walk vgg_layers(until, arch) in reverse: ``rule`` on the post-ReLU
    convs (``conv_rule`` in f32), the alpha1beta0 split rule on the image
    layer, WTA on the pools."""
    ops = vgg_layers(until, arch)
    for idx, (op, x) in enumerate(zip(reversed(ops), reversed(inputs))):
        if op[0] == "pool":
            r = lrp_maxpool_wta(r, x)
            continue
        p = params[op[1]]
        if idx == len(ops) - 1:  # the image layer: x is signed
            r = conv_rule(r, x, p["kernel"], p["bias"], input_nonneg=False)
        else:
            r = rule(r, x, p["kernel"], p["bias"])
    return r


def vgg_lrp_preset_a(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                     until: str = "block5_conv3", arch: str = "vgg16") -> torch.Tensor:
    """LRPSequentialPresetA, one seed per image, f32.

    image: (B, H, W, 3) preprocessed; relevance_seed: (B, h, w, C) at
    ``until``. Returns the input-space relevance (B, H, W, 3)."""
    _, inputs = vgg_apply_with_acts(params, image, until, arch)
    return _backward(params, inputs, relevance_seed, until, conv_rule, arch)


def vgg_lrp_preset_a_wordbatched(params, image: torch.Tensor, relevance_seeds: torch.Tensor,
                                 until: str = "block5_conv3",
                                 storage_dtype: torch.dtype | None = None,
                                 arch: str = "vgg16") -> torch.Tensor:
    """Per-word LRP with the forward pass shared across words.

    image: (1, H, W, 3); relevance_seeds: (W, h, w, C) — one seed per caption
    word, the words as the batch. The forward activations are computed once
    (batch 1) and broadcast against the W relevances. Returns (W, H, W, 3).

    ``storage_dtype=torch.bfloat16`` holds params, activations and
    relevances in bf16: the forward runs once in bf16, the post-ReLU convs
    take ``lrp_a1b0_fused`` and the result comes back in f32."""
    if storage_dtype is None:
        _, inputs = vgg_apply_with_acts(params, image, until, arch)
        return _backward(params, inputs, relevance_seeds, until, conv_rule, arch)
    params = tree_to(params, dtype=storage_dtype)
    _, inputs = vgg_apply_with_acts(params, image.to(storage_dtype), until, arch)
    r = _backward(params, inputs, relevance_seeds.to(storage_dtype), until, lrp_a1b0_fused, arch)
    return r.float()


def vgg_lrp_per_image(params, images: torch.Tensor, r_feat: torch.Tensor,
                      until: str = "block5_conv3",
                      storage_dtype: torch.dtype | None = None,
                      arch: str = "vgg16") -> torch.Tensor:
    """``vgg_lrp_preset_a_wordbatched`` for each of B images: images (B, H,
    W, 3), r_feat (B, Tw, L, D) the feature-grid relevance of Tw words an
    image (L = h * w, a square grid) -> heatmaps (B, Tw, H, W, 3)."""
    B, Tw, L, D = r_feat.shape
    g = math.isqrt(L)
    seeds = r_feat.reshape(B, Tw, g, g, D)
    # cast once per batch; the per-image cast then returns these tensors as they are
    params = tree_to(params, dtype=storage_dtype)
    return torch.stack([vgg_lrp_preset_a_wordbatched(params, images[b:b + 1], seeds[b], until,
                                                     storage_dtype, arch) for b in range(B)])


def vgg_deep_taylor(params, image: torch.Tensor, relevance_seeds: torch.Tensor,
                    until: str = "block5_conv3", arch: str = "vgg16") -> torch.Tensor:
    """DeepTaylor decomposition (reference: innvestigate/analyzer/deeptaylor.py:38-153).

    Rule wiring per the reference's conditional mappings: kernel layers with
    ReLU -> Alpha1Beta0 (deeptaylor.py:56-61), max-pooling -> gradient/WTA
    (deeptaylor.py:85-89). Every conv in the tapped VGG stack carries a ReLU,
    so the walk is alpha1beta0 throughout (``conv_rule``: K3 on the
    post-ReLU convs, the plain split rule on the image layer). The
    reference's ``_prepare_model`` clamps the model outputs through a ReLU
    so only positive relevance enters (deeptaylor.py:144-153); with a seeded
    walk that is a ReLU on the seed.

    image: (1 or B, H, W, 3); relevance_seeds: (B, h, w, C), one seed per
    image or, against a single image, one per word (the words as the batch,
    the forward run once). Returns (B, H, W, 3)."""
    _, inputs = vgg_apply_with_acts(params, image, until, arch)
    return _backward(params, inputs, torch.relu(relevance_seeds), until, conv_rule, arch)
