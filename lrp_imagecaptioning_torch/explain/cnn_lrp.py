"""CNN-side LRP: LRPSequentialPresetA over the VGG conv stack.

The relevance seed is injected at the tapped layer (the decoder LRP's
feature-grid relevance) and propagated back to the input image: alpha1beta0
on every conv, winner-take-all on every pool, ReLU passes relevance through.
The 12 convs whose input is post-ReLU (x >= 0) go through a kernel: in f32
the ``lrp_conv_a1b0`` pair, in bf16 storage the one-launch
``lrp_a1b0_fused``. The signed input layer takes the plain
``lrp_conv_alpha_beta``.
"""

from __future__ import annotations

import math

import torch

from ..models.vgg import vgg_apply_with_acts, vgg_layers
from ..ops.kernels import lrp_a1b0_fused, lrp_conv_a1b0
from ..ops.lrp_conv import lrp_conv_alpha_beta, lrp_maxpool_wta
from ..weights import tree_to


def _backward(params, inputs, r: torch.Tensor, until: str, conv_rule) -> torch.Tensor:
    """Walk vgg_layers(until) in reverse: ``conv_rule`` on the post-ReLU convs,
    the alpha1beta0 split rule on the image layer, WTA on the pools."""
    ops = vgg_layers(until)
    for idx, (op, x) in enumerate(zip(reversed(ops), reversed(inputs))):
        if op[0] == "pool":
            r = lrp_maxpool_wta(r, x)
            continue
        p = params[op[1]]
        if idx == len(ops) - 1:  # the image layer: x is signed
            r = lrp_conv_alpha_beta(r, x, p["kernel"], p["bias"])
        else:
            r = conv_rule(r, x, p["kernel"], p["bias"])
    return r


def vgg_lrp_preset_a(params, image: torch.Tensor, relevance_seed: torch.Tensor,
                     until: str = "block5_conv3") -> torch.Tensor:
    """LRPSequentialPresetA, one seed per image, f32.

    image: (B, H, W, 3) preprocessed; relevance_seed: (B, h, w, C) at
    ``until``. Returns the input-space relevance (B, H, W, 3)."""
    _, inputs = vgg_apply_with_acts(params, image, until)
    return _backward(params, inputs, relevance_seed, until, lrp_conv_a1b0)


def vgg_lrp_preset_a_wordbatched(params, image: torch.Tensor, relevance_seeds: torch.Tensor,
                                 until: str = "block5_conv3",
                                 storage_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Per-word LRP with the forward pass shared across words.

    image: (1, H, W, 3); relevance_seeds: (W, h, w, C) — one seed per caption
    word, the words as the batch. The forward activations are computed once
    (batch 1) and broadcast against the W relevances. Returns (W, H, W, 3).

    ``storage_dtype=torch.bfloat16`` holds params, activations and
    relevances in bf16: the forward runs once in bf16, the post-ReLU convs
    take ``lrp_a1b0_fused`` and the result comes back in f32."""
    if storage_dtype is None:
        _, inputs = vgg_apply_with_acts(params, image, until)
        return _backward(params, inputs, relevance_seeds, until, lrp_conv_a1b0)
    params = tree_to(params, dtype=storage_dtype)
    _, inputs = vgg_apply_with_acts(params, image.to(storage_dtype), until)
    r = _backward(params, inputs, relevance_seeds.to(storage_dtype), until, lrp_a1b0_fused)
    return r.float()


def vgg_lrp_per_image(params, images: torch.Tensor, r_feat: torch.Tensor,
                      until: str = "block5_conv3",
                      storage_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``vgg_lrp_preset_a_wordbatched`` for each of B images: images (B, H,
    W, 3), r_feat (B, Tw, L, D) the feature-grid relevance of Tw words an
    image (L = h * w, a square grid) -> heatmaps (B, Tw, H, W, 3)."""
    B, Tw, L, D = r_feat.shape
    g = math.isqrt(L)
    seeds = r_feat.reshape(B, Tw, g, g, D)
    # cast once per batch; the per-image cast then returns these tensors as they are
    params = tree_to(params, dtype=storage_dtype)
    return torch.stack([vgg_lrp_preset_a_wordbatched(params, images[b:b + 1], seeds[b], until,
                                                     storage_dtype) for b in range(B)])
