"""CNN-side LRP: LRPSequentialPresetA over the VGG conv stack.

The relevance seed is injected at the tapped layer (the decoder LRP's
feature-grid relevance) and propagated back to the input image: alpha1beta0
on every conv, winner-take-all on every pool, ReLU passes relevance through.
The 12 convs whose input is post-ReLU (x >= 0) go through the fused
``lrp_conv_a1b0`` kernel pair; the signed input layer takes the plain
``lrp_conv_alpha_beta``.
"""

from __future__ import annotations

import torch

from ..models.vgg import vgg_apply_with_acts, vgg_layers
from ..ops.kernels import lrp_conv_a1b0
from ..ops.lrp_conv import lrp_conv_alpha_beta, lrp_maxpool_wta


def vgg_lrp_preset_a_wordbatched(params, image: torch.Tensor, relevance_seeds: torch.Tensor,
                                 until: str = "block5_conv3") -> torch.Tensor:
    """Per-word LRP with the forward pass shared across words.

    image: (1, H, W, 3); relevance_seeds: (W, h, w, C) — one seed per caption
    word, the words as the batch. The forward activations are computed once
    (batch 1) and broadcast against the W relevances. Returns (W, H, W, 3)."""
    ops = vgg_layers(until)
    _, inputs = vgg_apply_with_acts(params, image, until)
    r = relevance_seeds
    for idx, (op, x) in enumerate(zip(reversed(ops), reversed(inputs))):
        if op[0] == "pool":
            r = lrp_maxpool_wta(r, x)
            continue
        p = params[op[1]]
        if idx == len(ops) - 1:  # the image layer: x is signed
            r = lrp_conv_alpha_beta(r, x, p["kernel"], p["bias"])
        else:
            r = lrp_conv_a1b0(r, x, p["kernel"], p["bias"])
    return r
