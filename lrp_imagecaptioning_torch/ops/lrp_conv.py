"""LRP rules for the VGG conv / pool layers, NHWC activations, HWIO kernels.

* ``lrp_conv_alpha_beta`` — iNNvestigate's AlphaBetaRule (relevance_rule.py:
  216-322) at alpha = 1, beta = 0, the only setting LRPSequentialPresetA
  uses: inputs and weights split by sign, the bias split by sign too, zero
  denominators replaced via SafeDivide.
* ``lrp_maxpool_wta`` — max pooling reversed by winner-take-all, with ties
  splitting the relevance equally (the reduce-max VJP of the reference).
  ``torch.max_pool2d``'s backward gives a tie's relevance to one index, so it
  is not used.

A tensor with batch 1 broadcasts against one with batch N (the forward
activations shared by every word seed of the word-batched explanation).
Every op keeps the dtype of its inputs: under the CNN LRP's bf16 storage
each conv, divide and WTA split rounds to bf16, as the JAX package's ops do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .lrp_core import safe_divide


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(3, 2, 0, 1)


def _same_pad(kernel: torch.Tensor) -> tuple[int, int]:
    kh, kw = kernel.shape[:2]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME padding needs an odd kernel, got {kh}x{kw}")
    return kh // 2, kw // 2


def conv2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv: NHWC input, HWIO kernel -> NHWC output."""
    return _nhwc(F.conv2d(_nchw(x), _oihw(kernel), padding=_same_pad(kernel)))


def conv2d_input_vjp(kernel: torch.Tensor, cotangent: torch.Tensor) -> torch.Tensor:
    """Gradient of ``conv2d(., kernel)`` wrt its input for ``cotangent``
    (the transposed conv), NHWC."""
    return _nhwc(F.conv_transpose2d(_nchw(cotangent), _oihw(kernel),
                                    padding=_same_pad(kernel)))


def lrp_conv_alpha_beta(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor | None, input_nonneg: bool = False) -> torch.Tensor:
    """AlphaBetaRule with alpha = 1, beta = 0 for a 3x3 SAME conv.

    ``input_nonneg=True`` declares x >= 0 (every post-ReLU VGG activation):
    the x-/W pair of convs is elided, and z still adds the FULL bias b+ + b-.
    """
    kp = kernel * (kernel >= 0)
    kn = kernel * (kernel < 0)
    bp = bn = None
    if bias is not None:
        bp = bias * (bias >= 0)
        bn = bias * (bias < 0)
    xp = x if input_nonneg else torch.clamp(x, min=0)
    xn = None if input_nonneg else torch.clamp(x, max=0)

    # the activator term: (x+, W+, b+) and (x-, W-, b-)
    z = conv2d(xp, kp)
    if bp is not None:
        z = z + bp
    if xn is not None:
        z2 = conv2d(xn, kn)
        if bn is not None:
            z2 = z2 + bn
        z = z + z2
    elif bn is not None:
        z = z + bn
    s = safe_divide(r, z)
    out = xp * conv2d_input_vjp(kp, s)
    if xn is not None:
        out = out + xn * conv2d_input_vjp(kn, s)
    return out


def _windows(x: torch.Tensor, window: int) -> torch.Tensor:
    B, H, W, C = x.shape
    if H % window or W % window:
        raise ValueError(f"non-overlapping pool needs H, W divisible by {window}, got {H}x{W}")
    return x.reshape(B, H // window, window, W // window, window, C)


def maxpool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping max pool (window == stride, every VGG pool), NHWC."""
    return _windows(x, window).amax(dim=(2, 4))


def lrp_maxpool_wta(r: torch.Tensor, x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Winner-take-all relevance through a non-overlapping max pool.

    Each output's relevance divides equally among the window entries equal
    to the max: dx = [x == max] * (r / count)."""
    xw = _windows(x, window)
    y = xw.amax(dim=(2, 4), keepdim=True)
    mask = (xw == y).to(r.dtype)
    count = mask.sum(dim=(2, 4), keepdim=True)
    B, Ho, Wo, C = r.shape
    rw = r.reshape(B, Ho, 1, Wo, 1, C)
    dx = mask * (rw / count)
    return dx.reshape(dx.shape[0], Ho * window, Wo * window, C)
