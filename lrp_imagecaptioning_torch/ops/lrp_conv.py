"""LRP rules for the conv / pool layers, NHWC activations, HWIO kernels.

* ``conv2d`` / ``conv2d_input_vjp`` — a conv of any kernel, stride and
  padding ("VALID", or "SAME" as TensorFlow pads it where that padding is
  symmetric: every conv of the ported encoders), and its transpose;
  ``compute_dtype`` rounds both operands to it (bf16) and sums in f32.
* ``lrp_conv_alpha_beta`` — iNNvestigate's AlphaBetaRule (relevance_rule.py:
  216-322): inputs and weights split by sign, the bias split by sign too,
  zero denominators replaced via SafeDivide, ``alpha * activator - beta *
  inhibitor``.
* ``lrp_conv_epsilon`` (EpsilonRule), ``lrp_conv_flat`` (FlatRule),
  ``lrp_conv_zplus`` (ZPlusRule, alpha1beta0 on every input) and
  ``lrp_conv_bounded`` (the zB rule of an input layer of bounded range).
* ``lrp_conv_wsquare`` — the WSquareRule (relevance_rule.py:156-183) that
  DeepTaylor takes on ResNet's and Inception's convs.
* ``deeplift_conv_linear`` / ``deeplift_relu_rescale`` — DeepLIFT's
  LinearRule and RescaleRule (deeplift.py:44-116).
* ``lrp_maxpool_wta`` / ``lrp_maxpool_overlapping_wta`` — max pooling
  reversed by winner-take-all, with ties splitting the relevance equally
  (the reduce-max VJP of the reference). ``torch.max_pool2d``'s backward
  gives a tie's relevance to one index, so it is not used.
* ``avgpool2d`` / ``lrp_avgpool`` — average pooling (Inception's pools
  divide by the count of in-image taps) and its z-rule.

A tensor with batch 1 broadcasts against one with batch N (the forward
activations shared by every word seed of the word-batched explanation).
Every op keeps the dtype of its inputs: under the CNN LRP's bf16 storage
each conv, divide and WTA split rounds to bf16, as the JAX package's ops do.
"""

from __future__ import annotations

import numbers

import torch
import torch.nn.functional as F

from .lrp_core import EPS_KERAS, safe_divide, sign_stabilizer


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(3, 2, 0, 1)


def _pads(size: int, k: int, stride: int, padding: str) -> tuple[int, int]:
    """(before, after) zero padding of one axis, as TensorFlow pads it."""
    if padding == "VALID":
        return 0, 0
    if padding != "SAME":
        raise ValueError(f"padding {padding!r} not in ('SAME', 'VALID')")
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _window_pads(shape, kh: int, kw: int, stride: int, padding: str) -> tuple[int, int]:
    """The (rows, cols) padding on each side of an NHWC tensor of ``shape``."""
    (t, b), (l, r) = _pads(shape[1], kh, stride, padding), _pads(shape[2], kw, stride, padding)
    if t != b or l != r:
        raise ValueError(f"asymmetric SAME padding ({t}, {b}, {l}, {r}) for a {kh}x{kw}/{stride} "
                         f"window over {tuple(shape[1:3])}")
    return t, l


def _output_padding(x_shape, out_shape, kh: int, kw: int, stride: int, pad) -> tuple[int, int]:
    """The rows and columns of the padded input that no output window reaches
    (fewer than the stride): what a transposed conv must add to give back
    the input's shape (ResNet's conv1, 7x7/2 over 230 -> 112 -> 230)."""
    return (x_shape[1] + 2 * pad[0] - ((out_shape[1] - 1) * stride + kh),
            x_shape[2] + 2 * pad[1] - ((out_shape[2] - 1) * stride + kw))


def _rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``t`` rounded to ``compute_dtype`` and held in f32: a product of two
    bf16 values is exact in f32, so an f32 conv of rounded operands is a
    bf16 conv that accumulates in f32 (XLA's ``preferred_element_type``)."""
    return t.to(compute_dtype).float()


def check_alpha_beta(alpha, beta) -> None:
    """Raise ``TypeError`` unless alpha and beta are numbers (not a bool, a
    string or a tensor): they follow the bias in the JAX package's order."""
    for name, v in (("alpha", alpha), ("beta", beta)):
        if isinstance(v, bool) or not isinstance(v, numbers.Real):
            raise TypeError(f"{name} must be a real number, got {v!r} (the order is "
                            "(r, x, kernel, bias, alpha, beta, stride, padding, ...))")


def conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
           padding: str = "SAME", compute_dtype=None) -> torch.Tensor:
    """NHWC input, HWIO kernel -> NHWC output. ``compute_dtype``
    (``torch.bfloat16``) rounds both operands to it and returns the f32 sums,
    unrounded."""
    if compute_dtype is not None:
        x, kernel = _rounded(x, compute_dtype), _rounded(kernel, compute_dtype)
    pad = _window_pads(x.shape, *kernel.shape[:2], stride, padding)
    return _nhwc(F.conv2d(_nchw(x), _oihw(kernel), stride=stride, padding=pad))


def conv2d_input_vjp(x_shape, kernel: torch.Tensor, cotangent: torch.Tensor, stride: int = 1,
                     padding: str = "SAME", compute_dtype=None) -> torch.Tensor:
    """Gradient of ``conv2d(x, kernel, stride, padding)`` wrt its input x for
    ``cotangent`` (the transposed conv), NHWC. ``x_shape`` (its batch is not
    read) gives x's height and width; None takes the cotangent's, which a
    stride-1 SAME conv keeps. ``compute_dtype`` rounds both operands to it,
    sums in f32 and rounds the result to it once, returned in f32: the JAX
    package's VJP of a conv in that dtype."""
    if isinstance(x_shape, torch.Tensor) or not isinstance(cotangent, torch.Tensor):
        raise TypeError("conv2d_input_vjp(x_shape, kernel, cotangent, ...): x_shape is a "
                        f"shape, cotangent a tensor; got {type(x_shape).__name__}, "
                        f"{type(cotangent).__name__}")
    kh, kw = kernel.shape[:2]
    if x_shape is None:
        if stride != 1 or padding != "SAME":
            raise ValueError("conv2d_input_vjp: a strided or VALID conv needs x_shape")
        x_shape = cotangent.shape
    if compute_dtype is not None:
        kernel, cotangent = _rounded(kernel, compute_dtype), _rounded(cotangent, compute_dtype)
    pad = _window_pads(x_shape, kh, kw, stride, padding)
    dx = _nhwc(F.conv_transpose2d(
        _nchw(cotangent), _oihw(kernel), stride=stride, padding=pad,
        output_padding=_output_padding(x_shape, cotangent.shape, kh, kw, stride, pad)))
    return dx if compute_dtype is None else _rounded(dx, compute_dtype)


def lrp_conv_epsilon(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor | None = None, eps: float = EPS_KERAS,
                     stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """EpsilonRule (relevance_rule.py:113-144): x * conv^T(r / stab(z), W)
    with z = conv(x, W) (+ bias) and the sign-aligned stabilizer of ``eps``.
    ``bias=None`` is the rule with bias=False."""
    z = conv2d(x, kernel, stride, padding)
    if bias is not None:
        z = z + bias
    s = r / sign_stabilizer(z, eps)
    return x * conv2d_input_vjp(x.shape, kernel, s, stride, padding)


def lrp_conv_alpha_beta(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor | None, alpha: float = 1.0, beta: float = 0.0,
                        stride: int = 1, padding: str = "SAME", factor: float = EPS_KERAS,
                        compute_dtype=None, *, input_nonneg: bool = False) -> torch.Tensor:
    """AlphaBetaRule (alpha - beta = 1): the activator pairs (x+, W+, b+) with
    (x-, W-, b-), the inhibitor (x+, W-, b-) with (x-, W+, b+); the result is
    ``alpha * activator - beta * inhibitor``, the inhibitor skipped where
    beta = 0 (relevance_rule.py:313-322). SafeDivide replaces a zero
    denominator by ``factor``.

    ``input_nonneg=True`` declares x >= 0 (every post-ReLU activation):
    the x- convs are elided, and z still adds the FULL bias b+ + b- in both
    terms. ``compute_dtype=torch.bfloat16`` runs the convs on bf16 operands
    with f32 sums (``conv2d``); the divides and re-weights stay f32.
    """
    check_alpha_beta(alpha, beta)
    kp = kernel * (kernel >= 0)
    kn = kernel * (kernel < 0)
    bp = bn = None
    if bias is not None:
        bp = bias * (bias >= 0)
        bn = bias * (bias < 0)
    xp = x if input_nonneg else torch.clamp(x, min=0)
    xn = None if input_nonneg else torch.clamp(x, max=0)

    def term(k1, b1, k2, b2):
        """(x+, k1, b1) and (x-, k2, b2) share one denominator."""
        z = conv2d(xp, k1, stride, padding, compute_dtype)
        if b1 is not None:
            z = z + b1
        if xn is not None:
            z2 = conv2d(xn, k2, stride, padding, compute_dtype)
            if b2 is not None:
                z2 = z2 + b2
            z = z + z2
        elif b2 is not None:
            z = z + b2
        s = safe_divide(r, z, factor)
        out = xp * conv2d_input_vjp(x.shape, k1, s, stride, padding, compute_dtype)
        if xn is not None:
            out = out + xn * conv2d_input_vjp(x.shape, k2, s, stride, padding, compute_dtype)
        return out

    activator = term(kp, bp, kn, bn)
    if beta:
        return alpha * activator - beta * term(kn, bn, kp, bp)
    return alpha * activator if alpha != 1.0 else activator


def lrp_conv_zplus(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor | None = None, stride: int = 1,
                   padding: str = "SAME") -> torch.Tensor:
    """ZPlusRule == AlphaBetaRule(alpha=1, beta=0) (relevance_rule.py:445-462)."""
    return lrp_conv_alpha_beta(r, x, kernel, bias, 1.0, 0.0, stride, padding)


def lrp_conv_flat(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                  padding: str = "SAME", factor: float = EPS_KERAS) -> torch.Tensor:
    """FlatRule (relevance_rule.py:186-211): every weight one, over an input
    of ones, so the relevance spreads evenly over the receptive field."""
    k1 = torch.ones_like(kernel)
    z = conv2d(torch.ones_like(x[:1]), k1, stride, padding)
    return conv2d_input_vjp(x.shape, k1, safe_divide(r, z, factor), stride, padding)


def lrp_conv_bounded(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor, low: float,
                     high: float, stride: int = 1, padding: str = "SAME",
                     factor: float = EPS_KERAS) -> torch.Tensor:
    """BoundedRule, the zB rule of an input layer (relevance_rule.py:372-441):
    z = conv(x, W) - conv(lo, W+) - conv(hi, W-), then
    x * c - lo * c+ - hi * c- with c = conv^T(r / z, .) for W, W+ and W-;
    ``low`` / ``high`` bound the input's values."""
    kp = kernel * (kernel >= 0)
    kn = kernel * (kernel < 0)
    lo = torch.full_like(x, low)
    hi = torch.full_like(x, high)
    z = conv2d(x, kernel, stride, padding) - conv2d(lo, kp, stride, padding) \
        - conv2d(hi, kn, stride, padding)
    s = safe_divide(r, z, factor)
    c = conv2d_input_vjp(x.shape, kernel, s, stride, padding)
    cp = conv2d_input_vjp(x.shape, kp, s, stride, padding)
    cn = conv2d_input_vjp(x.shape, kn, s, stride, padding)
    return x * c - lo * cp - hi * cn


def lrp_conv_wsquare(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                     padding: str = "SAME", factor: float = EPS_KERAS) -> torch.Tensor:
    """WSquareRule: the weights squared over an input of ones, so the
    relevance spreads by squared-weight share, whatever x holds (only its
    shape is read)."""
    k2 = kernel * kernel
    z = conv2d(torch.ones_like(x[:1]), k2, stride, padding)
    return conv2d_input_vjp(x.shape, k2, safe_divide(r, z, factor), stride, padding)


def deeplift_conv_linear(r: torch.Tensor, x: torch.Tensor, x_ref: torch.Tensor,
                         z: torch.Tensor, z_ref: torch.Tensor, kernel: torch.Tensor,
                         stride: int = 1, padding: str = "SAME",
                         approximate: bool = True, factor: float = EPS_KERAS) -> torch.Tensor:
    """DeepLIFT LinearRule for a bias-free conv (deeplift.py:77-116): the
    relevance over the output difference (SafeDivide by ``factor``), back
    through the conv's transpose, times the input difference; where |Δx| <
    ``factor`` the plain gradient takes over (``approximate``, the
    reference's default)."""
    dx = x - x_ref
    s = safe_divide(r, z - z_ref, factor)
    contrib = dx * conv2d_input_vjp(x.shape, kernel, s, stride, padding)
    if not approximate:
        return contrib
    grad = conv2d_input_vjp(x.shape, kernel, r, stride, padding)
    return torch.where(dx.abs() < factor, grad, contrib)


def deeplift_relu_rescale(r: torch.Tensor, x: torch.Tensor, x_ref: torch.Tensor,
                          approximate: bool = True, factor: float = EPS_KERAS) -> torch.Tensor:
    """DeepLIFT RescaleRule for a standalone ReLU (deeplift.py:44-73): the
    relevance scaled by Δy/Δx, the ReLU's gradient where |Δx| < ``factor``.
    The other branch is the reference's unstabilised ``r Δy / (Δx + factor)``."""
    dx = x - x_ref
    dy = torch.relu(x) - torch.relu(x_ref)
    if not approximate:
        return r * dy / (dx + factor)
    small = dx.abs() < factor
    resc = r * dy / torch.where(small, torch.ones_like(dx), dx)
    grad = torch.where(x > 0, r, torch.zeros_like(r))
    return torch.where(small, grad, resc)


def _windows(x: torch.Tensor, window: int) -> torch.Tensor:
    B, H, W, C = x.shape
    if H % window or W % window:
        raise ValueError(f"non-overlapping pool needs H, W divisible by {window}, got {H}x{W}")
    return x.reshape(B, H // window, window, W // window, window, C)


def _tiles(x: torch.Tensor, window: int, stride: int) -> bool:
    """True where the pool's windows tile x exactly (window == stride)."""
    return stride == window and x.shape[1] % window == 0 \
        and x.shape[2] % window == 0


def maxpool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max pool, NHWC (every max pool of the ported encoders is VALID)."""
    if _tiles(x, window, stride):
        return _windows(x, window).amax(dim=(2, 4))
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def lrp_maxpool_wta(r: torch.Tensor, x: torch.Tensor, window: int = 2,
                    stride: int = 2) -> torch.Tensor:
    """Winner-take-all relevance through a VALID max pool.

    Each output's relevance divides equally among the window entries equal
    to the max: dx = [x == max] * (r / count). Windows that do not tile x
    (``stride != window``, or a remainder row) take the overlapping rule."""
    if not _tiles(x, window, stride):
        return lrp_maxpool_overlapping_wta(r, x, window, stride)
    xw = _windows(x, window)
    y = xw.amax(dim=(2, 4), keepdim=True)
    mask = (xw == y).to(r.dtype)
    count = mask.sum(dim=(2, 4), keepdim=True)
    B, Ho, Wo, C = r.shape
    rw = r.reshape(B, Ho, 1, Wo, 1, C)
    dx = mask * (rw / count)
    return dx.reshape(dx.shape[0], Ho * window, Wo * window, C)


def lrp_maxpool_overlapping_wta(r: torch.Tensor, x: torch.Tensor, window: int = 3,
                                stride: int = 2, padding: str = "VALID") -> torch.Tensor:
    """Winner-take-all relevance through an overlapping max pool (ResNet's
    stem, Inception's reductions): each output's relevance divides equally
    among the window entries equal to the max, and an input sums what every
    window covering it hands back. window x window strided taps. ``padding``
    "SAME" pads x with -inf as TensorFlow pads it (the pads never win)."""
    if padding == "SAME":
        (t, b), (l, rt) = (_pads(x.shape[1], window, stride, padding),
                           _pads(x.shape[2], window, stride, padding))
        xp = F.pad(x, (0, 0, l, rt, t, b), value=float("-inf"))
        out = lrp_maxpool_overlapping_wta(r, xp, window, stride)
        return out[:, t:t + x.shape[1], l:l + x.shape[2]]
    if padding != "VALID":
        raise ValueError(f"padding {padding!r} not in ('SAME', 'VALID')")
    B, H, W, C = x.shape
    Ho, Wo = (H - window) // stride + 1, (W - window) // stride + 1
    y = maxpool2d(x, window, stride)
    hs, ws = (Ho - 1) * stride + 1, (Wo - 1) * stride + 1

    def tap(dy, dx):
        return x[:, dy:dy + hs:stride, dx:dx + ws:stride]

    ties = torch.zeros_like(y)
    for dy in range(window):
        for dx in range(window):
            ties = ties + (tap(dy, dx) == y).to(y.dtype)
    r_scaled = r / ties
    out = torch.zeros((r.shape[0], H, W, C), dtype=r.dtype, device=r.device)
    for dy in range(window):
        for dx in range(window):
            out[:, dy:dy + hs:stride, dx:dx + ws:stride] += \
                torch.where(tap(dy, dx) == y, r_scaled, torch.zeros_like(r_scaled))
    return out


def avgpool2d(x: torch.Tensor, window: int = 2, stride: int = 2, *,
              padding: str = "VALID") -> torch.Tensor:
    """Average pool, NHWC, each output over its in-image taps only (Keras's
    SAME average pool: ``count_include_pad=False``)."""
    if _tiles(x, window, stride) and padding == "VALID":
        return _windows(x, window).mean(dim=(2, 4))
    pad = _window_pads(x.shape, window, window, stride, padding)
    # an NCHW copy: on the card, avg_pool2d's backward over a channels-last
    # view (what _nchw gives) returns a wrong gradient
    return _nhwc(F.avg_pool2d(_nchw(x).contiguous(), window, stride, padding=pad,
                              count_include_pad=False))


def avgpool2d_input_vjp(cotangent: torch.Tensor, x_shape, window: int = 2,
                        stride: int = 2, padding: str = "VALID") -> torch.Tensor:
    """Gradient of ``avgpool2d(x, window, stride, padding)`` wrt x for
    ``cotangent``: each output's share (cotangent / its in-image tap count)
    handed back to its taps, a depthwise transposed conv of ones."""
    C = cotangent.shape[-1]
    pad = _window_pads(x_shape, window, window, stride, padding)
    ones = torch.ones((1, 1, x_shape[1], x_shape[2]), dtype=cotangent.dtype,
                      device=cotangent.device)
    counts = F.avg_pool2d(ones, window, stride, padding=pad, divisor_override=1)
    taps = torch.ones((C, 1, window, window), dtype=cotangent.dtype, device=cotangent.device)
    return _nhwc(F.conv_transpose2d(
        _nchw(cotangent) / counts, taps, stride=stride, padding=pad, groups=C,
        output_padding=_output_padding(x_shape, cotangent.shape, window, window, stride, pad)))


def lrp_avgpool(r: torch.Tensor, x: torch.Tensor, window: int = 2, stride: int = 2,
                eps: float = EPS_KERAS, *, padding: str = "VALID") -> torch.Tensor:
    """AveragePoolingReverseLayer (relevance_analyzer.py:262-291): the pool
    as a linear layer under the z-rule, x * pool^T(r / stab(z)), stab's
    stabilizer ``eps``."""
    z = avgpool2d(x, window, stride, padding=padding)
    s = safe_divide(r, sign_stabilizer(z, eps))
    return x * avgpool2d_input_vjp(s, x.shape, window, stride, padding)
