"""PatternNet / PatternAttribution over the VGG conv stack.

The port of the JAX package's ``explain/patterns.py``: the vendored
``innvestigate/analyzer/pattern_based.py`` and the pattern estimator of
``innvestigate/tools/pattern.py`` as streamed statistics and one backward
walk.

* **Patterns** (tools/pattern.py:220-306, ``LinearPattern``): each conv is a
  dense map over its 3x3 patches; over (masked) samples the f32 sums of x,
  y and x*y give A = cov(x, y) / diag(W^T cov(x, y)) (pattern.py:277-305),
  with the reference's divide a / (b + (b == 0)). y is the conv without its
  bias (``copy_layer_wo_activation(keep_bias=False)``, pattern.py:234-236).
  The mask picks the samples that count for an output unit: ``linear`` all,
  ``relu`` the post-ReLU outputs > 0, ``relu.negative`` those <= 0
  (pattern.py:308-325). The sums stream over batches as the reference's
  ``RunningMeans`` layers do.
* **PatternNet** (pattern_based.py:68-126): per conv, the relevance passes
  the ReLU's gradient at the actual pre-activation, then the transposed conv
  with the pattern A in place of the weights; pools reverse by
  winner-take-all.
* **PatternAttribution** (pattern_based.py:260-280): the same walk with the
  weights A * W.

The statistics' per-tap contractions (``_patch_correlate``) and the walk's
convs run as torch ops (cuDNN and cuBLAS on the card), as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.vgg import vgg_apply_with_acts, vgg_layers
from ..ops.lrp_conv import conv2d, conv2d_input_vjp, lrp_maxpool_wta, maxpool2d

PATTERN_TYPES = ("linear", "relu", "relu.negative")


def _conv_patches_3x3(x: torch.Tensor) -> torch.Tensor:
    """im2col of a 3x3 SAME stride-1 conv in (kh, kw, cin) order, so that
    ``patches @ kernel.reshape(-1, cout) == conv2d(x, kernel)``. The tests'
    oracle: the statistics use ``_patch_correlate``, which builds no
    (B, H, W, 9 cin) tensor."""
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, i:i + H, j:j + W, :] for i in range(3) for j in range(3)], dim=-1)


def _patch_correlate(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``_conv_patches_3x3(x).reshape(-1, 9 cin).T @ m.reshape(-1, cout)`` as
    one (cin, cout) contraction per tap over the padded x -> (9 cin, cout)."""
    H, W, cin = x.shape[1], x.shape[2], x.shape[3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    m2 = m.reshape(-1, m.shape[-1])
    return torch.cat([xp[:, i:i + H, j:j + W, :].reshape(-1, cin).T @ m2
                      for i in range(3) for j in range(3)], dim=0)


def init_pattern_stats(params, arch: str = "vgg16", until: str = "block5_conv3"):
    """Zeroed running sums, one entry per conv (the ``RunningMeans`` state,
    pattern.py:246-266), in the params' dtype (f32 sums, as in the JAX
    package) on their device."""
    stats = {}
    for op in vgg_layers(arch, until):
        if op[0] != "conv":
            continue
        _, name, cin, cout = op
        k = params[name]["kernel"]
        zeros = lambda *shape: torch.zeros(shape, dtype=k.dtype, device=k.device)  # noqa: E731
        stats[name] = {
            "sum_x": zeros(9 * cin, cout),    # sum of x * mask, per unit
            "sum_xy": zeros(9 * cin, cout),   # sum of x * y * mask
            "cnt": zeros(cout),               # sum of mask, per unit
            "sum_y": zeros(cout),             # sum of y over every sample
            "cnt_all": zeros(),               # the samples
        }
    return stats


def update_pattern_stats(stats, params, images: torch.Tensor, pattern_type: str = "linear",
                         arch: str = "vgg16", until: str = "block5_conv3"):
    """One batch of images (B, H, W, 3) added into the running sums
    (``LinearPattern.get_stats_from_batch``, pattern.py:232-275); returns
    the new stats."""
    if pattern_type not in PATTERN_TYPES:
        raise ValueError(f"pattern_type must be one of {PATTERN_TYPES}")
    new = dict(stats)
    x = images
    for op in vgg_layers(arch, until):
        if op[0] != "conv":
            x = maxpool2d(x)
            continue
        name = op[1]
        p = params[name]
        y_nobias = conv2d(x, p["kernel"])
        post = torch.relu(y_nobias + p["bias"])
        if pattern_type == "linear":
            mask = torch.ones_like(post)
        elif pattern_type == "relu":
            mask = (post > 0).to(x.dtype)
        else:
            mask = (post <= 0).to(x.dtype)
        s = stats[name]
        new[name] = {
            "sum_x": s["sum_x"] + _patch_correlate(x, mask),
            "sum_xy": s["sum_xy"] + _patch_correlate(x, y_nobias * mask),
            "cnt": s["cnt"] + mask.sum(dim=(0, 1, 2)),
            "sum_y": s["sum_y"] + y_nobias.sum(dim=(0, 1, 2)),
            "cnt_all": s["cnt_all"] + float(y_nobias.shape[0] * y_nobias.shape[1]
                                            * y_nobias.shape[2]),
        }
        x = post
    return new


def _safe_divide_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The pattern computer's divide, a / (b + (b == 0)) (pattern.py:279-281)."""
    return a / (b + (b == 0).to(b.dtype))


def compute_patterns(stats, params, arch: str = "vgg16", until: str = "block5_conv3"):
    """The sums turned into each conv's pattern A, shaped as its kernel
    (``LinearPattern.compute_pattern``, pattern.py:277-305)."""
    patterns = {}
    for op in vgg_layers(arch, until):
        if op[0] != "conv":
            continue
        name, kernel = op[1], params[op[1]]["kernel"]
        s = stats[name]
        w2d = kernel.reshape(-1, kernel.shape[-1])
        mean_x = _safe_divide_ref(s["sum_x"], s["cnt"][None, :])
        mean_xy = _safe_divide_ref(s["sum_xy"], s["cnt"][None, :])
        mean_y = _safe_divide_ref(s["sum_y"], s["cnt_all"])
        cov_xy = mean_xy - mean_x * mean_y[None, :]
        w_cov_xy = (w2d * cov_xy).sum(dim=0)                # diag(W^T C)
        patterns[name] = _safe_divide_ref(cov_xy, w_cov_xy[None, :]).reshape(kernel.shape)
    return patterns


def compute_vgg_patterns(params, image_batches, pattern_type: str = "linear",
                         arch: str = "vgg16", until: str = "block5_conv3"):
    """Stream ``image_batches`` (an iterable of (B, H, W, 3) arrays or
    tensors) -> {layer name: pattern} (``PatternComputer.compute``,
    pattern.py:452-524). Each batch goes to the params' device."""
    stats = init_pattern_stats(params, arch, until)
    like = next(iter(stats.values()))["cnt"]
    with torch.no_grad():
        for images in image_batches:
            images = torch.as_tensor(images, dtype=like.dtype, device=like.device)
            stats = update_pattern_stats(stats, params, images, pattern_type, arch, until)
        return compute_patterns(stats, params, arch, until)


def _pattern_backward(params, patterns, image, relevance_seed, arch, until, attribution: bool):
    ops = vgg_layers(arch, until)
    _, inputs = vgg_apply_with_acts(params, image, arch, until)
    r = relevance_seed
    for op, x in zip(reversed(ops), reversed(inputs)):
        if op[0] != "conv":
            r = lrp_maxpool_wta(r, x)
            continue
        p = params[op[1]]
        pre = conv2d(x, p["kernel"]) + p["bias"]
        r = r * (pre > 0).to(r.dtype)         # the ReLU's gradient at the actual input
        back = patterns[op[1]] * p["kernel"] if attribution else patterns[op[1]]
        r = conv2d_input_vjp(x.shape, back, r)
    return r


def vgg_patternnet(params, patterns, image: torch.Tensor, relevance_seed: torch.Tensor,
                   arch: str = "vgg16", until: str = "block5_conv3") -> torch.Tensor:
    """PatternNet: the gradient with each kernel replaced by its pattern
    (pattern_based.py:105-126). image (B, H, W, 3), relevance_seed (B, h, w,
    C) -> (B, H, W, 3)."""
    return _pattern_backward(params, patterns, image, relevance_seed, arch, until, False)


def vgg_pattern_attribution(params, patterns, image: torch.Tensor, relevance_seed: torch.Tensor,
                            arch: str = "vgg16", until: str = "block5_conv3") -> torch.Tensor:
    """PatternAttribution: each kernel replaced by pattern * weight
    (pattern_based.py:274-280)."""
    return _pattern_backward(params, patterns, image, relevance_seed, arch, until, True)
