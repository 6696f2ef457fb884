"""The analyzer catalogue: ``create_analyzer`` over the VGG encoders.

The port of the JAX package's ``explain/analyzers.py``, itself the vendored
iNNvestigate's name registry (innvestigate/analyzer/__init__.py:35-99):
``create_analyzer(name, params, **kwargs)`` returns ``analyze(image,
relevance_seed, **kw)`` closed over the VGG params. image (B, H, W, 3),
relevance_seed (B, h, w, C) at ``until`` -> the attribution (B, H, W, 3).

Every reference registry name is covered:

* utility: ``input``, ``random`` (misc.py:33-64);
* gradient family: ``gradient``, ``gradient.baseline`` (the same map here:
  autograd is the built-in gradient), ``input_t_gradient``, ``deconvnet``,
  ``guided_backprop``, ``integrated_gradients``, ``smoothgrad``: the
  ``cnn_gradient.vgg_*`` adapters over ``gradient_maps`` (one image per seed);
* relevance family: ``lrp.z``, ``lrp.z_IB``, ``lrp.epsilon``,
  ``lrp.epsilon_IB``, ``lrp.w_square``, ``lrp.flat``, ``lrp.alpha_beta``,
  ``lrp.alpha_2_beta_1(_IB)``, ``lrp.alpha_1_beta_0(_IB)``, ``lrp.z_plus``,
  ``lrp.z_plus_fast``, ``lrp.sequential_preset_a/b(_flat)``
  (relevance_analyzer.py:173-770). Every alpha-beta walk reaches K3 on its
  post-ReLU f32 convs through ``cnn_lrp.conv_rule``;
* deep taylor: ``deep_taylor``, ``deep_taylor.bounded`` (deeptaylor.py);
* deeplift: ``deep_lift``, and ``deep_lift.wrapper`` on the same rescale
  rule (the reference's wrapper calls the ``deeplift`` package with it,
  deeplift.py:257-366);
* pattern based: ``pattern.net``, ``pattern.attribution``
  (pattern_based.py), which take ``patterns=`` from
  ``patterns.compute_vgg_patterns``.

Random draws (``random``, ``smoothgrad``, ``gaussian_smoother``) come from a
``torch.Generator`` (``generator=``), or ready-made as ``noise=``.

The wrappers of analyzer/wrapper.py lift any analyzer: ``augment_reduce``
(AugmentReduceBase), ``gaussian_smoother`` (GaussianSmoother) and
``path_integrator`` (PathIntegrator).
"""

from __future__ import annotations

import functools

import torch

from ..ops.lrp_conv import check_alpha_beta, lrp_conv_flat, lrp_conv_wsquare
from .cnn_deeplift import vgg_deeplift
from .cnn_gradient import (normal_like, vgg_deconvnet, vgg_gradient, vgg_guided_backprop,
                           vgg_input_times_gradient, vgg_integrated_gradients, vgg_smoothgrad)
from .cnn_lrp import (alpha_beta_rules, vgg_deep_taylor, vgg_deep_taylor_bounded,
                      vgg_lrp_epsilon, vgg_lrp_preset_a, vgg_lrp_preset_a_flat,
                      vgg_lrp_preset_b, vgg_lrp_preset_b_flat, vgg_lrp_walk)
from .patterns import vgg_pattern_attribution, vgg_patternnet

# K.epsilon(): the ZRule's SafeDivide fuzz and LRPEpsilon's default epsilon
# (relevance_rule.py:74-98, relevance_analyzer.py:438-450)
_K_EPSILON = 1e-7


def vgg_lrp_alpha_beta(params, image: torch.Tensor, relevance_seed: torch.Tensor, alpha: float,
                       beta: float, bias: bool = True, arch: str = "vgg16",
                       until: str = "block5_conv3") -> torch.Tensor:
    """LRPAlphaBeta at any (alpha, beta), alpha - beta = 1, on every conv
    (relevance_analyzer.py:528-560); the ``*_IB`` names pass bias=False."""
    check_alpha_beta(alpha, beta)
    rule, input_rule = alpha_beta_rules(alpha, beta, bias)
    return vgg_lrp_walk(params, image, relevance_seed, rule, arch, until, input_rule)


def _analyzer_input(params, image, relevance_seed, **kw):
    """The analysis is the input itself (misc.py:33-38)."""
    return image


def _analyzer_random(params, image, relevance_seed, generator=None, stddev: float = 1.0,
                     noise=None, **kw):
    """Input-shaped Gaussian noise (misc.py:41-52); ``noise`` a standard
    normal draw of the image's shape."""
    return stddev * (normal_like(image.shape, image, generator) if noise is None else noise)


def _eps_rule(bias: bool):
    def analyze(params, image, relevance_seed, epsilon: float = _K_EPSILON, **kw):
        return vgg_lrp_epsilon(params, image, relevance_seed, eps=epsilon, bias=bias, **kw)

    return analyze


def _one_rule(conv_rule):
    """One rule of (r, x, kernel) on every conv, the image layer included."""
    def rule(r, x, kernel, bias):
        return conv_rule(r, x, kernel)

    def analyze(params, image, relevance_seed, arch="vgg16", until="block5_conv3"):
        return vgg_lrp_walk(params, image, relevance_seed, rule, arch, until, input_rule=rule)

    return analyze


def _pattern(fn):
    def analyze(params, image, relevance_seed, patterns=None, **kw):
        return fn(params, patterns, image, relevance_seed, **kw)

    return analyze


_REGISTRY = {
    # utility
    "input": _analyzer_input,
    "random": _analyzer_random,
    # gradient based
    "gradient": vgg_gradient,
    "gradient.baseline": vgg_gradient,
    "input_t_gradient": vgg_input_times_gradient,
    "deconvnet": vgg_deconvnet,
    "guided_backprop": vgg_guided_backprop,
    "integrated_gradients": vgg_integrated_gradients,
    "smoothgrad": vgg_smoothgrad,
    # relevance based: lrp.z is LRPEpsilon at K.epsilon() (relevance_analyzer.py:438-450)
    "lrp.z": _eps_rule(bias=True),
    "lrp.z_IB": _eps_rule(bias=False),
    "lrp.epsilon": _eps_rule(bias=True),
    "lrp.epsilon_IB": _eps_rule(bias=False),
    "lrp.w_square": _one_rule(lrp_conv_wsquare),
    "lrp.flat": _one_rule(lrp_conv_flat),
    "lrp.alpha_beta": vgg_lrp_alpha_beta,
    "lrp.alpha_2_beta_1": functools.partial(vgg_lrp_alpha_beta, alpha=2.0, beta=1.0),
    "lrp.alpha_2_beta_1_IB": functools.partial(vgg_lrp_alpha_beta, alpha=2.0, beta=1.0,
                                               bias=False),
    "lrp.alpha_1_beta_0": functools.partial(vgg_lrp_alpha_beta, alpha=1.0, beta=0.0),
    "lrp.alpha_1_beta_0_IB": functools.partial(vgg_lrp_alpha_beta, alpha=1.0, beta=0.0,
                                               bias=False),
    # ZPlus == alpha1beta0 (relevance_rule.py:445-448); the "fast" variant is
    # the same rule, which K3 already computes on W+ alone for x >= 0
    "lrp.z_plus": functools.partial(vgg_lrp_alpha_beta, alpha=1.0, beta=0.0),
    "lrp.z_plus_fast": functools.partial(vgg_lrp_alpha_beta, alpha=1.0, beta=0.0),
    "lrp.sequential_preset_a": vgg_lrp_preset_a,
    "lrp.sequential_preset_b": vgg_lrp_preset_b,
    "lrp.sequential_preset_a_flat": vgg_lrp_preset_a_flat,
    "lrp.sequential_preset_b_flat": vgg_lrp_preset_b_flat,
    # deep Taylor
    "deep_taylor": vgg_deep_taylor,
    "deep_taylor.bounded": vgg_deep_taylor_bounded,
    # DeepLIFT
    "deep_lift": vgg_deeplift,
    "deep_lift.wrapper": vgg_deeplift,
    # pattern based
    "pattern.net": _pattern(vgg_patternnet),
    "pattern.attribution": _pattern(vgg_pattern_attribution),
}


def analyzer_names():
    return sorted(_REGISTRY)


def create_analyzer(name: str, params, **fixed_kwargs):
    """Address an analyzer by name (analyzer/__init__.py:88-99): returns
    ``analyze(image, relevance_seed, **kw)`` closed over ``params`` and
    ``fixed_kwargs`` (``until=``, ``arch=``, the analyzer's own options)."""
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"Unknown analyzer {name!r}; available: {analyzer_names()}") from None

    def analyze(image, relevance_seed, **kwargs):
        return fn(params, image, relevance_seed, **{**fixed_kwargs, **kwargs})

    analyze.analyzer_name = name
    return analyze


# --- the wrapper analyzers (analyzer/wrapper.py) ---


def augment_reduce(analyze_fn, image, relevance_seed, augment_fn, n: int, reduce="mean"):
    """AugmentReduceBase (wrapper.py:78-166): the analyzer on ``n`` copies
    ``augment_fn(image, i)``, reduced over the copies: "mean", "sum",
    "stack" (the (n, ...) maps as they are) or a callable of (maps, dim)."""
    stacked = torch.stack([analyze_fn(augment_fn(image, i), relevance_seed) for i in range(n)])
    if callable(reduce):
        return reduce(stacked, 0)
    if reduce == "mean":
        return stacked.mean(0)
    if reduce == "sum":
        return stacked.sum(0)
    if reduce == "stack":
        return stacked
    raise ValueError(f"reduce must be 'mean', 'sum', 'stack' or callable, got {reduce!r}")


def gaussian_smoother(analyze_fn, image, relevance_seed, generator=None,
                      noise_scale: float = 1.0, n: int = 16, *, noise=None):
    """GaussianSmoother (SmoothGrad over any analyzer): the mean of the
    analyses of ``image + noise_scale * N(0, 1)`` over ``n`` draws, drawn
    from ``generator`` or given as ``noise`` (n, *image.shape)."""
    if noise is None:
        noise = normal_like((n, *image.shape), image, generator)

    def aug(img, i):
        return img + noise_scale * noise[i]

    return augment_reduce(analyze_fn, image, relevance_seed, aug, n)


def path_integrator(analyze_fn, image, relevance_seed, steps: int = 16, reference_inputs=0.0):
    """PathIntegrator (IntegratedGradients over any analyzer): the mean
    analysis at the midpoints of ``steps`` segments of the straight path
    from ``reference_inputs`` to the image, times (image - reference).
    ``path_integrator(gradient) == integrated_gradients``."""
    ref = torch.as_tensor(reference_inputs, dtype=image.dtype,
                          device=image.device).expand(image.shape)
    maps = [analyze_fn(ref + (k + 0.5) / steps * (image - ref), relevance_seed)
            for k in range(steps)]
    return (image - ref) * torch.stack(maps).mean(0)
