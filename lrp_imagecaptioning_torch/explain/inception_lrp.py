"""Rule-based explanations through InceptionV3: LRP (PresetA), DeepTaylor and
DeepLIFT, word-batched.

The port of the JAX package's ``explain/inception_lrp.py``: a reverse walk
over the op list of ``models/inception.py``:

* conv (+BN +ReLU): the BatchNorm rule, then alpha1beta0. The 3x3 SAME
  stride-1 convs over post-ReLU inputs (stem3, mixed{0,1,2}_b3x3dbl_2 and
  _3, mixed3_b3x3dbl_2, mixed{9,10}_b3x3dbl_2) take K3
  (``cnn_lrp.conv_rule``); the others the plain generalized rule;
* max pool: winner-take-all, ties split;
* average pool: the z-rule through the pool (AveragePoolingReverseLayer);
* concat: the relevance splits back onto the branches by channel slices,
  each made contiguous before a conv rule takes it.

Words are the batch: the forward runs once per image, its cached tensors
broadcast against the W seeds. DeepTaylor (WSquareRule on every conv) and
DeepLIFT (LinearRule / RescaleRule) launch no K3.
"""

from __future__ import annotations

import torch

from ..models.inception import BN_EPS, CHANNELS, SPEC, bn, pool
from ..ops.lrp_conv import (avgpool2d_input_vjp, conv2d, deeplift_conv_linear,
                            deeplift_relu_rescale, lrp_avgpool, lrp_conv_wsquare,
                            lrp_maxpool_overlapping_wta)
from .cnn_deeplift import reference_image
from .cnn_lrp import conv_rule
from .resnet_lrp import lrp_bn


def _forward_cached(params, image, until="mixed10"):
    """The forward, keeping each op's input (and each conv's pre-BN output
    z and BN output)."""
    tensors, cache = {"input": image}, {}
    for op in SPEC:
        if op[0] == "conv":
            _, name, src, _, _, s, p = op
            z = conv2d(tensors[src], params[name]["kernel"], s, p)
            y = bn(params[name], z)
            cache[name] = {"in": tensors[src], "z": z, "bn": y}
            tensors[name] = torch.relu(y)
        elif op[0] == "pool":
            _, name, src, kind, w, s, p = op
            cache[name] = {"in": tensors[src]}
            tensors[name] = pool(tensors[src], kind, w, s, p)
        else:
            tensors[op[1]] = torch.cat([tensors[s] for s in op[2]], dim=-1)
        if op[1] == until:
            break
    return tensors, cache


def _walk_backward(relevance_seed, until, conv_rev, pool_rev):
    """The reverse walk over SPEC from ``until``: conv_rev(r, op) and
    pool_rev(r, op) return their source's relevance; a concat hands each
    source its channel slice (a contiguous copy)."""
    rel = {until: relevance_seed}
    seen_until = False
    for op in reversed(SPEC):
        name = op[1]
        if not seen_until:
            if name != until:
                continue
            seen_until = True
        r = rel.pop(name, None)
        if r is None:
            continue
        if op[0] == "concat":
            off = 0
            for src in op[2]:
                ch = CHANNELS[src]
                part = r[..., off:off + ch].contiguous()
                rel[src] = rel[src] + part if src in rel else part
                off += ch
            continue
        src = op[2]
        r_src = conv_rev(r, op) if op[0] == "conv" else pool_rev(r, op)
        rel[src] = rel[src] + r_src if src in rel else r_src
    return rel["input"]


def _pool_gradient(cache):
    """The gradient reverse of a pool (DeepTaylor's and DeepLIFT's default
    mapping): WTA for a max pool, the pool's transpose for an average one."""

    def rev(r, op):
        _, name, _, kind, w, s, p = op
        x = cache[name]["in"]
        if kind == "max":
            return lrp_maxpool_overlapping_wta(r, x, w, s)
        return avgpool2d_input_vjp(r, x.shape, w, s, p)

    return rev


def _backward(params, cache, relevance_seed, until="mixed10"):
    """PresetA: the BN rule then alpha1beta0 per conv, WTA / z-rule per pool."""

    def conv_rev(r, op):
        _, name, src, _, _, s, p = op
        c, pn = cache[name], params[name]
        r = lrp_bn(r, c["z"], c["bn"], pn["bn_mean"], pn["bn_beta"])
        return conv_rule(r, c["in"], pn["kernel"], None, s, p, input_nonneg=src != "input")

    def pool_rev(r, op):
        _, name, _, kind, w, s, p = op
        x = cache[name]["in"]
        if kind == "max":
            return lrp_maxpool_overlapping_wta(r, x, w, s)
        return lrp_avgpool(r, x, w, s, padding=p)

    return _walk_backward(relevance_seed, until, conv_rev, pool_rev)


def inception_lrp_preset_a(params, image, relevance_seed, until: str = "mixed10"):
    """One seed per image: image (B, 299, 299, 3), seed (B, 8, 8, 2048) ->
    (B, 299, 299, 3)."""
    _, cache = _forward_cached(params, image, until)
    return _backward(params, cache, relevance_seed, until)


def inception_lrp_wordbatched(params, image, relevance_seeds, until: str = "mixed10"):
    """Per-word LRP sharing one forward: image (1, ...), seeds (W, 8, 8, 2048)."""
    _, cache = _forward_cached(params, image, until)
    return _backward(params, cache, relevance_seeds, until)


def inception_deep_taylor_wordbatched(params, image, relevance_seeds, until: str = "mixed10"):
    """Per-word DeepTaylor (deeptaylor.py:52-137): the WSquareRule on every
    conv (no fused activation), BN does nothing, ReLU / pools / concat
    reverse by the gradient; seeds through a ReLU first (144-153)."""
    _, cache = _forward_cached(params, image, until)

    def conv_rev(r, op):
        _, name, _, _, _, s, p = op
        c = cache[name]
        r = torch.where(c["bn"] > 0, r, torch.zeros_like(r))
        return lrp_conv_wsquare(r, c["in"], params[name]["kernel"], s, p)

    return _walk_backward(torch.relu(relevance_seeds), until, conv_rev, _pool_gradient(cache))


def inception_deeplift_wordbatched(params, image, relevance_seeds, until: str = "mixed10",
                                   reference_inputs=0.0, approximate_gradient: bool = True):
    """Per-word DeepLIFT-rescale (deeplift.py:120-197): the LinearRule on
    each conv, the RescaleRule on each ReLU, the gradient through BN, the
    pools and the concats; one actual and one reference forward."""
    _, cache = _forward_cached(params, image, until)
    _, cache_ref = _forward_cached(params, reference_image(image, reference_inputs), until)

    def conv_rev(r, op):
        _, name, _, _, _, s, p = op
        c, cr, pn = cache[name], cache_ref[name], params[name]
        r = deeplift_relu_rescale(r, c["bn"], cr["bn"], approximate_gradient)
        r = r * (pn["bn_gamma"] * torch.rsqrt(pn["bn_var"] + BN_EPS))
        return deeplift_conv_linear(r, c["in"], cr["in"], c["z"], cr["z"], pn["kernel"], s, p,
                                    approximate_gradient)

    return _walk_backward(relevance_seeds, until, conv_rev, _pool_gradient(cache))
