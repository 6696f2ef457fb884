"""DeepLIFT (rescale rule) over the VGG conv stack.

The port of the JAX package's ``explain/cnn_deeplift.py`` for VGG16 and
VGG19 (ResNet's and Inception's walks are in ``resnet_lrp.py`` and
``inception_lrp.py``), itself the vendored
``innvestigate/analyzer/deeplift.py`` analyzer (reference deeplift.py:44-255)
as one backward walk instead of a reversed Keras graph:

* Reference activations are a second forward pass on ``reference_inputs``
  (default 0, matching ``DeepLIFT.__init__`` deeplift.py:123) with every
  op's input kept (``_create_reference_activations``, deeplift.py:135-172).
* Each conv+bias+ReLU unit (Keras VGG16 fuses the ReLU into the conv layer,
  and the reference assigns rules per Keras layer, deeplift.py:180-193) takes
  the **LinearRule** (deeplift.py:77-116): divide the incoming relevance by
  the unit's output difference Δy, take the unit's VJP at the *actual*
  input, re-weight by the input difference Δx; where |Δx| < eps the plain
  gradient takes over (``approximate_gradient=True``, the default,
  deeplift.py:78-86). The VJP of relu(conv(x) + b) is a ReLU mask (y > 0,
  y the unit's output, relu's derivative 0 at 0) then the transposed conv
  (``ops/lrp_conv.py::conv2d_input_vjp``, cuDNN on the card): the JAX
  package computes this outside any Pallas kernel.
* Max pools fall to the default gradient reverse: winner-take-all at the
  actual input (``_default_reverse_mapping``).
* The head seed is the caller's relevance tensor at the tapped layer (the
  decoder's relevance); ``vgg_deeplift_standalone`` seeds with
  features - reference features, the reference's ``_head_mapping``
  (deeplift.py:217-218).

``approximate_gradient=False`` reproduces the reference's other branch: the
LinearRule's Δx re-weighting alone (deeplift.py:83-86).

A single image (batch 1) broadcasts against several seeds (the words of a
caption as the batch): both forwards run once.
"""

from __future__ import annotations

import torch

from ..models.vgg import vgg_apply_with_acts, vgg_layers
from ..ops.lrp_conv import conv2d_input_vjp, lrp_maxpool_wta
from ..ops.lrp_core import EPS_KERAS, safe_divide

# K.epsilon(): the Keras fuzz factor of the reference's switch and SafeDivide
# (deeplift.py:49, ilayers.SafeDivide's default)
_K_EPSILON = EPS_KERAS


def _deeplift_backward(params, relevance_seed, ops, inputs, inputs_ref, out, out_ref,
                       approximate_gradient):
    # each op's output is the next op's input; the last one's is the tap
    outputs = inputs[1:] + [out]
    outputs_ref = inputs_ref[1:] + [out_ref]
    r = relevance_seed
    for op, x, x_ref, y, y_ref in zip(reversed(ops), reversed(inputs), reversed(inputs_ref),
                                      reversed(outputs), reversed(outputs_ref)):
        if op[0] != "conv":
            r = lrp_maxpool_wta(r, x)     # no kernel, no activation: WTA
            continue
        kernel = params[op[1]]["kernel"]
        active = (y > 0).to(r.dtype)      # relu'(conv(x) + b) at the actual input

        def vjp(cot):
            return conv2d_input_vjp(None, kernel, cot * active)

        dx = x - x_ref
        # LinearRule: R / Δy -> the unit's VJP -> x Δx (deeplift.py:98-109)
        contrib = dx * vjp(safe_divide(r, y - y_ref))
        if approximate_gradient:
            r = torch.where(dx.abs() < _K_EPSILON, vjp(r), contrib)
        else:
            r = contrib
    return r


def reference_image(image: torch.Tensor, reference_inputs) -> torch.Tensor:
    """``reference_inputs`` (a scalar or an image) at ``image``'s shape."""
    return torch.as_tensor(reference_inputs, dtype=image.dtype,
                           device=image.device).expand(image.shape).contiguous()


def _forwards(params, image, arch, until, reference_inputs):
    out, inputs = vgg_apply_with_acts(params, image, arch, until)
    out_ref, inputs_ref = vgg_apply_with_acts(params, reference_image(image, reference_inputs),
                                              arch, until)
    return out, inputs, out_ref, inputs_ref


def vgg_deeplift(params, image: torch.Tensor, relevance_seed: torch.Tensor, arch: str = "vgg16",
                 until: str = "block5_conv3", reference_inputs=0.0,
                 approximate_gradient: bool = True) -> torch.Tensor:
    """DeepLIFT-rescale attribution, seeded at the tapped feature grid.

    image: (1 or B, H, W, 3) preprocessed; relevance_seed: (B, h, w, C) at
    ``until``; reference_inputs: a scalar or an image of ``image``'s shape.
    Returns the input-space attribution (B, H, W, 3)."""
    out, inputs, out_ref, inputs_ref = _forwards(params, image, arch, until, reference_inputs)
    return _deeplift_backward(params, relevance_seed, vgg_layers(arch, until), inputs,
                              inputs_ref, out, out_ref, approximate_gradient)


def vgg_deeplift_standalone(params, image: torch.Tensor, arch: str = "vgg16",
                            until: str = "block5_conv3", reference_inputs=0.0,
                            approximate_gradient: bool = True):
    """The reference's standalone head: seed = features - reference features
    (``_head_mapping``, deeplift.py:217-218), one pair of forwards shared by
    the seed and the backward walk."""
    out, inputs, out_ref, inputs_ref = _forwards(params, image, arch, until, reference_inputs)
    return _deeplift_backward(params, out - out_ref, vgg_layers(arch, until), inputs, inputs_ref,
                              out, out_ref, approximate_gradient)
