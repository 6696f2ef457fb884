"""Gradient-family CNN explanations (iNNvestigate's gradient_based.py with
neuron_selection_mode='replace'), word-batched, through any encoder:
``gradient_maps`` takes one image (1, H, W, 3), the W words' seeds at the
tapped layer and the encoder as a function of the image and its ReLU, and
returns (W, H, W, 3).

* ``gradient``: d(features)/d(image) contracted with each seed.
* ``input_times_gradient``: the gradient times the image.
* ``guided_backprop``: the backward ReLU also zeroes negative upstream
  gradients (``guided_relu``).
* ``deconvnet``: ReLU on the backward signal only (``deconv_relu``).
* ``integrated_gradients``: the mean gradient along the straight path
  from a zero baseline, times the image.
* ``smoothgrad``: the gradient averaged over noisy copies of the image;
  the noise comes ready-made, so that a caller can feed any generator's
  draws (the JAX package's ``jax.random`` bits in the tests).
* ``guided_gradcam`` (explainers.py:925-949): the guided-backprop map times
  the CAM, the ReLU of the gradient-mean-weighted feature map,
  ``pyramid_expand``-ed and normalised (``grad_cam``).

The JAX package's ``vgg_*`` functions (one seed per image, the VGG
encoders) are thin adapters over ``gradient_maps`` with its signatures;
``vgg_smoothgrad`` takes a ``torch.Generator`` (or ready ``noise``) where
the JAX package takes a PRNG key.

Each pass (the image, an IG step, a SmoothGrad sample) is one forward and
the W words' VJPs in one backward vmapped over them (``input_gradients``),
on cuDNN's convs: the LRP kernels (K3, K4) have no gradient and are never
reached here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.vgg import vgg_apply


def guided_relu(x):
    """ReLU whose backward passes the gradient only where the input and the
    gradient are both positive (guided backprop): a hook hands ReLU's own
    backward the ReLU of the gradient. A hook, not a custom
    ``autograd.Function``: under ``torch.vmap`` of ``torch.func.vjp``
    (``input_gradients``) a Function's backward goes through functorch's
    Python rules at every call, a host cost a word bucket of few words pays
    at each of the encoder's ReLUs."""
    y = torch.relu(x)
    if y.requires_grad:
        y.register_hook(torch.relu)
    return y


def deconv_relu(x):
    """ReLU whose backward is the ReLU of the gradient, whatever the forward
    input's sign (deconvnet, gradient_based.py:171-216): the forward is
    ReLU's value on the identity's gradient, hooked as ``guided_relu``."""
    y = x + (torch.relu(x) - x).detach()
    if y.requires_grad:
        y.register_hook(torch.relu)
    return y


RELU_FNS = {"guided_backprop": guided_relu, "guided_gradcam": guided_relu,
            "deconvnet": deconv_relu}


def input_gradients(encode, images, seeds):
    """d(sum(encode(x) * seed))/dx for each of the W seeds -> (W, H, W, 3).

    images (1, H, W, 3), one image for every seed: one forward, then the W
    VJPs as ``torch.vmap`` of ``torch.func.vjp``'s pullback, as the reference
    maps its VJP over the seeds (``jax.vmap`` of ``jax.vjp``). Each layer's
    backward then runs once over the W seeds (a conv's as one transposed
    conv at batch W), where ``torch.autograd.grad(is_grads_batched=True)``
    loops over them in convolution_backward: a traced program
    (``infer/export.py``) holds one backward, not W. A forward of W copies instead flips near-tied ReLUs, 4e-3 to 8e-3 of
    a map from the one-forward result (scripts/gradient_vjp_forms.py times
    the forms). images (W, H, W, 3), each seed its own image: one forward
    and one backward at batch W."""
    with torch.enable_grad():
        if images.shape[0] == 1:
            feats, pullback = torch.func.vjp(lambda x: encode(x)[0], images.detach())
            (grad,) = torch.vmap(pullback)(seeds.reshape(-1, *feats.shape))
            return grad[:, 0]
        x = images.detach().clone().requires_grad_(True)
        feats = encode(x)
        (grad,) = torch.autograd.grad(feats, x, seeds.reshape(feats.shape))
    return grad


def gradient_maps(method, encode, image, seeds, feat_grid_hw=None, steps: int = 16, noise=None,
                  noise_scale: float = 16.0):
    """The gradient method's map for each of the W seeds (W, h, w, D).

    encode(x, relu_fn) -> the tapped features of images x; image (1, H, W,
    3); ``feat_grid_hw`` (h, w, D) the image's features (Guided-GradCAM);
    ``steps`` IG's steps; ``noise`` SmoothGrad's standard normal draws (1 or
    W, n, H, W, 3): n samples shared by the words, or each word its own.
    Returns (W, H, W, 3)."""
    relu_fn = RELU_FNS.get(method)

    def grads(x):
        return input_gradients(lambda im: encode(im, relu_fn), x, seeds)

    if method == "integrated_gradients":
        total = None
        for k in range(steps):
            g = grads((k + 0.5) / steps * image)
            total = g if total is None else total + g
        return total / steps * image
    if method == "smoothgrad":
        total = None
        for k in range(noise.shape[1]):
            g = grads(image + noise_scale * noise[:, k])
            total = g if total is None else total + g
        return total / noise.shape[1]
    maps = grads(image)
    if method == "input_times_gradient":
        return maps * image
    if method == "guided_gradcam":
        return maps * gradcam_weight(image, seeds, feat_grid_hw)
    return maps


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """numpy's 'reflect' padding as indices, repeated while the pad exceeds
    the axis (``jnp.pad`` does so; ``F.pad(mode='reflect')`` raises)."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _linear_upsample_matrix(n: int, upscale: int, device) -> torch.Tensor:
    """(n * upscale, n) float64 weights of linear interpolation with
    half-pixel centres, sources left of the first centre clamped to it: what
    ``F.interpolate(mode="bilinear", align_corners=False)`` applies along one
    axis."""
    src = ((torch.arange(n * upscale, dtype=torch.float64, device=device) + 0.5) / upscale
           - 0.5).clamp(min=0)
    i0 = src.floor().long().clamp(max=n - 1)
    i1 = (i0 + 1).clamp(max=n - 1)
    frac = (src - i0)[:, None]
    cols = torch.arange(n, device=device)
    return (i0[:, None] == cols) * (1 - frac) + (i1[:, None] == cols) * frac


def _expand_matrix(n: int, upscale: int, sigma: float, device) -> torch.Tensor:
    """(n * upscale, n) float64 on ``device``: the linear upsampling by
    ``upscale``, then the Gaussian blur of ``sigma`` (radius int(4 sigma +
    0.5), numpy-reflect padding) along one axis, as one linear map: output
    row i sums the blur's taps times the upsampling's rows at the taps'
    reflected indices. Device ops alone, no host copy or sync, so that a
    traced program (``infer/export.py``) replays it from a CUDA graph."""
    size = n * upscale
    radius = int(4 * sigma + 0.5)
    xs = torch.arange(-radius, radius + 1, dtype=torch.float64, device=device)
    kern = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    kern = kern / kern.sum()
    offsets = torch.arange(size, device=device)[:, None] + torch.arange(2 * radius + 1,
                                                                        device=device)
    taps = _reflect_index(size, radius, device)[offsets]                # (size, 2r + 1)
    return (kern[:, None] * _linear_upsample_matrix(n, upscale, device)[taps]).sum(dim=1)


def pyramid_expand(img: torch.Tensor, upscale: int = 16, sigma: float = 20.0) -> torch.Tensor:
    """skimage.transform.pyramid_expand as the JAX package computes it:
    bilinear upsampling by ``upscale`` (half-pixel centres, no antialias: the
    same weights as ``jax.image.resize``), then a separable Gaussian blur of
    ``sigma`` with radius int(4 sigma + 0.5) over numpy-reflect padding.
    img: (..., h, w) -> (..., h * upscale, w * upscale).

    Both steps are linear and separable, so each axis is one (h * upscale, h)
    matrix and the whole is two small products."""
    h, w = img.shape[-2:]
    rows = _expand_matrix(h, upscale, float(sigma), img.device).to(img.dtype)
    cols = _expand_matrix(w, upscale, float(sigma), img.device).to(img.dtype)
    return rows @ img @ cols.T


def grad_cam(feat_grid_hw: torch.Tensor, grads_hw: torch.Tensor, upscale: int = 16) -> torch.Tensor:
    """GradCAM heatmaps (explainers.py:938-949), one a seed: channel weights
    are the gradient's means, the weighted feature sum is pyramid-expanded,
    ReLU'd and normalised by its max |.|.

    feat_grid_hw (h, w, D); grads_hw (W, h, w, D) -> (W, h * upscale, w * upscale),
    or one seed's grads_hw (h, w, D) -> (h * upscale, w * upscale)."""
    if grads_hw.dim() == 3:
        return grad_cam(feat_grid_hw, grads_hw[None], upscale)[0]
    weights = grads_hw.mean(dim=(1, 2))                                    # (W, D)
    cam = torch.einsum("hwd,nd->nhw", feat_grid_hw, weights)
    cam = torch.relu(pyramid_expand(cam, upscale=upscale, sigma=20.0))
    return cam / (cam.abs().amax(dim=(1, 2), keepdim=True) + 1e-6)


def resize_bilinear(maps: torch.Tensor, size) -> torch.Tensor:
    """(N, h, w) -> (N, *size), ``jax.image.resize(..., 'bilinear')`` for
    the upsampling (and identity) the callers need."""
    if tuple(maps.shape[-2:]) == tuple(size):
        return maps
    return F.interpolate(maps[:, None], size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def gradcam_weight(image, seeds, feat_grid_hw):
    """The CAM of each seed, upscaled by the tap's stride and resized to the
    image: (W, H, W, 1)."""
    H, Wd = image.shape[1:3]
    g = seeds.shape[1]
    cam = grad_cam(feat_grid_hw, seeds, upscale=max(H // g, 1))
    return resize_bilinear(cam, (H, Wd))[:, :, :, None]


def normal_like(shape, like: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """Standard normal draws of ``shape`` in ``like``'s dtype and device."""
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def vgg_encoder(params, arch: str = "vgg16", until: str = "block5_conv3"):
    """``encode(x, relu_fn)`` of ``gradient_maps`` over a VGG encoder."""
    def encode(x, relu_fn):
        return vgg_apply(params, x, arch, until, relu_fn=relu_fn)

    return encode


def vgg_gradient(params, image, relevance_seed, arch="vgg16", until="block5_conv3"):
    """d(sum(features * seed))/d(image), the 'replace'-mode Gradient analyzer:
    image (B, H, W, 3), relevance_seed (B, h, w, C) -> (B, H, W, 3)."""
    return gradient_maps("gradient", vgg_encoder(params, arch, until), image, relevance_seed)


def vgg_input_times_gradient(params, image, relevance_seed, arch="vgg16", until="block5_conv3"):
    return gradient_maps("input_times_gradient", vgg_encoder(params, arch, until), image,
                         relevance_seed)


def vgg_guided_backprop(params, image, relevance_seed, arch="vgg16", until="block5_conv3"):
    return gradient_maps("guided_backprop", vgg_encoder(params, arch, until), image,
                         relevance_seed)


def vgg_deconvnet(params, image, relevance_seed, arch="vgg16", until="block5_conv3"):
    """Deconvnet: ReLU on the backward signal (gradient_based.py:171-216)."""
    return gradient_maps("deconvnet", vgg_encoder(params, arch, until), image, relevance_seed)


def vgg_integrated_gradients(params, image, relevance_seed, arch="vgg16", until="block5_conv3",
                             steps: int = 16, baseline=None):
    """The mean gradient at the midpoints of ``steps`` segments of the
    straight path from ``baseline`` (0 by default) to the image, times
    (image - baseline); a baseline shifts the encoder's input."""
    encode = vgg_encoder(params, arch, until)
    if baseline is None:
        return gradient_maps("integrated_gradients", encode, image, relevance_seed, steps=steps)
    base = torch.as_tensor(baseline, dtype=image.dtype, device=image.device).expand(image.shape)
    return gradient_maps("integrated_gradients", lambda x, relu_fn: encode(x + base, relu_fn),
                         image - base, relevance_seed, steps=steps)


def vgg_smoothgrad(params, image, relevance_seed, generator=None, arch="vgg16",
                   until="block5_conv3", n: int = 16, noise_scale: float = 16.0, *, noise=None):
    """The gradient averaged over ``n`` noisy copies of each image;
    ``noise`` (B, n, H, W, 3) standard normal draws, else drawn from
    ``generator``."""
    if noise is None:
        noise = normal_like((image.shape[0], n, *image.shape[1:]), image, generator)
    return gradient_maps("smoothgrad", vgg_encoder(params, arch, until), image, relevance_seed,
                         noise=noise, noise_scale=noise_scale)


def vgg_guided_gradcam(params, image, relevance_seed, feat_grid_hw, arch="vgg16",
                       until="block5_conv3"):
    """Guided-GradCAM (explainers.py:925-935): the guided-backprop map times
    the CAM of the first seed, ``grad_cam``'s (h * 16, w * 16) map (the
    image's size at the reference's 14x14 grid of 224x224 images)."""
    guided = vgg_guided_backprop(params, image, relevance_seed, arch, until)
    cam = grad_cam(feat_grid_hw, relevance_seed[0])
    return guided * cam[None, :, :, None]
