"""Gradient-family CNN explanations (iNNvestigate's gradient_based.py with
neuron_selection_mode='replace'), word-batched: every function takes one
image (1, H, W, 3) and the W words' seeds at the tapped layer (W, h, w, C),
and returns (W, H, W, 3).

* ``vgg_gradient``: d(features)/d(image) contracted with each seed, one VJP.
* ``vgg_input_times_gradient``: the gradient times the image.
* ``vgg_guided_backprop``: the backward ReLU also zeroes negative upstream
  gradients (``GuidedReLU``).
* ``vgg_deconvnet``: ReLU on the backward signal only (``DeconvReLU``).
* ``vgg_integrated_gradients``: the mean gradient along the straight path
  from a zero baseline, times the image.
* ``vgg_smoothgrad``: the gradient averaged over noisy copies of the image;
  the noise comes ready-made (``noise``), so that a caller can feed any
  generator's draws (the JAX package's ``jax.random`` bits in the tests).
* ``grad_cam`` / ``vgg_guided_gradcam`` (explainers.py:925-949): the CAM is
  the ReLU of the gradient-mean-weighted feature map, ``pyramid_expand``-ed
  and normalised; Guided-GradCAM multiplies the guided-backprop map by it.

Every word's gradient is one image of a batch-W forward under autograd on
cuDNN's convs (``models/vgg.py``): the LRP kernels (K3, K4) have no
gradient and are never reached here.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..models.vgg import vgg_apply


class GuidedReLU(torch.autograd.Function):
    """ReLU whose backward passes the gradient only where the input and the
    gradient are both positive (guided backprop)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x > 0) & (g > 0), g, torch.zeros_like(g))


class DeconvReLU(torch.autograd.Function):
    """ReLU whose backward is the ReLU of the gradient, whatever the forward
    input's sign (deconvnet, gradient_based.py:171-216)."""

    @staticmethod
    def forward(ctx, x):
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, min=0.0)


def _vjp(params, images, seeds, until, relu_fn=None):
    """d(sum(features * seeds))/d(images) for (W, H, W, 3) images, each row
    its own forward (a batch of W)."""
    with torch.enable_grad():
        x = images.detach().clone().requires_grad_(True)
        feats = vgg_apply(params, x, until, relu_fn=relu_fn)
        (grad,) = torch.autograd.grad(feats, x, seeds)
    return grad


def _per_word(image, seeds):
    """The image once for each of the W seeds: (W, H, W, 3)."""
    return image.expand(seeds.shape[0], *image.shape[1:])


def vgg_gradient(params, image, seeds, until="block5_conv3"):
    """The 'replace'-mode Gradient analyzer, one map per seed."""
    return _vjp(params, _per_word(image, seeds), seeds, until)


def vgg_input_times_gradient(params, image, seeds, until="block5_conv3"):
    return image * vgg_gradient(params, image, seeds, until)


def vgg_guided_backprop(params, image, seeds, until="block5_conv3"):
    return _vjp(params, _per_word(image, seeds), seeds, until, GuidedReLU.apply)


def vgg_deconvnet(params, image, seeds, until="block5_conv3"):
    return _vjp(params, _per_word(image, seeds), seeds, until, DeconvReLU.apply)


def vgg_integrated_gradients(params, image, seeds, until="block5_conv3", steps: int = 16):
    """IntegratedGradients (PathIntegrator over Gradient, zero baseline): the
    gradient at alpha * image for alpha = (k + 0.5) / steps, averaged, times
    the image. One batch-W forward and backward a step."""
    total = None
    for k in range(steps):
        alpha = (k + 0.5) / steps
        g = _vjp(params, _per_word(alpha * image, seeds), seeds, until)
        total = g if total is None else total + g
    return total / steps * image


def vgg_smoothgrad(params, image, seeds, noise, until="block5_conv3", noise_scale: float = 16.0):
    """SmoothGrad: the gradient averaged over ``image + noise_scale * noise``.
    noise: (W, n, H, W, 3) standard normal draws, n samples for each word.
    One batch-W forward and backward a sample."""
    n = noise.shape[1]
    total = None
    for k in range(n):
        g = _vjp(params, image + noise_scale * noise[:, k], seeds, until)
        total = g if total is None else total + g
    return total / n


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """numpy's 'reflect' padding as indices, repeated while the pad exceeds
    the axis (``jnp.pad`` does so; ``F.pad(mode='reflect')`` raises)."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _linear_upsample_matrix(n: int, upscale: int) -> torch.Tensor:
    """(n * upscale, n) float64 weights of linear interpolation with
    half-pixel centres, sources left of the first centre clamped to it: what
    ``F.interpolate(mode="bilinear", align_corners=False)`` applies along one
    axis."""
    src = ((torch.arange(n * upscale, dtype=torch.float64) + 0.5) / upscale - 0.5).clamp(min=0)
    i0 = src.floor().long().clamp(max=n - 1)
    i1 = (i0 + 1).clamp(max=n - 1)
    frac = src - i0
    rows = torch.arange(n * upscale)
    m = torch.zeros(n * upscale, n, dtype=torch.float64)
    m.index_put_((rows, i0), 1 - frac, accumulate=True)
    m.index_put_((rows, i1), frac, accumulate=True)
    return m


@functools.lru_cache(maxsize=16)
def _expand_matrix(n: int, upscale: int, sigma: float) -> torch.Tensor:
    """(n * upscale, n) float64 on the CPU: the linear upsampling by
    ``upscale``, then the Gaussian blur of ``sigma`` (radius int(4 sigma +
    0.5), numpy-reflect padding) along one axis, as one linear map. Read
    only: every caller shares it."""
    size = n * upscale
    radius = int(4 * sigma + 0.5)
    xs = torch.arange(-radius, radius + 1, dtype=torch.float64)
    kern = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    kern = kern / kern.sum()
    rows = torch.arange(size)[:, None].expand(size, 2 * radius + 1)
    taps = _reflect_index(size, radius, "cpu")[rows + torch.arange(2 * radius + 1)]
    blur = torch.zeros(size, size, dtype=torch.float64)
    blur.index_put_((rows, taps), kern.expand(size, -1), accumulate=True)
    return blur @ _linear_upsample_matrix(n, upscale)


def pyramid_expand(img: torch.Tensor, upscale: int = 16, sigma: float = 20.0) -> torch.Tensor:
    """skimage.transform.pyramid_expand as the JAX package computes it:
    bilinear upsampling by ``upscale`` (half-pixel centres, no antialias: the
    same weights as ``jax.image.resize``), then a separable Gaussian blur of
    ``sigma`` with radius int(4 sigma + 0.5) over numpy-reflect padding.
    img: (..., h, w) -> (..., h * upscale, w * upscale).

    Both steps are linear and separable, so each axis is one (h * upscale, h)
    matrix and the whole is two small products."""
    h, w = img.shape[-2:]
    rows = _expand_matrix(h, upscale, float(sigma)).to(img.device, img.dtype)
    cols = _expand_matrix(w, upscale, float(sigma)).to(img.device, img.dtype)
    return rows @ img @ cols.T


def grad_cam(feat_grid_hw: torch.Tensor, grads_hw: torch.Tensor, upscale: int = 16) -> torch.Tensor:
    """GradCAM heatmaps (explainers.py:938-949), one a seed: channel weights
    are the gradient's means, the weighted feature sum is pyramid-expanded,
    ReLU'd and normalised by its max |.|.

    feat_grid_hw (h, w, D); grads_hw (W, h, w, D) -> (W, h * upscale, w * upscale)."""
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


def vgg_guided_gradcam(params, image, seeds, feat_grid_hw, until="block5_conv3"):
    """Guided-GradCAM = the guided-backprop map x the CAM (explainers.py:
    925-935), the CAM upscaled by the tap's stride and resized to the image."""
    guided = vgg_guided_backprop(params, image, seeds, until)              # (W, H, W, 3)
    H, Wd = image.shape[1:3]
    g = seeds.shape[1]
    cam = grad_cam(feat_grid_hw, seeds, upscale=max(H // g, 1))
    cam = resize_bilinear(cam, (H, Wd))
    return guided * cam[:, :, :, None]

