"""PyTorch port: the gradient-family CNN explanations
(``explain/cnn_gradient.py``) against the JAX package's, and the pieces of
Grad-CAM where the two frameworks differ: numpy-reflect padding wider than
the axis (``jnp.pad`` reflects again, ``F.pad`` raises) and bilinear
upsampling (``jax.image.resize`` against ``F.interpolate`` without
antialias). Maps within 1e-4 of their scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.explain import cnn_gradient as jg  # noqa: E402
from lrp_imagecaptioning_tpu.models import vgg as jvgg  # noqa: E402
from lrp_imagecaptioning_torch.explain import cnn_gradient as tg  # noqa: E402
from lrp_imagecaptioning_torch.models import vgg as tvgg  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

UNTIL = "block2_conv1"
MAP_RTOL = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def setup():
    pj = jvgg.init_vgg_params(jax.random.PRNGKey(2), "vgg16", UNTIL)
    rng = np.random.default_rng(9)
    image = (rng.normal(size=(1, 8, 8, 3)) * 40).astype(np.float32)
    seeds = rng.normal(size=(3, 4, 4, 128)).astype(np.float32)
    return pj, params_from_jax(pj, "cpu"), image, seeds


@pytest.mark.parametrize("name", ["vgg_gradient", "vgg_input_times_gradient",
                                  "vgg_guided_backprop", "vgg_deconvnet"])
def test_vjp_methods_match_jax(setup, name):
    pj, pt, image, seeds = setup
    got = getattr(tg, name)(pt, torch.from_numpy(image), torch.from_numpy(seeds), UNTIL)
    assert got.shape == (3, 8, 8, 3) and not got.requires_grad
    for w in range(3):
        ref = getattr(jg, name)(pj, jnp.asarray(image), jnp.asarray(seeds[w:w + 1]), "vgg16", UNTIL)
        assert _rel(got[w:w + 1], ref) <= MAP_RTOL


def test_integrated_gradients_and_smoothgrad_match_jax(setup):
    pj, pt, image, seeds = setup
    ti, ts = torch.from_numpy(image), torch.from_numpy(seeds)
    got = tg.vgg_integrated_gradients(pt, ti, ts, UNTIL, steps=4)
    for w in range(3):
        ref = jg.vgg_integrated_gradients(pj, jnp.asarray(image), jnp.asarray(seeds[w:w + 1]),
                                          "vgg16", UNTIL, steps=4)
        assert _rel(got[w:w + 1], ref) <= MAP_RTOL
    # SmoothGrad on the JAX draws: keys split(key_w, n), one normal each
    n, keys = 3, [jax.random.PRNGKey(10 + w) for w in range(3)]
    noise = np.stack([np.stack([np.asarray(jax.random.normal(k, image.shape, jnp.float32))[0]
                                for k in jax.random.split(key, n)]) for key in keys])
    got = tg.vgg_smoothgrad(pt, ti, ts, torch.from_numpy(noise), UNTIL, noise_scale=16.0)
    for w in range(3):
        ref = jg.vgg_smoothgrad(pj, jnp.asarray(image), jnp.asarray(seeds[w:w + 1]), keys[w],
                                "vgg16", UNTIL, n=n, noise_scale=16.0)
        assert _rel(got[w:w + 1], ref) <= MAP_RTOL


def test_guided_relu_and_deconv_relu_backward():
    x = torch.tensor([-1.0, 0.0, 2.0, 3.0], requires_grad=True)
    g = torch.tensor([5.0, 5.0, -1.0, 4.0])
    (gx,) = torch.autograd.grad(tg.GuidedReLU.apply(x), x, g)
    assert gx.tolist() == [0.0, 0.0, 0.0, 4.0]
    (gx,) = torch.autograd.grad(tg.DeconvReLU.apply(x), x, g)
    assert gx.tolist() == [5.0, 5.0, 0.0, 4.0]


@pytest.mark.parametrize("n, pad", [(1, 3), (2, 5), (4, 80), (8, 80), (224, 80)])
def test_reflect_index_is_numpy_reflect(n, pad):
    """Repeated reflection where the pad exceeds the axis, as np.pad does."""
    ref = np.pad(np.arange(n), pad, mode="reflect")
    np.testing.assert_array_equal(tg._reflect_index(n, pad, "cpu").numpy(), ref)


@pytest.mark.parametrize("shape, upscale", [((4, 4), 2), ((3, 5), 3), ((2, 2), 16)])
def test_pyramid_expand_matches_jax(shape, upscale):
    """The blur's radius is 80 > every upscaled axis here."""
    img = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    got = tg.pyramid_expand(torch.from_numpy(img), upscale=upscale)
    ref = jg.pyramid_expand(jnp.asarray(img), upscale=upscale)
    assert _rel(got, ref) <= MAP_RTOL
    # batched over leading dims
    both = tg.pyramid_expand(torch.from_numpy(np.stack([img, -img])), upscale=upscale)
    torch.testing.assert_close(both[0], got)
    torch.testing.assert_close(both[1], -got)


def test_resize_bilinear_matches_jax():
    img = np.random.default_rng(12).normal(size=(2, 3, 5)).astype(np.float32)
    got = tg.resize_bilinear(torch.from_numpy(img), (7, 11))
    for i in range(2):
        assert _rel(got[i], jax.image.resize(jnp.asarray(img[i]), (7, 11), "bilinear")) <= MAP_RTOL
    same = torch.from_numpy(img)
    assert tg.resize_bilinear(same, (3, 5)) is same


def test_grad_cam_and_guided_gradcam_match_jax(setup):
    pj, pt, image, seeds = setup
    feat = np.random.default_rng(13).normal(size=(4, 4, 128)).astype(np.float32)
    # one seed aligned with the features, so that its CAM is not all negative
    seeds = seeds.copy()
    seeds[1] = np.abs(seeds[1]) * np.sign(feat.mean(axis=(0, 1)))
    cams = tg.grad_cam(torch.from_numpy(feat), torch.from_numpy(seeds), upscale=2)
    assert cams.shape == (3, 8, 8) and cams[1].abs().max() > 0
    for w in range(3):
        ref = np.asarray(jg.grad_cam(jnp.asarray(feat), jnp.asarray(seeds[w]), upscale=2))
        if np.abs(ref).max() == 0:
            assert cams[w].abs().max() == 0
        else:
            assert _rel(cams[w], ref) <= MAP_RTOL
    got = tg.vgg_guided_gradcam(pt, torch.from_numpy(image), torch.from_numpy(seeds),
                                torch.from_numpy(feat), UNTIL)
    # the Explainer's recipe (engine.py:421-437): the CAM upscaled by the
    # tap's stride (2 here; jg.vgg_guided_gradcam fixes 16), then resized
    guided = jg.vgg_guided_backprop(pj, jnp.asarray(image), jnp.asarray(seeds[1:2]), "vgg16", UNTIL)
    cam = jax.image.resize(jg.grad_cam(jnp.asarray(feat), jnp.asarray(seeds[1]), upscale=2),
                           (8, 8), "bilinear")
    assert _rel(got[1:2], guided * cam[None, :, :, None]) <= MAP_RTOL


def test_encode_relu_fn_forward_is_relu(setup):
    """The guided and deconvnet ReLUs change the backward only: the
    encoder's forward (``vgg_apply(relu_fn=)``) is the plain one."""
    _, pt, image, _ = setup
    x = torch.from_numpy(image)
    ref = tvgg.vgg_apply(pt, x, UNTIL)
    for fn in (tg.GuidedReLU.apply, tg.DeconvReLU.apply):
        torch.testing.assert_close(tvgg.vgg_apply(pt, x, UNTIL, relu_fn=fn), ref, rtol=0, atol=0)
