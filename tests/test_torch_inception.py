"""PyTorch port: InceptionV3 (models/inception.py, explain/inception_lrp.py)
with grid-TD against the JAX package on the CPU.

Size: Keras's smallest input, 75x75 (full channel widths; 'mixed10' is
1x1x2048), E = H = 32, vocab 50, T = 5; the encoder's params from the port's
init with BatchNorm's statistics drawn from a seed (tests/torch_encoders.py),
the same tree on both sides.

Tolerances, each with its reason:
* the forward: 1e-5 of the output's scale (f32 sums in another order);
* the average pools: 1e-6 (a sum over at most 9 taps); the z-rule 1e-4 (it
  divides by the pool's output);
* the Explainer: as tests/test_torch_resnet.py (every array within 1e-4 of
  its scale; IG and SmoothGrad's CNN side in f64 at 1e-9);
* DeepLIFT: in f64 on both sides, 1e-9 of scale;
* Guided-Grad-CAM's resize 296 -> 299 (8 x 37 up to the image): 1e-6 of
  ``jax.image.resize``'s scale.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_encoders as te  # noqa: E402
from lrp_imagecaptioning_tpu.explain import inception_lrp as jil  # noqa: E402
from lrp_imagecaptioning_tpu.models import inception as jinc  # noqa: E402
from lrp_imagecaptioning_torch.explain import cnn_gradient, cnn_lrp  # noqa: E402
from lrp_imagecaptioning_torch.explain import inception_lrp as til  # noqa: E402
from lrp_imagecaptioning_torch.models import inception as tinc  # noqa: E402
from lrp_imagecaptioning_torch.ops import lrp_conv as tconv  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_to  # noqa: E402

torch.set_num_threads(2)

METHODS = ("lrp", "deep_taylor", *te.GRADIENT_METHODS)
# the 3x3 SAME stride-1 convs over a post-ReLU input: K3's on the lrp walk
K3_CONVS = ("stem3", "mixed0_b3x3dbl_2", "mixed0_b3x3dbl_3", "mixed1_b3x3dbl_2",
            "mixed1_b3x3dbl_3", "mixed2_b3x3dbl_2", "mixed2_b3x3dbl_3", "mixed3_b3x3dbl_2",
            "mixed9_b3x3dbl_2", "mixed10_b3x3dbl_2")


@pytest.fixture(scope="module")
def pair():
    return te.build_pair("gridTD", "inception_v3")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_spec_matches_jax():
    assert tinc.SPEC == jinc._SPEC and tinc.CONV_ORDER == jinc.CONV_ORDER
    assert tinc.CONV_DIMS == jinc._CONV_DIMS and tinc.CHANNELS == jinc._CHANNELS
    assert tinc.BN_EPS == jinc.BN_EPS and tinc.CHANNELS["mixed10"] == 2048
    k3 = tuple(op[1] for op in tinc.SPEC if op[0] == "conv" and op[4] == (3, 3)
               and op[5] == 1 and op[6] == "SAME" and op[2] != "input")
    assert k3 == K3_CONVS


@pytest.mark.parametrize("until", ["mixed10", "mixed5"])
def test_forward_matches_jax(pair, until):
    _, pj, _, pt = pair
    x = te.images("inception_v3")
    ref = np.asarray(jinc.inception_v3_apply(pj["vgg"], jnp.asarray(x), until=until))
    got = tinc.inception_v3_apply(pt["vgg"], _t(x), until=until).numpy()
    assert got.shape == ref.shape
    assert te.rel(got, ref) <= 1e-5


@pytest.mark.parametrize("window, stride, padding, size", [
    (3, 1, "SAME", 7), (3, 1, "SAME", 5), (3, 2, "VALID", 9), (2, 2, "VALID", 8),
    (3, 1, "SAME", 8)])
def test_average_pool_and_z_rule_match_jax(window, stride, padding, size):
    """The pool divides by its in-image taps (count_include_pad=False); its
    VJP and the z-rule (AveragePoolingReverseLayer), words as the batch."""
    rng = np.random.default_rng(size + window)
    x = rng.normal(size=(1, size, size, 4)).astype(np.float32)
    y = np.asarray(jil._pool(jnp.asarray(x), "avg", window, stride, padding))
    assert te.rel(tconv.avgpool2d(_t(x), window, stride, padding=padding).numpy(), y) <= 1e-6
    r = rng.normal(size=(3, *y.shape[1:])).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jil._pool(t, "avg", window, stride, padding),
                     jnp.broadcast_to(x, (3, *x.shape[1:])))
    got = tconv.avgpool2d_input_vjp(_t(r), x.shape, window, stride, padding).numpy()
    assert te.rel(got, vjp(jnp.asarray(r))[0]) <= 1e-6
    z = y + np.where(y >= 0, 1e-7, -1e-7)
    ref = np.broadcast_to(x, (3, *x.shape[1:])) * np.asarray(vjp(jnp.asarray(r / z))[0])
    got = tconv.lrp_avgpool(_t(r), _t(x), window, stride, padding=padding).numpy()
    assert te.rel(got, ref) <= 1e-4


@pytest.mark.parametrize("method", METHODS)
def test_explainer_matches_jax(pair, method):
    """Every method but deep_lift (below, in f64) through Explainer.analyze_batch."""
    te.check_explainer(*pair, method, "inception_v3")


def test_deeplift_matches_jax_in_f64(pair):
    _, pj, _, pt = pair
    x = te.images("inception_v3", n=1).astype(np.float64)
    seeds = np.random.default_rng(4).normal(size=(2, 1, 1, 2048))
    with jax.enable_x64(True):
        pj64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), pj["vgg"])
        ref = np.asarray(jax.jit(jil.inception_deeplift_wordbatched)(
            pj64, jnp.asarray(x), jnp.asarray(seeds)))
    got = til.inception_deeplift_wordbatched(tree_to(pt["vgg"], dtype=torch.float64), _t(x),
                                             _t(seeds)).numpy()
    assert got.shape == (2, 75, 75, 3) and te.rel(got, ref) <= 1e-9


def test_concat_split_reaches_the_conv_rule_contiguous(pair, monkeypatch):
    """A concat hands each branch a slice of its relevance; the walk makes it
    contiguous before a conv rule takes it, and the K3 rule sees exactly the
    10 eligible convs (the CUDA wrapper raises on a strided tensor)."""
    _, _, _, pt = pair
    seen = []
    plain = cnn_lrp.lrp_conv_a1b0

    def spy(r, x, kernel, bias):
        seen.append((tuple(kernel.shape), r.is_contiguous(), bias is None))
        return plain(r, x, kernel, bias)

    monkeypatch.setattr(cnn_lrp, "lrp_conv_a1b0", spy)
    x = _t(te.images("inception_v3", n=1))
    seeds = _t(np.random.default_rng(8).normal(size=(2, 1, 1, 2048)).astype(np.float32))
    out = til.inception_lrp_wordbatched(pt["vgg"], x, seeds)
    assert out.shape == (2, 75, 75, 3)
    assert len(seen) == len(K3_CONVS)
    assert all(shape[:2] == (3, 3) and contiguous and no_bias
               for shape, contiguous, no_bias in seen)


def test_guided_gradcam_resize_296_to_299_matches_jax():
    """Inception's 8x8 grid upscaled by 299 // 8 = 37 is 296 wide; the CAM is
    then resized bilinearly to the image, as jax.image.resize does."""
    cam = np.random.default_rng(9).random((3, 296, 296)).astype(np.float32)
    got = cnn_gradient.resize_bilinear(_t(cam), (299, 299)).numpy()
    ref = np.stack([np.asarray(jax.image.resize(jnp.asarray(c), (299, 299), "bilinear"))
                    for c in cam])
    assert got.shape == (3, 299, 299) and te.rel(got, ref) <= 1e-6


def test_preprocessing_matches_jax(tmp_path):
    """[-1, 1] scaling at 299x299 by default, through the PIL path."""
    PIL = pytest.importorskip("PIL.Image")
    from lrp_imagecaptioning_tpu.data import images as jimg
    from lrp_imagecaptioning_torch.data import images as timg

    path = os.path.join(tmp_path, "a.png")
    arr = np.random.default_rng(10).integers(0, 256, size=(40, 50, 3)).astype(np.uint8)
    PIL.fromarray(arr).save(path)
    t = timg.ImagePreprocessor(encoder="inception_v3")
    j = jimg.ImagePreprocessor(encoder="inception_v3")
    got = np.asarray(t.preprocess_images([path]))
    assert got.shape == (1, 299, 299, 3) and got.min() >= -1.0 and got.max() <= 1.0
    np.testing.assert_array_equal(got, np.asarray(j.preprocess_images([path])))


def test_h5_round_trip_from_the_jax_writer(pair, tmp_path):
    from lrp_imagecaptioning_tpu.models.weights_io import save_reference_checkpoint_h5
    from lrp_imagecaptioning_torch.models.weights_io import load_reference_checkpoint_h5

    _, pj, _, _ = pair
    path = os.path.join(tmp_path, "inception.h5")
    save_reference_checkpoint_h5(path, pj, "gridTD", "inception_v3")
    got = load_reference_checkpoint_h5(path, "gridTD", "inception_v3", device="cpu")
    ref = params_from_jax(pj, "cpu")
    leaves = te.tree_pairs(ref, got)
    assert len(leaves) == len(jax.tree.leaves(pj))
    for path_, a, b in leaves:
        assert torch.equal(a, b), path_
