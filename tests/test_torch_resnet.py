"""PyTorch port: ResNet-50/101 (models/resnet.py, explain/resnet_lrp.py) and
the generalized conv rules (ops/lrp_conv.py) against the JAX package on the
CPU.

Sizes: ResNet-50 at 64x64 (full channel widths, a 2x2x2048 grid), the
ResNet-101 topology at 32x32 (1x1 grid); E = H = 32, vocab 50, T = 5; the
encoder's params from the port's init with BatchNorm's statistics drawn from
a seed (tests/torch_encoders.py), the same tree on both sides.

Tolerances, each with its reason:
* forwards: 1e-5 of the output's scale (f32 sums in another order);
* the conv and pool rules: 1e-5 of scale; those that divide by a sum
  (alpha-beta, WSquare, BN, Add) 1e-4, the divide amplifies last ulps;
* the Explainer: every Explanation array within 1e-4 of its scale (max
  |JAX|; the arrays read at most 3e-6);
* IG and SmoothGrad: their scaled and noisy forwards near-tie ReLUs that f32
  flips in either package (~3e-3 of a map's scale), so the Explainer holds
  their other arrays as above and their CNN side is held in f64 on both
  sides (``torch_encoders.generic_cnn_f64``), 1e-9 of scale;
* DeepLIFT: in f64 on both sides, 1e-9 of scale (its Δy cancels in f32).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_encoders as te  # noqa: E402
from lrp_imagecaptioning_tpu.explain import resnet_lrp as jrl  # noqa: E402
from lrp_imagecaptioning_tpu.explain.engine import Explainer as JExplainer  # noqa: E402
from lrp_imagecaptioning_tpu.models import resnet as jres  # noqa: E402
from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv  # noqa: E402
from lrp_imagecaptioning_torch.explain import resnet_lrp as trl  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.models import resnet as tres  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.ops import lrp_conv as tconv  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_to  # noqa: E402

torch.set_num_threads(2)

METHODS = ("lrp", "deep_taylor", *te.GRADIENT_METHODS)


@pytest.fixture(scope="module")
def pair():
    return te.build_pair("adaptiveattention", "resnet50")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("depth", ["resnet50", "resnet101"])
def test_topology_matches_jax(depth):
    assert tres.conv_names(depth) == jres._conv_names(depth)
    assert tres._stages(depth) == jres._stages(depth)
    assert tres.BN_EPS == jres.BN_EPS
    twos = [c for c in tres.conv_names(depth) if c[0].endswith("2b")]
    assert len(twos) == {"resnet50": 16, "resnet101": 33}[depth]


@pytest.mark.parametrize("depth", ["resnet50", "resnet101"])
def test_forward_matches_jax(depth):
    enc = te.encoder_params(depth)
    x = te.images(depth)
    ref = np.asarray(jres.resnet50_apply(jax.tree.map(jnp.asarray, enc), jnp.asarray(x),
                                         depth=depth))
    got = tres.resnet50_apply(params_from_jax(enc, "cpu"), _t(x), depth=depth).numpy()
    assert got.shape == ref.shape == (2, *(s // 32 for s in x.shape[1:3]), 2048)
    assert te.rel(got, ref) <= 1e-5


def test_lrp_bn_and_add_match_jax():
    rng = np.random.default_rng(0)
    x, r = rng.normal(size=(2, 5, 5, 8)), rng.normal(size=(3, 5, 5, 8))
    mean, beta = rng.normal(0, 0.3, 8), rng.normal(0, 0.3, 8)
    y = (x - mean) * rng.uniform(0.5, 1.5, 8) + beta
    x, y, r, mean, beta = (a.astype(np.float32) for a in (x[:1], y[:1], r, mean, beta))
    got = trl.lrp_bn(*map(_t, (r, x, y, mean, beta))).numpy()
    ref = np.asarray(jrl.lrp_bn(*map(jnp.asarray, (r, x, y, mean, beta))))
    assert got.shape == (3, 5, 5, 8) and te.rel(got, ref) <= 1e-4
    a, b = rng.normal(size=(1, 4, 4, 8)).astype(np.float32), rng.normal(size=(1, 4, 4, 8)).astype(np.float32)
    for g, j in zip(trl.lrp_add(_t(r[:, :4, :4]), [_t(a), _t(b)]),
                    jrl.lrp_add(jnp.asarray(r[:, :4, :4]), [jnp.asarray(a), jnp.asarray(b)])):
        assert te.rel(g.numpy(), j) <= 1e-4


# (kernel, stride, padding, input height): ResNet's and Inception's convs
CONVS = [((7, 7), 2, "VALID", 14), ((7, 7), 2, "VALID", 13), ((1, 1), 2, "VALID", 8),
         ((1, 1), 1, "VALID", 5), ((3, 3), 1, "SAME", 7), ((3, 3), 2, "VALID", 9),
         ((5, 5), 1, "SAME", 7), ((1, 7), 1, "SAME", 6), ((7, 1), 1, "SAME", 6),
         ((1, 3), 1, "SAME", 5)]


@pytest.mark.parametrize("kernel, stride, padding, size", CONVS)
def test_generalized_conv_rules_match_jax(kernel, stride, padding, size):
    """conv2d, its transpose (back to the input's shape: output_padding on a
    stride 2), alpha1beta0 on a signed and a post-ReLU input, WSquare and
    DeepLIFT's LinearRule, words as the batch against one input."""
    rng = np.random.default_rng(size + stride)
    x = rng.normal(size=(1, size, size + 1, 4)).astype(np.float32)
    k = rng.normal(size=(*kernel, 4, 8)).astype(np.float32)
    y = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(k), stride, padding))
    assert te.rel(tconv.conv2d(_t(x), _t(k), stride, padding).numpy(), y) <= 1e-5
    r = rng.normal(size=(3, *y.shape[1:])).astype(np.float32)
    xs = np.broadcast_to(x, (3, *x.shape[1:]))
    vjp = tconv.conv2d_input_vjp(x.shape, _t(k), _t(r), stride, padding).numpy()
    assert vjp.shape == xs.shape
    assert te.rel(vjp, jconv.conv2d_input_vjp(xs.shape, jnp.asarray(k), jnp.asarray(r),
                                              stride, padding)) <= 1e-5
    for xin, nonneg in ((x, False), (np.maximum(x, 0), True)):
        got = tconv.lrp_conv_alpha_beta(_t(r), _t(xin), _t(k), None, input_nonneg=nonneg,
                                        stride=stride, padding=padding)
        ref = jconv.lrp_conv_alpha_beta(jnp.asarray(r), jnp.broadcast_to(xin, xs.shape),
                                        jnp.asarray(k), None,
                                        stride=stride, padding=padding, input_nonneg=nonneg)
        assert te.rel(got.numpy(), ref) <= 1e-4
    got = tconv.lrp_conv_wsquare(_t(r), _t(x), _t(k), stride, padding).numpy()
    assert te.rel(got, jconv.lrp_conv_wsquare(jnp.asarray(r), jnp.asarray(xs), jnp.asarray(k),
                                              stride, padding)) <= 1e-4
    x_ref = np.where(rng.random(x.shape) < 0.3, x, x * 0.5).astype(np.float32)
    z, z_ref = (np.asarray(jconv.conv2d(jnp.asarray(a), jnp.asarray(k), stride, padding))
                for a in (x, x_ref))
    for approximate in (True, False):
        got = tconv.deeplift_conv_linear(*map(_t, (r, x, x_ref, z, z_ref, k)), stride, padding,
                                         approximate).numpy()
        ref = jconv.deeplift_conv_linear(*map(jnp.asarray, (r, xs, x_ref, z, z_ref, k)), stride,
                                         padding, approximate)
        assert te.rel(got, ref) <= 1e-4


@pytest.mark.parametrize("approximate", [True, False])
def test_deeplift_relu_rescale_matches_jax(approximate):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 6, 6, 4)).astype(np.float32)
    x_ref = np.where(rng.random(x.shape) < 0.3, x, rng.normal(size=x.shape)).astype(np.float32)
    r = rng.normal(size=(2, 6, 6, 4)).astype(np.float32)
    got = tconv.deeplift_relu_rescale(_t(r), _t(x), _t(x_ref), approximate).numpy()
    ref = jconv.deeplift_relu_rescale(jnp.asarray(r), jnp.asarray(x), jnp.asarray(x_ref),
                                      approximate)
    assert te.rel(got, ref) <= 1e-5


@pytest.mark.parametrize("size", [7, 9, 10])
def test_overlapping_wta_splits_ties_like_jax(size):
    """3x3/2 VALID, integer-valued inputs after a ReLU: many ties, which split
    the relevance equally (JAX's reduce-max VJP)."""
    rng = np.random.default_rng(size)
    x = np.maximum(rng.integers(-2, 3, size=(1, size, size, 3)), 0).astype(np.float32)
    n = (size - 3) // 2 + 1
    r = rng.normal(size=(4, n, n, 3)).astype(np.float32)
    got = tconv.lrp_maxpool_overlapping_wta(_t(r), _t(x), 3, 2).numpy()
    ref = jconv.lrp_maxpool_overlapping_wta(jnp.asarray(r), jnp.broadcast_to(x, (4, *x.shape[1:])),
                                            3, 2)
    assert te.rel(got, ref) <= 1e-6
    np.testing.assert_allclose(got.sum(axis=(1, 2)), r.sum(axis=(1, 2)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_explainer_matches_jax(pair, method):
    """Every method but deep_lift (below, in f64) through Explainer.analyze_batch
    on given captions; on the CPU the lrp walk's 16 '2b' convs take K3's
    plain version, launching nothing."""
    kernels.reset_launches()
    te.check_explainer(*pair, method, "resnet50")
    assert kernels.conv3x3_fused.launches == 0


def test_decode_matches_jax(pair):
    """The beam-search caption, token for token."""
    jcap, pj, tcap, pt = pair
    img = te.images("resnet50", n=1, seed=5)[0]
    got = Explainer(tcap, pt, te.FakePP(), beam_size=2, device="cpu").predict_caption(img)
    ref = JExplainer(jcap, pj, te.FakePP(), beam_size=2).predict_caption(img)
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    assert got[1] == ref[1]


def _deeplift_f64(enc, depth, x, seeds, reference):
    with jax.enable_x64(True):
        pj64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), enc)
        ref = np.asarray(jax.jit(jrl.resnet_deeplift_wordbatched, static_argnums=3)(
            pj64, jnp.asarray(x, jnp.float64), jnp.asarray(seeds, jnp.float64), depth,
            reference_inputs=jnp.asarray(reference, jnp.float64)))
    got = trl.resnet_deeplift_wordbatched(
        tree_to(params_from_jax(enc, "cpu"), dtype=torch.float64), _t(x).double(),
        _t(seeds).double(), depth, reference_inputs=torch.as_tensor(reference).double())
    return got.numpy(), ref


def test_deeplift_matches_jax_in_f64():
    """Against a reference image equal to the input on half its pixels (Δx = 0
    there: the gradient switch's case)."""
    enc = te.encoder_params("resnet50")
    x = te.images("resnet50", n=1).astype(np.float64)
    seeds = np.random.default_rng(4).normal(size=(2, 2, 2, 2048))
    ref_img = np.where(np.random.default_rng(5).random(x.shape) < 0.5, x, 0.0)
    got, ref = _deeplift_f64(enc, "resnet50", x, seeds, ref_img)
    assert got.shape == (2, 64, 64, 3) and te.rel(got, ref) <= 1e-9


def test_lrp_walk_matches_jax_on_resnet101():
    """The LRP walk alone through ResNet-101's topology (its 33 '2b' convs on
    K3's plain version), two word seeds against one image."""
    enc = te.encoder_params("resnet101")
    x = te.images("resnet101", n=1)
    seeds = np.random.default_rng(6).normal(size=(2, 1, 1, 2048)).astype(np.float32)
    pj, pt = jax.tree.map(jnp.asarray, enc), params_from_jax(enc, "cpu")
    got = trl.resnet_lrp_wordbatched(pt, _t(x), _t(seeds), "resnet101").numpy()
    ref = np.asarray(jrl.resnet_lrp_wordbatched(pj, jnp.asarray(x), jnp.asarray(seeds),
                                                "resnet101"))
    assert got.shape == (2, 32, 32, 3) and te.rel(got, ref) <= 1e-4


def test_h5_round_trip_from_the_jax_writer(pair, tmp_path):
    from lrp_imagecaptioning_tpu.models.weights_io import save_reference_checkpoint_h5
    from lrp_imagecaptioning_torch.models.weights_io import load_reference_checkpoint_h5

    _, pj, _, _ = pair
    path = os.path.join(tmp_path, "resnet.h5")
    save_reference_checkpoint_h5(path, pj, "adaptiveattention", "resnet50")
    got = load_reference_checkpoint_h5(path, "adaptiveattention", "resnet50", device="cpu")
    leaves = []

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=path)
            leaves.append(path)

    walk(pj, got)
    assert len(leaves) == len(jax.tree.leaves(pj))


def test_cli_train_and_explain_with_resnet50(tmp_path, monkeypatch):
    """``cli.main`` train (one epoch) and explain with img_encoder=resnet50 on
    the mini-Flickr30k fixture at 64x64: a checkpoint, then a heatmap file
    per word."""
    from lrp_imagecaptioning_torch import cli
    from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k

    root = str(tmp_path / "mini")
    write_mini_flickr30k(root)
    monkeypatch.chdir(tmp_path)
    common = ["--dataset", "flickr30k", "--dataset-root", root, "--model", "adaptiveattention",
              "--batch-size", "4", "--device", "cpu"]
    for k, v in {"img_encoder": "resnet50", "image_size": "64,64", "layer_name": "activation_49",
                 "img_feature_length": "4", "img_feature_dim": "2048", "embedding_dim": "16",
                 "hidden_dim": "16", "sentence_length": "4", "words_min_occur": "1",
                 "rare_words_handling": "nothing", "drop_rate": "0.0"}.items():
        common += ["--set", f"{k}={v}"]
    cli.main(["train", *common, "--label", "r50", "--epochs", "1"])
    ckpt = sorted((tmp_path / "results/flickr30k/training-results/r50").glob("ckpt_*.npz"))
    assert ckpt
    image = sorted((tmp_path / "mini/Flickr30k_images").glob("*.jpg"))[0]
    cli.main(["explain", *common, "--weights", str(ckpt[-1]), "--image", str(image),
              "--method", "lrp", "--out", "ex"])
    assert list((tmp_path / "ex").rglob("*"))
