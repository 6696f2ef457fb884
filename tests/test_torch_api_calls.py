"""The JAX package's call forms on the port, at tiny widths on the CPU: each
test makes the JAX-form call (positional where the JAX package's order
differed from the port's) on both packages, from inputs drawn with numpy
from a seed, and compares the results.

Tolerances: f64 rules within 1e-7 of their scale (as
tests/test_torch_analyzers.py holds them); f32 maps within 1e-4 of their scale and the fine-tuner's
metrics within 1e-5 (as tests/test_torch_gradient.py and
tests/test_torch_multi_step_entry.py hold them); parameters, checkpoints
and the forward that changes no sum bit for bit.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_leaves  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_multi_step import _assert_update_close  # noqa: E402
from test_torch_multi_step_entry import _Provider  # noqa: E402

torch.set_num_threads(2)

F64_RTOL = 1e-7
MAP_RTOL = 1e-4
KW = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
          img_feature_dim=128, sentence_length=6, batch_size=4, drop_rate=0.0)
VOCAB, B, T, LR = 32, 4, 7, 1e-3


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _f64(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]


def _jax64(fn, *arrays):
    with jax.enable_x64(True):
        return np.asarray(fn(*[jnp.asarray(a, jnp.float64) for a in arrays]))


# -- the calls that bound to another parameter before ------------------------------


def test_lrp_finetuner_positional_steps_per_call(tmp_path):
    """``LRPFinetuner(cap, params, provider, "mean", lr, 0, 2)``: 2 steps a
    call on both packages (it asked the port to explain 2 words before),
    over 2 batches, without dropout: the chunk's metrics and the update."""
    from lrp_imagecaptioning_tpu.train import lrp_finetune as jft
    from lrp_imagecaptioning_torch.train import lrp_finetune as tft

    jcap = j_build("adaptiveattention", JConfig(**KW, image_size=(8, 8)), VOCAB)
    tcap = t_build("adaptiveattention", TConfig(**KW), VOCAB)
    pj = jcap.init_params(jax.random.PRNGKey(0))
    pt = params_from_jax(pj, "cpu")
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(2):
        y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(B, T))]
        y[0, -2:] = 0
        batches.append((rng.normal(size=(B, 8, 8, 3)).astype(np.float32),
                        rng.integers(0, VOCAB, size=(B, T)).astype(np.int32), y))
    tuner = tft.LRPFinetuner(tcap, pt, _Provider(batches), "mean", LR, 0, 2, device="cpu")
    jtuner = jft.LRPFinetuner(jcap, pj, _Provider(batches), "mean", LR, 0, 2)
    assert tuner._steps_per_call == 2 and tuner._multi_step is not None
    got = tuner.run(save_idx=0, epoch_length=2, result_dir=str(tmp_path / "torch"))
    want = jtuner.run(save_idx=0, epoch_length=2, result_dir=str(tmp_path / "jax"))
    for k in ("loss", "accuracy"):
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), (k, got, want)
    _assert_update_close(pt, tuner.params, jtuner.params)


@pytest.mark.parametrize("nonneg", [False, True])
def test_lrp_conv_alpha_beta_positional_alpha_beta(nonneg):
    """``lrp_conv_alpha_beta(r, x, W, b, 2.0, 1.0)`` is alpha2beta1 on both
    packages (alpha1beta0 with input_nonneg=2.0 in the port before), and
    the rest of JAX's positional order (stride, padding, factor) holds."""
    from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv
    from lrp_imagecaptioning_torch.ops import lrp_conv as tconv

    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 8, 2))
    x = np.abs(x) if nonneg else x
    k, b = rng.normal(size=(3, 3, 2, 3)), rng.normal(size=(3,)) * 0.1
    r = rng.normal(size=(1, 3, 3, 3))
    got = tconv.lrp_conv_alpha_beta(*_f64(r, x, k, b), 2.0, 1.0, 2, "VALID", 1e-3,
                                    input_nonneg=nonneg).numpy()
    ref = _jax64(lambda *a: jconv.lrp_conv_alpha_beta(*a, 2.0, 1.0, 2, "VALID", 1e-3,
                                                      input_nonneg=nonneg), r, x, k, b)
    assert _rel(got, ref) <= F64_RTOL
    a1b0 = tconv.lrp_conv_alpha_beta(*_f64(r, x, k, b), 1.0, 0.0, 2, "VALID").numpy()
    assert _rel(got, a1b0) > 1e-3


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"), (2, "VALID")])
def test_conv2d_input_vjp_jax_order(stride, padding):
    """``conv2d_input_vjp(x_shape, kernel, cotangent, stride, padding)``."""
    from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv
    from lrp_imagecaptioning_torch.ops import lrp_conv as tconv

    rng = np.random.default_rng(2)
    x_shape = (2, 9, 9, 3)       # SAME pads 9 symmetrically at strides 1 and 2
    k = rng.normal(size=(3, 3, 3, 4))
    out = -(-9 // stride) if padding == "SAME" else (9 - 3) // stride + 1
    cot = rng.normal(size=(2, out, out, 4))
    got = tconv.conv2d_input_vjp(x_shape, *_f64(k, cot), stride, padding).numpy()
    ref = _jax64(lambda k_, c_: jconv.conv2d_input_vjp(x_shape, k_, c_, stride, padding), k, cot)
    assert _rel(got, ref) <= F64_RTOL
    with pytest.raises(TypeError):
        tconv.conv2d_input_vjp(*_f64(k, cot), x_shape)


def test_lrp_avgpool_positional_eps():
    """``lrp_avgpool(r, x, window, stride, eps)``: the 5th argument is the
    stabilizer on both packages (it was the padding in the port before)."""
    from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv
    from lrp_imagecaptioning_torch.ops import lrp_conv as tconv

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 3)) * 1e-2
    r = rng.normal(size=(2, 4, 4, 3))
    got = tconv.lrp_avgpool(*_f64(r, x), 2, 2, 1e-2).numpy()
    ref = _jax64(lambda r_, x_: jconv.lrp_avgpool(r_, x_, 2, 2, 1e-2), r, x)
    assert _rel(got, ref) <= F64_RTOL
    assert _rel(got, tconv.lrp_avgpool(*_f64(r, x), 2, 2).numpy()) > 1e-3


def test_vgg_apply_vgg19_positional():
    """``vgg_apply(p, x, "vgg19", "block3_conv1")``: VGG19's layers up to
    block3_conv1 on both packages, bit for bit (the port ran a ValueError
    or another network before)."""
    from lrp_imagecaptioning_tpu.models import vgg as jvgg
    from lrp_imagecaptioning_torch.models import vgg as tvgg

    pj = jvgg.init_vgg_params(jax.random.PRNGKey(1), "vgg19", "block3_conv1")
    pt = params_from_jax(pj, "cpu")
    x = np.random.default_rng(4).normal(size=(2, 16, 16, 3)).astype(np.float32)
    got = tvgg.vgg_apply(pt, torch.from_numpy(x), "vgg19", "block3_conv1")
    ref = np.asarray(jvgg.vgg_apply(pj, jnp.asarray(x), "vgg19", "block3_conv1"))
    assert _rel(got.numpy(), ref) <= MAP_RTOL
    assert [op[1] for op in tvgg.vgg_layers("vgg19", "block3_conv1")] == \
        [op[1] for op in jvgg.vgg_layers("vgg19", "block3_conv1")]
    torch.testing.assert_close(tvgg.vgg_apply(pt, torch.from_numpy(x), arch="vgg19",
                                              until="block3_conv1"), got, rtol=0, atol=0)


def test_init_params_jax_form_reuses_the_encoder(tmp_path):
    """``init_params(seed, vocab_words, word_vector_path, encoder_params=...)``:
    the given encoder tree is the params' 'vgg', the vector file's rows
    are the embedding's, the trees have JAX's structure and shapes."""
    from lrp_imagecaptioning_tpu.models import vgg as jvgg

    p = tmp_path / "glove.txt"
    p.write_text("dog 1.0 0.0 0.5 0.0\ncat 0.0 1.0 0.0 0.25\n")
    small = dict(embedding_dim=4, hidden_dim=8, img_feature_length=4, img_feature_dim=128,
                 sentence_length=4, layer_name="block2_conv1", pretrained_word_vector="glove")
    vocab = ["dog", "zzz", "cat"]
    enc_j = jvgg.init_vgg_params(jax.random.PRNGKey(5), "vgg16", "block2_conv1")
    enc_np = jax.tree.map(np.asarray, enc_j)
    ref = j_build("adaptiveattention", JConfig(drop_rate=0.0, **small), 3).init_params(
        jax.random.PRNGKey(0), vocab, str(p), enc_j)
    cap = t_build("adaptiveattention", TConfig(**small), 3)
    got = cap.init_params(0, vocab, str(p), enc_np, device="cpu")
    for name in enc_np:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got["vgg"][name][leaf].numpy(), enc_np[name][leaf])
    np.testing.assert_array_equal(got["decoder"]["embedding"][[0, 2]].numpy(),
                                  np.asarray(ref["decoder"]["embedding"])[[0, 2]])
    shapes = [tuple(t.shape) for t in tree_leaves(got)]
    assert shapes == [tuple(np.shape(a)) for a in tree_leaves(jax.tree.map(np.asarray, ref))]
    with pytest.raises(TypeError):
        cap.init_params(0, "cpu")


def test_run_stepped_steps_jax_order_with_a_generator():
    """``run_stepped_steps(generator, steps, K, place, split_rng, multi_fn,
    single_fn, params, opt_state, record)``: the port's dropout generator
    in split_rng's place reaches every step; a JAX key function raises."""
    from lrp_imagecaptioning_torch.train import step as tstep

    def batches():
        for s in (4, 4, 4):
            yield ((np.zeros((s, 2)), np.zeros((s, 3))), np.zeros((s, 5)))

    g, seen = torch.Generator(), []

    def fn(p, o, imgs, cap, y, rng):
        seen.append(rng)
        return p + 1, o, {"loss": 0.0}

    p, _ = tstep.run_stepped_steps(batches(), 3, 2, lambda a: a, g, fn, fn, 0, None,
                                   lambda m: None)
    assert p == 2 and seen == [g, g]
    with pytest.raises(TypeError):
        tstep.run_stepped_steps(batches(), 3, 2, lambda a: a, lambda n: [None] * n, fn, fn, 0,
                                None, lambda m: None)


# -- the names the port lacked ------------------------------------------------------


@pytest.fixture(scope="module")
def vgg_setup():
    from lrp_imagecaptioning_tpu.models import vgg as jvgg

    pj = jvgg.init_vgg_params(jax.random.PRNGKey(2), "vgg16", "block2_conv1")
    rng = np.random.default_rng(9)
    image = (rng.normal(size=(2, 8, 8, 3)) * 40).astype(np.float32)
    seed = rng.normal(size=(2, 4, 4, 128)).astype(np.float32)
    return pj, params_from_jax(pj, "cpu"), image, seed


@pytest.mark.parametrize("name", ["vgg_gradient", "vgg_input_times_gradient",
                                  "vgg_guided_backprop", "vgg_deconvnet",
                                  "vgg_integrated_gradients", "vgg_smoothgrad"])
def test_vgg_gradient_functions_match_jax(vgg_setup, name):
    """The JAX package's ``vgg_*`` gradient functions, one seed an image,
    called alike; SmoothGrad's noise is JAX's draws."""
    from lrp_imagecaptioning_tpu.explain import cnn_gradient as jg
    from lrp_imagecaptioning_torch.explain import cnn_gradient as tg

    pj, pt, image, seed = vgg_setup
    args = ("vgg16", "block2_conv1")
    if name == "vgg_smoothgrad":
        key, n = jax.random.PRNGKey(3), 3
        ref = jg.vgg_smoothgrad(pj, jnp.asarray(image), jnp.asarray(seed), key, *args, n, 4.0)
        noise = np.stack([np.asarray(jax.random.normal(k, image.shape))
                          for k in jax.random.split(key, n)], axis=1)
        got = tg.vgg_smoothgrad(pt, torch.from_numpy(image), torch.from_numpy(seed), None,
                                *args, n, 4.0, noise=torch.from_numpy(noise))
    elif name == "vgg_integrated_gradients":
        base = np.full(image.shape, 3.0, np.float32)
        ref = jg.vgg_integrated_gradients(pj, jnp.asarray(image), jnp.asarray(seed), *args, 4,
                                          jnp.asarray(base))
        got = tg.vgg_integrated_gradients(pt, torch.from_numpy(image), torch.from_numpy(seed),
                                          *args, 4, torch.from_numpy(base))
    else:
        ref = getattr(jg, name)(pj, jnp.asarray(image), jnp.asarray(seed), *args)
        got = getattr(tg, name)(pt, torch.from_numpy(image), torch.from_numpy(seed), *args)
    assert _rel(got.numpy(), ref) <= MAP_RTOL


def test_vgg_guided_gradcam_matches_jax():
    """``vgg_guided_gradcam`` at the grid that the CAM's x16 upscale fits
    (block5_conv1 of a 32x32 image: 2x2), and ``grad_cam`` of one seed."""
    from lrp_imagecaptioning_tpu.explain import cnn_gradient as jg
    from lrp_imagecaptioning_tpu.models import vgg as jvgg
    from lrp_imagecaptioning_torch.explain import cnn_gradient as tg

    pj = jvgg.init_vgg_params(jax.random.PRNGKey(4), "vgg16", "block5_conv1")
    pt = params_from_jax(pj, "cpu")
    rng = np.random.default_rng(10)
    image = (rng.normal(size=(1, 32, 32, 3)) * 40).astype(np.float32)
    seed = np.abs(rng.normal(size=(1, 2, 2, 512))).astype(np.float32)   # a positive CAM
    feat = np.asarray(jvgg.vgg_apply(pj, jnp.asarray(image), "vgg16", "block5_conv1"))[0]
    ref = jg.vgg_guided_gradcam(pj, jnp.asarray(image), jnp.asarray(seed), jnp.asarray(feat),
                                "vgg16", "block5_conv1")
    got = tg.vgg_guided_gradcam(pt, torch.from_numpy(image), torch.from_numpy(seed),
                                torch.from_numpy(feat), "vgg16", "block5_conv1")
    assert _rel(got.numpy(), ref) <= MAP_RTOL
    cam = tg.grad_cam(torch.from_numpy(feat), torch.from_numpy(seed[0]))
    assert _rel(cam.numpy(), jg.grad_cam(jnp.asarray(feat), jnp.asarray(seed[0]))) <= MAP_RTOL


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD", "aoa"])
def test_reference_h5_written_by_the_port_reads_in_jax(tmp_path, model_type):
    """``save_reference_checkpoint_h5`` (the port's) read back by the JAX
    package's ``load_reference_checkpoint_h5``, bit for bit."""
    from lrp_imagecaptioning_tpu.models.weights_io import load_reference_checkpoint_h5
    from lrp_imagecaptioning_torch.models.weights_io import save_reference_checkpoint_h5

    pj = j_build(model_type, JConfig(**KW, image_size=(8, 8)), VOCAB).init_params(
        jax.random.PRNGKey(7))
    path = str(tmp_path / "ref.h5")
    save_reference_checkpoint_h5(path, params_from_jax(pj, "cpu"), model_type, "vgg16",
                                 KW["layer_name"])
    back = load_reference_checkpoint_h5(path, model_type, "vgg16", KW["layer_name"])
    want = jax.tree.map(np.asarray, pj)
    got = jax.tree.map(np.asarray, back)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_small_names():
    """greedy_decode_jit, MIXED10_CHANNELS, load_keras_vgg_h5 in models.vgg,
    save_params_npz / load_params_npz in train.checkpoint."""
    from lrp_imagecaptioning_tpu.models import inception as jinc
    from lrp_imagecaptioning_torch.infer import greedy
    from lrp_imagecaptioning_torch.models import inception as tinc
    from lrp_imagecaptioning_torch.models import vgg as tvgg
    from lrp_imagecaptioning_torch.train import checkpoint as tckpt
    from lrp_imagecaptioning_torch.weights import load_params_npz

    assert tinc.MIXED10_CHANNELS == jinc.MIXED10_CHANNELS == 2048
    assert tckpt.load_params_npz is load_params_npz and callable(tckpt.save_params_npz)
    assert callable(tvgg.load_keras_vgg_h5)
    cap = t_build("adaptiveattention", TConfig(**KW), VOCAB)
    params = cap.init_params(0, device="cpu")
    feat = torch.from_numpy(np.random.default_rng(11).normal(size=(2, 16, 128))
                            .astype(np.float32))
    a = greedy.greedy_decode_jit(cap, params, feat, 1, 2, 5)
    b = greedy.greedy_decode(cap, params, feat, 1, 2, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_load_keras_vgg_h5_jax_order(tmp_path):
    """``load_keras_vgg_h5(path, arch, until)`` on a file the JAX side wrote."""
    from lrp_imagecaptioning_tpu.models import vgg as jvgg
    from lrp_imagecaptioning_tpu.models.weights_io import save_reference_checkpoint_h5
    from lrp_imagecaptioning_torch.models import vgg as tvgg

    pj = j_build("adaptiveattention", JConfig(**KW, img_encoder="vgg19", image_size=(8, 8)),
                 VOCAB).init_params(jax.random.PRNGKey(8))
    path = str(tmp_path / "w.h5")
    save_reference_checkpoint_h5(path, pj, "adaptiveattention", "vgg19", KW["layer_name"])
    got = tvgg.load_keras_vgg_h5(path, "vgg19", KW["layer_name"])
    want = jvgg.load_keras_vgg_h5(path, "vgg19", KW["layer_name"])
    assert set(got) == set(want)
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf], np.asarray(want[name][leaf]))


# -- the parameters the port lacked -------------------------------------------------


@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (2, 1)])
def test_lrp_maxpool_wta_stride(window, stride):
    """``lrp_maxpool_wta(r, x, window, stride)``: stride != window takes the
    overlapping rule; against the JAX package (ties split alike)."""
    from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv
    from lrp_imagecaptioning_torch.ops import lrp_conv as tconv

    rng = np.random.default_rng(12)
    x = rng.integers(0, 4, size=(2, 9, 9, 3)).astype(np.float64)   # with ties
    out = (9 - window) // stride + 1
    r = rng.normal(size=(2, out, out, 3))
    got = tconv.lrp_maxpool_wta(*_f64(r, x), window, stride).numpy()
    ref = _jax64(lambda r_, x_: jconv.lrp_maxpool_overlapping_wta(r_, x_, window, stride), r, x)
    assert _rel(got, ref) <= F64_RTOL


def test_lrp_maxpool_overlapping_same_padding():
    """``padding="SAME"`` pads with -inf as TensorFlow pads: the relevance of
    each output reaches its window's max, held to autograd of the padded
    max pool (no ties)."""
    import torch.nn.functional as F

    from lrp_imagecaptioning_torch.ops import lrp_conv as tconv

    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 3)))
    r = torch.from_numpy(rng.normal(size=(2, 4, 4, 3)))
    got = tconv.lrp_maxpool_overlapping_wta(r, x, 3, 2, "SAME")
    xg = x.clone().requires_grad_(True)
    y = F.max_pool2d(F.pad(xg.permute(0, 3, 1, 2), (0, 1, 0, 1), value=float("-inf")), 3, 2)
    (want,) = torch.autograd.grad(y, xg, r.permute(0, 3, 1, 2))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert torch.isclose(got.sum(), r.sum())


@pytest.mark.parametrize("fn", ["lrp_linear", "lrp_identity", "lrp_bn", "lrp_add",
                                "deeplift_conv_linear", "deeplift_relu_rescale"])
def test_eps_and_factor_are_honoured(fn):
    """``eps`` / ``factor`` at 1e-2, positional at JAX's place, against the
    JAX package's rule (and away from the default's result)."""
    from lrp_imagecaptioning_tpu.explain import resnet_lrp as jres
    from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv
    from lrp_imagecaptioning_tpu.ops import lrp_core as jcore
    from lrp_imagecaptioning_torch.explain import resnet_lrp as tres
    from lrp_imagecaptioning_torch.ops import lrp_conv as tconv
    from lrp_imagecaptioning_torch.ops import lrp_core as tcore

    rng = np.random.default_rng(14)
    a = [rng.normal(size=(2, 6, 6, 4)) * 1e-2 for _ in range(5)]
    k, w = rng.normal(size=(3, 3, 4, 4)), rng.normal(size=(4, 4))
    calls = {
        "lrp_linear": (lambda m, r, x, z, w_, *e: m.lrp_linear(r, x, z, w_, *e), 3, tcore, jcore),
        "lrp_identity": (lambda m, r, x, z, *e: m.lrp_identity(r, x, z, *e), 3, tcore, jcore),
        "lrp_bn": (lambda m, r, x, y, mu, be, *e: m.lrp_bn(r, x, y, mu, be, *e), 5, tres, jres),
        "lrp_add": (lambda m, r, x, y, *e: m.lrp_add(r, [x, y], *e)[0], 3, tres, jres),
        "deeplift_relu_rescale": (lambda m, r, x, xr, *e: m.deeplift_relu_rescale(
            r, x, xr, True, *e), 3, tconv, jconv),
        "deeplift_conv_linear": (lambda m, r, x, xr, z, zr, k_, *e: m.deeplift_conv_linear(
            r, x, xr, z, zr, k_, 1, "SAME", True, *e), 5, tconv, jconv),
    }
    call, n, tmod, jmod = calls[fn]
    extra = {"lrp_linear": [w], "deeplift_conv_linear": [k]}.get(fn, [])
    arrays = a[:n] + extra
    got = call(tmod, *_f64(*arrays), 1e-2).numpy()
    ref = _jax64(lambda *xs: call(jmod, *xs, 1e-2), *arrays)
    assert _rel(got, ref) <= F64_RTOL
    assert _rel(got, call(tmod, *_f64(*arrays)).numpy()) > 1e-6


def test_kernel_lrp_linear_eps():
    """K1's wrapper: another eps runs the plain version on the CPU and raises
    ``ValueError`` for a tensor elsewhere (the kernel holds 1e-7)."""
    from lrp_imagecaptioning_torch.ops import kernels, lrp_core

    rng = np.random.default_rng(15)
    r, z = _f64(rng.normal(size=(3, 5)), rng.normal(size=(3, 5)))
    x, w = _f64(rng.normal(size=(3, 4)), rng.normal(size=(4, 5)))
    torch.testing.assert_close(kernels.lrp_linear(r, x, z, w, 1e-2),
                               lrp_core.lrp_linear(r, x, z, w, 1e-2), rtol=0, atol=0)
    meta = [t.to("meta") for t in (r, x, z, w)]
    with pytest.raises(ValueError, match="eps"):
        kernels.lrp_linear(*meta, 1e-2)


def test_init_dtype():
    """``dtype`` on the inits, as the JAX package's."""
    from lrp_imagecaptioning_torch.models import cells, inception, resnet, vgg

    gen = torch.Generator().manual_seed(0)
    trees = [vgg.init_vgg_params(gen, "vgg16", "block1_conv2", torch.float64),
             cells.lstm_init(gen, 4, 4, torch.float64), cells.dense_init(gen, 4, 3, torch.float64),
             {"w": cells.attn_weight_init(gen, (4, 4), torch.float64)},
             resnet.init_resnet50_params(gen, torch.float64)]
    assert all(t.dtype == torch.float64 for tree in trees for t in tree_leaves(tree))
    one = inception.init_inception_v3_params(torch.Generator().manual_seed(1), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(one))
    f32 = vgg.init_vgg_params(torch.Generator().manual_seed(2), "vgg16", "block1_conv2")
    f64 = vgg.init_vgg_params(torch.Generator().manual_seed(2), "vgg16", "block1_conv2",
                              torch.float64)
    for a, b in zip(tree_leaves(f32), tree_leaves(f64)):
        torch.testing.assert_close(a.double(), b, rtol=0, atol=0)


def test_lane_pack_has_no_effect(vgg_setup):
    """``vgg_lrp_preset_a_wordbatched(..., lane_pack=...)``: the same result
    both ways, as the JAX package's."""
    from lrp_imagecaptioning_torch.explain import cnn_lrp

    _, pt, image, seed = vgg_setup
    args = (pt, torch.from_numpy(image[:1]), torch.from_numpy(seed), "vgg16", "block2_conv1",
            None, torch.bfloat16)
    torch.testing.assert_close(cnn_lrp.vgg_lrp_preset_a_wordbatched(*args, True),
                               cnn_lrp.vgg_lrp_preset_a_wordbatched(*args, False), rtol=0, atol=0)


@pytest.mark.parametrize("multi", [False, True])
def test_donate_false_returns_unaliased_state(multi):
    """``donate=False``: the returned params and moments share no storage
    with the caller's, and equal ``donate=True``'s."""
    from lrp_imagecaptioning_torch.train import optimizer, step

    cap = t_build("adaptiveattention", TConfig(**KW), VOCAB)
    opt = optimizer.make_optimizer("adaptiveattention", LR)
    params = cap.init_params(0, device="cpu")
    rng = np.random.default_rng(16)
    lead = (2,) if multi else ()
    images = torch.from_numpy(rng.normal(size=(*lead, B, 8, 8, 3)).astype(np.float32))
    caps = torch.from_numpy(rng.integers(0, VOCAB, size=(*lead, B, T)))
    y = torch.from_numpy(np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (*lead, B, T))])
    make = step.make_multi_train_step if multi else step.make_train_step
    out = {}
    for donate in (True, False):
        state = opt.init(params)
        p1, s1, _ = make(cap, opt, donate)(params, state, images, caps, y, None)
        held = {t.untyped_storage().data_ptr() for t in tree_leaves((params, state))
                if isinstance(t, torch.Tensor)}
        mine = [t.untyped_storage().data_ptr() for t in tree_leaves((p1, s1))
                if isinstance(t, torch.Tensor)]
        if not donate:
            assert not held & set(mine)
        out[donate] = p1
    for a, b in zip(tree_leaves(out[True]), tree_leaves(out[False])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_restore_checkpoint_onto_templates(tmp_path):
    """``restore_checkpoint(path, params_template, opt_state_template)``: the
    tensors on the templates' devices and dtypes; a tree that differs from
    its template raises ``ValueError``."""
    from lrp_imagecaptioning_torch.train import checkpoint, optimizer
    from lrp_imagecaptioning_torch.weights import tree_map

    cap = t_build("adaptiveattention", TConfig(**KW), VOCAB)
    params = cap.init_params(0, device="cpu")
    opt_state = optimizer.make_optimizer("adaptiveattention", LR).init(params)
    path = checkpoint.save_checkpoint(str(tmp_path), 1, params, opt_state, 0.5)
    t64 = tree_map(lambda t: t.double(), params)
    p, s = checkpoint.restore_checkpoint(path, t64, dict(opt_state, mu=t64, nu=t64))
    assert all(t.dtype == torch.float64 for t in tree_leaves((p, s["mu"], s["nu"])))
    for a, b in zip(tree_leaves(p), tree_leaves(params)):
        torch.testing.assert_close(a, b.double(), rtol=0, atol=0)
    p_only, s_none = checkpoint.restore_checkpoint(path, params)
    assert s_none is not None and all(t.dtype == torch.float32 for t in tree_leaves(p_only))
    bad = dict(params, decoder=dict(params["decoder"], extra=torch.zeros(1)))
    with pytest.raises(ValueError, match="template"):
        checkpoint.restore_checkpoint(path, bad)
    with pytest.raises(TypeError):
        checkpoint.restore_checkpoint(path, "cpu")


def test_sharded_step_templates_and_donate():
    """``make_sharded_train_step(cap, opt, mesh, False, params_template,
    donate, opt_state_template)``: JAX's positional order; ``place_state``
    holds the state to the templates."""
    from lrp_imagecaptioning_torch.parallel import make_mesh
    from lrp_imagecaptioning_torch.train import optimizer, step

    cap = t_build("adaptiveattention", TConfig(**KW), VOCAB)
    opt = optimizer.make_optimizer("adaptiveattention", LR)
    params = cap.init_params(0, device="cpu")
    state = opt.init(params)
    mesh = make_mesh(devices=["cpu"] * 2)
    _, place = step.make_sharded_train_step(cap, opt, mesh, False, params, False, state)
    placed, _ = place(params, state)
    assert set(placed) == set(params)
    _, place_bad = step.make_sharded_multi_train_step(cap, opt, mesh, False,
                                                      {"vgg": params["vgg"]}, True, None)
    with pytest.raises(ValueError, match="template"):
        place_bad(params, state)
