"""PyTorch port: the CNN side's DeepTaylor (``explain/cnn_lrp.py::vgg_deep_taylor``)
and DeepLIFT (``explain/cnn_deeplift.py``), and the Explainer's
``deep_taylor`` and ``deep_lift`` methods, against the JAX package on the
same params (``params_from_jax``) and numpy-seeded inputs.

Maps are held to 1e-4 of their scale (max |JAX|), as the port's other LRP
maps (tests/test_torch_explain.py): the divides by z (DeepTaylor) amplify
last-ulp differences of the forward sums. DeepLIFT divides by Δy = y - y_ref,
the difference of two conv outputs that take both signs of weight, which
cancels near a ReLU's edge and near the reference: at these sizes an f32
run, the JAX package's as the port's, lies far more than 1e-4 of the scale
from an f64 one. So the DeepLIFT functions are held to the JAX package
in f64 on both sides (``jax.enable_x64``), with drawn biases, the zero
reference and a reference image; the Explainer's ``deep_lift`` in f32 at
the engine tests' size, where the tap is two convs deep; and the port's f32
walk against the JAX package's f64 walk over the port's own f32 forward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.explain import cnn_deeplift as j_dl  # noqa: E402
from lrp_imagecaptioning_tpu.explain.cnn_lrp import vgg_deep_taylor as j_deep_taylor  # noqa: E402
from lrp_imagecaptioning_tpu.explain.engine import Explainer as JExplainer  # noqa: E402
from lrp_imagecaptioning_tpu.models import vgg as jvgg  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain import cnn_deeplift as t_dl  # noqa: E402
from lrp_imagecaptioning_torch.explain.cnn_lrp import vgg_deep_taylor as t_deep_taylor  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_to  # noqa: E402

torch.set_num_threads(2)

MAP_RTOL = 1e-4
UNTIL = "block3_conv1"    # three pools' worth of convs at 16x16 -> a 4x4x256 tap
SIZE = 16
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")
# the Explainer at the engine tests' size (tests/test_torch_explainer.py)
SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
             img_feature_dim=128, sentence_length=5, image_size=(8, 8))
VOCAB = 16
TOKENS = np.array([[5, 7, 6, 2, 0],
                   [5, 7, 6, 8, 3]], np.int32)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if ref.size == 0:
        return 0.0
    scale = np.abs(ref).max()
    return 0.0 if scale == 0 else float(np.abs(got - ref).max() / scale)


def _vgg(seed=2):
    """JAX VGG params with biases drawn (the init's are zero) and their port."""
    pj = jvgg.init_vgg_params(jax.random.PRNGKey(seed), "vgg16", UNTIL)
    rng = np.random.default_rng(seed)
    for p in pj.values():
        p["bias"] = jnp.asarray(rng.normal(size=p["bias"].shape).astype(np.float32) * 0.05)
    return pj, params_from_jax(pj, "cpu")


def _inputs(n_img, n_seed, seed=0):
    rng = np.random.default_rng(seed)
    image = (rng.normal(size=(n_img, SIZE, SIZE, 3)) * 40).astype(np.float32)
    seeds = rng.normal(size=(n_seed, SIZE // 4, SIZE // 4, 256)).astype(np.float32)
    return image, seeds


def test_deep_taylor_matches_jax_per_image():
    pj, pt = _vgg()
    image, seeds = _inputs(2, 2)
    ref = j_deep_taylor(pj, jnp.asarray(image), jnp.asarray(seeds), "vgg16", UNTIL)
    got = t_deep_taylor(pt, torch.from_numpy(image), torch.from_numpy(seeds), until=UNTIL)
    assert np.abs(np.asarray(ref)).max() > 0
    assert _rel(got.numpy(), ref) <= MAP_RTOL


def test_deep_taylor_words_as_the_batch_match_jax_per_word():
    """One image, three word seeds in one call: each the JAX map of that seed
    alone (the engine's vmap over seeds)."""
    pj, pt = _vgg(3)
    image, seeds = _inputs(1, 3, seed=1)
    got = t_deep_taylor(pt, torch.from_numpy(image), torch.from_numpy(seeds), until=UNTIL)
    for w in range(3):
        ref = j_deep_taylor(pj, jnp.asarray(image), jnp.asarray(seeds[w:w + 1]), "vgg16", UNTIL)
        assert _rel(got[w:w + 1].numpy(), ref) <= MAP_RTOL


def test_deep_taylor_ignores_negative_seed():
    """The ReLU on the seed: a negated seed carries no relevance."""
    _, pt = _vgg()
    image, seeds = _inputs(1, 1, seed=2)
    seeds = -np.abs(seeds)
    out = t_deep_taylor(pt, torch.from_numpy(image), torch.from_numpy(seeds), until=UNTIL)
    assert float(out.abs().max()) == 0.0


def _reference_image(image, seed, share=0.5):
    """A reference that equals ``image`` on a ``share`` of its pixels (Δx = 0
    there: the gradient switch's case) and is drawn elsewhere."""
    rng = np.random.default_rng(1000 + seed)
    other = (rng.normal(size=image.shape) * 40).astype(np.float32)
    return np.where(rng.random(image.shape[:3] + (1,)) < share, image, other)


def _deeplift_pair(pj, pt, image, seeds, reference, **kw):
    """(port, JAX) DeepLIFT maps in f64; ``seeds`` None: the standalone head."""
    with jax.enable_x64(True):
        pj64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), pj)
        x = jnp.asarray(image, jnp.float64)
        if seeds is None:
            ref = j_dl.vgg_deeplift_standalone(pj64, x, "vgg16", UNTIL,
                                               reference_inputs=reference, **kw)
        else:
            ref = j_dl.vgg_deeplift(pj64, x, jnp.asarray(seeds, jnp.float64), "vgg16", UNTIL,
                                    reference_inputs=reference, **kw)
        ref = np.asarray(ref)
    pt64 = tree_to(pt, dtype=torch.float64)
    x, r = torch.from_numpy(image).double(), torch.as_tensor(reference, dtype=torch.float64)
    if seeds is None:
        got = t_dl.vgg_deeplift_standalone(pt64, x, until=UNTIL, reference_inputs=r, **kw)
    else:
        got = t_dl.vgg_deeplift(pt64, x, torch.from_numpy(seeds).double(), until=UNTIL,
                                reference_inputs=r, **kw)
    assert ref.dtype == np.float64 and got.dtype == torch.float64
    return got.numpy(), ref


@pytest.mark.parametrize("approximate_gradient", [True, False])
@pytest.mark.parametrize("standalone", [False, True])
@pytest.mark.parametrize("reference", ["zero", "drawn", "half"])
def test_deeplift_matches_jax(approximate_gradient, standalone, reference):
    pj, pt = _vgg(5)
    image, seeds = _inputs(2, 2, seed=4)
    ref_img = {"zero": 0.0, "drawn": _reference_image(image, 4, share=0.0),
               "half": _reference_image(image, 4)}[reference]
    got, ref = _deeplift_pair(pj, pt, image, None if standalone else seeds, ref_img,
                              approximate_gradient=approximate_gradient)
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= MAP_RTOL


def test_deeplift_words_as_the_batch_match_jax_per_word():
    """One image, three word seeds in one call (both forwards once): each the
    JAX map of that seed alone."""
    pj, pt = _vgg(6)
    image, seeds = _inputs(1, 3, seed=5)
    got = t_dl.vgg_deeplift(tree_to(pt, dtype=torch.float64), torch.from_numpy(image).double(),
                            torch.from_numpy(seeds).double(), until=UNTIL).numpy()
    for w in range(3):
        _, ref = _deeplift_pair(pj, pt, image, seeds[w:w + 1], 0.0)
        assert _rel(got[w:w + 1], ref) <= MAP_RTOL


@pytest.mark.parametrize("reference", ["zero", "half"])
def test_deeplift_f32_walk_matches_jax_f64_walk_over_its_forward(reference):
    """The port's f32 DeepLIFT against the JAX package's f64 backward walk
    over the port's own f32 forward, promoted exactly: the forward's rounding
    is then shared, so only the walk's own f32 rounding remains, within
    MAP_RTOL (the smoke's 10a holds the card so)."""
    from lrp_imagecaptioning_torch.models.vgg import vgg_apply_with_acts

    pj, pt = _vgg(8)
    image, seeds = _inputs(2, 2, seed=7)
    x, s = torch.from_numpy(image), torch.from_numpy(seeds)
    x_ref = (torch.zeros_like(x) if reference == "zero"
             else torch.from_numpy(_reference_image(image, 7)))
    got = t_dl.vgg_deeplift(pt, x, s, until=UNTIL, reference_inputs=x_ref).numpy()
    top, acts = vgg_apply_with_acts(pt, x, until=UNTIL)
    top_ref, acts_ref = vgg_apply_with_acts(pt, x_ref, until=UNTIL)
    with jax.enable_x64(True):
        def f64(a):
            return jnp.asarray(np.asarray(a), jnp.float64)

        ref = np.asarray(j_dl._deeplift_backward(
            jax.tree.map(f64, pj), f64(seeds), jvgg.vgg_layers("vgg16", UNTIL),
            [f64(a) for a in acts], [f64(a) for a in acts_ref], f64(top), f64(top_ref), True))
    assert ref.dtype == np.float64 and np.abs(ref).max() > 0
    assert _rel(got, ref) <= MAP_RTOL


def test_deeplift_gradient_switch_fires():
    """Where Δx is 0 (the image equals the reference) the plain gradient takes
    over: with the switch off those pixels carry zero."""
    _, pt = _vgg(7)
    image, seeds = _inputs(1, 1, seed=6)
    x, s = torch.from_numpy(image), torch.from_numpy(seeds)
    ref = torch.from_numpy(_reference_image(image, 6))
    same = x == ref
    assert 0 < float(same.double().mean()) < 1
    on = t_dl.vgg_deeplift(pt, x, s, until=UNTIL, reference_inputs=ref, approximate_gradient=True)
    off = t_dl.vgg_deeplift(pt, x, s, until=UNTIL, reference_inputs=ref, approximate_gradient=False)
    assert float(off[same].abs().max()) == 0.0 and float(on[same].abs().max()) > 0


_MODELS = {}


def _pair(model_type, method):
    if model_type not in _MODELS:
        jcap = j_build(model_type, JConfig(drop_rate=0.0, **SMALL), VOCAB)
        pj = jcap.init_params(jax.random.PRNGKey(3))
        _MODELS[model_type] = (jcap, pj, t_build(model_type, TConfig(**SMALL), VOCAB),
                               params_from_jax(pj, "cpu"))
    jcap, pj, tcap, pt = _MODELS[model_type]

    class PP:
        SOS_TOKEN, EOS_TOKEN = "szeros", "zeros"
        SOS_TOKEN_LABEL_ENCODED, EOS_TOKEN_LABEL_ENCODED = 1, 2
        word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}

    return (JExplainer(jcap, pj, PP(), method=method, beam_size=2),
            Explainer(tcap, pt, PP(), method=method, beam_size=2, device="cpu"))


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.words == r.words and g.caption == r.caption
        np.testing.assert_array_equal(g.tokens_1based, r.tokens_1based)
        for name in FIELDS:
            assert _rel(getattr(g, name), np.asarray(getattr(r, name))) <= MAP_RTOL, name


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
@pytest.mark.parametrize("method", ["deep_taylor", "deep_lift"])
def test_explainer_method_matches_jax(model_type, method):
    """Decoded captions token-exact, then given ones; every array within 1e-4
    of its scale."""
    jex, tex = _pair(model_type, method)
    images = (np.random.default_rng(8).normal(size=(2, 8, 8, 3)) * 40).astype(np.float32)
    _assert_same(tex.analyze_batch(images), jex.analyze_batch(images))
    got = tex.analyze_batch(images, tokens_1based=TOKENS)
    _assert_same(got, jex.analyze_batch(images, tokens_1based=TOKENS))
    assert sum(np.abs(e.relevance_maps).sum() for e in got) > 0


def test_explainer_storage_dtype_leaves_deep_methods_in_f32():
    """As in the JAX package, storage_dtype applies to ``lrp`` only: DeepTaylor
    under bf16 storage gives the f32 maps."""
    _, tex = _pair("adaptiveattention", "deep_taylor")
    tbf = Explainer(tex.captioner, tex.params, tex._pp, method="deep_taylor", beam_size=2,
                    device="cpu", storage_dtype=torch.bfloat16)
    images = (np.random.default_rng(9).normal(size=(1, 8, 8, 3)) * 40).astype(np.float32)
    a = tex.analyze_batch(images, tokens_1based=TOKENS[:1])[0]
    b = tbf.analyze_batch(images, tokens_1based=TOKENS[:1])[0]
    np.testing.assert_array_equal(a.relevance_maps, b.relevance_maps)
