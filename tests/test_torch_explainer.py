"""PyTorch port: the ``Explainer`` (explain/engine.py) against the JAX
package's, for both decoders and every method the port has, at the engine
tests' small size (the ``block2_conv1`` tap, 8x8 images, E = H = 16, T = 5,
vocab 16) on the same params (``params_from_jax``) and numpy-seeded images.

Captions must be token-exact and every ``Explanation`` array within 1e-4 of
its scale (max |JAX|): the divides by stab(z) at eps = 1e-7 amplify
last-ulp differences, and the port encodes and runs the cached forward at
batch B where JAX runs batch 1 (another summation order). bf16 storage is
held as tests/test_torch_bf16.py holds it: to the JAX f32 maps as anchor,
within 2x the JAX bf16 run's distance and 3e-2 of scale. SmoothGrad takes
the JAX package's own noise (``jax.random``, keyed per word position).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.explain.engine import Explainer as JExplainer  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain import engine  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
             img_feature_dim=128, sentence_length=5, image_size=(8, 8))
VOCAB = 16
MAP_RTOL = 1e-4
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")
GRADIENT_METHODS = ("gradient", "input_times_gradient", "guided_backprop", "guided_gradcam",
                    "deconvnet", "integrated_gradients", "smoothgrad")
# 1, 3, 2, 5 (no EOS: full T) and 1 real words
TOKENS = np.array([[5, 2, 0, 0, 0],
                   [5, 7, 6, 2, 0],
                   [5, 7, 2, 0, 0],
                   [5, 7, 6, 8, 3],
                   [6, 2, 0, 0, 0]], np.int32)


class FakePP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}
    word_of[1], word_of[2] = "szeros", "zeros"


_MODELS = {}


def _models(model_type):
    """(JAX captioner, JAX params, port captioner, port params), once per model."""
    if model_type not in _MODELS:
        jcap = j_build(model_type, JConfig(drop_rate=0.0, **SMALL), VOCAB)
        pj = jcap.init_params(jax.random.PRNGKey(3))
        _MODELS[model_type] = (jcap, pj, t_build(model_type, TConfig(**SMALL), VOCAB),
                               params_from_jax(pj, "cpu"))
    return _MODELS[model_type]


def _images(n, seed=0):
    # caffe-range inputs: the random VGG's ReLUs then keep a spread of signs
    return (np.random.default_rng(seed).normal(size=(n, 8, 8, 3)) * 40).astype(np.float32)


def jax_smoothgrad_noise(n_words, image_shape, samples=8, seed=0):
    """The JAX Explainer's SmoothGrad draws: word position p's keys are
    split(fold_in(PRNGKey(seed), p), samples), one normal of the image's
    shape each (engine.py:412-416, cnn_gradient.py:325-329)."""
    out = []
    for p in range(n_words):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), p), samples)
        out.append(np.stack([np.asarray(jax.random.normal(k, (1, *image_shape), jnp.float32))[0]
                             for k in keys]))
    return torch.from_numpy(np.stack(out))


def _pair(model_type, method="lrp", **kw):
    jcap, pj, tcap, pt = _models(model_type)
    jex = JExplainer(jcap, pj, FakePP(), method=method, beam_size=2, **kw)
    tex = Explainer(tcap, pt, FakePP(), method=method, beam_size=2, device="cpu", **kw)
    if method == "smoothgrad":
        tex.smoothgrad_noise = jax_smoothgrad_noise
    return jex, tex


def _rel(got, ref):
    if ref.size == 0:
        return 0.0
    scale = np.abs(ref).max()
    return 0.0 if scale == 0 else float(np.abs(got - ref).max() / scale)


def _assert_same(got, ref, rtol=MAP_RTOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.words == r.words and g.caption == r.caption
        np.testing.assert_array_equal(g.tokens_1based, r.tokens_1based)
        for name in FIELDS:
            a, b = getattr(g, name), np.asarray(getattr(r, name))
            assert a.shape == b.shape, name
            assert np.isfinite(a).all(), name
            assert _rel(a, b) <= rtol, (name, _rel(a, b))


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_lrp_matches_jax_decoded_and_given(model_type):
    """Beam-decoded captions token-exact; every array within 1e-4 of scale,
    on the decoded captions and on given ones of mixed lengths."""
    jex, tex = _pair(model_type)
    images = _images(3)
    _assert_same(tex.analyze_batch(images), jex.analyze_batch(images))
    images = _images(5, seed=1)
    _assert_same(tex.analyze_many(images, tokens_1based=TOKENS, batch_size=2),
                 jex.analyze_many(images, tokens_1based=TOKENS, batch_size=2))


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
@pytest.mark.parametrize("method", GRADIENT_METHODS)
def test_gradient_methods_match_jax(model_type, method):
    jex, tex = _pair(model_type, method)
    jex._ig_steps = tex._ig_steps = 4
    jex._sg_samples = tex._sg_samples = 3
    if method == "smoothgrad":
        tex.smoothgrad_noise = lambda n, shape: jax_smoothgrad_noise(n, shape, samples=3)
    images = _images(2, seed=3)
    got = tex.analyze_batch(images, tokens_1based=TOKENS[1:3])
    _assert_same(got, jex.analyze_batch(images, tokens_1based=TOKENS[1:3]))
    # (a CAM may be all negative, so Guided-GradCAM can zero a word's map)
    assert sum(np.abs(e.relevance_maps).sum() for e in got) > 0


def test_lrp_bf16_storage_matches_jax():
    """bf16 storage: the port's maps within 2x the JAX bf16 run's distance
    from the JAX f32 maps, and within 3e-2 of their scale; the decoder side
    stays f32 and matches as in f32."""
    jf32, _ = _pair("adaptiveattention")
    jbf = JExplainer(*_models("adaptiveattention")[:2], FakePP(), beam_size=2,
                     storage_dtype=jnp.bfloat16)
    tbf = Explainer(*_models("adaptiveattention")[2:], FakePP(), beam_size=2, device="cpu",
                    storage_dtype=torch.bfloat16)
    images = _images(2, seed=3)
    anchor = jf32.analyze_batch(images, tokens_1based=TOKENS[1:3])
    ref = jbf.analyze_batch(images, tokens_1based=TOKENS[1:3])
    got = tbf.analyze_batch(images, tokens_1based=TOKENS[1:3])
    for g, r, a in zip(got, ref, anchor):
        assert g.relevance_maps.dtype == np.float32
        for w in range(len(g.words)):
            d_port = _rel(g.relevance_maps[w], np.asarray(a.relevance_maps[w]))
            d_jax = _rel(np.asarray(r.relevance_maps[w]), np.asarray(a.relevance_maps[w]))
            assert d_port <= 3e-2 and d_port <= 2.0 * d_jax, (d_port, d_jax)
        assert _rel(g.feat_relevance, np.asarray(r.feat_relevance)) <= MAP_RTOL


@pytest.mark.parametrize("split_buckets", [False, True])
def test_analyze_batch_and_many_equal_analyze(split_buckets):
    """analyze, analyze_batch and analyze_many (sorted chunks, padded last
    chunk, or ladder sub-batches) give the same Explanation per image."""
    _, tex = _pair("adaptiveattention", word_buckets=(2, 4))
    images = _images(5, seed=4)
    many = tex.analyze_many(images, tokens_1based=TOKENS, batch_size=4,
                            split_buckets=split_buckets)
    assert [len(e.words) for e in many] == [1, 3, 2, 5, 1]
    batch = tex.analyze_batch(images, tokens_1based=TOKENS)
    single = [tex.analyze(images[b], tokens_1based=TOKENS[b]) for b in range(5)]
    _assert_same(many, single)
    _assert_same(batch, single)


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_buckets_match_full_program(model_type):
    """A bucket explains its positions exactly as the full-T program does
    on the kept rows (as tests/test_explain_engine.py checks for JAX)."""
    jcap, pj, tcap, pt = _models(model_type)
    image = _images(1, seed=5)[0]
    tokens = np.array([5, 7, 2, 0, 0], np.int32)
    bucketed = Explainer(tcap, pt, FakePP(), word_buckets=(4,), device="cpu")
    full = Explainer(tcap, pt, FakePP(), word_buckets=(), device="cpu")
    rb, rf = bucketed.analyze(image, tokens), full.analyze(image, tokens)
    assert rb.words == rf.words == ["w5", "w7"]
    for name in FIELDS:
        np.testing.assert_allclose(getattr(rb, name), getattr(rf, name), atol=1e-6, err_msg=name)
    ref = JExplainer(jcap, pj, FakePP(), word_buckets=(4,)).analyze(jnp.asarray(image), tokens)
    _assert_same([rb], [ref])


def test_analyze_decodes_and_predict_caption_match_jax():
    jex, tex = _pair("adaptiveattention")
    image = _images(1, seed=6)[0]
    tok_t, cap_t = tex.predict_caption(image)
    tok_j, cap_j = jex.predict_caption(jnp.asarray(image))
    np.testing.assert_array_equal(tok_t, np.asarray(tok_j))
    assert cap_t == cap_j
    _assert_same([tex.analyze(image)], [jex.analyze(jnp.asarray(image))])


def test_analyze_many_decodes_in_chunks():
    """Without tokens, analyze_many decodes in (padded) chunks; its captions
    are analyze_batch's."""
    _, tex = _pair("gridTD")
    images = _images(3, seed=7)
    many = tex.analyze_many(images, batch_size=2)
    assert [e.caption for e in many] == [e.caption for e in tex.analyze_batch(images)]


def test_sub_batch_ladder_and_cover():
    _, tex = _pair("adaptiveattention")
    assert tex._sub_batch_ladder(8) == (8, 4, 2, 1)
    assert tex._sub_batch_ladder(56) == (56, 28, 14, 7, 4, 2, 1)
    ladder = tex._sub_batch_ladder(8)
    assert tex._cover_with_ladder(8, ladder) == [8]
    assert tex._cover_with_ladder(7, ladder) == [4, 2, 1]
    assert tex._cover_with_ladder(5, ladder) == [4, 1]
    assert tex._cover_with_ladder(3, ladder) == [2, 1]
    assert tex._bucket_for(0) == 4 and tex._bucket_for(5) == 5


def test_word_relevances_normalised():
    """The SOS slot is zeroed, then each row is max-|.|-normalised: the first
    word's row (its only input is SOS) is all zero, the others reach 1."""
    _, tex = _pair("adaptiveattention")
    e = tex.analyze(_images(1, seed=8)[0], tokens_1based=np.array([5, 7, 9, 2, 0], np.int32))
    m = np.abs(e.word_relevances).max(axis=1)
    np.testing.assert_allclose(m[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(m[1:], 1.0, rtol=1e-4)


def test_smoothgrad_noise_keyed_per_position():
    """The default noise of position p does not depend on how many words a
    call explains."""
    _, tex = _pair("adaptiveattention", "smoothgrad")
    tex.smoothgrad_noise = Explainer.smoothgrad_noise.__get__(tex)
    a, b = tex.smoothgrad_noise(2, (8, 8, 3)), tex.smoothgrad_noise(4, (8, 8, 3))
    assert a.shape == (2, 8, 8, 8, 3)
    torch.testing.assert_close(a, b[:2], rtol=0, atol=0)


@pytest.mark.parametrize("kw, match", [
    (dict(mesh="2 cpu slots", batch_size=5), "not divisible by the mesh"),
    (dict(shard_words=True), "requires a mesh")])
def test_unported_options_raise(kw, match):
    """The JAX package's errors on these paths: shard_words without a mesh,
    a batch that does not divide over the mesh's data slots."""
    from lrp_imagecaptioning_torch.parallel import make_mesh

    tcap = _models("adaptiveattention")[2]
    if "mesh" in kw:
        kw = dict(kw, mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match=match):
        Explainer(tcap, None, FakePP(), device="cpu", **kw)


def test_methods_and_entry_point_default():
    from lrp_imagecaptioning_tpu.explain.engine import METHODS as J_METHODS

    assert engine.METHODS == J_METHODS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Explainer(_models("adaptiveattention")[2], None, FakePP())
