"""PyTorch port: ``infer/serving.py``'s ``CaptionService`` against the JAX
package's, at the serving tests' small size (tests/test_drivers.py: the
``block2_conv1`` tap, 8x8 images, E = H = 16, T = 5, vocab 16) on the same
params (``params_from_jax``) and numpy-seeded images.

Captions must be equal; explanations token-exact with every array within
1e-4 of its scale (max |JAX|), the bound tests/test_torch_explainer.py
holds the Explainer to (the divides by stab(z) at eps = 1e-7 amplify
last-ulp differences, and the port runs the encode and the cached forward
at batch B where JAX runs batch 1). The queue's mechanics (grouping by
method, the drain on stop, the smoothed stats) are held as
tests/test_drivers.py holds the JAX service's.
"""

import sys
import threading
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.infer.serving import CaptionService as JService  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explanation  # noqa: E402
from lrp_imagecaptioning_torch.infer.serving import CaptionService  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
             img_feature_dim=128, sentence_length=5, image_size=(8, 8))
VOCAB = 16
MAP_RTOL = 1e-4
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")


class FakePP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}
    word_of[1], word_of[2] = "szeros", "zeros"


_MODELS = {}


def _models():
    """(JAX captioner, JAX params, port captioner, port params), once."""
    if not _MODELS:
        jcap = j_build("adaptiveattention", JConfig(drop_rate=0.0, **SMALL), VOCAB)
        pj = jcap.init_params(jax.random.PRNGKey(3))
        _MODELS["m"] = (jcap, pj, t_build("adaptiveattention", TConfig(**SMALL), VOCAB),
                        params_from_jax(pj, "cpu"))
    return _MODELS["m"]


def _services(**kw):
    jcap, pj, tcap, pt = _models()
    return (JService(jcap, pj, FakePP(), **kw),
            CaptionService(tcap, pt, FakePP(), device="cpu", **kw))


def _images(n, seed=0):
    # caffe-range inputs: the random VGG's ReLUs then keep a spread of signs
    return (np.random.default_rng(seed).normal(size=(n, 8, 8, 3)) * 40).astype(np.float32)


def _rel(got, ref):
    ref = np.asarray(ref)
    if ref.size == 0:
        return 0.0
    scale = np.abs(ref).max()
    return 0.0 if scale == 0 else float(np.abs(got - ref).max() / scale)


def _assert_same(got, ref, rtol=MAP_RTOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert isinstance(g, Explanation)
        assert g.words == r.words and g.caption == r.caption
        np.testing.assert_array_equal(g.tokens_1based, r.tokens_1based)
        for name in FIELDS:
            a, b = getattr(g, name), np.asarray(getattr(r, name))
            assert a.shape == b.shape, name
            assert np.isfinite(a).all(), name
            assert _rel(a, b) <= rtol, (name, _rel(a, b))


@pytest.mark.parametrize("beam_size", [1, 2])
def test_caption_matches_jax_ragged_and_oversized(beam_size):
    """Greedy (beam 1) and beam captions equal JAX's for a ragged request
    (3 < batch 4, zero padded) and an oversized one (5 > 4, chunked)."""
    jsvc, tsvc = _services(batch_size=4, beam_size=beam_size)
    tsvc.warmup()
    for n, seed in ((3, 0), (5, 1)):
        images = _images(n, seed)
        got = tsvc.caption(images)
        assert got == jsvc.caption(images)
        assert len(got) == n and all(isinstance(c, str) for c in got)
    assert tsvc.stats["images"] == 8 and tsvc.stats["requests"] == 3


@pytest.mark.parametrize("split_buckets", [False, True])
def test_explain_matches_jax(split_buckets):
    """explain() of a ragged request through analyze_many at the service
    batch, the batch-max bucket or per-bucket ladder dispatches."""
    jsvc, tsvc = _services(batch_size=4, beam_size=2, split_buckets=split_buckets)
    tsvc.warmup(explain=True)
    assert tsvc.graph_stats() == {"captures": 0, "pool_bytes": 0}   # no graphs on the CPU
    images = _images(3, seed=2)
    _assert_same(tsvc.explain(images), jsvc.explain(images))


def test_queue_serves_mixed_submissions_as_direct_calls():
    """submit() coalesces captions and an explanation; each future's result
    equals the same image's direct call."""
    _, tsvc = _services(batch_size=4, beam_size=2)
    images = _images(5, seed=3)
    tsvc.start_queue(linger_ms=50.0)
    try:
        futs = [tsvc.submit(images[i]) for i in range(4)]
        fut_e = tsvc.submit(images[4], explain=True)
        captions = [f.result(timeout=120) for f in futs]
        queued_e = fut_e.result(timeout=120)
    finally:
        tsvc.stop_queue()
    assert captions == tsvc.caption(images[:4])
    _assert_same([queued_e], tsvc.explain(images[4:]), rtol=0.0)


def test_queue_groups_explain_by_method():
    """The batcher dispatches each method's explain requests apart, captions
    first; a hostile method or a second image shape resolves every future
    (the endpoints are stubbed: no device work)."""
    _, tsvc = _services(batch_size=4, beam_size=1)
    calls = []

    def fake_explain(images, method="lrp"):
        if method not in ("lrp", "gradient"):
            raise ValueError(f"method {method!r} not supported")
        calls.append(("explain", method, images.shape[0]))
        return [f"{method}-{i}" for i in range(images.shape[0])]

    def fake_caption(images):
        calls.append(("caption", None, images.shape[0]))
        return [f"cap-{i}" for i in range(images.shape[0])]

    tsvc.explain, tsvc.caption = fake_explain, fake_caption
    img = _images(1)[0]
    batch = [(img, False, "lrp", Future()), (img, True, "lrp", Future()),
             (img, True, "gradient", Future()), (img, True, "lrp", Future())]
    tsvc._dispatch_queue_batch(batch)
    assert sorted(calls) == [("caption", None, 1), ("explain", "gradient", 1),
                             ("explain", "lrp", 2)]
    assert calls[0][0] == "caption"
    assert [b[3].result(timeout=1) for b in batch] == ["cap-0", "lrp-0", "gradient-0", "lrp-1"]

    calls.clear()
    img2 = _images(1)[0][:4, :4]
    hostile = [(img, True, ["lrp"], Future()), (img, False, "lrp", Future()),
               (img2, False, "lrp", Future())]
    tsvc._dispatch_queue_batch(hostile)
    assert isinstance(hostile[0][3].exception(timeout=1), ValueError)
    assert hostile[1][3].result(timeout=1) == "cap-0"
    assert hostile[2][3].result(timeout=1) == "cap-0"
    assert calls == [("caption", None, 1), ("caption", None, 1)]


def test_stop_queue_serves_already_submitted():
    """Futures enqueued before stop_queue() are served by its drain;
    submissions after it raise, and dispatch() falls back to direct calls."""
    _, tsvc = _services(batch_size=4, beam_size=1)
    tsvc.start_queue(linger_ms=200.0)
    images = _images(3, seed=4)
    futs = tsvc.submit_many(images)
    tsvc.stop_queue()
    assert [f.result(timeout=60) for f in futs] == tsvc.caption(images)
    with pytest.raises(RuntimeError):
        tsvc.submit_many(images)
    assert tsvc.dispatch(images) == tsvc.caption(images)


def test_latency_stats_are_smoothed():
    _, tsvc = _services(batch_size=2, beam_size=1)
    images = _images(2)
    tsvc.caption(images)
    first = tsvc.stats["latency_ema_s"]
    assert first == tsvc.stats["last_latency_s"] > 0
    tsvc.caption(images)
    assert tsvc.stats["latency_ema_s"] == pytest.approx(0.9 * first
                                                        + 0.1 * tsvc.stats["last_latency_s"])


def test_expected_hw_matches_jax():
    """The service resolution, derived as the JAX service derives it."""
    jsvc, tsvc = JService.__new__(JService), CaptionService.__new__(CaptionService)
    for kw in (dict(img_feature_length=196), dict(img_encoder="resnet50", img_feature_length=49),
               dict(img_encoder="inception_v3", img_feature_length=64),
               dict(img_feature_length=4),
               dict(img_encoder="inception_v3", image_size=(75, 75), img_feature_length=1)):
        kw = dict(dict(image_size=None, layer_name="block5_conv3"), **kw)
        jsvc.captioner = type("C", (), {"cfg": JConfig(**kw)})()
        tsvc.captioner = type("C", (), {"cfg": TConfig(**kw)})()
        assert tsvc.expected_hw == jsvc.expected_hw


def test_two_threads_of_direct_dispatch_get_their_own_answers():
    """Two threads dispatching directly (no queue) at once, many times over,
    each get their own image's answer: the service's device lock keeps one
    request's stages from interleaving with another's."""
    _, tsvc = _services(batch_size=2, beam_size=2)
    images = _images(2, seed=5)
    want = [tsvc.dispatch(images[i:i + 1], explain=True) for i in range(2)]
    got, errors = {0: [], 1: []}, []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(i):
            try:
                for _ in range(4):
                    got[i].append(tsvc.dispatch(images[i:i + 1], explain=True))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors
    for i in range(2):
        assert len(got[i]) == 4
        for answer in got[i]:
            _assert_same(answer, want[i], rtol=0.0)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(shard_words=True)])
def test_several_cards_raise_naming_a13b(kw):
    _, _, tcap, pt = _models()
    with pytest.raises(NotImplementedError, match="A13b"):
        CaptionService(tcap, pt, FakePP(), device="cpu", **kw)
