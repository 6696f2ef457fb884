"""PyTorch port: the Explainer's graph cache (``graphs.GraphCache``).

Here, on the CPU: the cache's bookkeeping over a stand-in for the CUDA graph
API (one graph per (stage, key), one shared pool, captures counted, launch
counts per replay), and the Explainer's dispatch sizes (every stage call of
a request of any size takes a size of its batch's halving ladder). On a machine with a card (class ``TestExplainerOnCard``,
marked ``cuda``; it skips here):

* after ``warmup(sub_batches=True)`` no call of any ladder size or bucket
  captures, and requests of every size from 1 to past the batch size leave
  the captures and the pool's size as they were;
* graphs replayed in another order than their capture order, sharing one
  pool, give each output equal to the eager stage within 1e-6 of its scale;
* grid-TD launches K2 twice a step at 3 B rows in the beam search and at B
  rows in the cached forward, with the kernel counts the code derives;
* ``deep_taylor`` runs K3 on the post-ReLU convs and matches its plain
  version on the card; ``deep_lift`` launches no K3.

This file imports no JAX: the card's machine runs it with ``--noconftest``.
"""

import contextlib
import gc
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch import graphs  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.models.vgg import vgg_layers  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.weights import tree_to  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block3_conv1", img_feature_length=64,
             img_feature_dim=256, sentence_length=6)
V = 32


class PP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, V + 1)}


class _FakeGraph:
    replays = 0

    def __init__(self):
        self.pool_handle = None

    def replay(self):
        _FakeGraph.replays += 1


@pytest.fixture
def fake_cuda_graphs(monkeypatch):
    """The CUDA graph API replaced by stand-ins: a capture runs the function
    once, a replay nothing; ``graph(pool=)`` records the pool it was given."""
    class _Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    pools = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        pools.append(pool)
        # a capture runs with the cyclic garbage collector off
        assert not gc.isenabled()
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool", 7))
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    _FakeGraph.replays = 0
    yield pools
    kernels.reset_launches()


def test_graph_cache_keeps_one_graph_per_stage_and_key(fake_cuda_graphs):
    pools = fake_cuda_graphs
    calls = []

    def stage_a(params, x):
        calls.append(("a", x.shape))
        kernels.lrp_linear.launches += 3
        return x * params["decoder"]["w"]

    def stage_b(params, x, y):
        calls.append(("b", x.shape))
        kernels.lstm_gates.launches += 2
        return x + 1, y * 2

    cache = graphs.GraphCache()
    of = lambda p: graphs.param_tensors(p["decoder"])   # noqa: E731
    a, b = cache.stage(stage_a, of), cache.stage(stage_b, of)
    p = {"decoder": {"w": torch.tensor(2.0)}}
    kernels.reset_launches()
    out = a(p, torch.ones(2, 3))
    assert isinstance(out, torch.Tensor) and cache.captures == 1 and len(calls) == 2
    assert kernels.lrp_linear.launches == 3 + 3   # warm-up + one replay; the capture's taken back
    a(p, torch.ones(4, 3))                         # another shape: a second graph, the first kept
    b(p, torch.ones(2, 3), torch.ones(1))          # another stage, the same shapes: a third
    assert cache.captures == 3 and len(cache.entries) == 3
    n_calls = len(calls)
    for x in (torch.zeros(2, 3), torch.zeros(4, 3), torch.zeros(2, 3)):   # any order: replays
        a(p, x)
    out = b(p, torch.zeros(2, 3), torch.ones(1))
    assert len(calls) == n_calls and cache.captures == 3 and isinstance(out, tuple)
    # each stage's warm-ups (2 of a, 1 of b) and replays (5 of a, 2 of b)
    assert kernels.lrp_linear.launches == 3 * 7 and kernels.lstm_gates.launches == 2 * 3
    # every capture went into the one shared pool
    assert pools == [("pool", 7)] * 3 and cache.pool == ("pool", 7)
    assert cache.output_bytes() == 4 * (6 + 12 + 6 + 1)
    # a new params dict captures anew
    a({"decoder": {"w": torch.tensor(3.0)}}, torch.ones(2, 3))
    assert cache.captures == 4


def test_capture_turns_the_cyclic_gc_off_and_back(fake_cuda_graphs):
    """A collection inside a capture could destroy a dropped Explainer's
    graph, which CUDA refuses while a stream captures; the fake ``graph``
    asserts that the collector is off inside, and it is on again after."""
    assert gc.isenabled()
    graphs.capture(lambda: torch.ones(2))
    assert gc.isenabled() and fake_cuda_graphs == [None]
    gc.disable()
    try:
        graphs.capture(lambda: torch.ones(2))
        assert not gc.isenabled()                 # left as the caller had it
    finally:
        gc.enable()


def test_graphed_stage_still_captures_without_a_shared_pool(fake_cuda_graphs):
    """pipeline.build's GraphedStage keeps its own pool (bench's numbers)."""
    run = graphs.GraphedStage(lambda params, x: x * 2, lambda p: [])
    run({}, torch.ones(3))
    assert fake_cuda_graphs == [None] and run.captures == 1


def _recording_stages(ex, calls):
    """Wrap the Explainer's two graphed stages so that each call records
    (stage, rows, bucket)."""
    slot = ex._slots[0]
    decode, decoder = slot.decode, slot.decoder

    def rec_decode(params, feat):
        calls.append(("decode", feat.shape[0], None))
        return decode(params, feat)

    def rec_decoder(params, feat, toks, positions):
        calls.append(("decoder", feat.shape[0], positions.shape[1]))
        return decoder(params, feat, toks, positions)

    slot.decode, slot.decoder = rec_decode, rec_decoder


def test_every_dispatch_takes_a_ladder_size():
    """Whatever a request's size, the graphed stages see only the sizes of
    the batch's halving ladder (the keys warmup(sub_batches=True) captures),
    and the padded rows are dropped: one Explanation per image, the same as
    the image explained alone."""
    cfg = FlickrConfig(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1",
                       img_feature_length=16, img_feature_dim=128, sentence_length=5)
    cap = build_captioner("adaptiveattention", cfg, V)
    ex = Explainer(cap, cap.init_params(0, "cpu"), PP(), beam_size=2, word_buckets=(2,),
                   batch_size=4, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.normal(size=(9, 8, 8, 3)).astype(np.float32) * 40
    calls = []
    _recording_stages(ex, calls)
    ladder = ex._sub_batch_ladder(4)
    assert ladder == (4, 2, 1)
    for n in (1, 3, 5, 9):
        out = ex.analyze_batch(images[:n])
        assert len(out) == n
    toks = np.zeros((7, 5), np.int32)
    toks[:, :3] = rng.integers(3, V, size=(7, 3))
    toks[:, 3] = 2
    ex.analyze_many(images[:7])
    many = ex.analyze_many(images[:7], tokens_1based=toks)
    one = ex.analyze(images[6], tokens_1based=toks[6])
    assert len(one.words) == 3
    assert {rows for _, rows, _ in calls} <= set(ladder)
    assert {w for stage, _, w in calls if stage == "decoder"} <= {2, 5}
    # a padded dispatch's real rows are those of the image alone
    np.testing.assert_array_equal(many[6].tokens_1based, one.tokens_1based)
    for name in ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas"):
        a, b = getattr(many[6], name), getattr(one, name)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
class TestExplainerOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the Explainer replays CUDA graphs only there")
        yield
        kernels.reset_launches()

    def _explainer(self, model_type="adaptiveattention", **kw):
        cap = build_captioner(model_type, FlickrConfig(**SMALL), V)
        return Explainer(cap, cap.init_params(0, "cuda"), PP(), beam_size=3,
                         word_buckets=(2, 4), **kw)

    def _images(self, n, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(n, 32, 32, 3, generator=gen, device="cuda") * 40

    def _tokens(self, n, seed):
        rng = np.random.default_rng(seed)
        toks = np.zeros((n, SMALL["sentence_length"]), np.int32)
        for i, ln in enumerate(rng.integers(1, SMALL["sentence_length"] + 1, size=n)):
            toks[i, :ln] = rng.integers(3, V, size=ln)
            if ln < SMALL["sentence_length"]:
                toks[i, ln] = 2
        return toks

    def test_no_capture_after_warmup_with_sub_batches(self):
        ex = self._explainer(batch_size=6)
        images, toks = self._images(6, 1), self._tokens(6, 1)
        ex.warmup(images, sub_batches=True)
        captured = ex.graphs.captures
        # beam search at (6, 3, 2, 1); decoder stage at (6, 3, 2, 1) x (2, 4, 6)
        assert captured == 4 + 4 * 3
        ex.analyze_batch(images, tokens_1based=toks)
        ex.analyze_many(images, tokens_1based=toks, batch_size=6, split_buckets=True)
        ex.analyze_many(images[:5], tokens_1based=toks[:5], batch_size=6)   # one padded chunk
        ex.analyze_many(images, batch_size=6)                                # decodes at 6
        ex.analyze(images[0], tokens_1based=toks[0])                         # size 1
        ex.analyze(images[0])                                                # decodes at 1
        assert ex.graphs.captures == captured

    def test_pool_holds_across_request_sizes(self):
        """Requests of every size from 1 to past the batch size, decoded and
        given tokens, neither capture nor grow the graph pool after
        warmup(sub_batches=True)."""
        ex = self._explainer(batch_size=6)
        images, toks = self._images(13, 5), self._tokens(13, 5)
        ex.warmup(images, sub_batches=True)
        captured, pool, held = ex.graphs.captures, ex.graphs.pool_bytes(), ex.graphs.output_bytes()
        assert pool > 0
        for n in range(1, 14):
            ex.analyze_batch(images[:n])
            ex.analyze_batch(images[:n], tokens_1based=toks[:n])
            ex.analyze_many(images[:n], tokens_1based=toks[:n])
            ex.analyze_many(images[:n], split_buckets=True)
        assert ex.graphs.captures == captured
        assert ex.graphs.pool_bytes() == pool and ex.graphs.output_bytes() == held

    def test_out_of_order_replays_match_eager(self):
        ex = self._explainer(batch_size=4)
        images = self._images(4, 2)
        ex.warmup(images, sub_batches=True)
        feat = ex._encode(images)
        toks = torch.as_tensor(self._tokens(4, 2), dtype=torch.long, device="cuda")
        pools = {tuple(e.graph.pool()) for e in ex.graphs.entries.values()}
        assert len(pools) == 1 and len(ex.graphs.entries) == 3 + 3 * 3
        captured = ex.graphs.captures
        # the reverse of the capture order, then a shuffle of it
        plan = [(s, w) for w in (2, 4, 6) for s in (4, 2, 1)]
        order = plan[::-1] + [plan[i] for i in np.random.default_rng(3).permutation(len(plan))]
        for size, W in order:
            pos = torch.arange(W, device="cuda").expand(size, W).contiguous()
            got = ex._slots[0].decoder(ex.params, feat[:size], toks[:size], pos)
            want = ex._decoder_impl(ex.params, feat[:size], toks[:size], pos)
            for g, w in zip(got, want):
                assert g.shape == w.shape and _rel(g, w) <= 1e-6, (size, W)
        tok_g = ex._slots[0].decode(ex.params, feat)
        assert torch.equal(tok_g, ex._decode_impl(ex.params, feat))
        assert ex.graphs.captures == captured

    @staticmethod
    def _k2_rows(ex, images, seen):
        """K2's rows at each launch of the eager beam search and cached forward."""
        T = SMALL["sentence_length"]
        feat = ex._encode(images)
        kernels.reset_launches()
        tokens = ex._decode_impl(ex.params, feat)
        assert kernels.lstm_gates.launches == 2 * T
        beam = list(seen)
        seen.clear()
        ex._decoder_impl(ex.params, feat, tokens,
                         torch.arange(T, device="cuda").expand(len(images), T).contiguous())
        return beam, list(seen)

    @pytest.mark.parametrize("batch", [1, 5])
    def test_gridtd_k2_at_3b_rows(self, batch):
        ex = self._explainer("gridTD", batch_size=batch)
        images = self._images(batch, 4)
        T = SMALL["sentence_length"]
        seen = []
        orig = kernels._lstm_gates_launch

        def spy(zx, zh, bias, c_prev):
            seen.append(zx.shape[0])
            return orig(zx, zh, bias, c_prev)

        kernels._lstm_gates_launch = spy
        try:
            with torch.no_grad():
                seen_beam, seen_fwd = self._k2_rows(ex, images, seen)
        finally:
            kernels._lstm_gates_launch = orig
        assert seen_beam == [3 * batch] * (2 * T) and seen_fwd == [batch] * (2 * T)
        # the graphed path: the same launches per call, derived from the capture
        ex.warmup(images)
        kernels.reset_launches()
        out = ex.analyze_batch(images)
        W = ex._bucket_for(max(len(e.words) for e in out))
        # K3 twice per post-ReLU conv (every conv but the input layer) per image
        convs = sum(op[0] == "conv" for op in vgg_layers(SMALL["layer_name"])) - 1
        assert kernels.lstm_gates.launches == 2 * T + 2 * T
        assert kernels.lrp_linear.launches == 2 * T + 3
        assert kernels.conv3x3_fused.launches == 2 * convs * batch
        assert all(e.relevance_maps.shape == (len(e.words), 32, 32, 3) for e in out)
        # tokens as on the CPU
        assert W in (2, 4, T)
        cpu = Explainer(ex.captioner, tree_to(ex.params, "cpu"), PP(), beam_size=3, device="cpu")
        np.testing.assert_array_equal(cpu._decode(images.cpu()),
                                      np.stack([e.tokens_1based for e in out]))

    def test_deep_taylor_matches_plain_and_deep_lift_runs_no_k3(self):
        """DeepTaylor's maps against the same walk with the plain alpha1beta0
        rule in f64 on the card, on the f32 forward's activations, within 1e-4
        of scale; K1, K2 and K3 launched as for ``lrp``; DeepLIFT's conv VJPs
        are cuDNN's, so it launches no K3."""
        from lrp_imagecaptioning_torch.explain.cnn_lrp import _backward
        from lrp_imagecaptioning_torch.models.vgg import vgg_apply_with_acts
        from lrp_imagecaptioning_torch.ops.lrp_conv import lrp_conv_alpha_beta

        T, until = SMALL["sentence_length"], SMALL["layer_name"]
        convs = sum(op[0] == "conv" for op in vgg_layers(until)) - 1
        images, toks = self._images(2, 6), self._tokens(2, 6)
        ex = self._explainer(method="deep_taylor", batch_size=2).warmup(images)
        kernels.reset_launches()
        out = ex.analyze_batch(images, tokens_1based=toks)
        assert kernels.conv3x3_fused.launches == 2 * convs * 2
        assert kernels.lrp_linear.launches == T + 3 and kernels.lstm_gates.launches == T
        vgg = ex.params["vgg"]
        vgg64 = tree_to(vgg, dtype=torch.float64)
        plain = lambda r, x, k, b: lrp_conv_alpha_beta(r, x, k, b, input_nonneg=True)
        g = math.isqrt(SMALL["img_feature_length"])
        for b, e in enumerate(out):
            seeds = torch.as_tensor(e.feat_relevance, device="cuda").reshape(-1, g, g,
                                                                            SMALL["img_feature_dim"])
            with torch.no_grad():
                _, inputs = vgg_apply_with_acts(vgg, images[b:b + 1], until)
                want = _backward(vgg64, [x.double() for x in inputs], torch.relu(seeds).double(),
                                 until, plain)
            got = torch.as_tensor(e.relevance_maps, device="cuda").double()
            assert got.shape == want.shape and _rel(got, want) <= 1e-4
        ex = self._explainer(method="deep_lift", batch_size=2).warmup(images)
        kernels.reset_launches()
        out = ex.analyze_batch(images, tokens_1based=toks)
        assert kernels.conv3x3_fused.launches == 0
        assert kernels.lrp_linear.launches == T + 3 and kernels.lstm_gates.launches == T
        assert all(np.isfinite(e.relevance_maps).all() for e in out)
