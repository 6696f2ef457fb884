"""PyTorch port: the serving layer on a card (class ``TestServingOnCard``,
marked ``cuda``; it skips where there is none), at a small size (the
``block3_conv1`` tap, 32x32 images, E = H = 16, T = 6, vocab 32):

* after ``CaptionService.warmup(explain=True)`` no caption or explain
  request of any size, with or without ``split_buckets``, captures a graph
  or grows a pool;
* two threads dispatching directly at once each get their own image's
  answer, the answer it gets alone: the service's lock keeps the graph
  replays' static buffers from being shared;
* an exported artifact, loaded and warmed (its programs captured), launches
  each kernel on one explain request as often as the live service does on
  the same request (the custom ops count as the kernels do).

Answers are held bit for bit but the heatmaps, within 1e-6 of their scale:
the card's CNN side is not bit for bit from run to run (chip_smoke.py
phase 12a read analyze_batch against itself 1.8e-7 apart).

This file imports no JAX: the card's machine runs it with ``--noconftest``.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.infer.export import ExportedService, export_serving  # noqa: E402
from lrp_imagecaptioning_torch.infer.serving import CaptionService  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402

SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block3_conv1", img_feature_length=64,
             img_feature_dim=256, sentence_length=6, image_size=(32, 32))
V = 32
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")


class PP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, V + 1)}


def _counts():
    return {k.__name__: k.launches for k in kernels.KERNELS}


def _assert_same(got, want):
    assert got.words == want.words
    np.testing.assert_array_equal(got.tokens_1based, want.tokens_1based)
    for name in FIELDS[1:]:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    a, b = got.relevance_maps, want.relevance_maps
    if b.size:
        assert float(np.abs(a - b).max()) <= 1e-6 * max(float(np.abs(b).max()), 1e-30)


@pytest.mark.cuda
class TestServingOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the service replays CUDA graphs only there")

    def _model(self):
        cap = build_captioner("adaptiveattention", FlickrConfig(**SMALL), V)
        return cap, cap.init_params(0, device="cuda")

    def _images(self, n, seed=0):
        return (np.random.default_rng(seed).normal(size=(n, 32, 32, 3)) * 40).astype(np.float32)

    @pytest.mark.parametrize("split_buckets", [False, True])
    def test_no_request_captures_after_warmup(self, split_buckets):
        cap, params = self._model()
        svc = CaptionService(cap, params, PP(), batch_size=4, split_buckets=split_buckets,
                             device="cuda").warmup(explain=True)
        warm = svc.graph_stats()
        assert warm["captures"] > 0 and warm["pool_bytes"] > 0
        for n in range(1, 7):
            assert len(svc.caption(self._images(n, n))) == n
            assert len(svc.explain(self._images(n, 10 + n))) == n
        assert svc.graph_stats() == warm

    def test_two_threads_of_direct_dispatch_get_their_own_answers(self):
        cap, params = self._model()
        svc = CaptionService(cap, params, PP(), batch_size=4, device="cuda").warmup(explain=True)
        images = self._images(2, 20)
        want = [svc.dispatch(images[i:i + 1], explain=True)[0] for i in range(2)]
        got, errors = {0: [], 1: []}, []

        def run(i):
            try:
                for _ in range(6):
                    got[i].append(svc.dispatch(images[i:i + 1], explain=True)[0])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not errors
        for i in range(2):
            assert len(got[i]) == 6
            for e in got[i]:
                _assert_same(e, want[i])

    def test_exported_launches_match_the_live_path(self, tmp_path):
        cap, params = self._model()
        out = str(tmp_path / "artifact")
        export_serving(cap, params, PP(), out, batch_size=4, method="lrp", word_buckets=(2,),
                       device="cuda")
        svc = CaptionService(cap, params, PP(), batch_size=4, device="cuda").warmup(explain=True)
        esvc = ExportedService(out, device="cuda")
        warm = esvc.graph_stats()
        images = self._images(4, 30)
        kernels.reset_launches()
        live = svc.explain(images)
        live_counts = _counts()
        kernels.reset_launches()
        exported = esvc.dispatch(images, explain=True)
        assert _counts() == live_counts and live_counts["conv3x3_fused"] > 0
        assert esvc.graph_stats() == warm
        for g, w in zip(exported, live):
            _assert_same(g, w)
