"""PyTorch port: the CUDA-graph runner of the caption and decoder-LRP stages
(``lrp_imagecaptioning_torch/graphs.py``).

Here, on the CPU: the graph key (pure Python), the runner's launch-count
bookkeeping over a stand-in for the CUDA graph API, and ``build`` on the CPU
running its stages eagerly. On a machine with a card (class ``TestOnCard``,
marked ``cuda``; it skips here): graph replays against the eager stages, and
the launch counts a replay adds against the kernel nodes of the captured
graph.
"""

import contextlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch import graphs  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.pipeline import build  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block3_conv1", img_feature_length=64,
             img_feature_dim=256)
V, T, B = 32, 5, 3


def _params():
    return {"decoder": {"w": torch.ones(4, 8), "b": torch.zeros(8),
                        "nested": {"v": torch.ones(3)}}}


def test_param_tensors_sorted_by_key():
    p = _params()
    got = graphs.param_tensors(p["decoder"])
    assert [t.shape for t in got] == [(8,), (3,), (4, 8)]   # b, nested.v, w
    assert got[2] is p["decoder"]["w"]


def test_graph_key_reuses_and_renews():
    p = _params()
    x = torch.randn(2, 5)
    key = graphs.graph_key((x,), graphs.param_tensors(p))
    # the same params and input shapes, other input values: the same graph
    assert graphs.graph_key((torch.randn(2, 5),), graphs.param_tensors(p)) == key
    # new pointers: a params dict of copies
    copies = {"decoder": {k: (v.clone() if isinstance(v, torch.Tensor) else
                              {kk: vv.clone() for kk, vv in v.items()})
                          for k, v in p["decoder"].items()}}
    assert graphs.graph_key((x,), graphs.param_tensors(copies)) != key
    # one param swapped for another tensor
    p2 = _params()
    p2["decoder"] = dict(p["decoder"], b=torch.zeros(8))
    assert graphs.graph_key((x,), graphs.param_tensors(p2)) != key
    # another input shape or dtype
    assert graphs.graph_key((torch.randn(3, 5),), graphs.param_tensors(p)) != key
    assert graphs.graph_key((x.double(),), graphs.param_tensors(p)) != key
    # a view of the same storage with other strides
    p3 = {"decoder": dict(p["decoder"], w=p["decoder"]["w"].T)}
    assert graphs.graph_key((x,), graphs.param_tensors(p3)) != key


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay runs nothing."""

    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


@pytest.fixture
def fake_cuda_graphs(monkeypatch):
    """The CUDA graph API replaced by stand-ins, so the runner's bookkeeping
    runs on the CPU: the capture runs the function once, a replay nothing."""
    class _Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    _FakeGraph.replays = 0


def test_graphed_stage_counts_launches_per_replay(fake_cuda_graphs):
    """Python runs at the warm-up and at the capture; only the warm-up
    launched. Each replay adds the stage's launches; a new key captures anew
    and the stage keeps that one graph."""
    calls = []

    def stage(params, x):
        calls.append(x.clone())
        kernels.lstm_gates.launches += 2
        kernels.lrp_linear.launches += 1
        return x * params["decoder"]["w"][0, 0], x + 1

    run = graphs.GraphedStage(stage, lambda p: graphs.param_tensors(p["decoder"]))
    p = _params()
    kernels.reset_launches()
    out = run(p, torch.ones(2, 5))
    assert len(calls) == 2 and run.captures == 1 and _FakeGraph.replays == 1
    # warm-up 2 + replay 2; the capture's own 2 are taken back
    assert kernels.lstm_gates.launches == 4 and kernels.lrp_linear.launches == 2
    assert isinstance(out, tuple) and len(out) == 2
    run(p, torch.zeros(2, 5))          # the same key: a replay, no Python
    assert len(calls) == 2 and run.captures == 1 and _FakeGraph.replays == 2
    assert kernels.lstm_gates.launches == 6 and kernels.lrp_linear.launches == 3
    # the input is copied into the static tensor the capture ran on
    assert torch.equal(run.entry.inputs[0], torch.zeros(2, 5))
    first = run.entry
    run(p, torch.ones(3, 5))           # another shape: the graph is replaced
    assert run.captures == 2 and run.entry is not first
    assert run.entry.inputs[0].shape == (3, 5)
    new = _params()
    run(new, torch.ones(3, 5))         # new params: captured anew
    assert run.captures == 3 and run.key == graphs.graph_key(
        (torch.ones(3, 5),), graphs.param_tensors(new["decoder"]))
    kernels.reset_launches()


def test_graphed_stage_returns_copies(fake_cuda_graphs):
    run = graphs.GraphedStage(lambda params, x: x * 2, lambda p: [])
    a = run({}, torch.ones(4))
    b = run({}, torch.ones(4))
    assert isinstance(a, torch.Tensor) and a is not b
    a.add_(1)
    assert torch.equal(b, torch.full((4,), 2.0))
    kernels.reset_launches()


def test_build_on_cpu_runs_stages_eagerly():
    """No graphs on the CPU: the stages are the eager functions."""
    fn, cap = build(FlickrConfig(**SMALL), V, device="cpu", T=T)
    assert fn.graphed == {}
    params = cap.init_params(0, "cpu")
    images = torch.from_numpy(np.random.default_rng(50).normal(size=(B, 32, 32, 3))
                              .astype(np.float32))
    feat, tok = fn.stages["caption"](params, images)
    feat_e, tok_e = fn.eager_stages["caption"](params, images)
    assert torch.equal(feat, feat_e) and torch.equal(tok, tok_e)
    assert torch.equal(fn.stages["decoder_lrp"](params, feat, tok),
                       fn.eager_stages["decoder_lrp"](params, feat, tok))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
class TestOnCard:
    """Graph replays against the eager stages on the card."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the stages replay CUDA graphs only there")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _images(self, seed, batch=B):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(batch, 32, 32, 3, generator=gen, device="cuda")

    def _check(self, fn, params, images):
        st, eager = fn.stages, fn.eager_stages
        feat, tok = st["caption"](params, images)
        feat_e, tok_e = eager["caption"](params, images)
        assert torch.equal(tok, tok_e)
        kernels.reset_launches()
        r_e = eager["decoder_lrp"](params, feat_e, tok_e)
        eager_launches = {k.__name__: k.launches for k in kernels.KERNELS}
        kernels.reset_launches()
        r = st["decoder_lrp"](params, feat, tok)
        graph_launches = {k.__name__: k.launches for k in kernels.KERNELS}
        torch.cuda.synchronize()
        assert r.shape == (images.shape[0], T, 64, 256)
        assert _rel(r, r_e) <= 1e-6
        return eager_launches, graph_launches

    def test_graphs_match_eager(self):
        fn, cap = build(FlickrConfig(**SMALL), V, device="cuda", T=T)
        params = cap.init_params(0, "cuda")
        self._check(fn, params, self._images(1))   # first call: capture, then replay
        eager, graphed = self._check(fn, params, self._images(1))
        assert eager == graphed and graphed["lstm_gates"] == T and graphed["lrp_linear"] == T + 3
        runs = fn.graphed
        assert runs["beam_search"].captures == 1 and runs["decoder_lrp"].captures == 1

    def test_second_batch_replays_the_same_graph(self):
        fn, cap = build(FlickrConfig(**SMALL), V, device="cuda", T=T)
        params = cap.init_params(0, "cuda")
        self._check(fn, params, self._images(2))
        self._check(fn, params, self._images(3))   # other values, the same shapes
        assert fn.graphed["beam_search"].captures == 1
        assert fn.graphed["decoder_lrp"].captures == 1
        self._check(fn, params, self._images(4, batch=2))   # another batch: a new capture
        assert fn.graphed["decoder_lrp"].captures == 2

    def test_params_swap_captures_anew(self):
        fn, cap = build(FlickrConfig(**SMALL), V, device="cuda", T=T)
        images = self._images(5)
        first = cap.init_params(0, "cuda")
        self._check(fn, first, images)
        # other weights (while the first stay alive, at other addresses): the
        # first params' graphs must not be replayed
        self._check(fn, cap.init_params(1, "cuda"), images)
        assert fn.graphed["beam_search"].captures == 2
        assert fn.graphed["decoder_lrp"].captures == 2

    def test_recorded_launches_are_the_graphs_kernel_nodes(self, monkeypatch, tmp_path):
        """A replay adds to each wrapper's count the launches recorded at
        capture; they must be the kernel nodes of that wrapper's kernel in
        the captured graph, read from the graph's debug dump."""
        new_graph = torch.cuda.CUDAGraph

        def debug_graph():
            graph = new_graph(keep_graph=True)   # the captured graph stays for debug_dump
            graph.enable_debug_mode()
            return graph

        monkeypatch.setattr(torch.cuda, "CUDAGraph", debug_graph)
        fn, cap = build(FlickrConfig(**SMALL), V, device="cuda", T=T)
        self._check(fn, cap.init_params(0, "cuda"), self._images(6))
        for name, run in fn.graphed.items():
            path = tmp_path / f"{name}.dot"
            run.entry.graph.debug_dump(str(path))
            dot = path.read_text()
            for wrapper, n in run.entry.launches.items():
                symbol = wrapper.__name__ + "_kernel"
                nodes = len(re.findall(rf"[_A-Za-z0-9]*{symbol}[_A-Za-z0-9]*", dot))
                assert nodes == n, (name, symbol, nodes, n)
            assert run.entry.launches[kernels.lstm_gates] == T
