"""PyTorch port: the spans at its layer boundaries (``utils/profiling.py::
annotate``), as ``torch.profiler`` records them.

On the CPU, at the explain tests' small size:

* ``Explainer.analyze_many`` records ``lrpic.explain.analyze_many`` once,
  ``lrpic.explain.beam`` once where it decodes, per dispatch one each of
  ``dispatch``, ``encode``, ``decoder``, ``cnn`` and ``to_host`` (the issue
  of its copies), the stages inside their dispatch, and one ``to_host``
  more after the last dispatch (the call's one wait for the copies), every
  span inside the call;
* a K-step ``StepGraph`` call records ``lrpic.step_graph.call`` once,
  ``scalars`` once, ``capture`` on its first call only and ``replay`` K
  times, each inside the call;
* with no profiler recording a span records nothing, and the spans leave
  no node in the exported programs of ``infer/export.py`` (``lrp`` through
  ``torch.export``, ``gradient`` through ``make_fx`` first).

On a card (``TestSpansOnCard``, marked ``cuda``; it skips here): no device
event of a profiled ``analyze_many`` is named ``lrpic.*``, every device
copy to the host is ``Device -> Pinned`` (none pageable), and every one ends
before the call's last ``lrpic.explain.to_host`` span (its wait) ends, on
the profiler's clock.

This file imports no JAX: the card's machine runs it with ``--noconftest``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.graphs import StepGraph  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.train.optimizer import make_optimizer  # noqa: E402
from lrp_imagecaptioning_torch.train.step import graph_body, train_grads  # noqa: E402
from lrp_imagecaptioning_torch.utils.profiling import annotate  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
             img_feature_dim=128, sentence_length=5, image_size=(8, 8))
V = 32
STAGES = ("dispatch", "encode", "decoder", "cnn", "to_host")
IN_DISPATCH = ("encode", "decoder", "cnn", "to_host")


class PP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, V + 1)}


def spans(prof, device=False) -> list:
    """(name, start, end) in ns of the profiled events named ``lrpic.*``:
    the host's, or with ``device=True`` the card's."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lrpic.") and ("CUDA" in str(e.device_type())) == device:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def named(found, name) -> list:
    return [s for s in found if s[0] == name]


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def explainer(device="cpu", method="lrp"):
    cfg = FlickrConfig(**SMALL)
    cap = build_captioner("adaptiveattention", cfg, V)
    return Explainer(cap, cap.init_params(0, device=device), PP(), method, batch_size=2,
                     word_buckets=(3,), device=device)


def inputs(n: int, lengths, device="cpu"):
    gen = np.random.default_rng(0)
    images = torch.as_tensor(gen.standard_normal((n, 8, 8, 3)).astype(np.float32) * 30,
                             device=device)
    toks = np.zeros((n, 5), np.int32)
    for r, m in enumerate(lengths):
        toks[r, :m] = gen.integers(3, V + 1, m)
        toks[r, m] = PP.EOS_TOKEN_LABEL_ENCODED
    return images, toks


@pytest.mark.parametrize("given", [True, False], ids=["captions_given", "decoded"])
def test_analyze_many_spans(given):
    ex = explainer()
    images, toks = inputs(5, [1, 4, 2, 3, 1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ex.analyze_many(images, toks if given else None)
    assert len(out) == 5 and all(e is not None for e in out)
    found = spans(prof)
    calls = named(found, "lrpic.explain.analyze_many")
    assert len(calls) == 1
    assert len(named(found, "lrpic.explain.beam")) == (0 if given else 1)
    # five rows at batch 2: chunks of 2, 2 and 1
    dispatches = named(found, "lrpic.explain.dispatch")
    assert len(dispatches) == 3
    to_host = named(found, "lrpic.explain.to_host")
    # one issue of the copies a dispatch, then the call's one wait
    assert len(to_host) == 3 + 1
    wait = max(to_host, key=lambda s: s[1])
    assert inside(wait, calls[0]) and not any(inside(wait, d) for d in dispatches)
    assert wait[1] >= max(d[2] for d in dispatches)
    for stage in IN_DISPATCH:
        each = [s for s in named(found, f"lrpic.explain.{stage}") if s is not wait]
        assert len(each) == 3, stage
        assert all(inside(s, calls[0]) for s in each), stage
        assert all(sum(inside(s, d) for d in dispatches) == 1 for s in each), stage
    assert all(inside(d, calls[0]) for d in dispatches)
    for beam in named(found, "lrpic.explain.beam"):
        assert inside(beam, calls[0]) and not any(inside(beam, d) for d in dispatches)
    assert {s[0] for s in found} == {"lrpic.explain.analyze_many",
                                     *[f"lrpic.explain.{s}" for s in STAGES],
                                     *([] if given else ["lrpic.explain.beam"])}


def test_step_graph_call_spans():
    """On the CPU a StepGraph runs its body where a card replays: the same
    spans, ``capture`` around the first call's set-up of its static
    tensors."""
    cfg = FlickrConfig(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1",
                       img_feature_length=16, img_feature_dim=128, sentence_length=6)
    cap = build_captioner("adaptiveattention", cfg, V)
    opt = make_optimizer("adaptiveattention", 1e-3)
    params = cap.init_params(0, device="cpu")
    state = opt.init(params)
    K, gen = 3, torch.Generator().manual_seed(0)
    stacks = (torch.randn(K, 4, 8, 8, 3), torch.randint(0, V, (K, 4, 7), generator=gen),
              torch.nn.functional.one_hot(torch.randint(0, V, (K, 4, 7), generator=gen),
                                          V).float())
    graph = StepGraph(graph_body(opt, train_grads(cap)), opt)
    for call in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            params, state, m = graph(params, state, stacks)
        assert m["loss"].shape == (K,)
        found = spans(prof)
        calls = named(found, "lrpic.step_graph.call")
        assert len(calls) == 1
        counts = {"scalars": 1, "capture": 1 if call == 0 else 0, "replay": K}
        for stage, count in counts.items():
            each = named(found, f"lrpic.step_graph.{stage}")
            assert len(each) == count, (call, stage)
            assert all(inside(s, calls[0]) for s in each), stage
        assert len(found) == 1 + sum(counts.values())


def test_no_profiler_records_nothing():
    """A span entered and left with no profiler recording is in no later
    trace, and a trace holds only the spans run inside it."""
    for _ in range(3):
        with annotate("lrpic.test.outside"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("lrpic.test.inside"):
            torch.ones(2) + 1
    with annotate("lrpic.test.after"):
        pass
    assert [s[0] for s in spans(prof)] == ["lrpic.test.inside"]
    with profile(activities=[ProfilerActivity.CPU]) as empty:
        pass
    assert spans(empty) == []


def profiler_nodes(graph) -> list:
    return [str(n.target) for n in graph.nodes
            if "profiler" in str(n.target) or "record_function" in str(n.target)]


@pytest.mark.parametrize("method", ["lrp", "gradient"])
def test_traced_programs_hold_no_profiler_node(method, tmp_path):
    """The explain body's ``make_fx`` trace (which keeps a
    ``record_function``'s enter and exit as nodes) and the artifact's
    programs that ``export_serving`` writes hold no profiler node."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from lrp_imagecaptioning_torch.infer.export import _ExplainBucket, export_serving

    ex = explainer(method=method)
    images, toks = inputs(2, [1, 3])
    args = (ex.params, images, torch.as_tensor(toks, dtype=torch.long))
    with torch.no_grad():
        traced = make_fx(_ExplainBucket(ex, 5), tracing_mode="fake")(*args)
    assert profiler_nodes(traced.graph) == []
    out = export_serving(ex.captioner, ex.params, PP(), str(tmp_path / "art"), batch_size=2,
                         beam_size=2, method=method, word_buckets=(), device="cpu")
    programs = [f for f in sorted(os.listdir(out)) if f.endswith(".pt2")]
    assert len(programs) == 2, programs   # the decode and the explain program at T
    for name in programs:
        program = torch.export.load(os.path.join(out, name))
        assert profiler_nodes(program.graph) == [], name
        assert any("lstm_gates" in str(n.target) for n in program.graph.nodes), name


@pytest.mark.cuda
class TestSpansOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the device timeline exists only there")

    def test_spans_are_host_events_on_the_device_clock(self):
        """The copies to the host are pinned and asynchronous: none is
        pageable, and each lands before the call's one wait ends."""
        ex = explainer("cuda")
        images, toks = inputs(5, [1, 4, 2, 3, 1], "cuda")
        ex.warmup(images, sub_batches=True)
        ex.analyze_many(images, toks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ex.analyze_many(images, toks)
        assert spans(prof, device=True) == []
        to_host = named(spans(prof), "lrpic.explain.to_host")
        assert len(to_host) == 3 + 1
        wait_end = max(e for _, _, e in to_host)
        copies = [(e.name(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if "CUDA" in str(e.device_type()) and "Memcpy DtoH" in e.name()]
        # five outputs a dispatch, three dispatches
        assert len(copies) >= 5 * 3, copies
        assert all("Pinned" in name and "Pageable" not in name for name, _ in copies), copies
        slack = 50_000   # ns
        for name, end in copies:
            assert end <= wait_end + slack, (name, end, wait_end)
