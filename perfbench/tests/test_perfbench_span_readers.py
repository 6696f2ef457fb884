"""The readers of the program's spans (``lrpic.*``, ``source:
program_span``) on synthetic trace summaries: a value, None where the span
was not recorded, and the worst rank."""

import pytest

from perfbench.harness.cell import load_reader
from perfbench.harness.trace import WINDOW_SPAN, Event, TraceSummary, summarize
from perfbench.reference.model import Sizes

SIZES = Sizes("adaptiveattention", "vgg16", "block1_conv2", E=2, H=3, L=4, D=5, V=7, image=4)
TRAIN = {"kind": "train", "steps": 8, "batch": 4, "width": 3, "counters": {}}
EXPLAIN = {"kind": "explain", "T": 3, "lengths": [1, 3], "counters": {}}
SHARES = {"to_host_share.explain": "lrpic.explain.to_host",
          "cnn_issue_share.explain": "lrpic.explain.cnn"}
PER_STEP = {f"{family}.{kind}": span
            for family, span in (("graph_call_host_ms", "lrpic.step_graph.call"),
                                 ("step_scalars_ms", "lrpic.step_graph.scalars"))
            for kind in ("train", "finetune")}


def ctx(traces, traced):
    return {"traces": traces, "peaks": None, "chips": len(traces), "sizes": SIZES,
            "traced": traced}


def summary(window_s: float, spans: dict) -> TraceSummary:
    return TraceSummary(window_s, window_s / 2, {}, [], dict(spans))


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_explain_share(metric):
    span = SHARES[metric]
    # 1.5 s of the span (two of them, nested in others) in a window of 3 s
    one = summary(3.0, {span: 1.5, "lrpic.explain.dispatch": 2.9, "aten::mul": 0.4})
    assert load_reader(metric)(ctx([one], EXPLAIN)) == pytest.approx(50.0)
    # the worst rank's share
    other = summary(2.0, {span: 1.8})
    assert load_reader(metric)(ctx([one, other], EXPLAIN)) == pytest.approx(90.0)
    # no such span recorded (the parent's program): nothing
    assert load_reader(metric)(ctx([summary(3.0, {"aten::mul": 0.4})], EXPLAIN)) is None
    assert load_reader(metric)(ctx([], EXPLAIN)) is None


@pytest.mark.parametrize("metric", sorted(PER_STEP))
def test_ms_a_step(metric):
    span = PER_STEP[metric]
    one = summary(4.0, {span: 0.012, "cudaGraphLaunch": 0.003})
    assert load_reader(metric)(ctx([one], TRAIN)) == pytest.approx(1.5)
    other = summary(4.0, {span: 0.040})
    assert load_reader(metric)(ctx([one, other], TRAIN)) == pytest.approx(5.0)
    assert load_reader(metric)(ctx([summary(4.0, {"cudaGraphLaunch": 0.003})], TRAIN)) is None
    assert load_reader(metric)(ctx([one], None)) is None
    assert load_reader(metric)(ctx([one], dict(TRAIN, steps=0))) is None


def test_span_names_hold_no_other_span_name():
    """``host_span_s`` matches by substring: no span the readers read holds
    another span's name."""
    names = [*SHARES.values(), *set(PER_STEP.values()), "lrpic.explain.analyze_many",
             "lrpic.explain.beam", "lrpic.explain.dispatch", "lrpic.explain.encode",
             "lrpic.explain.decoder", "lrpic.step_graph.capture", "lrpic.step_graph.replay"]
    for a in names:
        assert [b for b in names if a in b] == [a]


def test_span_from_events_reads_inside_the_window():
    """From events as the trace has them: only the span's time inside the
    traced window counts, and an idle gap inside a span with no narrower
    host event is put down to the span."""
    events = [Event(WINDOW_SPAN, 0.0, 10.0, False),
              Event("kernel", 0.0, 4.0, True),
              Event("lrpic.explain.to_host", 3.0, 8.0, False),
              Event("lrpic.explain.to_host", 9.0, 12.0, False),
              Event("Memcpy DtoH", 7.0, 8.0, True)]
    s = summarize(events)
    assert load_reader("to_host_share.explain")(ctx([s], EXPLAIN)) == pytest.approx(60.0)
    assert s.gaps[0] == (3.0, "lrpic.explain.to_host")
