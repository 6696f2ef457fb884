"""The trace reduction and the per-layer readers on a synthetic event list."""

import pytest

from perfbench.harness.cell import load_reader
from perfbench.harness.peaks import peaks_for
from perfbench.harness.readers import roofline_share
from perfbench.harness.trace import (WINDOW_SPAN, Event, TraceSummary, idle_gaps, summarize,
                                     union_length)
from perfbench.reference.model import Sizes
from perfbench.work import explain, train

PEAKS = peaks_for("NVIDIA H100 80GB HBM3")


def events():
    # window [0, 10); device: two overlapping kernels [1, 3) and [2, 4), a
    # copy [6, 7); the host sits in a sync during [4, 6) and [7, 10)
    return [Event(WINDOW_SPAN, 0.0, 10.0, False),
            Event("lrp_a1b0_fused_kernel<256>", 1.0, 3.0, True),
            Event("conv3x3_fused_kernel<1,4>", 2.0, 4.0, True),
            Event("Memcpy DtoH", 6.0, 7.0, True),
            Event("aten::copy_", 0.5, 9.5, False),
            Event("cudaStreamSynchronize", 4.0, 6.0, False)]


def test_union_and_gaps():
    assert union_length([(1, 3), (2, 4), (6, 7)], 0, 10) == 4
    assert union_length([(1, 3)], 2, 10) == 1
    assert idle_gaps([(1, 3), (2, 4), (6, 7)], 0, 10) == [(0, 1), (4, 6), (7, 10)]


def test_summary():
    s = summarize(events())
    assert s.window_s == 10 and s.busy_s == 4
    assert s.kernel_s("lrp_a1b0_fused") == 2 and s.kernel_s("conv3x3_fused") == 2
    # longest gap first, each with the innermost host activity at its middle
    assert s.gaps[0] == (3.0, "aten::copy_")
    assert s.gaps[1] == (2.0, "cudaStreamSynchronize")


SIZES = Sizes("adaptiveattention", "vgg16", "block1_conv2", E=2, H=3, L=4, D=5, V=7, image=4)


def ctx(traced=None, chips=1, trace=None):
    return {"traces": [trace or summarize(events())], "peaks": PEAKS, "chips": chips,
            "sizes": SIZES, "traced": traced}


def test_idle_share():
    for name in ("device_idle.explain", "device_idle.train", "device_idle.finetune"):
        assert load_reader(name)(ctx()) == pytest.approx(60.0)


def test_roofline_share():
    # the kernel ran 2 s; 989e12 operations are 1 s at the bf16 peak and
    # the bytes less: 50 %
    assert roofline_share(ctx(), "lrp_a1b0_fused", 989e12, 1e9, "bf16_flop_s") == \
        pytest.approx(50.0)
    # bytes bound: 3.35e12 bytes is 1 s at 3.35 TB/s
    assert roofline_share(ctx(), "conv3x3_fused", 1.0, 3.35e12, "tf32_flop_s") == \
        pytest.approx(50.0)


def test_k4_counts_the_words_explained_not_the_slots():
    # captions of 1 and 3 words: 4 words' transposed convs, whatever bucket
    # they ran on; block1_conv2 at 4x4 is the one post-ReLU conv
    conv = 2 * 16 * 9 * 64 * 64
    nbytes = sum(2.0 * (w * 16 * 64 + 16 * 64 + 16 * 64 + 9 * 64 * 64 + w * 16 * 64)
                 for w in (1, 3))
    want = 100.0 * max(4 * conv / PEAKS["bf16_flop_s"], nbytes / PEAKS["hbm_bytes_s"]) / 2.0
    traced = {"kind": "explain", "T": 3, "lengths": [1, 3], "plan": [(2, 4)], "counters": {}}
    assert load_reader("k4_roofline.explain")(ctx(traced)) == pytest.approx(want)


def test_k3_counts_every_position_of_every_row():
    conv = 2 * 16 * 9 * 64 * 64
    traced = {"kind": "finetune", "steps": 2, "batch": 3, "width": 4, "counters": {}}
    nbytes = 4.0 * (4 * 16 * 64 + 16 * 64 + 9 * 64 * 64 + 64 + 4 * 16 * 64)
    want = 100.0 * max(6 * 5 * conv / PEAKS["tf32_flop_s"],
                       6 * nbytes / PEAKS["hbm_bytes_s"]) / 2.0
    assert load_reader("k3_roofline.finetune")(ctx(traced)) == pytest.approx(want)


def test_mfu():
    traced = {"kind": "train", "steps": 4, "batch": 8, "width": 3, "counters": {}}
    flops = 32 * train.row_flops(SIZES, 3)
    want = 100.0 * flops / (10.0 * PEAKS["tf32_flop_s"])          # a window of 10 s
    assert load_reader("mfu.train")(ctx(traced)) == pytest.approx(want)
    assert load_reader("mfu.train")(ctx(traced, chips=4)) == pytest.approx(want / 4)
    explained = {"kind": "explain", "T": 3, "lengths": [1, 3], "counters": {}}
    want = 100.0 * explain.model_flops(SIZES, explained) / (10.0 * PEAKS["bf16_flop_s"])
    assert load_reader("mfu.explain")(ctx(explained)) == pytest.approx(want)


def test_nothing_to_read_reads_nothing():
    empty = {"traces": [], "peaks": None, "chips": 1, "sizes": SIZES, "traced": None}
    for name in ("k4_roofline.explain", "k3_roofline.finetune", "mfu.explain",
                 "device_idle.explain", "allreduce_share.train", "graph_captures.explain"):
        assert load_reader(name)(empty) is None
    # no NCCL kernel on one card: no all-reduce share
    assert load_reader("allreduce_share.train")(ctx()) is None
    counted = {"kind": "explain", "counters": {"graph_captures": 0}}
    assert load_reader("graph_captures.explain")(ctx(counted)) == 0.0


def test_host_spans_are_kept():
    s = summarize(events())
    assert s.host_span_s("cudaStreamSynchronize") == 2.0 and s.host_span_s("aten::") == 9.0
    assert TraceSummary.from_dict(s.as_dict()).host_s == s.host_s


def test_an_armed_tracer_records_only_its_window():
    import torch

    from perfbench.harness.trace import Tracer

    tracer, x = Tracer(True), torch.randn(64, 64)
    with tracer.armed():
        x @ x
        tracer.record()
        x - x
        with tracer.window():
            torch.mm(x, x)
        x + x
    s = tracer.summary
    assert s.window_s > 0 and s.host_span_s("aten::mm") > 0
    assert s.host_span_s("aten::add") == 0 and s.host_span_s("aten::sub") == 0
    assert not s.host_span_s("ProfilerStep")
