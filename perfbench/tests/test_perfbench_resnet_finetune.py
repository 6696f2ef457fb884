"""The cell ``resnet101-finetune-k2``: its CPU rehearsal end to end (sound,
it comes out correct; with each fault planted in the program, not
correct), its weights, its work counts by hand and its readers.

The faults: a step that leaves its state unchanged, half of the batch left
out of the loss, and two proper to the residual walk, planted in the
port's ``explain/resnet_lrp.py``: the Add rule handing all relevance to
the shortcut, and the BN rule skipped (R passed through)."""

import pytest
import torch

from perfbench import run
from perfbench.entries import finetune_resnet
from perfbench.harness.cell import load_cell, load_reader
from perfbench.harness.peaks import peaks_for
from perfbench.harness.readers import roofline_share
from perfbench.harness.trace import WINDOW_SPAN, Event, summarize
from perfbench.reference import resnet as ref
from perfbench.reference.model import Sizes, leaves
from perfbench.tests.faults import FAULTS, _patch
from perfbench.work import decoder, finetune_resnet as work, resnet

CELL = "resnet101-finetune-k2"


def rehearse(seed: int) -> dict:
    out = {}
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "4", "--trace", "0",
            "--rehearse"]
    assert run.main(argv, hooks={"result": out.update}) == 0
    return out


def add_to_shortcut():
    """The Add rule gives the shortcut all of a block's relevance."""
    from lrp_imagecaptioning_torch.explain import resnet_lrp

    return _patch(resnet_lrp, "lrp_add", lambda r, xs, eps=None: [torch.zeros_like(r), r])


def bn_skipped():
    """The BN rule hands R back unchanged."""
    from lrp_imagecaptioning_torch.explain import resnet_lrp

    return _patch(resnet_lrp, "lrp_bn", lambda r, x, y, mean, beta, eps=None: r)


RESNET_FAULTS = {"add_to_shortcut": add_to_shortcut, "bn_skipped": bn_skipped}


@pytest.mark.parametrize("seed", [2**31 + 11, 4_000_000_001])
def test_sound_rehearsal_is_correct(seed):
    result = rehearse(seed)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks" and result["metrics"] == {}
    assert set(result["checks"]) == {"loss", "first_gradient", "change"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "add_to_shortcut",
                                   "bn_skipped"])
def test_fault_is_not_correct(fault):
    undo = {**FAULTS, **RESNET_FAULTS}[fault]()
    try:
        result = rehearse(77)
    finally:
        undo()
    assert result["correct"] is False, result["checks"]


def test_bn_leaves_are_drawn_and_calibrated():
    """No BN is the identity (its rule would pass R through whatever its
    code), and the stream stays O(1) on other images of the same law."""
    cell = load_cell(CELL, rehearsal=True)
    p = finetune_resnet.make_params(cell.sizes, 5, torch.device("cpu"))["vgg"]
    for name, bn, _, _ in ref.convs(cell.sizes.arch):
        b = p[bn]
        assert b["beta"].abs().min() > 0 and b["moving_mean"].abs().min() > 0, bn
        assert (b["moving_var"] > 0).all() and not torch.equal(b["gamma"], torch.ones_like(
            b["gamma"])), bn
        hi = 0.2 if name.endswith("2c") else 1.0
        assert hi / 2 <= float(b["gamma"].min()) and float(b["gamma"].max()) <= hi, bn
    x = torch.randn(4, cell.sizes.image, cell.sizes.image, 3, generator=torch.Generator()
                    .manual_seed(9))
    feat = ref.forward(p, x, cell.sizes.arch)
    assert 0.1 < float(feat.pow(2).mean().sqrt()) < 5


def test_traced_reads_no_phase_counter_on_the_cpu():
    entry = finetune_resnet.Entry(load_cell(CELL, rehearsal=True), 3, torch.device("cpu"))
    t = entry.traced()
    assert t["kind"] == "finetune_resnet" and t["counters"] == {}
    assert sorted(k for k, _ in leaves(entry.params0)) == sorted(
        k for k, _ in leaves(entry.params))
    entry.release()


def test_resnet_shapes_and_counts_by_hand():
    layers = resnet.conv_layers("resnet50", 224)
    assert len(layers) == 53 and len(resnet.conv_layers("resnet101", 224)) == 104
    assert layers[0][:2] == ("conv1", 112)
    stage_size = {n[:4]: o for n, o, *_ in layers if n.endswith("2b")}
    assert stage_size == {"res2": 55, "res3": 28, "res4": 14, "res5": 7}
    # at 32: conv1 16x16 (7x7, 3 -> 64), pool to 7, res2a_branch1 7x7 (64 -> 256)
    c1, s1 = 2 * 16 * 16 * 49 * 3 * 64, 2 * 7 * 7 * 64 * 256
    small = resnet.conv_layers("resnet50", 32)
    assert resnet.conv_flops(*small[0][1:5]) == c1 and resnet.conv_flops(*small[1][1:5]) == s1
    f = resnet.forward_flops("resnet50", 32)
    assert f == sum(resnet.conv_flops(*x[1:5]) for x in small)
    assert resnet.train_flops("resnet50", 32) == 3 * f - c1
    # the walk for 3 words: the forward, each conv's z once and its
    # transpose a word, the stem's two of each
    assert resnet.lrp_flops("resnet50", 32, 3) == f + 4 * f + 4 * c1
    # K3: the '2b' convs only, bias-free
    ops, nbytes = resnet.k3_work("resnet50", 32, 3)
    b2 = [x for x in small if x[0].endswith("2b")]
    assert ops == sum(4 * resnet.conv_flops(*x[1:5]) for x in b2)
    o, _, ci, co = b2[0][1:5]
    assert nbytes >= 4.0 * (3 * o * o * co + o * o * ci + 9 * ci * co + 3 * o * o * ci)


SIZES = Sizes("adaptiveattention", "resnet50", "activation_49", E=2, H=3, L=4, D=2048, V=7,
              image=64)


def ctx(counters=None, traced=True):
    trace = summarize([Event(WINDOW_SPAN, 0.0, 10.0, False),
                       Event("conv3x3_fused_kernel<4, 8>", 1.0, 3.0, True)])
    t = ({"kind": "finetune_resnet", "steps": 2, "batch": 4, "width": 5,
          "counters": counters or {}} if traced else None)
    return {"traces": [trace], "peaks": peaks_for("NVIDIA H100 80GB HBM3"), "chips": 1,
            "sizes": SIZES, "traced": t}


def test_lrp_weights_share_reads_the_phase_counters():
    read = load_reader("lrp_weights_share.finetune_resnet")
    c = {"phase_ms.predict": 5.0, "phase_ms.lrp_weights": 85.0, "phase_ms.update": 10.0}
    assert read(ctx(c)) == pytest.approx(85.0)
    assert read(ctx()) is None and read(ctx(traced=False)) is None


def test_k3_roofline_and_mfu_read_their_work():
    ops, nbytes = resnet.k3_work("resnet50", 64, 5)
    want = roofline_share(ctx(), "conv3x3_fused_kernel", 8 * ops, 8 * nbytes, "tf32_flop_s")
    assert load_reader("k3_roofline.finetune_resnet")(ctx()) == pytest.approx(want)
    row = (resnet.train_flops("resnet50", 64) + 3 * decoder.forward_flops(SIZES, 5)
           + 2 * (resnet.forward_flops("resnet50", 64) + decoder.forward_flops(SIZES, 5))
           + sum(decoder.lrp_word_flops(SIZES, t) for t in range(5))
           + resnet.lrp_flops("resnet50", 64, 5))
    assert work.row_flops(SIZES, 5) == pytest.approx(row)
    assert load_reader("mfu.finetune_resnet")(ctx()) == pytest.approx(
        100 * 8 * row / (10.0 * 495e12))
