"""K3 (``conv3x3_fused_kernel``, f32 work) against its roofline: the work the
fine-tune's ``lrp_weights`` hands it, every position of every row of the
traced steps (``work.cnn.rule_work(..., "k3")``), at 495 TFLOP/s (TF32,
the fastest any f32 design can run) and 3.35 TB/s, over its device time."""

from perfbench.harness.readers import roofline_share
from perfbench.work import cnn


def read(ctx):
    t, s = ctx.get("traced"), ctx.get("sizes")
    if not t or not t.get("steps"):
        return None
    rows = t["steps"] * t["batch"]
    ops, nbytes = cnn.rule_work(s.arch, s.until, s.image, t["width"], "k3")
    return roofline_share(ctx, "conv3x3_fused_kernel", rows * ops, rows * nbytes,
                          "tf32_flop_s")
