"""K3 (``conv3x3_fused_kernel``, f32 work) against its roofline in the ResNet
fine-tune: the work ``lrp_weights`` hands it, the 33 '2b' convs' rule of
every position of every row of the traced steps (``work.resnet.k3_work``),
at 495 TFLOP/s (TF32, the fastest any f32 design can run) and 3.35 TB/s,
over its device time."""

from perfbench.harness.readers import roofline_share
from perfbench.work import resnet


def read(ctx):
    t, s = ctx.get("traced"), ctx.get("sizes")
    if not t or not t.get("steps"):
        return None
    rows = t["steps"] * t["batch"]
    ops, nbytes = resnet.k3_work(s.arch, s.image, t["width"])
    return roofline_share(ctx, "conv3x3_fused_kernel", rows * ops, rows * nbytes,
                          "tf32_flop_s")
