"""K4 (``lrp_a1b0_fused_kernel``, bf16) against its roofline: the work the
traced pass hands it for the words actually explained (each row's caption
length, not its bucket's padded slots; ``work.cnn.rule_work(..., "k4")``)
at 989 TFLOP/s and 3.35 TB/s, over its device time."""

from perfbench.harness.readers import roofline_share
from perfbench.work import cnn


def read(ctx):
    t, s = ctx.get("traced"), ctx.get("sizes")
    if not t or "lengths" not in t:
        return None
    work = [cnn.rule_work(s.arch, s.until, s.image, n, "k4") for n in t["lengths"]]
    return roofline_share(ctx, "lrp_a1b0_fused_kernel", sum(w[0] for w in work),
                          sum(w[1] for w in work), "bf16_flop_s")
