"""``allreduce_share.<cell kind>``: the NCCL kernels' device time over the
device's busy time, on the rank where that share is highest (a group of
several cards only)."""


def read(ctx):
    shares = [100.0 * t.kernel_s("nccl", "Nccl") / t.busy_s for t in ctx["traces"]
              if t.busy_s > 0]
    return max(shares) if ctx["chips"] > 1 and shares else None
