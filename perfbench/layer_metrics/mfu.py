"""``mfu.<cell kind>``: the whole step's share of the chip's peak, the
model's operations counted by ``perfbench/work/<kind>.py``
(``harness.readers.peak_share``)."""

from perfbench.harness.readers import peak_share


def read(ctx):
    return peak_share(ctx)
