"""``device_idle.<cell kind>``: the card's idle share of the traced window,
the highest over the ranks (``harness.readers.idle_share``)."""

from perfbench.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
