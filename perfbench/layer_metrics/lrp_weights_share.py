"""``lrp_weights_share.<cell kind>``: 100 x the device ms of the fine-tune
step's ``lrp_weights`` phase over the step's (predict, ``lrp_weights`` and
update), from the program's phase marks (CUDA events at the phase
boundaries, recorded inside the captured step; the entry's counters
``phase_ms.*``, the last step replayed). None where the program has no
phase marks."""

from perfbench.harness.readers import counter

PHASES = ("predict", "lrp_weights", "update")


def read(ctx):
    ms = [counter(ctx, f"phase_ms.{p}") for p in PHASES]
    if any(m is None for m in ms) or sum(ms) <= 0:
        return None
    return 100.0 * ms[1] / sum(ms)
