"""What the per-layer readers share. A reader takes ``ctx``: ``traces``
(one ``TraceSummary`` a rank), ``peaks`` (the chip's, or None), ``chips``,
``sizes`` (the configuration's) and ``traced`` (what the entry ran in the
traced stretch: its ``kind``, rows, steps or caption lengths, and
``counters``); it counts the work itself from ``perfbench/work/``. Each
returns None where there is nothing to read (no trace, no peak for this
chip, no time in the kernel)."""

from __future__ import annotations

import importlib


def roofline_share(ctx, kernel: str, ops: float, nbytes: float, peak: str):
    """100 x the least time of ``ops`` operations and ``nbytes`` bytes (the
    larger of operations over the peak and bytes over the memory's rate)
    over the device time of the ops whose name holds ``kernel``."""
    peaks, traces = ctx["peaks"], ctx["traces"]
    if not peaks or not traces or not ops:
        return None
    seconds = sum(t.kernel_s(kernel) for t in traces)
    if seconds <= 0:
        return None
    return 100.0 * max(ops / peaks[peak], nbytes / peaks["hbm_bytes_s"]) / seconds


def model_flops(ctx):
    """(the model's operations in the traced stretch, the peak they are held
    to), from ``perfbench/work/<kind>.py``; None where nothing was traced."""
    t = ctx.get("traced")
    if not t:
        return None
    work = importlib.import_module(f"perfbench.work.{t['kind']}")
    return work.model_flops(ctx["sizes"], t), work.PEAK


def peak_share(ctx):
    """100 x the model's operations in the traced window over the window
    times the peak of the cell's highest format, on every chip."""
    peaks, traces, counted = ctx["peaks"], ctx["traces"], model_flops(ctx)
    if not peaks or not traces or not counted or not counted[0]:
        return None
    window = max(t.window_s for t in traces)
    return 100.0 * counted[0] / (window * peaks[counted[1]] * ctx["chips"])


def idle_share(ctx):
    """100 x the traced window's share in which no kernel, copy or set ran
    on the card: the highest over the ranks."""
    traces = [t for t in ctx["traces"] if t.window_s > 0]
    if not traces:
        return None
    return max(100.0 * (1.0 - t.busy_s / t.window_s) for t in traces)


def counter(ctx, name: str):
    """A counter the entry read from the program over the traced stretch."""
    t = ctx.get("traced")
    return None if not t or name not in t.get("counters", {}) else float(t["counters"][name])
