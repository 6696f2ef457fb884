"""Profiling and observability helpers, on ``torch.profiler`` and
``torch.cuda``: the port's counterparts of the JAX package's
``utils/profiling.py``.

* ``trace(logdir)`` — a ``torch.profiler`` trace of everything inside (host
  and, with a card, device activity), written to ``logdir/trace.json`` in
  the Chrome trace format (chrome://tracing, Perfetto).
* ``annotate(name)`` — a named span in that trace, and an NVTX range on a card.
* ``memory_stats()`` — host RSS (psutil, when installed) and the card's
  allocated and peak bytes, under the JAX package's keys.
* ``StepTimer`` — cheap wall-clock step timing with an EMA.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def memory_stats() -> dict:
    """``host_rss_mb`` (with psutil) and, per visible card i,
    ``dev{i}_bytes_in_use_mb`` and ``dev{i}_peak_bytes_mb`` (MB = 1e6 bytes)."""
    out = {}
    try:
        import psutil
    except ImportError:
        psutil = None
    if psutil is not None:
        out["host_rss_mb"] = psutil.Process().memory_info().rss / 1e6
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"dev{i}_bytes_in_use_mb"] = torch.cuda.memory_allocated(i) / 1e6
            out[f"dev{i}_peak_bytes_mb"] = torch.cuda.max_memory_allocated(i) / 1e6
    return out


class StepTimer:
    """EMA step timer; ``update()`` per step, read ``.rate`` (steps/s)."""

    def __init__(self, alpha: float = 0.1):
        self._alpha = alpha
        self._last = None
        self._ema = None

    def update(self) -> float | None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._ema = dt if self._ema is None else (1 - self._alpha) * self._ema + self._alpha * dt
        self._last = now
        return self._ema

    @property
    def rate(self) -> float | None:
        return None if not self._ema else 1.0 / self._ema
