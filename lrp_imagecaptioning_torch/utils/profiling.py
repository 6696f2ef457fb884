"""Profiling and observability helpers, on ``torch.profiler`` and
``torch.cuda``: the port's counterparts of the JAX package's
``utils/profiling.py``.

* ``trace(logdir)`` — a ``torch.profiler`` trace of everything inside (host
  and, with a card, device activity), written to ``logdir/trace.json`` in
  the Chrome trace format (chrome://tracing, Perfetto).
* ``annotate(name)`` — a named span in that trace, on the profiler's clock,
  and an NVTX range on a card (Nsight). The port's own spans are named
  ``lrpic.<layer>.<stage>``.
* ``memory_stats()`` — host RSS (psutil, when installed) and the card's
  allocated and peak bytes, under the JAX package's keys.
* ``StepTimer`` — cheap wall-clock step timing with an EMA.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch._C._profiler import _RecordFunctionFast


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@functools.cache
def _nvtx_range():
    """NVTX's range push and pop where a card is present, else None:
    decided once, at the first span."""
    if not torch.cuda.is_available():
        return None
    from torch.cuda.nvtx import _nvtx

    return _nvtx.rangePushA, _nvtx.rangePop


class _CardSpan:
    """A host span and an NVTX range of one name."""

    __slots__ = ("_name", "_span", "_push", "_pop")

    def __init__(self, name: str, push, pop):
        self._name, self._push, self._pop = name, push, pop
        self._span = _RecordFunctionFast(name)

    def __enter__(self):
        self._push(self._name)
        self._span.__enter__()

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._pop()


def annotate(name: str):
    """A span named ``name`` (``with annotate(name): ...``): the host span
    that ``torch.profiler`` records while it records, and with a card an
    NVTX range. The span is a host event only: unlike ``record_function``,
    whose user range the profiler mirrors on the device timeline, it puts
    nothing among the device's events, and ``torch.export`` and ``make_fx``
    trace no node for it. With no profiler recording it costs about half a
    microsecond, and a microsecond more for NVTX's push and pop on a card."""
    nvtx = _nvtx_range()
    return _RecordFunctionFast(name) if nvtx is None else _CardSpan(name, *nvtx)


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
