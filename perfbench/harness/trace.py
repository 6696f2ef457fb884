"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activity, kept in memory) over a few steady seconds of the window, reduced
to what the per-layer readers and the breakdown read: the traced window,
the union of device activity in it, each device operation's time by name,
each host span's (operator, annotation, runtime call) total time by name,
and the idle gaps with what the host was doing in each."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

WINDOW_SPAN = "perfbench.traced_window"


@dataclass
class Event:
    name: str
    start: float    # seconds on the profiler's clock
    end: float
    device: bool


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_s: dict = field(default_factory=dict)       # device op name -> seconds
    gaps: list = field(default_factory=list)       # [(seconds, host activity)], longest first
    host_s: dict = field(default_factory=dict)     # host span name -> seconds (nested: each)

    def kernel_s(self, *needles: str) -> float:
        """Seconds of the device ops whose name holds any of ``needles``."""
        return sum(s for n, s in self.op_s.items() if any(k in n for k in needles))

    def host_span_s(self, *needles: str) -> float:
        """Seconds of the host spans whose name holds any of ``needles``."""
        return sum(s for n, s in self.host_s.items() if any(k in n for k in needles))

    def as_dict(self) -> dict:
        return {"window_s": self.window_s, "busy_s": self.busy_s, "op_s": self.op_s,
                "gaps": self.gaps, "host_s": self.host_s}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceSummary":
        return cls(d["window_s"], d["busy_s"], d["op_s"], [tuple(g) for g in d["gaps"]],
                   d.get("host_s", {}))


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    gaps, at = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def summarize(events: list, n_gaps: int = 10) -> TraceSummary:
    """Reduce the events of one profiled stretch. The window is the span
    ``WINDOW_SPAN`` (the whole stretch where it is missing)."""
    spans = [e for e in events if not e.device and e.name == WINDOW_SPAN]
    dev = [e for e in events if e.device]
    host = [e for e in events if not e.device and e.name != WINDOW_SPAN]
    if spans:
        lo, hi = spans[0].start, spans[0].end
    else:
        every = [e.start for e in events] + [e.end for e in events]
        lo, hi = (min(every), max(every)) if every else (0.0, 0.0)
    intervals = [(e.start, e.end) for e in dev]
    op_s: dict = {}
    for e in dev:
        op_s[e.name] = op_s.get(e.name, 0.0) + (min(e.end, hi) - max(e.start, lo)) * (
            e.end > lo and e.start < hi)
    host_s: dict = {}
    for e in host:
        if e.end > lo and e.start < hi:
            host_s[e.name] = host_s.get(e.name, 0.0) + min(e.end, hi) - max(e.start, lo)
    gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:n_gaps]
    described = []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [h for h in host if h.start <= mid < h.end]
        what = min(inside, key=lambda h: h.end - h.start).name if inside else "host between ops"
        described.append((e - s, what))
    return TraceSummary(hi - lo, union_length(intervals, lo, hi), op_s, described, host_s)


def kineto_events(prof) -> list:
    """The profiler's events as ``Event``s (device: CUDA kernels, copies and
    sets)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        on_card = "CUDA" in str(e.device_type())
        if on_card and e.name() == WINDOW_SPAN:
            continue   # the span's mirror on the device timeline, not device work
        if e.name().startswith("ProfilerStep#"):
            continue   # the armed profiler's own step, not the program's
        out.append(Event(e.name(), start, start + e.duration_ns() * 1e-9, on_card))
    return out


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Tracer:
    """The traced run's profiler; disabled, every call does nothing. Inside
    ``with tracer.armed():`` the profiler has started (its start, CUPTI's,
    takes seconds) and records nothing yet, so that its start falls outside
    the traced stretch; ``record()`` starts the recording and ``with
    tracer.window():`` marks the stretch that counts, then ends the
    recording and keeps the reduced trace in ``summary``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: TraceSummary | None = None
        self._prof = None

    def _keep(self, prof):
        self.summary = summarize(kineto_events(prof))

    @contextlib.contextmanager
    def armed(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts, on_trace_ready=self._keep,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            self._prof = prof
            try:
                yield
            finally:
                self._prof = None

    def record(self):
        if self._prof is not None:
            self._prof.step()         # warm-up -> recording

    @contextlib.contextmanager
    def window(self, synchronize=None):
        if self._prof is None:
            yield
            return
        from torch.profiler import record_function

        with record_function(WINDOW_SPAN):
            yield
            if synchronize is not None:
                synchronize()
        self._prof.step()             # recording -> done: ``_keep``
