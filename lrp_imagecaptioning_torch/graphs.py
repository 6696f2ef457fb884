"""Replay a host-bound stage from CUDA graphs.

The beam search and the decoder LRP (cached forward plus BPTT) are Python
loops of some 60 small launches a step. JAX's ``jit`` turns each into one
program; on the card the counterpart is a captured ``torch.cuda.CUDAGraph``,
which replays every launch of the stage for one launch from the host. Nothing
in these loops syncs with the host (T is fixed and nothing calls ``.item()``),
so the whole stage captures.

A graph keeps the device pointers it saw at capture:

* inputs are copied into the graph's own static tensors before each replay;
* params are not copied. The graph is keyed on the shapes and dtypes of the
  inputs and on the ``data_ptr``, shape, stride and dtype of every param
  tensor the stage reads (``graph_key``), so a new params dict gets a new
  capture and never stale weights.

Python runs once, at capture, so the kernel wrappers' launch counters
(``ops/kernels.py``) move then although nothing is launched: the runner takes
that back, records each kernel's launches of the stage, and adds them on every
replay. The counts on the graphed path are thus derived from the capture.
A capture that fails raises; the card has no eager fallback.

Two runners:

* ``GraphedStage`` keeps one graph a stage and captures anew when the key
  changes (``pipeline.build``: one batch shape, one params dict);
* ``GraphCache`` keeps every graph it captured, one per (stage, key), all in
  one private memory pool (the Explainer: word buckets and sub-batch sizes
  change the shapes from call to call). The graphs replay one after another
  on one stream, each replay's outputs are cloned before the next, and the
  static inputs are cloned before capture, outside the pool: so their
  scratch may overlap, and only their static outputs stay resident.
"""

from __future__ import annotations

import gc
from typing import Callable, NamedTuple

import torch

from .ops import kernels


def param_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a nested params dict, in sorted key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for k in sorted(tree) for t in param_tensors(tree[k])]


def graph_key(inputs, params: list[torch.Tensor]) -> tuple:
    """What a captured graph depends on: the inputs' shapes, dtypes and
    devices (their values are copied in) and where each param lies."""
    return (tuple((tuple(x.shape), x.dtype, x.device) for x in inputs),
            tuple((p.data_ptr(), tuple(p.shape), p.stride(), p.dtype) for p in params))


def capture(fn: Callable, device=None, pool=None):
    """``fn()`` captured into a new CUDA graph (in the memory pool ``pool``,
    or a pool of its own); returns the graph and what the captured call
    returned (tensors the graph rewrites at each replay).

    One eager call on a side stream comes first: lazy set-up (cuBLAS handles,
    the kernels' libraries) must not happen inside the capture. Python's
    cyclic garbage collector is off during the capture: a collection there
    can destroy an unreachable graph (a dropped Explainer's; the Explainer
    refers to itself through its graphed stages), which CUDA refuses while a
    stream captures, and the capture fails."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with (torch.cuda.graph(graph) if pool is None else torch.cuda.graph(graph, pool=pool)):
            out = fn()
    finally:
        if gc_was_on:
            gc.enable()
    return graph, out


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]         # static: copied into before each replay
    outputs: tuple[torch.Tensor, ...]  # static: rewritten by each replay
    launches: dict                     # kernel wrapper -> launches a replay makes


class GraphedStage:
    """``fn(params, *inputs)`` replayed from one CUDA graph. A call with
    another ``graph_key`` drops the graph (and its memory pool) and captures
    anew: the main path calls each stage with one batch shape and one params
    dict.

    ``fn`` returns a tensor or a tuple of tensors, and reads of ``params``
    only the tensors ``params_of(params)`` lists. A call returns copies of
    the graph's outputs, so a result stays valid across later calls."""

    def __init__(self, fn: Callable, params_of: Callable):
        self.fn = fn
        self.params_of = params_of
        self.key: tuple | None = None
        self.entry: _Graph | None = None
        self.captures = 0

    def __call__(self, params, *inputs):
        key = graph_key(inputs, self.params_of(params))
        if key != self.key:
            self.key = self.entry = None   # release the old graph's pool first
            self.entry = capture_stage(self.fn, params, inputs)
            self.captures += 1
            self.key = key
        return replay(self.entry, inputs)


def capture_stage(fn: Callable, params, inputs, pool=None) -> _Graph:
    """``fn(params, *static inputs)`` captured (in ``pool``, or a pool of its
    own), with each kernel's launches in one replay."""
    static = [x.clone(memory_format=torch.contiguous_format) for x in inputs]
    launches = {}

    def run():   # records the launches of its last call: the captured one
        before = {k: k.launches for k in kernels.KERNELS}
        out = fn(params, *static)
        launches.update((k, k.launches - before[k]) for k in kernels.KERNELS)
        return out

    graph, out = capture(run, static[0].device, pool)
    for wrapper, n in launches.items():
        wrapper.launches -= n   # the capture launched nothing
    outputs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    return _Graph(graph, static, outputs, launches)


def replay(entry: _Graph, inputs):
    """Copy ``inputs`` in, replay, count the launches, return copies of the
    outputs (a tensor, or a tuple of them)."""
    for static, x in zip(entry.inputs, inputs):
        static.copy_(x)
    entry.graph.replay()
    for wrapper, n in entry.launches.items():
        wrapper.launches += n
    out = tuple(o.clone() for o in entry.outputs)
    return out[0] if len(out) == 1 else out


class GraphCache:
    """Stages replayed from CUDA graphs kept one per (stage, ``graph_key``),
    all in one private memory pool made at the first capture. ``stage(fn,
    params_of)`` returns the runner of ``fn`` (called as GraphedStage is);
    ``captures`` counts the captures of every stage, so that a caller can
    show that no call after a warm-up captured. Nothing is evicted: the
    caller keeps the set of input shapes fixed (the Explainer pads every
    dispatch to a size of its batch's halving ladder)."""

    def __init__(self):
        self.entries: dict[tuple, _Graph] = {}
        self.pool = None
        self.captures = 0

    def stage(self, fn: Callable, params_of: Callable) -> Callable:
        def run(params, *inputs):
            key = (fn, graph_key(inputs, params_of(params)))
            entry = self.entries.get(key)
            if entry is None:
                if self.pool is None:
                    self.pool = torch.cuda.graph_pool_handle()
                entry = self.entries[key] = capture_stage(fn, params, inputs, self.pool)
                self.captures += 1
            return replay(entry, inputs)
        return run

    def output_bytes(self) -> int:
        """Bytes of the static outputs, which stay resident in the pool."""
        return sum(o.numel() * o.element_size() for e in self.entries.values() for o in e.outputs)

    def pool_bytes(self) -> int:
        """Bytes of the device memory segments the pool holds."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", (0, 0))) == pool)
