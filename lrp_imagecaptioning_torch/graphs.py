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
"""

from __future__ import annotations

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


def capture(fn: Callable, device=None):
    """``fn()`` captured into a new CUDA graph; returns the graph and what
    the captured call returned (tensors the graph rewrites at each replay).

    One eager call on a side stream comes first: lazy set-up (cuBLAS handles,
    the kernels' libraries) must not happen inside the capture."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
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
            self.entry = self._capture(params, inputs)
            self.key = key
        entry = self.entry
        for static, x in zip(entry.inputs, inputs):
            static.copy_(x)
        entry.graph.replay()
        for wrapper, n in entry.launches.items():
            wrapper.launches += n
        out = tuple(o.clone() for o in entry.outputs)
        return out[0] if len(out) == 1 else out

    def _capture(self, params, inputs) -> _Graph:
        static = [x.clone(memory_format=torch.contiguous_format) for x in inputs]
        launches = {}

        def run():   # records the launches of its last call: the captured one
            before = {k: k.launches for k in kernels.KERNELS}
            out = self.fn(params, *static)
            launches.update((k, k.launches - before[k]) for k in kernels.KERNELS)
            return out

        graph, out = capture(run, static[0].device)
        for wrapper, n in launches.items():
            wrapper.launches -= n   # the capture launched nothing
        self.captures += 1
        outputs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        return _Graph(graph, static, outputs, launches)
