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

A third, ``StepGraph``, runs K optimizer steps a call (``--steps-per-call``,
``train/step.py::make_multi_train_step``): one train or fine-tune step is
captured over static state and inputs and replayed once a step, the step's
batch, dropout masks and Adam scalars copied in on the card before each
replay. In a NCCL group of one card a process the captured step is one
rank's, its all-reduce of the gradient inside the graph
(``train/step.py::rank_multi``), as the JAX package's sharded K-step call
is one program on every process. Every rank captures and replays the same
collectives in the same order: the ranks' steps have one key (equal rows
a rank), and a capture is the only new collective a rank issues on its
own. Such a graph holds the communicator (NCCL waits for every graph that
captured one of its collectives before it destroys it): the StepGraphs
are released before ``torch.distributed.destroy_process_group``
(``release_step_graphs``, also run at exit).
"""

from __future__ import annotations

import atexit
import gc
import weakref
from typing import Callable, NamedTuple

import torch

from .ops import kernels
from .utils.profiling import annotate
from .weights import tree_leaves, tree_map


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

    One eager call on a side stream of ``device`` comes first, and the
    capture runs on that stream: lazy set-up (cuBLAS handles,
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
        # captured on the side stream of ``device``: torch.cuda.graph's own
        # capture stream lies on the card current at its first use, and work
        # on another card would run eagerly beside an empty graph
        with torch.cuda.graph(graph, pool=pool, stream=side):
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


def _rebuild(tree, fn):
    """A tuple tree of ``tree``'s structure (NamedTuples kept) of ``fn(t)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    items = [_rebuild(v, fn) for v in tree]
    return type(tree)._make(items) if hasattr(type(tree), "_make") else type(tree)(items)


def _adopt(static, given) -> None:
    """Copy the tensors of ``given`` into the tree ``static`` of the same
    structure, unless they are its own tensors."""
    pairs = list(zip(tree_leaves(static), tree_leaves(given)))
    if any(s is not g for s, g in pairs):
        for s, g in pairs:
            s.copy_(g)


class StepGraph:
    """K optimizer steps a call, each the replay of one captured step: the
    CUDA counterpart of the JAX package's jitted ``lax.scan`` over K stacked
    batches, where the host issues one launch a step.

    ``body(params, mu, nu, scalars, *batch, masks) -> (params, mu, nu,
    metrics)`` is one step: ``batch`` one step's input tensors, ``masks``
    its dropout masks (a tuple tree, or None), ``scalars`` a (3,) float32
    tensor of the step's (bc1, bc2, lr) (``Adam.step_scalars``, read by
    ``Adam.moments``), ``metrics`` {"loss", "accuracy"} of 0-d tensors.
    It is captured over static tensors, and the captured step copies the new
    params and moments back into the static ones: the state handed in is
    the state updated, as with the JAX package's ``donate_argnums=(0, 1)``.

    A call (``__call__``) takes the state, the batch as (K, ...) stacks on
    the card and the K steps' masks. Each step copies its batch slice, masks
    and scalars into the static inputs, on the card, and replays, with no
    host sync between steps. It returns the runner's own static params and
    moments, which the next call rewrites, and the metrics (K,)-stacked on
    the card. A params or moments tree that is not the runner's own (the
    first call, a checkpoint loaded, a single step between calls) is copied
    in, not recaptured; new input shapes or a new masks layout (dropout on
    or off) capture anew. One graph replayed K times: its capture time and
    memory do not grow with K.

    The kernel wrappers' launch counts are derived from the capture (as
    ``capture_stage`` does) and grow by each replay's. The capture's warm-up
    is one real step on the static state (the state is copied in after it),
    and its launches count. A capture that fails raises. On the CPU nothing
    is captured: each step runs the body on the static tensors, after the
    same copy-in, which is what a replay on the card computes.

    ``release()`` drops the graph and the static tensors (the state a call
    returned stays valid); the next call captures anew.

    A call records the spans ``lrpic.step_graph.call`` around it,
    ``.scalars`` around the scalars' staging, ``.capture`` around a capture
    and ``.replay`` around each step (``utils/profiling.py::annotate``)."""

    def __init__(self, body: Callable, optimizer):
        self.body = body
        self.optimizer = optimizer
        self.key: tuple | None = None
        self.graph = None
        self.captures = 0
        # static: the state a call returns, and the inputs copied into before each replay
        self.params = self.mu = self.nu = None
        self.scalars = self.batch = self.masks = self.out = None
        self.launches: dict = {}
        self._state: list = []   # the static params and moments, leaf by leaf

    def __call__(self, params, opt_state, stacks, masks=None):
        with annotate("lrpic.step_graph.call"):
            K, dev = stacks[0].shape[0], stacks[0].device
            count, lr = opt_state["count"], opt_state["learning_rate"]
            with annotate("lrpic.step_graph.scalars"):
                # every step's scalars in one copy to the card; the pinned
                # buffer is kept until the copy has run
                rows = torch.stack([torch.stack(self.optimizer.step_scalars(count + k + 1, lr))
                                    for k in range(K)])
                scalars = (rows.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda"
                           else rows)
            key = (tuple((tuple(x.shape[1:]), x.dtype, x.device) for x in stacks),
                   None if masks is None else tuple((tuple(t.shape), t.dtype)
                                                    for t in tree_leaves(masks[0])),
                   tuple((tuple(p.shape), p.dtype, p.device) for p in tree_leaves(params)))
            if key != self.key:
                self.release()   # the old graph's pool first
                with annotate("lrpic.step_graph.capture"):
                    self._capture(params, opt_state, [x[0] for x in stacks],
                                  None if masks is None else masks[0], scalars[0])
                self.key = key
            _adopt(self.params, params)
            _adopt(self.mu, opt_state["mu"])
            _adopt(self.nu, opt_state["nu"])
            metrics = torch.empty((2, K), device=dev)
            for k in range(K):
                with annotate("lrpic.step_graph.replay"):
                    for s, x in zip(self.batch, stacks):
                        s.copy_(x[k])
                    if masks is not None:
                        for s, m in zip(tree_leaves(self.masks), tree_leaves(masks[k])):
                            s.copy_(m)
                    self.scalars.copy_(scalars[k])
                    if self.graph is None:   # the CPU
                        metrics[:, k].copy_(self._run())
                        continue
                    self.graph.replay()
                    metrics[:, k].copy_(self.out)
                    for wrapper, n in self.launches.items():
                        wrapper.launches += n
            return self.params, {"count": count + K, "mu": self.mu, "nu": self.nu,
                                 "learning_rate": lr}, {"loss": metrics[0], "accuracy": metrics[1]}

    def _capture(self, params, opt_state, batch, masks, scalars) -> None:
        def static(t):
            return t.detach().clone(memory_format=torch.contiguous_format)

        self.params, self.mu, self.nu = (tree_map(static, t) for t in (
            params, opt_state["mu"], opt_state["nu"]))
        self.scalars, self.batch = static(scalars), [static(x) for x in batch]
        self.masks = None if masks is None else _rebuild(masks, static)
        self._state = [*tree_leaves(self.params), *tree_leaves(self.mu), *tree_leaves(self.nu)]
        dev = self.batch[0].device
        if dev.type != "cuda":
            return
        launches = {}

        def run():   # records the launches of its last call: the captured one
            before = {k: k.launches for k in kernels.KERNELS}
            out = self._run()
            launches.update((k, k.launches - before[k]) for k in kernels.KERNELS)
            return out

        self.graph, self.out = capture(run, dev)
        for wrapper, n in launches.items():
            wrapper.launches -= n   # the capture launched nothing
        self.launches = launches
        self.captures += 1
        _captured.add(self)

    def _run(self) -> torch.Tensor:
        """One step of the body on the static tensors, the new params and
        moments copied back into them; -> (loss, accuracy)."""
        p, mu, nu, m = self.body(self.params, self.mu, self.nu, self.scalars, *self.batch,
                                 self.masks)
        for dst, src in zip(self._state, [*tree_leaves(p), *tree_leaves(mu), *tree_leaves(nu)]):
            dst.copy_(src)
        return torch.stack([m["loss"].float(), m["accuracy"].float()])

    def release(self) -> None:
        """Drop the graph, its memory pool and the static tensors."""
        self.key = self.graph = None
        self.params = self.mu = self.nu = None
        self._state = []
        self.scalars = self.batch = self.masks = self.out = None


# every StepGraph that holds a graph: ``release_step_graphs`` drops them all
_captured: weakref.WeakSet = weakref.WeakSet()


def release_step_graphs() -> None:
    """Release every ``StepGraph``'s graph (``StepGraph.release``). A graph
    that captured a NCCL collective holds its communicator, and NCCL
    destroys a communicator only once every such graph is gone: call this
    before ``torch.distributed.destroy_process_group``. It runs at exit too,
    before the process group's own teardown."""
    for graph in list(_captured):
        graph.release()
    _captured.clear()


atexit.register(release_step_graphs)
