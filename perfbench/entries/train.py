"""The training entries: the K-step call of the train step
(``make_multi_train_step``; over a NCCL group of one card a process,
``make_sharded_multi_train_step``) or of the LRP-inference fine-tune step
(``make_multi_lrp_finetune_step``), each step replayed from its captured
graph. Batches come from a pool made from the seed, used in turn; every
step's dropout masks are drawn by the benchmark and handed in. The calls
are issued back to back, as a training loop issues them: the host waits
for a call only once the next one is queued behind it, and reads no
result inside the window. Each call's end is a CUDA event; the rate is
the global images of the calls that ended inside the window over the time
from its start to the end of the last of them.

Correct: set-up drives the call through its first 1 + K steps (a call of
one step, then one of K, as the window makes them, on 1 + K different
batches); the reference (``reference.steps``, float32, TF32 off) follows
them from the same weights, batches and masks. Compared: each step's loss
(relative gap), the first clipped gradient by leaf (from Adam's first
moment after one step) and the parameters' change after the 1 + K steps
by leaf, each as the largest gap between the two sides' norms of a leaf
over the reference's norm of that leaf or of the median leaf, whichever is
larger."""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time

import numpy as np
import torch

from perfbench.harness import inputs
from perfbench.reference import steps as ref
from perfbench.reference.model import draw_masks, leaves, mask_rows

TRACED_FROM_S, TRACED_S = 1.0, 2.0    # the traced run profiles calls from 1 s in, for about 2 s


def program_masks(model: str, m: dict):
    """The benchmark's masks as the program's ``DropoutMasks`` tuple."""
    if model == "adaptiveattention":
        from lrp_imagecaptioning_torch.models.adaptive import DropoutMasks as cls
    else:
        from lrp_imagecaptioning_torch.models.gridtd import GridTDDropoutMasks as cls
    return cls(m["v_feat"], m["global_feat"], m["out"], m["logit"], m["lstm"])


def leaf_norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves(tree)}


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's |got - want| / max(want, median of want)."""
    names = [k for k in want if keep is None or k in keep]
    med = float(np.median([want[k] for k in names]))
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in names}


def worst_leaf_gap(got: dict, want: dict, keep=None) -> float:
    return max(leaf_gaps(got, want, keep).values())


class CallClock:
    """The end of each call of the window, in seconds from its start: on the
    card a CUDA event recorded behind the call (read once the window has
    closed), on the CPU the host's clock (the calls run there as issued)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []
        self.t0 = time.perf_counter()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter() - self.t0)

    def wait(self, i: int):
        """Block the host until call ``i`` has ended (nothing for i < 0)."""
        if self.cuda and i >= 0:
            self.marks[i].synchronize()

    def ends(self) -> list:
        if not self.cuda:
            return list(self.marks)
        torch.cuda.synchronize()
        return [self.start.elapsed_time(e) / 1e3 for e in self.marks]


class Entry:
    def __init__(self, cell, seed: int, device, group=None):
        from lrp_imagecaptioning_torch.config import FlickrConfig
        from lrp_imagecaptioning_torch.models.captioner import build_captioner
        from lrp_imagecaptioning_torch.runtime import resolve_device
        from lrp_imagecaptioning_torch.train.optimizer import Adam

        tr, s, conf = cell.traffic, cell.sizes, cell.config
        # the program's device policy, as its entry points apply it (TF32 off)
        device = resolve_device(device)
        self.cell, self.s, self.seed, self.dev, self.group = cell, s, seed, device, group
        self.kind = tr["step"]                        # "train" | "finetune"
        self.K, self.B = tr["steps_per_call"], tr["batch"]
        self.width = conf["model_config"]["sentence_length"] + 1
        self.rank, self.world = (0, 1) if group is None else group
        cfg = FlickrConfig(**conf["model_config"])
        self.captioner = build_captioner(s.model, cfg, s.V)
        adam = dict(conf["adam"], learning_rate=tr["learning_rate"])
        self.adam = adam
        self.opt = Adam(adam["learning_rate"], b1=adam["b1"], b2=adam["b2"], eps=adam["eps"],
                        clipvalue=adam["clipvalue"])
        self.params0 = inputs.make_params(s, seed, device)
        self.stop = torch.zeros(s.V + 1, dtype=torch.bool)
        self.stop[inputs.FIRST_WORD:inputs.FIRST_WORD + tr.get("stop_words", 0)] = True
        self.multi = self._build()
        # the pool of batches, global rows; this process keeps its own
        gen = inputs.generator(seed, 1, device)
        n = tr["pool_batches"]
        self.check_steps = 1 + self.K
        if n < self.check_steps:
            raise ValueError(f"a pool of {n} batches cannot give the check's "
                             f"{self.check_steps} steps rows that all differ")
        toks, _ = inputs.captions(n * self.B, tr["lengths"], s.V, self.width, gen)
        self.images = inputs.images(n * self.B, s.image, gen).reshape(n, self.B, s.image,
                                                                       s.image, 3)
        cap_in, y = inputs.training_batch(toks, self.width, s.V, device)
        self.cap_in = cap_in.reshape(n, self.B, self.width)
        self.y = y.reshape(n, self.B, self.width, s.V)
        self.mask_gen = inputs.generator(seed, 2, device)
        self.check_masks = [self._masks() for _ in range(self.check_steps)]
        state = self.opt.init(self.params0)
        if group is not None:
            params, state = self.place(self.params0, state)
        else:
            params = self.params0
        # the first steps, through the window's call: one step, then K
        params, state, m1 = self.call(params, state, [0], self.check_masks[:1])
        mu = {k: v / (1.0 - adam["b1"]) for k, v in leaves(state["mu"])}
        self.g1 = {k: float(torch.linalg.vector_norm(v.double())) for k, v in mu.items()}
        params, state, m2 = self.call(params, state, list(range(1, self.check_steps)),
                                      self.check_masks[1:])
        p0 = dict(leaves(self.params0))
        self.delta = {k: float(torch.linalg.vector_norm((v - p0[k]).double()))
                      for k, v in leaves(params)}
        self.losses = [float(x) for x in torch.cat([m1["loss"], m2["loss"]]).cpu()]
        self.params, self.state = params, state
        # one more call of K steps, timed: the traced run's profile starts
        # about 1 s into the window and holds about 2 s of calls
        self.next = self.check_steps % n
        t = time.perf_counter()
        self._window_call()
        self._sync()
        call_s = time.perf_counter() - t
        first = self._agree(math.ceil(TRACED_FROM_S / call_s))
        self.trace_calls = (first, first + self._agree(max(1, round(TRACED_S / call_s))))
        self.traced_calls = 0

    def _build(self):
        tr = self.cell.traffic
        if self.kind == "finetune":
            from lrp_imagecaptioning_torch.train.lrp_finetune import make_multi_lrp_finetune_step

            return make_multi_lrp_finetune_step(self.captioner, self.opt, self.stop.numpy(),
                                                inputs.SOS, inputs.EOS, tr["mode"])
        if self.group is None:
            from lrp_imagecaptioning_torch.train.step import make_multi_train_step

            return make_multi_train_step(self.captioner, self.opt)
        from lrp_imagecaptioning_torch.parallel.distributed import make_multihost_mesh
        from lrp_imagecaptioning_torch.train.step import make_sharded_multi_train_step

        self.mesh = make_multihost_mesh(devices=None if self.dev.type == "cuda" else [self.dev])
        multi, self.place = make_sharded_multi_train_step(self.captioner, self.opt, self.mesh)
        return multi

    def _masks(self) -> dict:
        return draw_masks(self.s, self.B, self.cell.config["model_config"]["drop_rate"],
                          self.mask_gen, self.dev)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def call(self, params, state, batches: list, masks: list):
        """One K-step call over the pool's ``batches`` (K = len(batches))."""
        idx = torch.as_tensor(batches, device=self.dev)
        stacks = [x.index_select(0, idx) for x in (self.images, self.cap_in, self.y)]
        pm = [program_masks(self.s.model, m) for m in masks]
        if self.group is not None:
            from lrp_imagecaptioning_torch.parallel.distributed import (
                global_stacked_batch_from_local, process_batch_slice)

            rows = process_batch_slice(self.B, self.rank, self.world)
            stacks = [global_stacked_batch_from_local(self.mesh, x[:, rows].contiguous(), self.B)
                      for x in stacks]
        return self.multi(params, state, *stacks, None, masks=pm)

    def _window_call(self):
        n = self.images.shape[0]
        batches = [(self.next + k) % n for k in range(self.K)]
        self.next = (self.next + self.K) % n
        self.params, self.state, m = self.call(self.params, self.state, batches,
                                               [self._masks() for _ in range(self.K)])
        return m

    def _agree(self, value: int) -> int:
        """Rank 0's ``value`` on every rank of the group (set-up only: it
        waits for the card); alone, ``value``."""
        if self.group is None:
            return value
        import torch.distributed as dist

        t = torch.tensor([value], device=self.dev)
        dist.broadcast(t, src=0)
        return int(t.item())

    def _stop(self, clock: CallClock, deadline: float) -> bool:
        """Whether to stop after the call just issued. The host waits only
        for the call before it, so the one just issued keeps the card busy
        meanwhile. In a group rank 0's clock decides, one call late: its word
        is broadcast behind the call just issued and read once the next is
        queued, so that every rank makes the same calls."""
        late = time.perf_counter() >= deadline
        if self.group is None:
            clock.wait(len(clock.marks) - 2)
            return late
        import torch.distributed as dist

        word = torch.tensor([int(late)], device=self.dev)
        dist.broadcast(word, src=0)
        said, self._word = self._word, word
        return said is not None and bool(said.item())

    def window(self, seconds: float, tracer) -> dict:
        """K-step calls until ``seconds`` have gone on the host's clock;
        counted are the calls whose end lies inside the window. The traced
        run profiles the calls that set-up's timing placed from about 1 s
        to about 3 s in, whole: the profiler started before the window,
        its recording once the call before them has ended."""
        first, stop = self.trace_calls if tracer.enabled else (-1, -1)
        bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self._word = None
        with tracer.armed(), contextlib.ExitStack() as profiled:
            clock = CallClock(self.dev)
            deadline = clock.t0 + seconds
            i = 0
            while True:
                if i == first:
                    # the stretch holds whole calls: it opens once the call
                    # before has ended, so the work it counts is all in it
                    clock.wait(i - 1)
                    tracer.record()
                    profiled.enter_context(tracer.window(self._sync))
                m = self._window_call()
                bad += (~torch.isfinite(m["loss"])).sum()
                clock.mark()
                tracing = first <= i < stop
                self.traced_calls += tracing
                if i + 1 == stop:
                    profiled.close()
                i += 1
                # every rank asks each call (the word is a collective); the
                # traced calls run to their end whatever the clock says
                if self._stop(clock, deadline) and not tracing:
                    break
        ends = clock.ends()
        inside = [e for e in ends if e <= seconds]
        return {"attempted": len(ends) * self.K, "failed": int(bad),
                "rate": len(inside) * self.K * self.B / inside[-1] if inside else 0.0,
                "call_ends_s": [round(e, 4) for e in ends]}

    def traced(self) -> dict:
        """What ran in the traced calls, for the readers (global rows)."""
        return {"kind": self.kind, "steps": self.K * self.traced_calls, "batch": self.B,
                "width": self.width, "counters": {}}

    def release(self):
        from lrp_imagecaptioning_torch.graphs import release_step_graphs

        release_step_graphs()
        self.params = self.state = self.multi = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """What the program read in its first steps, for the check."""
        return {"losses": self.losses, "g1": self.g1, "delta": self.delta}

    def reference(self, tf32: bool = False, rows: slice = slice(None)) -> dict:
        """The reference's first 1 + K steps; ``tf32=True`` is the control
        (TF32 on), ``rows`` a batch cut to those rows, the loss their mean
        (the fault of a step that leaves rows out)."""
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        a = self.adam
        opt = ref.Adam(a["learning_rate"], a["b1"], a["b2"], a["eps"], a["clipvalue"])
        p, st = self.params0, opt.init(self.params0)
        losses = []
        g1 = None
        stop = self.stop.to(self.dev)
        for k in range(self.check_steps):
            x, c, y = self.images[k][rows], self.cap_in[k][rows], self.y[k][rows]
            m = mask_rows(self.check_masks[k], rows)
            if self.kind == "finetune":
                p, st, loss, g = ref.finetune_step(p, st, opt, x, c, y, m, self.s, stop,
                                                   inputs.SOS, inputs.EOS)
            else:
                p, st, loss, g = ref.train_step(p, st, opt, x, c, y, m, self.s)
            losses.append(float(loss))
            if g1 is None:
                g1 = leaf_norms(g)
        p0 = dict(leaves(self.params0))
        delta = {k: float(torch.linalg.vector_norm((v - p0[k]).double())) for k, v in leaves(p)}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return {"losses": losses, "g1": g1, "delta": delta}


def compare(got: dict, want: dict) -> dict:
    """The three numbers of a training cell: the worst step's relative loss
    gap, the first gradient's and the 1 + K steps' change's worst leaf
    gaps. Leaves whose reference gradient is under a thousandth of the
    median leaf's (nought to rounding) are left out of the change."""
    loss = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got["losses"], want["losses"]))
    med = float(np.median(list(want["g1"].values())))
    moving = {k for k, v in want["g1"].items() if v >= 1e-3 * med}
    return {"loss": loss, "first_gradient": worst_leaf_gap(got["g1"], want["g1"]),
            "change": worst_leaf_gap(got["delta"], want["delta"], moving)}


def check(entry, readings: list) -> dict:
    """The numbers of every rank's first steps against one reference run:
    each the worst over the ranks."""
    want = entry.reference()
    print(f"perfbench: step losses, reference {want['losses']}, each rank "
          f"{[r['losses'] for r in readings]}", file=sys.stderr)
    per_rank = [compare(r, want) for r in readings]
    return {k: max(p[k] for p in per_rank) for k in per_rank[0]}
