"""The explain entry: ``Explainer.analyze_many`` over passes of the mix's
image pools, each image with a given caption of natural length, every
word's heatmap delivered to the host. The rate is images over the time
from the window's start to the end of its last completed pass.

Correct: a sample of the window's explanations, drawn from the seed, one
row from every chunk of every pool (so from every bucket the passes
dispatch), the longest caption among them, against
``reference.steps.explain`` (float32, TF32 off): each field's largest
distance over the sample, relative to the reference's norm, under its
limit."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.harness import inputs
from perfbench.reference import steps as ref

FIELDS = ("relevance_maps", "feat_relevance", "word_relevances", "attentions", "betas")


class CaptionWords:
    """The caption preprocessor's surface the Explainer reads: ids 1..V,
    SOS 1 and EOS 2, the rest words."""

    SOS_TOKEN, EOS_TOKEN = "szeros", "zeros"
    SOS_TOKEN_LABEL_ENCODED, EOS_TOKEN_LABEL_ENCODED = inputs.SOS, inputs.EOS

    def __init__(self, vocab: int):
        self.vocab_size = vocab
        self.word_of = {i: f"w{i}" for i in range(1, vocab + 1)}
        self.word_of[inputs.SOS], self.word_of[inputs.EOS] = self.SOS_TOKEN, self.EOS_TOKEN


def chunks(lengths, batch: int) -> list:
    """analyze_many's chunks: the rows sorted by caption length (stable), in
    runs of ``batch`` -> [row indices]."""
    order = np.argsort(np.asarray(lengths), kind="stable")
    return [order[i:i + batch] for i in range(0, len(order), batch)]


def bucket_plan(lengths, batch: int, buckets, T: int) -> list:
    """analyze_many's dispatches: each chunk on the smallest bucket that
    holds its longest caption (else T) -> [(rows, bucket)]."""
    lengths = np.asarray(lengths)
    plan = []
    for rows in chunks(lengths, batch):
        longest = int(lengths[rows].max())
        plan.append((len(rows), next((w for w in sorted(buckets) if longest <= w), T)))
    return plan


def sample_rows(pools_lengths, batch: int, per_chunk: int, seed: int) -> list:
    """The rows checked after the window, per pool: ``per_chunk`` drawn from
    the seed in every chunk of the pass, and pool 0's longest caption."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 99])
    out = []
    for p, lengths in enumerate(pools_lengths):
        rows = set()
        for chunk in chunks(lengths, batch):
            rows.update(int(r) for r in rng.choice(chunk, size=min(per_chunk, len(chunk)),
                                                   replace=False))
        if p == 0:
            rows.add(int(np.argmax(lengths)))
        out.append(sorted(rows))
    return out


class Entry:
    def __init__(self, cell, seed: int, device):
        from lrp_imagecaptioning_torch.config import FlickrConfig
        from lrp_imagecaptioning_torch.explain.engine import Explainer
        from lrp_imagecaptioning_torch.models.captioner import build_captioner

        tr, s = cell.traffic, cell.sizes
        self.cell, self.s, self.seed, self.dev = cell, s, seed, device
        self.T = cell.config["model_config"]["sentence_length"]
        self.B, self.n = tr["batch_size"], tr["images_per_pass"]
        cfg = FlickrConfig(**cell.config["model_config"])
        captioner = build_captioner(s.model, cfg, s.V)
        self.params = inputs.make_params(s, seed, device)
        dtype = {"bfloat16": torch.bfloat16, "float32": None}[tr["storage_dtype"]]
        self.ex = Explainer(captioner, self.params, CaptionWords(s.V), method="lrp",
                            beam_size=cell.config["beam_size"], max_len=self.T,
                            storage_dtype=dtype, word_buckets=tuple(tr["word_buckets"]),
                            batch_size=self.B, device=device)
        self.pools = []
        for p in range(tr["pools"]):
            gen = inputs.generator(seed, 10 + p, device)
            imgs = inputs.images(self.n, s.image, gen)
            toks, lengths = inputs.captions(self.n, tr["lengths"], s.V, self.T, gen)
            self.pools.append((imgs, toks, lengths))
        self.sample = sample_rows([lengths for _, _, lengths in self.pools], self.B,
                                  tr["checked_per_chunk"], seed)
        self.kept = {}
        self.plan = bucket_plan(self.pools[0][2], self.B, tr["word_buckets"], self.T)
        # warm-up: every bucket's graphs, then one whole pass
        self.ex.warmup(self.pools[0][0][:self.B])
        self._pass(0)
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def captures(self) -> int:
        return sum(g.captures for g in self.ex.graph_caches)

    def _pass(self, p: int) -> list:
        imgs, toks, _ = self.pools[p]
        return self.ex.analyze_many(imgs, toks, batch_size=self.B)

    def window(self, seconds: float, tracer) -> dict:
        """Passes over the pools in turn until ``seconds`` have gone; the
        traced run profiles its second pass."""
        before = self.captures()
        with tracer.armed():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            done = attempted = passes = 0
            t_last, ends = t0, []
            while time.perf_counter() < deadline:
                p = passes % len(self.pools)
                if passes == 1:
                    tracer.record()
                    with tracer.window(self._sync):
                        out = self._pass(p)
                else:
                    out = self._pass(p)
                now = time.perf_counter()
                ends.append(round(now - t0, 4))
                attempted += self.n
                passes += 1
                if now <= deadline:
                    done += self.n
                    t_last = now
                    self.kept[p] = {r: {f: np.array(getattr(out[r], f)) for f in FIELDS}
                                    for r in self.sample[p]}
                del out
        self.captures_in_window = self.captures() - before
        return {"attempted": attempted, "rate": done / (t_last - t0) if done else 0.0,
                "call_ends_s": ends}

    def traced(self) -> dict:
        """What ran in the traced pass, for the readers: its rows' caption
        lengths (every pool has the same) and its buckets."""
        return {"kind": "explain", "T": self.T, "plan": self.plan,
                "lengths": [int(n) for n in self.pools[0][2]],
                "counters": {"graph_captures": self.captures_in_window}}

    def release(self):
        """Frees the program's state; keeps what the check reads."""
        self.checked = []
        for p, rows in self.kept.items():
            imgs, toks, lengths = self.pools[p]
            for r in rows:
                self.checked.append((imgs[r:r + 1].clone(), toks[r], int(lengths[r]),
                                     self.kept[p][r]))
        self.ex = self.pools = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, store=None, dec_dtype=None) -> dict:
        """Each field's largest relative distance over the checked sample;
        ``store`` / ``dec_dtype`` put a lower-precision reference in the
        program's place (the control)."""
        worst = dict.fromkeys(FIELDS, 0.0)
        if not self.checked:
            return {f: float("inf") for f in FIELDS}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            for img, toks, n, got in self.checked:
                tok = torch.as_tensor(toks[None], device=self.dev)
                want = ref.explain(self.params, img, tok, n, self.s, inputs.SOS)
                if store is not None or dec_dtype is not None:
                    got = dict(zip(FIELDS, (o[0].cpu().numpy() for o in ref.explain(
                        self.params, img, tok, n, self.s, inputs.SOS, store, dec_dtype))))
                for f, w in zip(FIELDS, want):
                    w = w[0].double().cpu().numpy()
                    g = np.asarray(got[f], np.float64)[:n]
                    d = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
                    worst[f] = max(worst[f], float(d))
        return worst


def check(entry, readings) -> dict:
    return entry.check()
