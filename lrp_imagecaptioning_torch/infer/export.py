"""Deployable serving artifacts via ``torch.export``: the port of the JAX
package's ``infer/export.py``.

``export_serving`` traces the batched beam decode (encode + beam search) and,
for an explanation method, the Explainer's per-bucket batch body
(``Explainer._explain_batch_impl``: encode, cached forward and decoder
backward, CNN side) at one fixed batch, and writes them with the params and
the tokenizer surface. An artifact directory holds::

    decode.pt2            (params, images (B,H,W,3)) -> (tokens (B,T), scores (B,))
    explain_w{W}.pt2      (params, images, tokens (B,T)) -> (maps, r_feat,
                          r_words, attentions, betas), one per word bucket and T
    params.npz            the params (train/checkpoint.py's layout)
    meta.json             vocab id -> word, SOS/EOS ids, shapes, buckets: the
                          JAX artifact's keys

The programs take the params as inputs, so no weight is baked into them. The
hand-written kernels appear in them as ``torch.library`` custom ops
(``ops/kernels.py``); loading needs torch, numpy and ``ops/kernels.py``,
which registers the ops, and no model, explain, config or tokenizer module
of the port. A program runs on the device it was exported on (its
placeholders' device; the CPU for the tests). On the card
``ExportedCaptioner`` replays each program from a CUDA graph, captured by
``ExportedService``'s warm-up, so no request captures.

``ExportedCaptioner(devices=N | list)`` serves data-parallel from the same
one-device artifact: one params replica a device, the programs moved to
each device once (``torch.export.passes.move_to_device_pass``; nothing is
traced again), each slot with its own graphs, since calls on one graph must
not overlap. Request chunks are dealt to the slots in turn, and every
chunk's work is issued before the first is copied to the host.

The traced bodies are the eager stages (no graph replay inside a trace) and
contain no host sync: the bucket choice, ``.cpu()`` and the assembly of the
explanations stay in ``ExportedCaptioner``. Only the relevance methods
(``lrp``, ``deep_taylor``, ``deep_lift``) export: the gradient methods run
autograd, which a traced program does not carry.
"""

from __future__ import annotations

import json
import os
import threading
import time
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..graphs import GraphCache, param_tensors
from ..ops import kernels  # noqa: F401  (registers the lrpic:: custom ops)
from ..runtime import resolve_device
from ..weights import load_params_npz, save_params_npz, tree_to
from .beam import beam_search, n_explained

_DECODE = "decode.pt2"
_META = "meta.json"
_PARAMS = "params.npz"
EXPORTABLE_METHODS = ("lrp", "deep_taylor", "deep_lift")


def _explain_file(w: int) -> str:
    return f"explain_w{w}.pt2"


class _Decode(torch.nn.Module):
    """(params, images) -> (tokens, scores): encode, then the beam search."""

    def __init__(self, captioner, sos: int, eos: int, beam_size: int, max_len: int):
        super().__init__()
        self.captioner, self.sos, self.eos = captioner, sos, eos
        self.beam_size, self.max_len = beam_size, max_len

    def forward(self, params, images):
        feat_grid = self.captioner.encode(params, images)
        return beam_search(self.captioner, params, feat_grid, self.sos, self.eos,
                           self.beam_size, self.max_len)


class _ExplainBucket(torch.nn.Module):
    """(params, images, tokens) -> the explain outputs of all B rows on W words."""

    def __init__(self, explainer, n_words: int):
        super().__init__()
        self.explainer, self.n_words = explainer, n_words

    def forward(self, params, images, tokens):
        return self.explainer._explain_batch_impl(params, images, tokens, self.n_words)


def export_serving(captioner, params, caption_pp, out_dir: str, *, batch_size: int = 8,
                   beam_size: int = 3, max_len: int | None = None, method: str | None = None,
                   word_buckets=(4, 8, 12, 16), device="cuda") -> str:
    """Write a self-contained serving artifact directory, its programs traced
    on ``device`` (default "cuda"). ``method``: also export the bucketed
    explain programs for this method, one per word bucket plus the full
    length, as ``Explainer.warmup`` captures them. The export time and the
    programs' sizes go to ``meta.json``'s sibling ``export.json``."""
    from ..explain.engine import Explainer

    if method is not None and method not in EXPORTABLE_METHODS:
        raise NotImplementedError(f"method {method!r}: only {EXPORTABLE_METHODS} export (the "
                                  "gradient methods run autograd, which a traced program "
                                  "does not carry)")
    dev = resolve_device(device)
    T = max_len or captioner.cfg.sentence_length
    sos = caption_pp.SOS_TOKEN_LABEL_ENCODED
    eos = caption_pp.EOS_TOKEN_LABEL_ENCODED
    size = getattr(captioner.cfg, "image_size", None) or (224, 224)
    if captioner.cfg.img_encoder == "inception_v3" and tuple(size) == (224, 224):
        size = (299, 299)

    os.makedirs(out_dir, exist_ok=True)
    # the Explainer carries the params to the device; the decode shares them
    ex = Explainer(captioner, params, caption_pp, method=method or "lrp", beam_size=beam_size,
                   max_len=T, word_buckets=word_buckets, batch_size=batch_size, device=dev)
    params = ex.params
    images = torch.zeros((batch_size, size[0], size[1], 3), dtype=torch.float32, device=dev)
    tokens = torch.zeros((batch_size, T), dtype=torch.long, device=dev)
    report = {"seconds": {}, "bytes": {}}

    def write(name, module, args):
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(module, args, strict=False)
        program.example_inputs = None   # else the archive carries the params
        path = os.path.join(out_dir, name)
        torch.export.save(program, path)
        report["seconds"][name] = time.perf_counter() - t0
        report["bytes"][name] = os.path.getsize(path)

    write(_DECODE, _Decode(captioner, sos, eos, beam_size, T), (params, images))
    buckets = []
    if method is not None:
        buckets = sorted({*ex._buckets, T})
        for w in buckets:
            write(_explain_file(w), _ExplainBucket(ex, w), (params, images, tokens))

    save_params_npz(os.path.join(out_dir, _PARAMS), params)
    meta = {
        "batch_size": batch_size,
        "beam_size": beam_size,
        "max_len": T,
        "image_size": list(size),
        "sos": int(sos),
        "eos": int(eos),
        "eos_word": caption_pp.EOS_TOKEN,
        "method": method,
        "buckets": [int(w) for w in buckets],
        "word_of": {str(i): w for i, w in caption_pp.word_of.items()},
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(out_dir, "export.json"), "w") as f:
        json.dump(report, f)
    return out_dir


def _program_device(program) -> torch.device:
    """The device an exported program was traced on: its user inputs'."""
    user = set(program.graph_signature.user_inputs)
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name in user:
            return node.meta["val"].device
    raise ValueError("exported program has no tensor input")


def _on_device(program, device: torch.device):
    """``program`` running on ``device``: itself where it was exported there,
    else a copy moved by ``move_to_device_pass``."""
    if _program_device(program) == device:
        return program
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, device)


def _serving_devices(devices, device: torch.device) -> list[torch.device]:
    """``ExportedCaptioner``'s slots: None -> ``device``; an int N -> the first
    N cards; a list (``["cpu"] * N`` for N CPU slots) as it is."""
    if devices is None:
        return [device]
    if isinstance(devices, int):
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if devices > avail:
            raise ValueError(f"devices={devices} but only {avail} available")
        return [torch.device("cuda", i) for i in range(devices)]
    return [resolve_device(d) for d in devices]


class _ServingSlot(NamedTuple):
    device: torch.device
    params: dict
    graphs: GraphCache | None
    decode: object
    explain: dict          # bucket -> program runner


class ExportedCaptioner:
    """Serve from an ``export_serving`` artifact, no model code needed.

    ``caption(images)`` / ``explain(images)`` mirror ``CaptionService``:
    requests are chunked and padded (the last row repeated) to the exported
    batch. ``device`` (default "cuda") must be the artifact's device type.
    ``devices`` (N, or a list of devices that may repeat one) serves over
    several slots (the module's docstring). On the card each program
    replays from a CUDA graph (captured at its first call), so calls must
    not overlap: ``ExportedService`` serializes them."""

    def __init__(self, out_dir: str, devices=None, device="cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(out_dir, _META)) as f:
            self.meta = json.load(f)
        self._word_of = {int(i): w for i, w in self.meta["word_of"].items()}
        self._B = self.meta["batch_size"]
        slot_devices = _serving_devices(devices, self.device)
        params = load_params_npz(os.path.join(out_dir, _PARAMS), slot_devices[0])
        programs = {None: torch.export.load(os.path.join(out_dir, _DECODE))}
        for w in self.meta["buckets"]:
            programs[w] = torch.export.load(os.path.join(out_dir, _explain_file(w)))
        for w, program in programs.items():
            got = _program_device(program)
            if got.type != self.device.type:
                raise ValueError(f"{out_dir}: exported on {got}, cannot run on {self.device}")
        by_device = {}   # device -> (params, modules)
        self._slots = []
        for d in slot_devices:
            if d not in by_device:
                by_device[d] = (tree_to(params, d),
                                {w: _on_device(p, d).module() for w, p in programs.items()})
            replica, modules = by_device[d]
            graphs = GraphCache() if d.type == "cuda" else None

            def stage(module, graphs=graphs):
                fn = lambda params, *inputs: module(params, *inputs)   # noqa: E731
                return fn if graphs is None else graphs.stage(fn, param_tensors)

            self._slots.append(_ServingSlot(d, replica, graphs, stage(modules[None]),
                                            {w: stage(m) for w, m in modules.items()
                                             if w is not None}))
        self.params = self._slots[0].params
        self.graphs = self._slots[0].graphs

    @property
    def devices(self) -> list[torch.device]:
        return [s.device for s in self._slots]

    @property
    def graph_caches(self) -> list:
        return [s.graphs for s in self._slots if s.graphs is not None]

    def _pad(self, chunk, device) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(chunk, np.float32)).to(device)
        n = x.shape[0]
        return x if n == self._B else torch.cat([x] + [x[-1:]] * (self._B - n))

    def _n_explained(self, row) -> int:
        return n_explained(row, self.meta["eos"])

    def _tokens_to_string(self, row) -> str:
        # CaptionService semantics: words only, no EOS word appended (the
        # explain() captions carry it, as Explainer.analyze* does)
        return " ".join(self._word_of[int(tok)] for tok in row[:self._n_explained(row)])

    def _chunks(self, images):
        """The request's chunks of the exported batch, each with the slot it
        is dealt to (in turn)."""
        images = np.asarray(images, np.float32)
        return [(images[i:i + self._B], self._slots[k % len(self._slots)])
                for k, i in enumerate(range(0, images.shape[0], self._B))]

    @torch.no_grad()
    def caption(self, images) -> list[str]:
        launched = [(len(chunk), slot.decode(slot.params, self._pad(chunk, slot.device))[0])
                    for chunk, slot in self._chunks(images)]
        return [self._tokens_to_string(r) for n, tokens in launched
                for r in tokens[:n].cpu().numpy()]

    @torch.no_grad()
    def explain(self, images) -> list[dict]:
        """-> one dict an image: caption, words, tokens_1based, relevance_maps,
        feat_relevance, attentions, word_relevances, betas (the Explanation
        fields). A chunk runs on the bucket of its longest caption, as
        ``analyze_batch`` does. Every chunk's decode is issued first, then
        each chunk's explain as its tokens arrive, then the outputs are
        copied to the host."""
        if not self._slots[0].explain:
            raise RuntimeError("artifact was exported without explain programs"
                               " (pass method= to export_serving)")
        decoded = []
        for chunk, slot in self._chunks(images):
            x = self._pad(chunk, slot.device)
            decoded.append((chunk, slot, x, slot.decode(slot.params, x)[0]))
        launched = []
        for chunk, slot, x, tokens in decoded:
            toks = tokens.cpu().numpy()[:len(chunk)]
            n_max = max((self._n_explained(row) for row in toks), default=0)
            bucket = min((w for w in slot.explain if w >= max(n_max, 1)),
                         default=self.meta["max_len"])
            toks_pad = torch.as_tensor(toks, device=slot.device)
            toks_pad = torch.cat([toks_pad] + [toks_pad[-1:]] * (self._B - len(chunk)))
            launched.append((toks, slot.explain[bucket](slot.params, x, toks_pad)))
        out = []
        for toks, outs in launched:
            maps, r_feat, r_words, atts, betas = (o.float().cpu().numpy() for o in outs)
            for b in range(len(toks)):
                n = self._n_explained(toks[b])
                words = [self._word_of[int(tok)] for tok in toks[b][:n]]
                out.append({
                    "caption": " ".join(words + [self.meta["eos_word"]]),
                    "words": words,
                    "tokens_1based": toks[b],
                    "relevance_maps": maps[b][:n],
                    "feat_relevance": r_feat[b][:n],
                    "attentions": atts[b][:n],
                    "word_relevances": r_words[b][:n],
                    "betas": betas[b][:n],
                })
        return out


class ExportedService:
    """``CaptionService``-compatible facade over an export directory, so the
    HTTP / gRPC front-ends (``dispatch``, ``stats``, ``expected_hw``) serve
    from an artifact with no model, config or tokenizer code in the process
    (``cli serve --exported DIR``). Device work runs under one lock."""

    def __init__(self, out_dir: str, warmup: bool = True, devices=None, device="cuda"):
        self._ec = ExportedCaptioner(out_dir, devices=devices, device=device)
        self.meta = self._ec.meta
        self._device_lock = threading.Lock()
        self.stats = {"requests": 0, "images": 0, "latency_ema_s": 0.0,
                      "exported_artifact": os.path.abspath(out_dir),
                      "devices": len(self._ec.devices)}
        if warmup:
            self.warmup()

    @torch.no_grad()
    def warmup(self):
        """Call every program once on every slot, not only the bucket a dummy
        request lands in: on the card each captures its graph then."""
        size, B = self.meta["image_size"], self.meta["batch_size"]
        t0 = time.perf_counter()
        with self._device_lock:
            for slot in self._ec._slots:
                x = torch.zeros((B, size[0], size[1], 3), device=slot.device)
                toks = torch.zeros((B, self.meta["max_len"]), dtype=torch.long,
                                   device=slot.device)
                slot.decode(slot.params, x)
                for run in slot.explain.values():
                    run(slot.params, x, toks)
            for d in set(self._ec.devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        self.stats["warmup_s"] = round(time.perf_counter() - t0, 3)
        return self

    @property
    def expected_hw(self) -> tuple:
        """(H, W) the exported programs were traced at."""
        return tuple(self.meta["image_size"])

    def graph_stats(self) -> dict:
        """Captures and pool bytes of the programs' graphs (zeros on the CPU)."""
        caches = self._ec.graph_caches
        return {"captures": sum(g.captures for g in caches),
                "pool_bytes": sum(g.pool_bytes() for g in caches)}

    def dispatch(self, images, explain: bool = False, method: str | None = None):
        """``method=None`` serves the artifact's own method; an explicit
        other method is an error."""
        t0 = time.perf_counter()
        if explain:
            exported = self.meta.get("method")
            if exported and method and method != exported:
                raise ValueError(f"artifact was exported with method {exported!r}; "
                                 f"cannot serve {method!r}")
        with self._device_lock:
            if explain:
                out = [SimpleNamespace(**e) for e in self._ec.explain(images)]
            else:
                out = self._ec.caption(images)
            dt = time.perf_counter() - t0
            self.stats["requests"] += 1
            self.stats["images"] += int(np.asarray(images).shape[0])
            self.stats["last_latency_s"] = dt
            ema = self.stats.get("latency_ema_s") or None
            self.stats["latency_ema_s"] = dt if ema is None else 0.9 * ema + 0.1 * dt
        return out
