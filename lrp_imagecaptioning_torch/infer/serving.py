"""Batched caption / explanation serving: the port of the JAX package's
``infer/serving.py``.

A service object pads incoming requests to one batch size, keeps the params
on the device, and answers ``caption`` (strings) and ``explain``
(``Explanation`` objects) requests, directly or through a micro-batching
queue that coalesces concurrent single-image requests into one dispatch.

On the card the beam search and the Explainer's decoder stage replay from
CUDA graphs (``graphs.GraphCache``), which read static input buffers and
write static outputs that the next replay overwrites, and keep no lock of
their own. The front-ends serve each request on a thread of its own, so the
service runs all device work under one lock (``_device_lock``), and every
result is on the host before the lock is released. ``warmup`` captures every
graph a request can replay: after it no request captures or grows a pool
(``graph_stats``).

``mesh=`` (``parallel.make_mesh``): each request batch splits over the
mesh's data slots, each with its params replica and its own graphs (the
batch must divide by the data size), and explain requests go through an
Explainer on the same mesh. ``shard_words=True`` (needs the mesh) explains
a one-image request with its word positions split over the slots
(``Explainer(shard_words=True)``): the latency mode.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..graphs import GraphCache, param_tensors
from ..runtime import resolve_device
from ..weights import tree_leaves, tree_to
from .beam import beam_search, n_explained
from .greedy import greedy_decode


def _writable(images):
    """A request's images as torch can wrap them: an array that a client's
    buffer backs read-only (gRPC's ``np.frombuffer``) is copied."""
    if isinstance(images, np.ndarray) and not images.flags.writeable:
        return images.copy()
    return images


class CaptionService:
    """Pad-and-dispatch caption + per-word heatmap serving.

    Endpoints: ``caption(images)`` (strings), ``explain(images)``
    (Explanation objects with LRP/gradient heatmaps), and a micro-batching
    queue (``start_queue()`` + ``submit(image)`` -> Future) that coalesces
    concurrent single-image requests into one device dispatch. ``device``
    (default "cuda") is where the params lie and every request runs; only an
    explicit "cpu" runs the kernels' plain versions."""

    def __init__(self, captioner, params, caption_pp, batch_size: int = 8,
                 beam_size: int = 3, max_len: int | None = None,
                 compute_dtype=None, storage_dtype=None, mesh=None,
                 shard_words: bool = False, split_buckets: bool = False, device="cuda"):
        """``split_buckets``: explain requests dispatch per caption-length
        bucket at halving-ladder sub-batch sizes instead of one padded batch
        at the longest caption's bucket (``Explainer.analyze_many``'s
        latency mode). ``storage_dtype=torch.bfloat16``: the Explainer's CNN
        LRP in bf16 storage (K4). ``mesh``, ``shard_words``: the module's
        docstring."""
        if shard_words and mesh is None:
            raise ValueError("shard_words=True requires a mesh")
        if mesh is not None and batch_size % len(mesh.slots):
            raise ValueError(f"batch_size {batch_size} not divisible by the mesh data-axis "
                             f"size {len(mesh.slots)}")
        devices = [resolve_device(device)] if mesh is None else [resolve_device(d)
                                                                 for d in mesh.slots]
        self.device = devices[0]
        self.captioner = captioner
        self._mesh = mesh
        self._shard_words = bool(shard_words)
        self._split_buckets = bool(split_buckets)
        self._pp = caption_pp
        self._B = batch_size
        self._beam = beam_size
        self._T = max_len or captioner.cfg.sentence_length
        self._dtype = compute_dtype
        self._storage_dtype = storage_dtype
        self.stats = {"requests": 0, "images": 0}
        # one (device, params, graphs, decode stage) a data slot: on the card
        # the beam (or greedy) search replays from the slot's graphs
        replicas, self._slots = {}, []
        for d in devices:
            graphs = GraphCache() if d.type == "cuda" else None
            stage = (self._decode_impl if graphs is None else graphs.stage(
                self._decode_impl, lambda p: param_tensors(p["decoder"])))
            self._slots.append((d, replicas.setdefault(d, tree_to(params, d)), graphs, stage))
        self.params, self.graphs = self._slots[0][1], self._slots[0][2]
        self._device_lock = threading.RLock()   # every device call and host copy
        self._explainers = {}          # method -> Explainer (kept warm)
        self._explainer_lock = threading.Lock()
        self._queue = None
        self._queue_thread = None
        self._queue_lock = threading.Lock()  # guards queue start/stop/submit

    @property
    def expected_hw(self) -> tuple:
        """(H, W) input resolution the service is warmed for: the config's
        ``image_size`` when set, else the encoder's canonical input: 299 for
        inception_v3, else the grid-implied size stride x g (VGG taps are
        stride 16, ResNet's conv5 tap stride 32: both 224 at their standard
        grids). Front-ends validate request shapes against this."""
        cfg = self.captioner.cfg
        size = getattr(cfg, "image_size", None)
        if size:
            return tuple(size)
        if cfg.img_encoder == "inception_v3":
            return (299, 299)
        g = int(round(float(np.sqrt(cfg.img_feature_length))))
        stride = 32 if cfg.img_encoder.startswith("resnet") else 16
        return (stride * g, stride * g)

    def _decode_impl(self, params, feat_grid):
        sos, eos = self._pp.SOS_TOKEN_LABEL_ENCODED, self._pp.EOS_TOKEN_LABEL_ENCODED
        if self._beam > 1:
            return beam_search(self.captioner, params, feat_grid, sos, eos, self._beam,
                               self._T)[0]
        return greedy_decode(self.captioner, params, feat_grid, sos, eos, self._T)[0]

    def _images(self, images) -> torch.Tensor:
        """Images as a contiguous tensor on the device, in the params' dtype."""
        dtype = tree_leaves(self.params["vgg"])[0].dtype
        return torch.as_tensor(_writable(images)).to(self.device, dtype).contiguous()

    def _decode(self, images) -> np.ndarray:
        """(n <= B, H, W, 3) -> (n, T) tokens on the host, at batch B (zero
        padded) split over the slots. Callers hold the device lock."""
        n = images.shape[0]
        batch = self._images(images)
        if n < self._B:
            batch = torch.cat([batch, batch.new_zeros((self._B - n, *batch.shape[1:]))])
        per = self._B // len(self._slots)
        tokens = []
        for i, (dev, params, _, stage) in enumerate(self._slots):
            feat_grid = self.captioner.encode(params, batch[i * per:(i + 1) * per].to(dev),
                                              compute_dtype=self._dtype)
            tokens.append(stage(params, feat_grid))
        return torch.cat([t.cpu() for t in tokens])[:n].numpy()

    @torch.no_grad()
    def warmup(self, explain: bool = False, method: str = "lrp"):
        """Capture the decode graph at the service batch; with
        ``explain=True`` also build the Explainer and capture every graph its
        requests replay: the beam search and each word bucket's decoder stage
        at every size of the batch's halving ladder (a short request or chunk
        dispatches at one of them, with or without ``split_buckets``)."""
        h, w = self.expected_hw
        dummy = np.zeros((self._B, h, w, 3), np.float32)
        with self._device_lock:
            self._decode(dummy)
            if explain:
                self._get_explainer(method).warmup(dummy, sub_batches=True)
        return self

    def graph_stats(self) -> dict:
        """Captures and pool bytes of the service's graphs and its
        Explainers' (zeros on the CPU)."""
        caches = [g for _, _, g, _ in self._slots if g is not None]
        caches += [c for e in self._explainers.values() for c in e.graph_caches]
        return {"captures": sum(c.captures for c in caches),
                "pool_bytes": sum(c.pool_bytes() for c in caches)}

    def _get_explainer(self, method: str = "lrp"):
        # one Explainer PER METHOD, built under a lock: a single shared slot
        # would race under the threaded front-ends and drop every captured
        # graph on each method switch
        with self._explainer_lock:
            ex = self._explainers.get(method)
            if ex is None:
                from ..explain.engine import Explainer

                ex = Explainer(self.captioner, self.params, self._pp, method=method,
                               beam_size=self._beam, max_len=self._T,
                               storage_dtype=self._storage_dtype, batch_size=self._B,
                               mesh=self._mesh, shard_words=self._shard_words,
                               device=self.device)
                self._explainers[method] = ex
            return ex

    @torch.no_grad()
    def caption(self, images) -> list[str]:
        """images: (N, H, W, 3) preprocessed, any N (chunked / zero padded to
        the service batch)."""
        n = images.shape[0]
        if n > self._B:
            out = []
            for i in range(0, n, self._B):
                out += self.caption(images[i:i + self._B])
            return out
        t0 = time.perf_counter()
        with self._device_lock:
            tokens = self._decode(images)
            self._note_request(n, t0)
        return [self._tokens_to_string(row) for row in tokens]

    def _note_request(self, n_images: int, t0: float):
        dt = time.perf_counter() - t0
        self.stats["requests"] += 1
        self.stats["images"] += n_images
        self.stats["last_latency_s"] = dt
        ema = self.stats.get("latency_ema_s")
        self.stats["latency_ema_s"] = dt if ema is None else 0.9 * ema + 0.1 * dt

    def explain(self, images, method: str = "lrp") -> list:
        """Caption + per-word heatmap explanation endpoint: (N, H, W, 3)
        preprocessed images, any N -> N ``Explanation`` objects with host
        arrays, through ``Explainer.analyze_many`` at the service batch
        (length-sorted chunks, each padded to a size of its halving ladder)."""
        n = images.shape[0]
        t0 = time.perf_counter()
        ex = self._get_explainer(method)
        with self._device_lock:
            if self._shard_words and n == 1:
                # latency mode: the one image's words split over the mesh
                result = [ex.analyze(_writable(images)[0])]
            else:
                result = ex.analyze_many(_writable(images), batch_size=self._B,
                                         split_buckets=self._split_buckets)
            self._note_request(n, t0)
        return result

    def dispatch(self, images, explain: bool = False, method: str | None = None) -> list:
        """Serve a request through the micro-batching queue when it is
        running, else directly: the front-ends' (HTTP/gRPC) single entry
        point. ``method=None`` means the default analyzer (``lrp``).

        Enqueueing is atomic (``submit_many``): a concurrent ``stop_queue()``
        takes the whole request (its drain serves it) or none of it
        (RuntimeError -> direct dispatch). Execution errors from
        ``Future.result()`` propagate to the caller."""
        method = method or "lrp"
        try:
            futs = self.submit_many(images, explain=explain, method=method)
        except RuntimeError:  # queue not running (or stopped concurrently)
            futs = None
        if futs is not None:
            return [f.result() for f in futs]
        if explain:
            return self.explain(images, method=method)
        return self.caption(images)

    # -- micro-batching queue ----------------------------------------------

    def start_queue(self, linger_ms: float = 5.0):
        """Start the background micro-batcher for ``submit()``: it takes the
        first queued request, lingers up to ``linger_ms`` collecting more (up
        to the batch size), then dispatches them together."""
        with self._queue_lock:
            if self._queue is not None:
                return self
            self._queue = queue.Queue()
            self._queue_linger = linger_ms / 1000.0
            self._queue_stop = threading.Event()
            self._queue_thread = threading.Thread(
                target=self._queue_loop, args=(self._queue, self._queue_stop), daemon=True)
            self._queue_thread.start()
        return self

    def stop_queue(self):
        """Stop the micro-batcher; pending requests are still served. The
        queue reference is nulled under the submit lock before the worker is
        joined, so nothing can be enqueued onto a queue nobody watches."""
        with self._queue_lock:
            if self._queue is None:
                return
            q, thread, stop = self._queue, self._queue_thread, self._queue_stop
            self._queue = None
            self._queue_thread = None
        stop.set()
        q.put(None)  # wake the loop
        thread.join()

    def submit(self, image, explain: bool = False, method: str = "lrp") -> Future:
        """Enqueue one (H, W, 3) image -> a Future of its caption string, or
        of its ``Explanation`` with ``explain=True``. Requires ``start_queue()``."""
        return self.submit_many(np.asarray(image)[None], explain=explain, method=method)[0]

    def submit_many(self, images, explain: bool = False, method: str = "lrp") -> list[Future]:
        """Enqueue N (H, W, 3) images atomically -> N Futures; RuntimeError,
        with nothing enqueued, when the queue is not running."""
        with self._queue_lock:
            if self._queue is None:
                raise RuntimeError("call start_queue() before submit()")
            futs = []
            for image in images:
                fut: Future = Future()
                self._queue.put((np.asarray(image), explain, method, fut))
                futs.append(fut)
            return futs

    def _queue_loop(self, q, stop):
        # `q` / `stop` are pinned at thread start: stop_queue() nulls
        # self._queue before joining, and the drain must keep reading THIS queue
        while not stop.is_set():
            item = q.get()
            if item is None:
                continue
            batch = [item]
            deadline = time.perf_counter() + self._queue_linger
            while len(batch) < self._B:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    continue
                batch.append(nxt)
            self._dispatch_queue_batch(batch)
        # drain: serve whatever arrived between stop() and join()
        leftovers = []
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                leftovers.append(item)
        if leftovers:
            self._dispatch_queue_batch(leftovers)

    def _dispatch_queue_batch(self, batch):
        # split by endpoint, method and image shape: captions batch together,
        # explanations per analyzer method, and differing resolutions cannot
        # be stacked. Keys never raise (a client-supplied unhashable method
        # would kill the batcher thread and strand every pending future), so
        # the method is stringified. Caption groups dispatch first: they are
        # cheap, and an explain group would hold them for seconds.
        groups = {}
        for b in batch:
            key = ((1, str(b[2])) if b[1] else (0, None)) + (np.shape(b[0]),)
            groups.setdefault(key, []).append(b)
        for (want_explain, method, _), group in sorted(groups.items(), key=lambda kv: kv[0]):
            try:
                images = np.stack([g[0] for g in group])
                results = (self.explain(images, method=method) if want_explain
                           else self.caption(images))
                if len(results) != len(group):
                    raise RuntimeError(f"dispatch returned {len(results)} results for "
                                       f"{len(group)} requests")
                for (_, _, _, fut), res in zip(group, results):
                    fut.set_result(res)
            except Exception as e:  # noqa: BLE001 — propagate to callers, keep the thread
                for _, _, _, fut in group:
                    if not fut.done():
                        fut.set_exception(e)

    def _tokens_to_string(self, row) -> str:
        n = n_explained(row, self._pp.EOS_TOKEN_LABEL_ENCODED)
        return " ".join(self._pp.word_of[int(tok)] for tok in row[:n])
