"""The Explainer: caption images and explain every word, batched.

The port of the JAX package's ``explain/engine.py`` for every encoder
(VGG16/19, ResNet-50/101, InceptionV3) and decoder (adaptive attention,
grid-TD, AOA). One explain call over B images and a word bucket W runs
three stages:

1. encode: the CNN forward (cuDNN) of the B images;
2. decoder: the cached forward over the captions and the decoder backward
   of W word positions an image (``positions = arange(W)``), batched over
   the B x W rows: the LRP recursion (``explain/decoder_lrp.py``, on K1 and,
   in the cached forward, K2) for ``lrp``, the reference's BPTT gradient
   (``explain/decoder_grad.py``) for the gradient family; then the word
   relevances' post-processing (SOS column zeroed, max-|.| normalised) and
   the sentinel gates;
3. CNN: per image, the word-batched PresetA LRP (``explain/cnn_lrp.py``: K3
   in f32, K4/K5 in bf16 storage), DeepTaylor (the same walk on a ReLU'd
   seed, K3), DeepLIFT (``explain/cnn_deeplift.py``, two forwards and
   cuDNN's transposed convs) or the gradient method
   (``explain/cnn_gradient.py``, autograd on cuDNN).

Positions past a caption's end are computed and dropped when the
``Explanation`` is assembled, as in the JAX bucket programs. On the card
the beam search and stage 2 replay from CUDA graphs, one per (stage, input
shapes) in one private pool (``graphs.GraphCache``). So that their set is
fixed whatever the requests' sizes, every dispatch carries at most
``batch_size`` rows and is padded (its last row repeated) to a size of that
batch's halving ladder; the padded rows go through the beam search and the
decoder stage and are dropped, and the CNN side runs on the real rows only.
``warmup`` captures the graphs up front.

The JAX package encodes and runs the cached forward at batch 1 per image;
here they run at batch B (the same function, summed in another order).

``mesh=`` (``parallel.make_mesh``): the batched calls split each dispatch's
rows over the mesh's data slots, each slot with its params replica and its
own graphs on its device (the JAX package's ``shard_map`` over images);
dispatch sizes are multiples of the data size. A slot holding only padded
rows is skipped. Every slot's work is issued, from the caller's thread,
before any output is copied to the host, so that no slot's launches wait
for another's copy. ``analyze`` and
``predict_caption`` (one image) run on the first slot, unless
``shard_words=True``: then each slot encodes the image and runs the cached
forward again, and explains its own slice of the word positions (the bucket
rounded up to a multiple of the data size; surplus positions clamp to the
last step and are dropped); the slices are stitched on the word axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..graphs import GraphCache, param_tensors
from ..infer.beam import beam_search, n_explained as _n_explained
from ..models.vgg import vgg_apply
from ..runtime import resolve_device
from ..weights import tree_leaves, tree_to
from . import cnn_gradient, inception_lrp, resnet_lrp
from .aoa_backward import explain_word_aoa, grad_word_aoa
from .cnn_deeplift import vgg_deeplift
from .cnn_lrp import vgg_deep_taylor, vgg_lrp_per_image
from .decoder_grad import grad_word_adaptive, grad_word_gridtd
from .decoder_lrp import explain_word_adaptive, explain_word_gridtd

METHODS = ("lrp", "gradient", "input_times_gradient", "guided_gradcam",
           "integrated_gradients", "smoothgrad", "guided_backprop", "deconvnet",
           "deep_taylor", "deep_lift")

# the decoder side of these runs the LRP recursion; every other method
# shares the reference-semantics BPTT gradient
_RELEVANCE_METHODS = ("lrp", "deep_taylor", "deep_lift")


@dataclass
class Explanation:
    """Everything the drivers / eval need for one image (host numpy arrays)."""

    caption: str                 # decoded caption incl. trailing EOS word
    words: list                  # caption words WITHOUT the EOS sentinel
    tokens_1based: np.ndarray    # (T,) beam-search output tokens (0 padded)
    relevance_maps: np.ndarray   # (W, H, W, 3) input-space heatmaps
    feat_relevance: np.ndarray   # (W, L, D) CNN feature-grid relevance
    attentions: np.ndarray       # (W, L) attention at each explained word
    word_relevances: np.ndarray  # (W, T) linguistic relevances, normalized
    betas: np.ndarray            # (W,) sentinel gate at each explained word


def _pad_rows(x, k: int):
    """``x`` (a tensor or an array) with its last row repeated up to k rows."""
    if x.shape[0] == k:
        return x
    cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
    return cat([x] + [x[-1:]] * (k - x.shape[0]))


_BACKWARDS = {"adaptiveattention": (explain_word_adaptive, grad_word_adaptive),
              "gridTD": (explain_word_gridtd, grad_word_gridtd),
              "aoa": (explain_word_aoa, grad_word_aoa)}
_RESNET_WALKS = {"lrp": resnet_lrp.resnet_lrp_wordbatched,
                 "deep_taylor": resnet_lrp.resnet_deep_taylor_wordbatched,
                 "deep_lift": resnet_lrp.resnet_deeplift_wordbatched}
_INCEPTION_WALKS = {"lrp": inception_lrp.inception_lrp_wordbatched,
                    "deep_taylor": inception_lrp.inception_deep_taylor_wordbatched,
                    "deep_lift": inception_lrp.inception_deeplift_wordbatched}
def _to_host(outs, axis: int = 0) -> list:
    """Each slot's explain outputs on the host, each array joined over the
    slots on ``axis`` (one slot's as it is: no copy)."""
    parts = zip(*([o.float().cpu().numpy() for o in out] for out in outs))
    return [p[0] if len(p) == 1 else np.concatenate(p, axis=axis) for p in parts]


@dataclass
class _Slot:
    """One data slot of an Explainer: its device, its params replica and its
    beam-search and decoder stages (replayed from its own graphs on a card)."""

    device: torch.device
    params: dict
    graphs: GraphCache | None
    decode: object
    decoder: object


def _decoder_backward_fn(model_type: str, method: str):
    """The decoder side of ``method``: the LRP recursion for the relevance
    methods, the reference's BPTT gradient (AOA: the true gradient) for
    every gradient method."""
    relevance, gradient = _BACKWARDS[model_type]
    return relevance if method in _RELEVANCE_METHODS else gradient


class Explainer:
    """Word-by-word explanation of a captioning model.

    Images must already be VGG-preprocessed (``data/images.py``); relevance
    maps come back in input space. ``device`` (default "cuda") is where the
    params are moved and every stage runs; only an explicit "cpu" runs the
    kernels' plain versions."""

    def __init__(self, captioner, params, caption_pp, method: str = "lrp", beam_size: int = 3,
                 max_len: int | None = None, storage_dtype=None, word_buckets=(4, 8, 12, 16),
                 batch_size: int = 32, mesh=None, shard_words: bool = False, device="cuda"):
        """``storage_dtype=torch.bfloat16`` holds the CNN LRP's params,
        activations and relevances in bf16 (bench's throughput mode; method
        ``lrp`` on VGG only: the other methods' and encoders' CNN side runs
        in f32, as in the JAX package). ``word_buckets``: the word counts an
        explain call may take; a caption's real length picks the smallest
        bucket that covers it (``()``: always all ``max_len`` positions). ``batch_size``: the
        most rows one dispatch carries (``analyze_many``'s default chunk);
        every dispatch is padded to a size of its halving ladder."""
        if method not in METHODS:
            raise ValueError(f"method {method!r} not in {METHODS}")
        if shard_words and mesh is None:
            raise ValueError("shard_words=True requires a mesh")
        n_data = 1 if mesh is None else len(mesh.slots)
        if batch_size % n_data:
            raise ValueError(f"batch_size {batch_size} not divisible by the mesh data-axis "
                             f"size {n_data}")
        devices = [resolve_device(device)] if mesh is None else [resolve_device(d)
                                                                 for d in mesh.slots]
        self.device = devices[0]
        self.captioner = captioner
        self._mesh = mesh
        self._shard_words = bool(shard_words)
        self._pp = caption_pp
        self.method = method
        self._beam_size = beam_size
        self._max_len = max_len or captioner.cfg.sentence_length
        # the augmentation-based analyzers (wrapper.py semantics); SmoothGrad's
        # noise is in input units: 16.0 ~= 6% of the caffe inputs' ~255 range,
        # 0.125 the same share of Inception's [-1, 1]
        self._ig_steps = 16
        self._sg_samples = 8
        self._sg_noise = 0.125 if captioner.cfg.img_encoder == "inception_v3" else 16.0
        self._storage_dtype = storage_dtype
        self._buckets = tuple(sorted(w for w in set(word_buckets) if w < self._max_len))
        self.batch_size = batch_size
        self._backward = _decoder_backward_fn(captioner.model_type, method)
        self._noise: dict = {}
        replicas = {}
        self._slots = [self._make_slot(d, replicas.setdefault(d, tree_to(params, d)))
                       for d in devices]

    def _make_slot(self, device, params) -> _Slot:
        # on the card the beam search and the decoder stage replay from graphs
        graphs = GraphCache() if device.type == "cuda" else None

        def graphed(fn):
            if graphs is None:
                return fn
            return graphs.stage(fn, lambda p: param_tensors(p["decoder"]))

        # AOA's decoder gradient runs autograd, which stays out of a capture
        eager = self.captioner.model_type == "aoa" and self.method not in _RELEVANCE_METHODS
        return _Slot(device, params, graphs, graphed(self._decode_impl),
                     self._decoder_impl if eager else graphed(self._decoder_impl))

    # the first slot's (the only one without a mesh)
    @property
    def params(self):
        return self._slots[0].params

    @property
    def graphs(self):
        return self._slots[0].graphs

    @property
    def graph_caches(self) -> list:
        """Every slot's ``GraphCache`` (none on the CPU)."""
        return [s.graphs for s in self._slots if s.graphs is not None]

    def _bucket_for(self, n_words: int) -> int:
        for w in self._buckets:
            if n_words <= w:
                return w
        return self._max_len

    # -- stages --------------------------------------------------------------

    def _decode_impl(self, params, feat_grid):
        tokens, _ = beam_search(self.captioner, params, feat_grid,
                                self._pp.SOS_TOKEN_LABEL_ENCODED, self._pp.EOS_TOKEN_LABEL_ENCODED,
                                self._beam_size, self._max_len)
        return tokens

    def _decoder_impl(self, params, feat_grid, tokens, positions):
        """Cached forward, then the decoder backward of each image's
        ``positions`` (B, W) -> (r_feat (B, W, L, D), r_words (B, W, T),
        attentions (B, W, L), betas (B, W))."""
        consts, caches = self.captioner.cached_forward(params, feat_grid, tokens,
                                                       self._pp.SOS_TOKEN_LABEL_ENCODED)
        words0 = torch.clamp(tokens - 1, min=0).gather(1, positions)
        r_feat, r_words, atts = self._backward(params["decoder"], consts, caches, words0, positions)
        # linguistic relevance: SOS slot zeroed, then max-|.| normalisation
        # (explainers.py:660-665); the full T is kept for alignment
        r_words = torch.cat([torch.zeros_like(r_words[:, :, :1]), r_words[:, :, 1:]], dim=-1)
        r_words = r_words / (r_words.abs().amax(dim=-1, keepdim=True) + 1e-12)
        if hasattr(caches, "beta"):
            rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
            betas = caches.beta[positions, rows, 0]                  # (B, W) sentinel gate
        else:   # AOA has no visual sentinel
            betas = torch.zeros(positions.shape, device=r_feat.device, dtype=r_feat.dtype)
        return r_feat, r_words, atts, betas

    def _encode(self, images, params=None):
        return self.captioner.encode(self.params if params is None else params, images)

    def _cnn(self, images, feat_grid, r_feat, params=None):
        """The CNN side of the method: (B, W, L, D) seeds -> (B, W, H, W, 3);
        ``params`` default the Explainer's (the gradient methods read those)."""
        cfg = self.captioner.cfg
        enc, until = cfg.img_encoder, cfg.layer_name
        vgg = (self.params if params is None else params)["vgg"]
        if self.method == "lrp" and enc in ("vgg16", "vgg19"):
            return vgg_lrp_per_image(vgg, images, r_feat, until, self._storage_dtype, enc)
        B, W, L, D = r_feat.shape
        g = math.isqrt(L)
        seeds = r_feat.reshape(B, W, g, g, D)
        maps = []
        for b in range(B):
            image, s = images[b:b + 1], seeds[b]
            if self.method not in _RELEVANCE_METHODS:
                maps.append(self._gradient(image, s, feat_grid[b].reshape(g, g, D), params))
            elif enc in ("vgg16", "vgg19"):
                walk = vgg_deep_taylor if self.method == "deep_taylor" else vgg_deeplift
                maps.append(walk(vgg, image, s, until, arch=enc))
            elif enc.startswith("resnet"):
                maps.append(_RESNET_WALKS[self.method](vgg, image, s, depth=enc))
            else:
                maps.append(_INCEPTION_WALKS[self.method](vgg, image, s, until=until))
        return torch.stack(maps)

    def _gradient(self, image, seeds, feat_hw, params=None):
        """The gradient methods' CNN side on any encoder: image (1, H, W, 3),
        seeds (W, g, g, D) -> (W, H, W, 3). VGG's SmoothGrad draws noise per
        word position, the other encoders' one set per image (as the JAX
        package draws them)."""
        cfg, params = self.captioner.cfg, self.params if params is None else params
        if cfg.img_encoder in ("vgg16", "vgg19"):
            # f32 whatever cfg.compute_dtype, as the reference's VGG functions
            def encode(x, relu_fn):
                return vgg_apply(params["vgg"], x, cfg.layer_name, relu_fn=relu_fn,
                                 arch=cfg.img_encoder)

            noise = (self._smoothgrad_noise_on(seeds.shape[0], image)
                     if self.method == "smoothgrad" else None)
        else:
            def encode(x, relu_fn):
                return self.captioner.encode(params, x, relu_fn=relu_fn)

            noise = self._generic_noise_on(image)[None] if self.method == "smoothgrad" else None
        return cnn_gradient.gradient_maps(self.method, encode, image, seeds, feat_hw,
                                          self._ig_steps, noise, self._sg_noise)

    def generic_smoothgrad_noise(self, image_shape) -> torch.Tensor:
        """The generic (ResNet, Inception) SmoothGrad's standard-normal noise,
        (samples, *image_shape) on the CPU, one set per image shared by its
        words (as the JAX package draws it, from one key): a CPU generator
        seeded 0, so its bits are not ``jax.random``'s."""
        gen = torch.Generator().manual_seed(0)
        return torch.randn((self._sg_samples, *image_shape), generator=gen)

    def _generic_noise_on(self, image):
        key = ("generic", tuple(image.shape[1:]), image.dtype, image.device)
        if key not in self._noise:
            self._noise[key] = self.generic_smoothgrad_noise(tuple(image.shape[1:])).to(
                image.device, image.dtype)
        return self._noise[key]

    def smoothgrad_noise(self, n_words: int, image_shape) -> torch.Tensor:
        """SmoothGrad's standard-normal noise, (n_words, samples, *image_shape)
        on the CPU. Word position p draws from its own generator (seed p), so
        a position's noise does not depend on the bucket or the batch (as the
        JAX package keys it per position)."""
        out = []
        for p in range(n_words):
            gen = torch.Generator().manual_seed(p)
            out.append(torch.randn((self._sg_samples, *image_shape), generator=gen))
        return torch.stack(out)

    def _smoothgrad_noise_on(self, n_words, image):
        key = (n_words, tuple(image.shape[1:]), image.dtype, image.device)
        if key not in self._noise:
            self._noise[key] = self.smoothgrad_noise(n_words, image.shape[1:]).to(
                image.device, image.dtype)
        return self._noise[key]

    def _explain_batch_impl(self, params, images, toks, W: int, n: int | None = None,
                            decoder_stage=None, positions=None):
        """images (B, H, W, 3) and tokens (B, T) on ``params``' device, W
        positions an image -> (maps, r_feat, r_words, attentions, betas) of
        the first ``n`` rows (default all B); the rows past ``n`` are
        padding, which the CNN side skips. ``positions`` (B, W) replaces the
        first W positions (the word-sharded slices). The decoder stage is by
        default the eager one: the body ``infer/export.py`` traces per bucket
        (no graph replay, no host sync)."""
        n = images.shape[0] if n is None else n
        feat_grid = self.captioner.encode(params, images)
        if positions is None:
            positions = torch.arange(W, device=images.device).expand(images.shape[0],
                                                                     W).contiguous()
        outs = (decoder_stage or self._decoder_impl)(params, feat_grid, toks, positions)
        r_feat, r_words, atts, betas = (o[:n] for o in outs)
        return self._cnn(images[:n], feat_grid[:n], r_feat, params), r_feat, r_words, atts, betas

    def _slots_for(self, size: int) -> list:
        """The slots a dispatch of ``size`` rows splits over: every slot when
        the size divides over them, else (one image) the first."""
        return self._slots if size % len(self._slots) == 0 else self._slots[:1]

    def _explain_rows(self, images, toks_np, size: int, W: int) -> list:
        """The Explanations of the k rows of ``images`` (device) and
        ``toks_np`` (host) on bucket W, from one explain call padded to
        ``size`` rows and split over the slots; each slot's outputs are
        copied to the host once, after every slot's work is issued."""
        k = images.shape[0]
        images, toks_pad = _pad_rows(images, size), _pad_rows(toks_np, size)
        slots = self._slots_for(size)
        per = size // len(slots)
        outs = []
        for i, slot in enumerate(slots):
            real = min(k - i * per, per)
            if real <= 0:   # padding only
                break
            rows = slice(i * per, (i + 1) * per)
            toks = torch.as_tensor(toks_pad[rows], dtype=torch.long, device=slot.device)
            outs.append(self._explain_batch_impl(slot.params, images[rows].to(slot.device), toks,
                                                 W, real, slot.decoder))
        host = _to_host(outs)
        return [self._assemble(toks_np, host, b) for b in range(k)]

    def _explain_words_sharded(self, image, toks_np, W: int):
        """One image's explanation with its word positions split over the
        slots (``shard_words``): bucket ``W`` rounded up to a multiple of the
        data size, each slot's slice of positions (clamped to the last step)
        explained on its device, the outputs stitched on the word axis."""
        slots = self._slots
        per = -(-W // len(slots))
        T = self._max_len
        outs = []
        for i, slot in enumerate(slots):
            positions = torch.arange(i * per, (i + 1) * per, device=slot.device).clamp(
                max=T - 1)[None]
            toks = torch.as_tensor(toks_np, dtype=torch.long, device=slot.device)
            outs.append(self._explain_batch_impl(slot.params, image.to(slot.device), toks, W, 1,
                                                 slot.decoder, positions))
        return self._assemble(toks_np, _to_host(outs, axis=1), 0)

    # -- host side -------------------------------------------------------------

    def _as_images(self, images) -> torch.Tensor:
        """Images as a contiguous tensor on the device, in the params' dtype."""
        dtype = tree_leaves(self.params["vgg"])[0].dtype
        return torch.as_tensor(images).to(self.device, dtype).contiguous()

    def _decode(self, images, B: int | None = None) -> np.ndarray:
        """Beam search over device images -> (n, T) int32 tokens, in the
        dispatches of ``_chunks`` at batch B (default ``batch_size``), each
        split over the slots (one image: the first)."""
        toks = []
        for i, j, size in self._chunks(images.shape[0], B or self.batch_size):
            chunk = _pad_rows(images[i:j], size)
            slots = self._slots_for(size)
            per = size // len(slots)
            parts = [slot.decode(slot.params,
                                 self._encode(chunk[s * per:(s + 1) * per].to(slot.device),
                                              slot.params)).to(self.device)
                     for s, slot in enumerate(slots) if s * per < j - i]
            toks.append(torch.cat(parts)[:j - i])
        return torch.cat(toks).cpu().numpy().astype(np.int32)

    def _assemble(self, toks_np, outs, b) -> Explanation:
        """Build one Explanation from row ``b`` of a batched explain output
        (host arrays). The kept positions, those before the first EOS/pad,
        are a prefix: each field is a view of the batch's array, with no host
        copy of the kept rows."""
        maps, r_feat, r_words, atts, betas = outs
        n = _n_explained(toks_np[b], self._pp.EOS_TOKEN_LABEL_ENCODED)
        words = [self._pp.word_of[int(tok)] for tok in toks_np[b][:n]]
        return Explanation(
            caption=" ".join(words + [self._pp.EOS_TOKEN]),
            words=words,
            tokens_1based=toks_np[b],
            relevance_maps=maps[b][:n],
            feat_relevance=r_feat[b][:n],
            attentions=atts[b][:n],
            word_relevances=r_words[b][:n],
            betas=betas[b][:n],
        )

    def _coerce_tokens(self, tokens_1based) -> np.ndarray:
        """Caller-supplied token rows padded with 0 to T (the post-EOS
        padding value); longer rows are rejected."""
        toks = np.asarray(tokens_1based)
        n = toks.shape[-1]
        T = self._max_len
        if n > T:
            raise ValueError(f"tokens_1based has {n} positions but max_len is {T}")
        if n < T:
            toks = np.pad(toks, [(0, 0)] * (toks.ndim - 1) + [(0, T - n)])
        return toks.astype(np.int32)

    def _sub_batch_ladder(self, B: int) -> tuple:
        """Descending halving ladder of dispatch sizes <= B: B, ceil(B/2), ...,
        1, each rounded up to a multiple of the mesh's data size."""
        n_data = len(self._slots)
        sizes, s = [], B
        while s >= 1:
            sizes.append(-(-s // n_data) * n_data)
            if s == 1:
                break
            s = -(-s // 2)
        return tuple(dict.fromkeys(sizes))

    def _chunks(self, n: int, B: int):
        """(start, stop, size) of the dispatches that carry n rows at batch B:
        chunks of B rows, a short last one padded up to the smallest size of
        B's halving ladder that holds it; one image alone on a mesh takes one
        row, on the first slot."""
        if n == 1 and B == 1:
            yield 0, 1, 1
            return
        ladder = self._sub_batch_ladder(B)
        for i in range(0, n, B):
            j = min(i + B, n)
            yield i, j, min(s for s in ladder if s >= j - i)

    def _cover_with_ladder(self, k: int, ladder: tuple) -> list:
        """Split a group of ``k`` items into dispatch sizes from ``ladder``
        (descending): the largest that fits, greedily, and the remainder padded
        up to the smallest size: k=7, ladder (8,4,2,1) -> [4, 2, 1]."""
        sizes = []
        while k > 0:
            fit = next((s for s in ladder if s <= k), None)
            if fit is None:
                sizes.append(ladder[-1])
                break
            sizes.append(fit)
            k -= fit
        return sizes

    # -- public API ------------------------------------------------------------

    @torch.no_grad()
    def warmup(self, images, sub_batches: bool = False):
        """Capture every graph a request can replay: the beam search and the
        decoder stage (every bucket) at ``batch_size`` rows (``images`` cut
        to it, or padded by repeating the last), and with ``sub_batches=True``
        at every size of its halving ladder, which ``analyze`` (one row), a
        short batch or chunk and ``analyze_many(split_buckets=True)``
        dispatch; on a mesh each slot at its share of those rows, and with
        ``shard_words`` the first slot's one-image decode and each slot's
        word slice of every bucket. Then run one whole explain call so that
        the eager stages' first calls are paid too."""
        B = self.batch_size
        images = _pad_rows(self._as_images(images)[:B], B)
        buckets = (*self._buckets, self._max_len)
        first = {}
        for size in (self._sub_batch_ladder(B) if sub_batches else (B,)):
            slots = self._slots_for(size)
            per = size // len(slots)
            for i, slot in enumerate(slots):
                feat = self._encode(images[i * per:(i + 1) * per].to(slot.device), slot.params)
                toks = slot.decode(slot.params, feat)
                first.setdefault(i, (feat, toks))
                for W in buckets:
                    positions = torch.arange(W, device=slot.device).expand(per, W).contiguous()
                    slot.decoder(slot.params, feat, toks, positions)
        if self._shard_words:
            slot0 = self._slots[0]
            toks = slot0.decode(slot0.params, self._encode(images[:1], slot0.params))
            for slot in self._slots:
                feat = self._encode(images[:1].to(slot.device), slot.params)
                for W in buckets:
                    positions = torch.arange(-(-W // len(self._slots)), device=slot.device)[None]
                    slot.decoder(slot.params, feat, toks.to(slot.device), positions)
        for i, (feat, toks) in first.items():
            slot = self._slots[i]
            per = feat.shape[0]
            self._explain_batch_impl(slot.params, images[i * per:(i + 1) * per].to(slot.device),
                                     toks, self._bucket_for(0), None, slot.decoder)
        return self

    @torch.no_grad()
    def predict_caption(self, image) -> tuple[np.ndarray, str]:
        tokens = self._decode(self._as_images(image)[None], 1)[0]
        words = []
        for tok in tokens:
            if tok == 0:
                break
            words.append(self._pp.word_of[int(tok)])
            if tok == self._pp.EOS_TOKEN_LABEL_ENCODED:
                break
        return tokens, " ".join(words)

    @torch.no_grad()
    def analyze(self, image, tokens_1based: np.ndarray | None = None) -> Explanation:
        """Beam-search a caption (unless given) and explain every word."""
        images = self._as_images(image)[None]
        if tokens_1based is None:
            tokens_1based, caption = self.predict_caption(images[0])
        else:
            caption = None
        toks = self._coerce_tokens(tokens_1based)
        n = _n_explained(np.asarray(tokens_1based), self._pp.EOS_TOKEN_LABEL_ENCODED)
        if self._shard_words:
            e = self._explain_words_sharded(images, toks[None], self._bucket_for(n))
        else:
            e = self._explain_rows(images, toks[None], 1, self._bucket_for(n))[0]
        e.tokens_1based = np.asarray(tokens_1based)
        if caption is not None:
            e.caption = caption
        return e

    @torch.no_grad()
    def analyze_batch(self, images, tokens_1based=None) -> list:
        """Batched analyze: (B, H, W, 3) images -> list[Explanation], every
        row on the bucket of the batch's longest caption, in the dispatches
        of ``_chunks`` at ``batch_size`` (one for B <= ``batch_size``)."""
        images = self._as_images(images)
        toks_np = (self._decode(images) if tokens_1based is None
                   else self._coerce_tokens(tokens_1based))
        eos = self._pp.EOS_TOKEN_LABEL_ENCODED
        n_max = max((_n_explained(row, eos) for row in toks_np), default=self._max_len)
        W = self._bucket_for(n_max)
        return [e for i, j, size in self._chunks(images.shape[0], self.batch_size)
                for e in self._explain_rows(images[i:j], toks_np[i:j], size, W)]

    @torch.no_grad()
    def analyze_many(self, images, tokens_1based=None, batch_size=None,
                     split_buckets: bool = False) -> list:
        """Dataset-scale analyze: decode in chunks (unless tokens are given),
        sort the images by caption length and explain contiguous chunks of
        ``batch_size`` (default the Explainer's), each on the bucket of its
        own longest caption; a short last chunk is padded to a size of the
        halving ladder (the padded rows are dropped). Results come back in
        input order. Another ``batch_size`` than the Explainer's replays
        graphs of its own ladder.

        ``split_buckets``: the latency mode for small requests: each
        same-bucket group goes out in sub-batches from the halving ladder of
        ``batch_size`` (``warmup(sub_batches=True)`` captures them all). On a
        mesh ``batch_size`` must divide by its data size."""
        images = self._as_images(images)
        n = images.shape[0]
        if n == 0:
            return []
        B = batch_size or self.batch_size
        if B % len(self._slots):
            raise ValueError(f"batch_size {B} not divisible by the mesh data-axis size "
                             f"{len(self._slots)}")
        toks_np = (self._decode(images, B) if tokens_1based is None
                   else self._coerce_tokens(tokens_1based))
        eos = self._pp.EOS_TOKEN_LABEL_ENCODED
        n_words = np.asarray([_n_explained(row, eos) for row in toks_np])
        order = np.argsort(n_words, kind="stable")

        out = [None] * n

        def dispatch(sel, size, bucket):
            rows = self._explain_rows(images[torch.as_tensor(sel, device=self.device)],
                                      toks_np[sel], size, bucket)
            for e, b in zip(rows, sel):
                out[int(b)] = e

        if split_buckets:
            ladder = self._sub_batch_ladder(B)
            i = 0
            while i < n:
                bucket = self._bucket_for(int(n_words[order[i]]))
                j = i
                while j < n and self._bucket_for(int(n_words[order[j]])) == bucket:
                    j += 1
                for size in self._cover_with_ladder(j - i, ladder):
                    sel = order[i:i + min(size, j - i)]
                    dispatch(sel, size, bucket)
                    i += len(sel)
            return out
        for i, j, size in self._chunks(n, B):
            sel = order[i:j]
            dispatch(sel, size, self._bucket_for(int(n_words[sel].max())))
        return out
