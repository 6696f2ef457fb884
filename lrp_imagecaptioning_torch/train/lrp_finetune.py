"""LRP-inference fine-tuning: relevance-weighted dual-loss training against
object hallucination.

One step, per batch:

1. predict: the teacher-forced forward without dropout; its argmax gives
   the predicted words;
2. ``lrp_weights``: for each predicted word that is neither a stop word nor
   at or after the first EOS, the decoder LRP (``lrp_linear`` kernel) and
   the f32 CNN LRP (``conv3x3_fused`` kernel) give a heatmap; its channel
   mean, projected to [-1, 1] by its absmax, reduces to a score by ``mode``
   ('mean' | 'pos_mean' | 'quantile' at 0.9); the weights are
   1 + score at [t, word] and 1 elsewhere. No gradient flows through them;
3. the dual loss 0.5 CE(y, logits) + 0.5 CE(y, logits * weights), with
   dropout, and one clipped Adam step on its gradient.

The decoder LRP runs on (image x word) rows in one pass; the CNN LRP runs
per image, all its words against one shared forward.

Over a mesh (``make_sharded_lrp_finetune_step``, ``LRPFinetuner(mesh=)``)
each data slot predicts and weighs its own rows (the weights are per image
and word, so they need no reduction), and the dual loss's gradient follows
the sharded train step's rules (``train/step.py``).
"""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from ..data.prefetch import prefetch
from ..explain.aoa_backward import explain_word_aoa
from ..explain.cnn_lrp import vgg_lrp_preset_a_wordbatched
from ..explain.decoder_lrp import explain_word_adaptive, explain_word_gridtd
from ..models.captioner import masked_accuracy, masked_accuracy_counts, masked_ce_from_logits
from ..parallel.mesh import batch_sharding, stacked_batch_sharding
from ..runtime import resolve_device
from .checkpoint import save_checkpoint
from .optimizer import apply_updates, make_optimizer
from .step import (chain_steps, drawn_masks, graph_body, group_multi, mask_rows,
                   metric_accumulator, one_device_mesh, place_on_mesh, replicas, run_slots,
                   run_stepped_steps, sharded_step, sharded_value_and_grad, undonated,
                   value_and_grad)

# NLTK english stop words, frozen so that no corpus download is needed
STOP_WORDS = frozenset("""a about above after again against ain all am an and any are aren aren't as at be
because been before being below between both but by can couldn couldn't d did didn didn't do does doesn
doesn't doing don don't down during each few for from further had hadn hadn't has hasn hasn't have haven
haven't having he her here hers herself him himself his how i if in into is isn isn't it it's its itself
just ll m ma me mightn mightn't more most mustn mustn't my myself needn needn't no nor not now o of off on
once only or other our ours ourselves out over own re s same shan shan't she she's should should've shouldn
shouldn't so some such t than that that'll the their theirs them themselves then there these they this those
through to too under until up ve very was wasn wasn't we were weren weren't what when where which while who
whom why will with won won't wouldn wouldn't y you you'd you'll you're you've your yours yourself
yourselves""".split())


def stop_word_table(caption_pp) -> np.ndarray:
    """(vocab_size + 1,) bool over 1-based token ids; True = skip this word.
    ``caption_pp`` has ``vocab_size`` and ``word_of`` (token -> word).
    Padding (0) and EOS are masked by ``lrp_weights`` itself."""
    table = np.zeros(caption_pp.vocab_size + 1, bool)
    for tok in range(1, caption_pp.vocab_size + 1):
        table[tok] = caption_pp.word_of[tok] in STOP_WORDS
    return table


def _project(hp: torch.Tensor) -> torch.Tensor:
    """Each map (W, ...) over its max |x|; an all-zero map stays 0."""
    absmax = hp.abs().flatten(1).amax(dim=1).reshape(-1, *([1] * (hp.dim() - 1)))
    return torch.where(absmax == 0, torch.zeros_like(hp),
                       hp / torch.where(absmax == 0, torch.ones_like(absmax), absmax))


def _score(hp: torch.Tensor, mode: str) -> torch.Tensor:
    """(W, ...) maps -> (W,) scores."""
    flat = hp.flatten(1)
    if mode == "mean":
        return flat.mean(dim=1)
    if mode == "pos_mean":
        return flat.clamp(min=0).mean(dim=1)
    if mode == "quantile":
        return torch.quantile(flat, 0.9, dim=1)    # 'linear', jnp.quantile's default
    raise NotImplementedError(f"lrp_inference_mode {mode!r}")


@torch.no_grad()
def lrp_weights(captioner, params, images: torch.Tensor, y_pred_logits: torch.Tensor,
                stop_table, sos_1based: int, eos_1based: int, mode: str = "mean",
                max_words: int | None = None) -> torch.Tensor:
    """(B, T, V) relevance weights.

    images: (B, H, W, 3) preprocessed; y_pred_logits: (B, T, V) teacher-forced
    predictions; stop_table: (V + 1,) bool (True = stop word), an array or
    a tensor (one on the images' device is used as it is). The CNN LRP
    is VGG's (vgg16 or vgg19), as in the JAX package.

    ``max_words = W`` explains only the first W valid words of each sample
    (their positions gathered, in time order); a valid word beyond W keeps
    weight 1. Exact against ``None`` (every step) when no sample has more
    than W valid words."""
    cap, cfg = captioner, captioner.cfg
    B, T, V = y_pred_logits.shape
    dev = y_pred_logits.device
    caption1 = y_pred_logits.argmax(dim=-1) + 1                          # (B, T) 1-based
    # decoder inputs: SOS, then the predicted words
    prev = torch.cat([torch.full((B, 1), sos_1based, dtype=torch.long, device=dev),
                      caption1[:, :-1]], dim=1)
    feat_grid = cap.encode(params, images)                              # (B, L, D)
    consts = cap.prepare_consts(params, feat_grid)
    caches = cap.decoder.forward_cached_from_inputs(params["decoder"], consts,
                                                    torch.clamp(prev - 1, min=0), cfg.hidden_dim)
    # stop words skipped; EOS and everything after it skipped
    is_stop = torch.as_tensor(stop_table, dtype=torch.bool, device=dev)[caption1]
    seen_eos = torch.cumsum((caption1 == eos_1based).int(), dim=1) > 0
    valid = ~is_stop & ~seen_eos                                        # (B, T)
    words0 = torch.clamp(caption1 - 1, min=0)

    if max_words is not None and max_words < T:
        # the first max_words valid positions of each sample, in time order
        pos = torch.argsort((~valid).int(), dim=1, stable=True)[:, :max_words]
        pos_valid = valid.gather(1, pos)
    else:
        pos = torch.arange(T, device=dev).expand(B, T)
        pos_valid = valid
    backward = {"adaptiveattention": explain_word_adaptive, "gridTD": explain_word_gridtd,
                "aoa": explain_word_aoa}[cap.model_type]
    r_feat, _, _ = backward(params["decoder"], consts, caches,
                            words0.gather(1, pos), positions=pos)               # (B, W, L, D)

    g = int(round(math.sqrt(cfg.img_feature_length)))
    seeds = r_feat.reshape(B, pos.shape[1], g, g, cfg.img_feature_dim)
    scores_w = torch.stack([
        _score(_project(vgg_lrp_preset_a_wordbatched(
            params["vgg"], images[b:b + 1], seeds[b], cfg.img_encoder,
            cfg.layer_name).mean(dim=-1)), mode)
        for b in range(B)])                                             # (B, W)
    scores_w = torch.where(pos_valid, scores_w, torch.zeros_like(scores_w))
    # back onto the (B, T) timeline (positions are unique in a row)
    scores = torch.zeros((B, T), dtype=scores_w.dtype, device=dev).scatter_add_(1, pos, scores_w)
    onehot = torch.nn.functional.one_hot(words0, V).to(scores.dtype)
    return 1.0 + onehot * scores[:, :, None]


def dual_loss(logits: torch.Tensor, lrp_weight: torch.Tensor, y_onehot: torch.Tensor):
    """0.5 CE(y, logits) + 0.5 CE(y, logits * lrp_weight), both softmax-CE on
    logits with the last timestep discarded."""
    return 0.5 * masked_ce_from_logits(logits, y_onehot) \
        + 0.5 * masked_ce_from_logits(logits * lrp_weight, y_onehot)


def make_lrp_finetune_step(captioner, optimizer, stop_table, sos_1based: int, eos_1based: int,
                           mode: str = "mean", donate: bool = True,
                           max_words: int | None = None):
    """-> step(params, opt_state, images, captions_in, y_onehot, generator,
    masks=None) -> (params, opt_state, metrics): predict -> LRP weights ->
    dual-loss gradient step (``masks``, the decoder's ``DropoutMasks``,
    replace the generator's draw). ``step.phases`` holds the three phases
    (``predict``, ``lrp_weights``, ``update``) for timing them apart;
    ``step.dual`` is the dual loss's (loss, metrics, grads) from given
    masks, the body the K-step call captures. ``donate``:
    ``train.step.undonated``."""
    stop_cpu = torch.as_tensor(np.asarray(stop_table), dtype=torch.bool)
    stops = {}   # the stop table on each device, copied there once (no copy a step)

    @torch.no_grad()
    def predict(params, images, captions_in):
        return captioner.forward_train(params, images, captions_in, None)

    def weights(params, images, y_pred):
        if images.device not in stops:
            stops[images.device] = stop_cpu.to(images.device)
        return lrp_weights(captioner, params, images, y_pred, stops[images.device], sos_1based,
                           eos_1based, mode, max_words=max_words)

    def weighted(params, images, captions_in, y_onehot, w, generator, masks=None):
        def loss(p):
            logits = captioner.forward_train(p, images, captions_in, generator, masks=masks)
            return dual_loss(logits, w, y_onehot), logits.detach()

        loss_value, logits, grads = value_and_grad(loss, params)
        return loss_value, {"accuracy": masked_accuracy(logits, y_onehot)}, grads

    def dual(params, images, captions_in, y_onehot, masks, generator=None):
        w = weights(params, images, predict(params, images, captions_in))
        return weighted(params, images, captions_in, y_onehot, w, generator, masks)

    def applied(params, opt_state, loss, metrics, grads):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, dict(metrics, loss=loss)

    def update(params, opt_state, images, captions_in, y_onehot, w, generator):
        return applied(params, opt_state,
                       *weighted(params, images, captions_in, y_onehot, w, generator))

    def step(params, opt_state, images, captions_in, y_onehot, generator, masks=None):
        return applied(params, opt_state,
                       *dual(params, images, captions_in, y_onehot, masks, generator))

    step.phases = {"predict": predict, "lrp_weights": weights, "update": update}
    step.dual = dual
    return undonated(step, donate)


def make_multi_lrp_finetune_step(captioner, optimizer, stop_table, sos_1based: int,
                                 eos_1based: int, mode: str = "mean", donate: bool = True,
                                 max_words: int | None = None):
    """K fine-tune steps a call over K stacked batches, the JAX package's
    ``make_multi_lrp_finetune_step``: ``multi(params, opt_state, images,
    captions_in, y_onehot, generator, masks=None)`` as
    ``train.step.make_multi_train_step``'s, the same as K chained
    ``make_lrp_finetune_step`` steps (each step's ``lrp_weights`` reads the
    params the step before wrote). On the card each step is the replay of
    one captured step (predict -> ``lrp_weights`` -> update); on the CPU the
    call is the loop of single steps."""
    from ..graphs import StepGraph

    single = make_lrp_finetune_step(captioner, optimizer, stop_table, sos_1based, eos_1based,
                                    mode, max_words=max_words)
    graph = StepGraph(graph_body(optimizer, single.dual), optimizer)

    def multi(params, opt_state, images, captions_in, y_onehot, generator, masks=None):
        stacks = (images, captions_in, y_onehot)
        if images.device.type != "cuda":
            return chain_steps(single, params, opt_state, stacks, generator, masks)
        masks = drawn_masks(captioner, params, images.shape[1], images.shape[0], generator,
                            masks)
        return graph(params, opt_state, stacks, masks)

    multi.graph = graph
    return undonated(multi, donate)


def sharded_finetune_grads(captioner, mesh, phases):
    """``train.step.sharded_train_grads`` for the fine-tune step of
    ``phases`` (``make_lrp_finetune_step``'s): each slot predicts and weighs
    its rows on its own device, then the dual loss's gradient is summed."""
    def grads(params, images, captions_in, y_onehot, masks):
        B = images.global_rows
        reps = replicas(mesh, params)
        x, c = images.shards, captions_in.shards
        weights = run_slots(mesh, lambda i: phases["lrp_weights"](
            reps[i], x[i], phases["predict"](reps[i], x[i], c[i])))

        def slot_loss(i, p):
            dev, y = mesh.slots[i], y_onehot.shards[i]
            m = None if masks is None else mask_rows(masks, images.rows[i], dev)
            logits = captioner.forward_train(p, images.shards[i], captions_in.shards[i], None,
                                             masks=m)
            return (dual_loss(logits, weights[i], y) * (y.shape[0] / B),
                    masked_accuracy_counts(logits.detach(), y))

        loss, accuracy, g = sharded_value_and_grad(mesh, reps, slot_loss)
        return loss, {"accuracy": accuracy}, g

    return grads


def make_sharded_lrp_finetune_step(captioner, optimizer, mesh, stop_table, sos_1based: int,
                                   eos_1based: int, mode: str = "mean", donate: bool = True,
                                   max_words: int | None = None):
    """Data-parallel LRP-inference fine-tuning: ``step(params, opt_state,
    images, captions_in, y_onehot, generator, masks=None)`` as
    ``make_lrp_finetune_step``'s, the batch split over the mesh's data slots
    (global arrays or ``Sharded``). Each slot predicts and weighs its rows on
    its own device (``train.step.run_slots``); the dual loss's gradients
    are weighted, summed and then clipped, as ``train/step.py``'s sharded
    step does. The params and the state stay on
    the mesh's first slot (``train.step.place_on_mesh``)."""
    phases = make_lrp_finetune_step(captioner, optimizer, stop_table, sos_1based, eos_1based,
                                    mode, max_words=max_words).phases
    return undonated(sharded_step(captioner, optimizer, mesh,
                                  sharded_finetune_grads(captioner, mesh, phases)), donate)


def make_sharded_multi_lrp_finetune_step(captioner, optimizer, mesh, stop_table,
                                         sos_1based: int, eos_1based: int, mode: str = "mean",
                                         donate: bool = True, max_words: int | None = None):
    """K sharded fine-tune steps a call over (K, B, ...) stacks split on the
    batch axis, the JAX package's ``make_sharded_multi_lrp_finetune_step``:
    what K ``make_sharded_lrp_finetune_step`` steps compute, each step
    replayed from one captured rank step in a NCCL group of one card a
    process, else the steps chained (``train.step.group_multi``)."""
    phases = make_lrp_finetune_step(captioner, optimizer, stop_table, sos_1based, eos_1based,
                                    mode, max_words=max_words).phases
    return undonated(group_multi(captioner, optimizer, mesh,
                                 sharded_finetune_grads(captioner, mesh, phases)), donate)


class LRPFinetuner:
    """The chunked fine-tune loop with a checkpoint after each chunk,
    resumable by ``save_idx``, on one device or, with ``mesh``, data-parallel
    over its slots (``make_sharded_lrp_finetune_step``; a ragged epoch tail
    is dropped). ``steps_per_call = K > 1`` runs K steps a call
    (``make_multi_lrp_finetune_step``, or on a mesh of several slots or
    in a process group its sharded form: in a NCCL group of one card a
    process each step replayed from one captured rank step; values below 1
    are 1, as in the JAX package), the ragged tail as single steps.

    ``provider`` has ``caption_preprocessor`` (``vocab_size``, ``word_of``,
    ``SOS_TOKEN_LABEL_ENCODED``, ``EOS_TOKEN_LABEL_ENCODED``) and
    ``training_set(pad_to_length, skip_batches, drop_remainder)`` yielding
    ``((captions_in, images), y_onehot)`` numpy batches."""

    def __init__(self, captioner, params, provider, mode: str = "mean",
                 learning_rate: float = 1e-6, seed: int = 0, steps_per_call: int = 1, mesh=None,
                 max_explained_words: int | None = None, *, device="cuda"):
        if isinstance(steps_per_call, bool) or not isinstance(steps_per_call, numbers.Integral):
            raise TypeError(f"steps_per_call must be an int, got {steps_per_call!r}")
        if max_explained_words is not None and (isinstance(max_explained_words, bool) or not
                                                isinstance(max_explained_words, numbers.Integral)):
            raise TypeError(f"max_explained_words must be an int or None, got "
                            f"{max_explained_words!r}")
        self.captioner = captioner
        self.provider = provider
        self.mesh = mesh
        # on a mesh the params, the state and the dropout live on its first slot
        self.device = mesh.primary if mesh is not None else resolve_device(device)
        self.params = params
        pp = provider.caption_preprocessor
        self.optimizer = make_optimizer(captioner.model_type, learning_rate)
        self.opt_state = self.optimizer.init(params)
        step_args = (captioner, self.optimizer, stop_word_table(pp), pp.SOS_TOKEN_LABEL_ENCODED,
                     pp.EOS_TOKEN_LABEL_ENCODED, mode, True, max_explained_words)
        self._steps_per_call = max(int(steps_per_call), 1)
        self._multi_step = None
        if mesh is None:
            self._step = make_lrp_finetune_step(*step_args)
            if self._steps_per_call > 1:
                self._multi_step = make_multi_lrp_finetune_step(*step_args)
        else:
            self._step = make_sharded_lrp_finetune_step(step_args[0], step_args[1], mesh,
                                                        *step_args[2:])
            if self._steps_per_call > 1:
                self._multi_step = (
                    make_multi_lrp_finetune_step(*step_args) if one_device_mesh(mesh) else
                    make_sharded_multi_lrp_finetune_step(step_args[0], step_args[1], mesh,
                                                         *step_args[2:]))
            self.params, self.opt_state = place_on_mesh(mesh)(self.params, self.opt_state)
        self._seed = seed
        self._T = captioner.cfg.sentence_length + 1

    def _place(self, arr):
        if self.mesh is not None:
            return batch_sharding(self.mesh).place(arr)
        return self._on_device(arr)

    def _place_stacked(self, arr):
        """A (K, B, ...) stack (in a process group, this process's rows): on
        a mesh of several slots its batch axis (1) split over the slots."""
        if self.mesh is not None and self.mesh.devices.size > 1:
            return stacked_batch_sharding(self.mesh).place(arr)
        return self._on_device(arr)

    def _on_device(self, arr):
        t = torch.as_tensor(arr, device=self.device)
        return t.long() if not t.is_floating_point() else t.float()

    def run(self, save_idx: int, epoch_length: int, result_dir: str = "results/lrp-finetune"):
        """Run ``epoch_length`` steps, after skipping ``save_idx * epoch_length``
        batches in the provider (without preprocessing them). The dropout
        generator is seeded from (seed, save_idx), so a resumed chunk does not
        replay chunk 0's masks. Saves a checkpoint; returns the chunk's mean
        metrics."""
        state = np.random.SeedSequence([self._seed, save_idx]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=self.device).manual_seed(int(state) >> 1)
        batches = prefetch(self.provider.training_set(
            pad_to_length=self._T, skip_batches=save_idx * epoch_length,
            drop_remainder=self.mesh is not None))
        record, finalize = metric_accumulator()
        try:
            self.params, self.opt_state = run_stepped_steps(
                batches, epoch_length, self._steps_per_call, self._place, gen, self._multi_step,
                self._step, self.params, self.opt_state, record, self._place_stacked)
        finally:
            batches.stop()   # each chunk starts its own producer thread
        metrics = finalize(epoch_length)
        save_checkpoint(result_dir, save_idx, self.params, self.opt_state,
                        metric=metrics["accuracy"])
        return metrics
