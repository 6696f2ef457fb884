"""Captioning model assembly: a CNN encoder (VGG16 / VGG19 tapped at
``cfg.layer_name``, ResNet-50 / ResNet-101 at the last block's ReLU,
InceptionV3 at ``cfg.layer_name``, default 'mixed10') + an adaptive-attention,
grid-TD or AOA decoder, and the training losses: ``masked_ce_from_logits`` (softmax-CE on
logits, last timestep discarded, all-zero label rows (padding) contribute 0)
and, for grid-TD with ``loss_mode='keras_categorical'``,
``keras_categorical_ce``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..data.images import ENCODERS
from ..runtime import resolve_device
from ..weights import tree_to
from . import adaptive, aoa, gridtd, inception, resnet, vgg


def masked_ce_from_logits(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """(B, T, V) logits, (B, T, V) one-hot (all-zero rows = padding) -> scalar,
    the mean over (B, T - 1)."""
    logits = logits[:, :-1, :]
    y = y_onehot[:, :-1, :].to(logits.dtype)
    return -(y * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def keras_categorical_ce(logits: torch.Tensor, y_onehot: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    """Keras categorical_crossentropy applied to raw logits (the reference
    grid-TD's loss, model.py:662-664): the output renormalized to sum 1,
    clipped to [eps, 1 - eps], then -y log p, the mean over (B, T).

    A step whose logits sum below 0 keeps its negative sum (Keras' raw
    ``output /= sum``): its target probability clips to eps. The denominator
    gets a stabilizer of its own sign, so an exactly-zero sum cannot give a
    NaN gradient."""
    y = y_onehot.to(logits.dtype)
    s = logits.sum(-1, keepdim=True)
    s = s + torch.where(s >= 0, torch.full_like(s, eps), torch.full_like(s, -eps))
    p = torch.clamp(logits / s, eps, 1.0 - eps)
    return -(y * torch.log(p)).sum(-1).mean()


def masked_accuracy_counts(logits: torch.Tensor, y_onehot: torch.Tensor):
    """(steps whose argmax is the label's, non-padding steps), last step
    discarded, as f32 scalars: a sharded step sums each over its slices."""
    logits, y = logits[:, :-1, :], y_onehot[:, :-1, :]
    valid = y.sum(-1) > 0
    match = logits.argmax(-1) == y.argmax(-1)
    return (match & valid).sum().float(), valid.sum().float()


def masked_accuracy(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Share of the non-padding steps (last step discarded) whose argmax is
    the label's (categorical_accuracy_with_variable_timestep)."""
    correct, valid = masked_accuracy_counts(logits, y_onehot)
    return correct / valid.clamp(min=1)


@dataclass
class Captioner:
    """Bundles encoder + decoder functions over one params dict
    ``{'vgg': {...}, 'decoder': {...}}`` (the key 'vgg' holds every
    encoder's params, as in the JAX package's checkpoints)."""

    model_type: str            # 'adaptiveattention' | 'gridTD' | 'aoa'
    cfg: Any
    vocab_size: int
    decoder: Any               # module: adaptive | gridtd | aoa

    def init_params(self, seed: int = 0, device="cuda", vocab_words=None,
                    word_vector_path: str | None = None):
        """Random params from ``seed`` (a ``torch.Generator`` on the CPU), with
        the JAX package's shapes and init laws, moved to ``device``.

        ``vocab_words`` (model-id order) and ``cfg.pretrained_word_vector``
        ('glove' | 'fasttext') seed the embedding table from the vector file
        ``word_vector_path`` (reference _build_word_embedding, model.py:80-93);
        its other rows are drawn from the same generator."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = {"vgg": self.init_encoder_params(gen),
                  "decoder": self.decoder.init_params(gen, self.vocab_size, self.cfg)}
        if self.cfg.pretrained_word_vector and vocab_words is not None:
            from .word_vectors import init_embedding

            params["decoder"]["embedding"] = init_embedding(
                gen, list(vocab_words), self.cfg.embedding_dim,
                pretrained=self.cfg.pretrained_word_vector, path=word_vector_path)
        return tree_to(params, dev)

    def init_encoder_params(self, gen: torch.Generator):
        """The encoder's params on the CPU from ``gen``."""
        enc = self.cfg.img_encoder
        if enc in ("vgg16", "vgg19"):
            return vgg.init_vgg_params(gen, self.cfg.layer_name, enc)
        if enc in ("resnet50", "resnet101"):
            return resnet.init_resnet50_params(gen, enc)
        return inception.init_inception_v3_params(gen)

    def _cfg_compute_dtype(self):
        """cfg.compute_dtype ('float32' | 'bfloat16') -> None | torch.bfloat16."""
        cd = self.cfg.compute_dtype
        if cd in (None, "float32", "f32"):
            return None
        if cd in ("bfloat16", "bf16"):
            return torch.bfloat16
        raise ValueError(f"unsupported compute_dtype {cd!r}")

    def encode(self, params, images: torch.Tensor, compute_dtype=None,
               relu_fn=None) -> torch.Tensor:
        """images (B, H, W, 3) preprocessed -> (B, L, D) f32 feature grid.

        ``compute_dtype`` defaults to ``cfg.compute_dtype``; ``relu_fn``
        replaces the encoder's every ReLU (the gradient methods')."""
        if compute_dtype is None:
            compute_dtype = self._cfg_compute_dtype()
        enc = self.cfg.img_encoder
        if enc in ("vgg16", "vgg19"):
            feats = vgg.vgg_apply(params["vgg"], images, self.cfg.layer_name, compute_dtype,
                                  relu_fn, enc)
        elif enc == "inception_v3":
            feats = inception.inception_v3_apply(params["vgg"], images, compute_dtype,
                                                 self.cfg.layer_name, relu_fn)
        else:
            feats = resnet.resnet50_apply(params["vgg"], images, compute_dtype, enc, relu_fn)
        return feats.reshape(feats.shape[0], self.cfg.img_feature_length,
                             self.cfg.img_feature_dim)

    def prepare_consts(self, params, feat_grid: torch.Tensor):
        return self.decoder.prepare_consts(params["decoder"], feat_grid)

    def cached_forward(self, params, feat_grid: torch.Tensor, tokens_1based: torch.Tensor,
                       sos_id_1based: int):
        """The decoder over a given caption, keeping every step's cache:
        (consts, caches of (T, B, ...)). tokens_1based (B, T); the input at
        step 0 is SOS, at step i the caption's word i - 1 (explainers.py:
        399-408)."""
        B = tokens_1based.shape[0]
        consts = self.prepare_consts(params, feat_grid)
        prev = torch.cat([torch.full((B, 1), sos_id_1based, dtype=torch.long,
                                     device=tokens_1based.device), tokens_1based[:, :-1]], dim=1)
        caches = self.decoder.forward_cached_from_inputs(
            params["decoder"], consts, torch.clamp(prev - 1, min=0), self.cfg.hidden_dim)
        return consts, caches

    def forward_train(self, params, images: torch.Tensor, captions_in: torch.Tensor,
                      generator: torch.Generator | None = None,
                      masks=None) -> torch.Tensor:
        """Teacher-forced logits (B, T, V). Dropout at ``cfg.drop_rate`` when a
        ``generator`` (or ready ``masks``: the decoder's ``DropoutMasks``,
        ``GridTDDropoutMasks`` or ``AOADropoutMasks``) is given, none otherwise.
        ``cfg.remat_encoder`` recomputes the CNN in the backward pass instead
        of keeping its activations."""
        if self.cfg.remat_encoder:
            feat_grid = checkpoint(self.encode, params, images, use_reentrant=False)
        else:
            feat_grid = self.encode(params, images)
        drop = self.cfg.drop_rate if generator is not None else 0.0
        return self.decoder.forward_train(params["decoder"], feat_grid, captions_in, self.cfg,
                                          generator, drop, masks)

    def loss_fn(self) -> Callable:
        if self.cfg.loss_mode == "keras_categorical" and self.model_type == "gridTD":
            return keras_categorical_ce
        return masked_ce_from_logits

    def loss(self, params, images, captions_in, y_onehot, generator=None, masks=None):
        logits = self.forward_train(params, images, captions_in, generator, masks)
        return self.loss_fn()(logits, y_onehot)


DECODERS = {"adaptiveattention": adaptive, "gridTD": gridtd, "aoa": aoa}


def build_captioner(model_type: str, cfg, vocab_size: int) -> Captioner:
    """``model_type`` 'adaptiveattention', 'gridTD' or 'aoa' ('AOA'), the JAX
    package's names, over ``cfg.img_encoder`` (one of ENCODERS)."""
    if model_type == "AOA":
        model_type = "aoa"
    if model_type not in DECODERS:
        raise ValueError(f"unknown model type {model_type!r} (choose adaptiveattention|gridTD|aoa)")
    if cfg.img_encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {cfg.img_encoder!r} (choose one of {ENCODERS})")
    return Captioner(model_type, cfg, vocab_size, DECODERS[model_type])
