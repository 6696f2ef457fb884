"""Captioning model assembly: VGG encoder + adaptive-attention or grid-TD
decoder, and the training loss ``masked_ce_from_logits``: softmax-CE on logits, last
timestep discarded, all-zero label rows (padding) contribute 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..runtime import resolve_device
from ..weights import tree_to
from . import adaptive, gridtd, vgg


def masked_ce_from_logits(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """(B, T, V) logits, (B, T, V) one-hot (all-zero rows = padding) -> scalar,
    the mean over (B, T - 1)."""
    logits = logits[:, :-1, :]
    y = y_onehot[:, :-1, :].to(logits.dtype)
    return -(y * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def masked_accuracy(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Share of the non-padding steps (last step discarded) whose argmax is
    the label's (categorical_accuracy_with_variable_timestep)."""
    logits, y = logits[:, :-1, :], y_onehot[:, :-1, :]
    valid = y.sum(-1) > 0
    match = logits.argmax(-1) == y.argmax(-1)
    return (match & valid).sum().float() / valid.sum().clamp(min=1).float()


@dataclass
class Captioner:
    """Bundles encoder + decoder functions over one params dict
    ``{'vgg': {...}, 'decoder': {...}}``."""

    model_type: str            # 'adaptiveattention' | 'gridTD'
    cfg: Any
    vocab_size: int
    decoder: Any               # module: adaptive | gridtd

    def init_params(self, seed: int = 0, device="cuda"):
        """Random params from ``seed`` (a ``torch.Generator`` on the CPU), with
        the JAX package's shapes and init laws, moved to ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = {"vgg": vgg.init_vgg_params(gen, self.cfg.layer_name),
                  "decoder": self.decoder.init_params(gen, self.vocab_size, self.cfg)}
        return tree_to(params, dev)

    def _cfg_compute_dtype(self):
        """cfg.compute_dtype ('float32' | 'bfloat16') -> None | torch.bfloat16."""
        cd = self.cfg.compute_dtype
        if cd in (None, "float32", "f32"):
            return None
        if cd in ("bfloat16", "bf16"):
            return torch.bfloat16
        raise ValueError(f"unsupported compute_dtype {cd!r}")

    def encode(self, params, images: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """images (B, H, W, 3) preprocessed -> (B, L, D) f32 feature grid.

        ``compute_dtype`` defaults to ``cfg.compute_dtype``."""
        if compute_dtype is None:
            compute_dtype = self._cfg_compute_dtype()
        feats = vgg.vgg_apply(params["vgg"], images, self.cfg.layer_name, compute_dtype)
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
                      masks: adaptive.DropoutMasks | None = None) -> torch.Tensor:
        """Teacher-forced logits (B, T, V). Dropout at ``cfg.drop_rate`` when a
        ``generator`` (or ready ``masks``) is given, none otherwise.
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
        return masked_ce_from_logits

    def loss(self, params, images, captions_in, y_onehot, generator=None, masks=None):
        logits = self.forward_train(params, images, captions_in, generator, masks)
        return self.loss_fn()(logits, y_onehot)


DECODERS = {"adaptiveattention": adaptive, "gridTD": gridtd}


def build_captioner(model_type: str, cfg, vocab_size: int) -> Captioner:
    """``model_type`` 'adaptiveattention' or 'gridTD' (the JAX package's
    names) over the vgg16 encoder. grid-TD's ``forward_train`` raises: its
    training is not ported yet."""
    if model_type in DECODERS and cfg.img_encoder == "vgg16":
        return Captioner(model_type, cfg, vocab_size, DECODERS[model_type])
    raise NotImplementedError(
        f"the port has vgg16 + adaptiveattention | gridTD; got {model_type!r} / "
        f"{cfg.img_encoder!r} (AOA and the other encoders are ROADMAP A11)")
