"""Captioning model assembly: VGG encoder + adaptive-attention decoder."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..runtime import resolve_device
from ..weights import tree_to
from . import adaptive, vgg


@dataclass
class Captioner:
    """Bundles encoder + decoder functions over one params dict
    ``{'vgg': {...}, 'decoder': {...}}``."""

    model_type: str            # 'adaptiveattention'
    cfg: Any
    vocab_size: int
    decoder: Any               # module: adaptive

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


def build_captioner(model_type: str, cfg, vocab_size: int) -> Captioner:
    if model_type == "adaptiveattention" and cfg.img_encoder == "vgg16":
        return Captioner(model_type, cfg, vocab_size, adaptive)
    raise NotImplementedError(
        f"the port has vgg16 + adaptiveattention; got {model_type!r} / {cfg.img_encoder!r}")
