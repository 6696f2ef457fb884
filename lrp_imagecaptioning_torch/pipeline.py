"""Caption + per-word LRP heatmaps: the port's main path.

The three stages of the JAX package's ``bench.py::build`` on one device:

1. caption:     VGG encode, then beam search (beam 3, T = 20 by default);
2. decoder_lrp: cached forward over the caption, then the decoder LRP of
                every word -> feature-grid relevance (B, T, L, D);
3. cnn_lrp:     per image, one shared VGG forward and the word-batched
                PresetA backward -> heatmaps (B, T, H, W, 3).

Two modes, one per setting of bench:

* ``storage_dtype=None``: f32 throughout, as bench with ``LRPIC_BENCH_F32=1``;
* ``storage_dtype=torch.bfloat16``: bench's default. The encode's conv
  operands are bf16 (``compute_dtype``) and the CNN LRP holds its params,
  activations and relevances in bf16 (``storage_dtype``). Beam search and
  the decoder LRP stay f32, as in bench.

On a CUDA device the caption stage's beam search (after the eager encode)
and the whole decoder-LRP stage replay from CUDA graphs (``graphs.py``),
keyed on the input shapes and the params' pointers; ``.eager_stages`` holds
the same two stages without graphs.
"""

from __future__ import annotations

import torch

from .config import FlickrConfig
from .explain.cnn_lrp import vgg_lrp_per_image
from .explain.decoder_lrp import explain_word_adaptive
from .graphs import GraphedStage, param_tensors
from .infer.beam import beam_search
from .models.captioner import build_captioner
from .runtime import resolve_device

BEAM = 3
T = 20


def build(cfg=None, vocab_size: int = 7003, device="cuda", beam: int = BEAM, T: int = T,
          sos: int = 1, eos: int = 2, storage_dtype: torch.dtype | None = None):
    """Returns ``(caption_and_explain, captioner)``; ``storage_dtype`` picks
    the mode (module docstring).

    ``caption_and_explain(params, images) -> (tokens_1based (B, T),
    heatmaps (B, T, H, W, 3))``; its stages are in ``.stages``. ``params``
    live on ``device`` (``captioner.init_params`` or ``weights.*``)."""
    cfg = cfg if cfg is not None else FlickrConfig()
    dev = resolve_device(device)
    cap = build_captioner("adaptiveattention", cfg, vocab_size)

    def search(params, feat_grid):
        return beam_search(cap, params, feat_grid, sos, eos, beam, T)

    def stage_decoder_lrp(params, feat_grid, tokens):
        consts, caches = cap.cached_forward(params, feat_grid, tokens, sos)
        words0 = torch.clamp(tokens - 1, min=0)
        r_feat, _, _ = explain_word_adaptive(params["decoder"], consts, caches, words0)
        return r_feat                                              # (B, T, L, D)

    # on the card the two host-bound loops replay from CUDA graphs (graphs.py)
    run_search, run_decoder_lrp, graphed = search, stage_decoder_lrp, {}
    if dev.type == "cuda":
        def decoder_params(params):
            return param_tensors(params["decoder"])
        run_search = GraphedStage(search, decoder_params)
        run_decoder_lrp = GraphedStage(stage_decoder_lrp, decoder_params)
        graphed = {"beam_search": run_search, "decoder_lrp": run_decoder_lrp}

    def caption_with(search_fn):
        def stage_caption(params, images):
            # f32 operands when storage_dtype is None, whatever cfg.compute_dtype says
            feat_grid = cap.encode(params, images, storage_dtype or torch.float32)  # (B, L, D)
            tokens, _ = search_fn(params, feat_grid)
            return feat_grid, tokens
        return stage_caption

    stage_caption = caption_with(run_search)

    def stage_cnn_lrp(params, images, r_feat):
        """Any number of words per image: r_feat (B, Tw, L, D)."""
        return vgg_lrp_per_image(params["vgg"], images, r_feat, cfg.layer_name, storage_dtype)

    @torch.no_grad()
    def caption_and_explain(params, images):
        images = torch.as_tensor(images, dtype=torch.float32, device=dev).contiguous()
        feat_grid, tokens = stage_caption(params, images)
        r_feat = run_decoder_lrp(params, feat_grid, tokens)
        return tokens, stage_cnn_lrp(params, images, r_feat)

    caption_and_explain.stages = {
        "caption": torch.no_grad()(stage_caption),
        "decoder_lrp": torch.no_grad()(run_decoder_lrp),
        "cnn_lrp": torch.no_grad()(stage_cnn_lrp),
    }
    # the same stage functions without graphs, as the CPU runs them
    caption_and_explain.eager_stages = {
        "caption": torch.no_grad()(caption_with(search)),
        "decoder_lrp": torch.no_grad()(stage_decoder_lrp),
    }
    caption_and_explain.graphed = graphed   # name -> GraphedStage; empty on the CPU
    return caption_and_explain, cap
