"""Adaptive-attention decoder (Lu et al. visual sentinel).

One ``step`` function serves teacher-forced training (``forward_train``),
greedy decoding and beam search (infer/), and the cached forward pass whose
per-step caches feed the decoder LRP (explain/decoder_lrp.py). Step math,
batched over B:

    x_t   = [e_t, g]                      g = global image feature
    h',c' = LSTM(x_t, h, c)
    a_l   = V_a^T tanh(Wv v_l + Wg h')            (attention logits, L)
    alpha = softmax(a)
    s_t   = tanh(c') * sigmoid(Wx x_t + Wh_s h)   (sentinel; uses OLD h)
    z_s   = V_a^T tanh(Ws s_t + Wg h')
    beta  = softmax([a ; z_s])[-1]
    ctx   = sum_l alpha_l v_l
    c_hat = beta s_t + (1-beta) ctx
    logit = W_out (h' + c_hat) + b_out
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cells import (LSTMState, _uniform, attn_weight_init, bernoulli_keep, dense, dense_init,
                    lstm_dropout_masks, lstm_init, lstm_step)


class AdaptiveConsts(NamedTuple):
    """Per-image constants computed once per forward pass."""

    v_feat: torch.Tensor        # (B, L, H) image_features after relu
    v_proj: torch.Tensor        # (B, L, H) v_feat @ Wv
    global_feat: torch.Tensor   # (B, E) relu'd global image feature
    v_pre: torch.Tensor         # (B, L, H) image_features pre-relu
    global_pre: torch.Tensor    # (B, E) global feature pre-relu
    feat_grid: torch.Tensor     # (B, L, D) raw CNN features
    avg_feat: torch.Tensor      # (B, D) mean over L


class AdaptiveStepCache(NamedTuple):
    """Per-step cache consumed by the LRP backward."""

    x_t: torch.Tensor       # (B, 2E) LSTM input
    h_prev: torch.Tensor    # (B, H)
    h: torch.Tensor         # (B, H)
    c_prev: torch.Tensor    # (B, H)
    c: torch.Tensor         # (B, H)
    z_pre: torch.Tensor     # (B, 4H) gate pre-activations
    attention: torch.Tensor # (B, L)
    st: torch.Tensor        # (B, H)
    beta: torch.Tensor      # (B, 1)
    context: torch.Tensor   # (B, H)
    c_hat: torch.Tensor     # (B, H)
    logits: torch.Tensor    # (B, V)


class DropoutMasks(NamedTuple):
    """The inverted-dropout masks of one training forward (1/keep or 0),
    where the JAX package's ``forward_train`` draws them (its key split
    ``ks = split(rng, 5)`` in this field order)."""

    v_feat: torch.Tensor        # (B, L, H) on image_features after relu
    global_feat: torch.Tensor   # (B, E) on the global image feature
    out: torch.Tensor           # (B, H) on h + c_hat before the output layer
    logit: torch.Tensor         # (B, V) on the logits
    lstm: tuple                 # (x_masks (4, B, 2E), h_masks (4, B, H)), all steps

    def to(self, *args, **kwargs) -> "DropoutMasks":
        """Every mask through ``Tensor.to(*args, **kwargs)``."""
        return DropoutMasks(*(f.to(*args, **kwargs) for f in self[:4]),
                            lstm=tuple(m.to(*args, **kwargs) for m in self.lstm))


def draw_dropout_masks(gen: torch.Generator, params, batch: int, cfg, rate: float) -> DropoutMasks:
    """Fresh masks for one forward from ``gen`` (on the params' device)."""
    keep = 1.0 - rate
    L, E = cfg.img_feature_length, params["embedding"].shape[-1]
    H, V = params["output"]["kernel"].shape
    return DropoutMasks(
        v_feat=bernoulli_keep(gen, keep, (batch, L, H)),
        global_feat=bernoulli_keep(gen, keep, (batch, E)),
        out=bernoulli_keep(gen, keep, (batch, H)),
        logit=bernoulli_keep(gen, keep, (batch, V)),
        lstm=lstm_dropout_masks(gen, 2 * E, cfg.hidden_dim, rate, batch=batch))


def init_params(gen: torch.Generator, vocab_size: int, cfg):
    """Decoder params on the CPU, shapes and init laws of the JAX package."""
    E, H, D = cfg.embedding_dim, cfg.hidden_dim, cfg.img_feature_dim
    return {
        "embedding": _uniform(gen, (vocab_size, E), math.sqrt(6.0 / (vocab_size + E))),
        "image_features": dense_init(gen, D, H),
        "global_img_feature": dense_init(gen, D, E),
        "lstm": lstm_init(gen, 2 * E, H),
        "attn": {
            "Wv": attn_weight_init(gen, (H, H)),
            "Wg": attn_weight_init(gen, (H, H)),
            "Wx": attn_weight_init(gen, (2 * E, H)),
            "Wh": attn_weight_init(gen, (H, H)),
            "Ws": attn_weight_init(gen, (H, H)),
            "V": attn_weight_init(gen, (H, 1)),
        },
        "output": dense_init(gen, H, vocab_size),
    }


def prepare_consts(params, feat_grid: torch.Tensor) -> AdaptiveConsts:
    """Encoder-side projections, run once per image. feat_grid: (B, L, D)."""
    v_pre = feat_grid @ params["image_features"]["kernel"] + params["image_features"]["bias"]
    v_feat = torch.relu(v_pre)
    avg = feat_grid.mean(dim=1)
    g_pre = avg @ params["global_img_feature"]["kernel"] + params["global_img_feature"]["bias"]
    return AdaptiveConsts(
        v_feat=v_feat,
        v_proj=v_feat @ params["attn"]["Wv"],
        global_feat=torch.relu(g_pre),
        v_pre=v_pre,
        global_pre=g_pre,
        feat_grid=feat_grid,
        avg_feat=avg,
    )


def step(params, consts: AdaptiveConsts, state: LSTMState, token_emb: torch.Tensor,
         lstm_masks: DropoutMasks | None = None):
    """One decoder step; returns (new_state, AdaptiveStepCache).
    ``lstm_masks`` (training) turns on Keras-style LSTM dropout and the masks on
    h + c_hat and on the logits; ``consts`` then holds the dropped features."""
    a = params["attn"]
    h_prev, c_prev = state
    x_t = torch.cat([token_emb, consts.global_feat], dim=-1)           # (B, 2E)
    new_state, lstm_cache = lstm_step(params["lstm"], x_t, state,
                                      None if lstm_masks is None else lstm_masks.lstm)
    h = new_state.h
    ht_proj = h @ a["Wg"]                                               # (B, H)
    att_pre = torch.tanh(ht_proj[:, None, :] + consts.v_proj)           # (B, L, H)
    att_logits = (att_pre @ a["V"]).squeeze(-1)                         # (B, L)
    attention = torch.softmax(att_logits, dim=-1)
    st = torch.tanh(new_state.c) * torch.sigmoid(x_t @ a["Wx"] + h_prev @ a["Wh"])
    z_s = torch.tanh(st @ a["Ws"] + ht_proj) @ a["V"]                   # (B, 1)
    beta = torch.softmax(torch.cat([att_logits, z_s], dim=-1), dim=-1)[:, -1:]
    context = torch.einsum("bl,blh->bh", attention, consts.v_feat)
    c_hat = beta * st + (1.0 - beta) * context
    if lstm_masks is None:
        logits = dense(params["output"], h + c_hat)
    else:
        logits = dense(params["output"], (h + c_hat) * lstm_masks.out) * lstm_masks.logit
    cache = AdaptiveStepCache(
        x_t=x_t, h_prev=h_prev, h=h, c_prev=c_prev, c=new_state.c, z_pre=lstm_cache.z_pre,
        attention=attention, st=st, beta=beta, context=context, c_hat=c_hat, logits=logits,
    )
    return new_state, cache


def init_state(batch: int, hidden: int, dtype=torch.float32, *, device=None) -> LSTMState:
    zeros = torch.zeros((batch, hidden), device=device, dtype=dtype)
    return LSTMState(zeros, zeros.clone())


def forward_train(params, feat_grid: torch.Tensor, captions_in: torch.Tensor, cfg,
                  generator: torch.Generator | None = None, drop_rate: float = 0.0,
                  *, masks: DropoutMasks | None = None) -> torch.Tensor:
    """Teacher forcing: (B, L, D) features + (B, T) 0-based ids -> (B, T, V) logits.

    Dropout, as the reference training graph places it: on the image
    features (v_proj recomputed from the dropped v_feat), the global feature,
    the LSTM input and recurrent state (per-sequence masks), h + c_hat and
    the logits. The masks are ``masks`` when given, else drawn from
    ``generator`` when ``drop_rate > 0``; with neither there is no dropout."""
    B, T = captions_in.shape
    consts = prepare_consts(params, feat_grid)
    if masks is None and generator is not None and drop_rate > 0.0:
        masks = draw_dropout_masks(generator, params, B, cfg, drop_rate)
    if masks is not None:
        v_feat = consts.v_feat * masks.v_feat
        consts = consts._replace(v_feat=v_feat, global_feat=consts.global_feat * masks.global_feat,
                                 v_proj=v_feat @ params["attn"]["Wv"])
    embs = params["embedding"][captions_in]                             # (B, T, E)
    state = init_state(B, cfg.hidden_dim, embs.dtype, device=embs.device)
    logits = []
    for t in range(T):
        state, cache = step(params, consts, state, embs[:, t], masks)
        logits.append(cache.logits)
    return torch.stack(logits, dim=1)                                  # (B, T, V)


def forward_cached_from_inputs(params, consts: AdaptiveConsts, input_tokens_0based: torch.Tensor,
                               hidden_dim: int) -> AdaptiveStepCache:
    """Run the step over precomputed 0-based input tokens and keep every cache.

    input_tokens_0based: (B, T); column 0 is SOS-1 and column i is
    caption[i-1]-1. Returns an AdaptiveStepCache of (T, B, ...) tensors."""
    B, T = input_tokens_0based.shape
    embs = params["embedding"][input_tokens_0based]                     # (B, T, E)
    state = init_state(B, hidden_dim, embs.dtype, device=embs.device)
    caches = []
    for t in range(T):
        state, cache = step(params, consts, state, embs[:, t])
        caches.append(cache)
    return AdaptiveStepCache(*(torch.stack(f, dim=0) for f in zip(*caches)))
