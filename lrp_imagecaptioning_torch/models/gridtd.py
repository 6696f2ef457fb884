"""grid-TD decoder (bottom-up/top-down attention on the CNN grid + adaptive
sentinel), two LSTMs a step:

    x1_t    = [h2, g, e_t]                 g = global image feature (E)
    h1',c1' = TD-LSTM(x1_t, h1, c1)        input H + 2E
    a_l     = W_a^T tanh(W_va v_l + W_ha h1')
    alpha   = softmax(a)
    s_t     = tanh(c1') * sigmoid(W_x x1_t + W_h h1)     (OLD h1)
    z_s     = W_a^T tanh(W_s s_t + W_ha h1')
    beta    = softmax([a ; z_s])[-1]
    ctx     = sum_l alpha_l v_l
    c_hat   = beta s_t + (1-beta) ctx
    x2_t    = [c_hat, h1']
    h2',c2' = Lang-LSTM(x2_t, h2, c2)      input 2H
    logit   = W_out (h2' + c_hat) + b_out

Both LSTMs run through ``cells.lstm_step``, so the ``lstm_gates`` kernel
(K2) launches twice a step. The logits take h2 + c_hat as the JAX package's
(and the reference's training graph) do. ``forward_train`` is the teacher-
forced training forward with the reference graph's dropout (model.py:630-660).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cells import (LSTMState, _uniform, attn_weight_init, bernoulli_keep, dense, dense_init,
                    lstm_dropout_masks, lstm_init, lstm_step)


class GridTDState(NamedTuple):
    h1: torch.Tensor
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor


class GridTDConsts(NamedTuple):
    v_feat: torch.Tensor       # (B, L, H)
    v_proj: torch.Tensor       # (B, L, H) v_feat @ W_va
    global_feat: torch.Tensor  # (B, E)
    v_pre: torch.Tensor        # (B, L, H)
    global_pre: torch.Tensor   # (B, E)
    feat_grid: torch.Tensor    # (B, L, D)
    avg_feat: torch.Tensor     # (B, D)


class GridTDStepCache(NamedTuple):
    x1_t: torch.Tensor       # (B, H+2E)
    x2_t: torch.Tensor       # (B, 2H)
    h1_prev: torch.Tensor
    c1_prev: torch.Tensor
    h2_prev: torch.Tensor
    c2_prev: torch.Tensor
    h1: torch.Tensor
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor
    z1_pre: torch.Tensor     # (B, 4H) TD-LSTM gates
    z2_pre: torch.Tensor     # (B, 4H) language-LSTM gates
    attention: torch.Tensor  # (B, L)
    st: torch.Tensor
    beta: torch.Tensor       # (B, 1)
    context: torch.Tensor
    c_hat: torch.Tensor
    logits: torch.Tensor


class GridTDDropoutMasks(NamedTuple):
    """The inverted-dropout masks of one training forward (1/keep or 0), in
    the order the JAX package's ``forward_train`` draws them (its key split
    ``ks = split(rng, 6)``)."""

    v_feat: torch.Tensor        # (B, L, H) on image_features after relu
    global_feat: torch.Tensor   # (B, E) on the global image feature
    out: torch.Tensor           # (B, H) on h2 + c_hat, the output kernel's input
    logit: torch.Tensor         # (B, V) on the logits, the output kernel's output
    # ((x (4, B, H + 2E), h (4, B, H)) of the TD LSTM, (x (4, B, 2H), h (4, B, H))
    # of the language LSTM), the same at every step
    lstm: tuple

    def to(self, *args, **kwargs) -> "GridTDDropoutMasks":
        """Every mask through ``Tensor.to(*args, **kwargs)``."""
        return GridTDDropoutMasks(*(f.to(*args, **kwargs) for f in self[:4]),
                                  lstm=tuple(tuple(m.to(*args, **kwargs) for m in pair)
                                             for pair in self.lstm))


def draw_dropout_masks(gen: torch.Generator, params, batch: int, cfg,
                       rate: float) -> GridTDDropoutMasks:
    """Fresh masks for one forward from ``gen`` (on the params' device)."""
    keep = 1.0 - rate
    L, E = cfg.img_feature_length, params["embedding"].shape[-1]
    H, V = params["output"]["kernel"].shape
    return GridTDDropoutMasks(
        v_feat=bernoulli_keep(gen, keep, (batch, L, H)),
        global_feat=bernoulli_keep(gen, keep, (batch, E)),
        out=bernoulli_keep(gen, keep, (batch, H)),
        logit=bernoulli_keep(gen, keep, (batch, V)),
        lstm=(lstm_dropout_masks(gen, H + 2 * E, cfg.hidden_dim, rate, batch=batch),
              lstm_dropout_masks(gen, 2 * H, cfg.hidden_dim, rate, batch=batch)))


def init_params(gen: torch.Generator, vocab_size: int, cfg):
    """Decoder params on the CPU, shapes and init laws of the JAX package."""
    E, H, D = cfg.embedding_dim, cfg.hidden_dim, cfg.img_feature_dim
    return {
        "embedding": _uniform(gen, (vocab_size, E), math.sqrt(6.0 / (vocab_size + E))),
        "image_features": dense_init(gen, D, H),
        "global_img_feature": dense_init(gen, D, E),
        "td_lstm": lstm_init(gen, H + 2 * E, H),
        "lang_lstm": lstm_init(gen, 2 * H, H),
        "attn": {
            "W_va": attn_weight_init(gen, (H, H)),
            "W_ha": attn_weight_init(gen, (H, H)),
            "W_a": attn_weight_init(gen, (H, 1)),
            "W_x": attn_weight_init(gen, (H + 2 * E, H)),
            "W_h": attn_weight_init(gen, (H, H)),
            "W_s": attn_weight_init(gen, (H, H)),
        },
        "output": dense_init(gen, H, vocab_size),
    }


def prepare_consts(params, feat_grid: torch.Tensor) -> GridTDConsts:
    v_pre = feat_grid @ params["image_features"]["kernel"] + params["image_features"]["bias"]
    v_feat = torch.relu(v_pre)
    avg = feat_grid.mean(dim=1)
    g_pre = avg @ params["global_img_feature"]["kernel"] + params["global_img_feature"]["bias"]
    return GridTDConsts(
        v_feat=v_feat,
        v_proj=v_feat @ params["attn"]["W_va"],
        global_feat=torch.relu(g_pre),
        v_pre=v_pre,
        global_pre=g_pre,
        feat_grid=feat_grid,
        avg_feat=avg,
    )


def step(params, consts: GridTDConsts, state: GridTDState, token_emb: torch.Tensor,
         lstm_masks: GridTDDropoutMasks | None = None):
    """One decoder step; returns (new_state, GridTDStepCache). ``lstm_masks``
    (training) turns on Keras-style dropout in both LSTMs and the masks on
    h2 + c_hat and on the logits; ``consts`` then holds the dropped features."""
    a = params["attn"]
    td_masks, lang_masks = (None, None) if lstm_masks is None else lstm_masks.lstm
    h1, c1, h2, c2 = state
    x1_t = torch.cat([h2, consts.global_feat, token_emb], dim=-1)
    td_state, td_cache = lstm_step(params["td_lstm"], x1_t, LSTMState(h1, c1), td_masks)
    h1_new, c1_new = td_state
    h_proj = h1_new @ a["W_ha"]
    att_pre = torch.tanh(consts.v_proj + h_proj[:, None, :])
    att_logits = (att_pre @ a["W_a"]).squeeze(-1)                   # (B, L)
    attention = torch.softmax(att_logits, dim=-1)
    st = torch.tanh(c1_new) * torch.sigmoid(x1_t @ a["W_x"] + h1 @ a["W_h"])
    z_s = torch.tanh(st @ a["W_s"] + h_proj) @ a["W_a"]
    beta = torch.softmax(torch.cat([att_logits, z_s], dim=-1), dim=-1)[:, -1:]
    context = torch.einsum("bl,blh->bh", attention, consts.v_feat)
    c_hat = beta * st + (1.0 - beta) * context
    x2_t = torch.cat([c_hat, h1_new], dim=-1)
    lang_state, lang_cache = lstm_step(params["lang_lstm"], x2_t, LSTMState(h2, c2), lang_masks)
    h2_new, c2_new = lang_state
    if lstm_masks is None:
        logits = dense(params["output"], h2_new + c_hat)
    else:
        logits = dense(params["output"], (h2_new + c_hat) * lstm_masks.out) * lstm_masks.logit
    cache = GridTDStepCache(
        x1_t=x1_t, x2_t=x2_t, h1_prev=h1, c1_prev=c1, h2_prev=h2, c2_prev=c2,
        h1=h1_new, c1=c1_new, h2=h2_new, c2=c2_new,
        z1_pre=td_cache.z_pre, z2_pre=lang_cache.z_pre,
        attention=attention, st=st, beta=beta, context=context, c_hat=c_hat, logits=logits,
    )
    return GridTDState(h1_new, c1_new, h2_new, c2_new), cache


def init_state(batch: int, hidden: int, dtype=torch.float32, *, device=None) -> GridTDState:
    return GridTDState(*(torch.zeros((batch, hidden), device=device, dtype=dtype)
                         for _ in range(4)))


def forward_train(params, feat_grid: torch.Tensor, captions_in: torch.Tensor, cfg,
                  generator: torch.Generator | None = None, drop_rate: float = 0.0,
                  *, masks: GridTDDropoutMasks | None = None) -> torch.Tensor:
    """Teacher forcing: (B, L, D) features + (B, T) 0-based ids -> (B, T, V)
    logits (model.py:630-660).

    Dropout, as the JAX package places it: on the image features (v_proj
    recomputed from the dropped v_feat) and the global feature, in both
    LSTMs (per-sequence masks at input widths H + 2E and 2H), on h2 + c_hat
    and on the logits. The masks are ``masks`` when given, else drawn from
    ``generator`` when ``drop_rate > 0``; with neither there is no dropout."""
    if masks is not None and not isinstance(masks, GridTDDropoutMasks):
        raise TypeError(f"grid-TD takes GridTDDropoutMasks, got {type(masks).__name__}")
    B, T = captions_in.shape
    consts = prepare_consts(params, feat_grid)
    if masks is None and generator is not None and drop_rate > 0.0:
        masks = draw_dropout_masks(generator, params, B, cfg, drop_rate)
    if masks is not None:
        v_feat = consts.v_feat * masks.v_feat
        consts = consts._replace(v_feat=v_feat, global_feat=consts.global_feat * masks.global_feat,
                                 v_proj=v_feat @ params["attn"]["W_va"])
    embs = params["embedding"][captions_in]                             # (B, T, E)
    state = init_state(B, cfg.hidden_dim, embs.dtype, device=embs.device)
    logits = []
    for t in range(T):
        state, cache = step(params, consts, state, embs[:, t], masks)
        logits.append(cache.logits)
    return torch.stack(logits, dim=1)                                  # (B, T, V)


def forward_cached_from_inputs(params, consts: GridTDConsts, input_tokens_0based: torch.Tensor,
                               hidden_dim: int) -> GridTDStepCache:
    """The step over precomputed 0-based input tokens (B, T), keeping every
    cache: a GridTDStepCache of (T, B, ...) tensors."""
    B, T = input_tokens_0based.shape
    embs = params["embedding"][input_tokens_0based]                 # (B, T, E)
    state = init_state(B, hidden_dim, embs.dtype, device=embs.device)
    caches = []
    for t in range(T):
        state, cache = step(params, consts, state, embs[:, t])
        caches.append(cache)
    return GridTDStepCache(*(torch.stack(f, dim=0) for f in zip(*caches)))
