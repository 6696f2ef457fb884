"""AOA (Attention-on-Attention) captioning decoder.

The port of the JAX package's ``models/aoa.py``, its working version of the
reference's commented-out model (model.py:828-1250). Step math, batched
over B:

    x_t     = [e_t, g]                     g = mean over L of the features
    h', c'  = LSTM(x_t, h, c)              (the ``lstm_gates`` kernel, K2)
    q       = h' Wq + bq
    per head i: a_i = softmax(q_i K_i^T / sqrt(d_k)); hat_i = a_i V_i
    hat     = concat_i hat_i
    ctx     = sigmoid(q Wgq + hat Wgh + bg) * (q Wpq + hat Wph + bp)   (AOA GLU)
    logit   = W_out (ctx + h') + b_out

The features are the layer-normed grid through ``image_features`` and a
ReLU, optionally refined by ``encoder_refine_num`` self-attention AOA blocks
(0 in the captioner, as in the JAX package); K/V are their projections,
computed once per image. Layer normalization stands where the reference
interleaves Keras BatchNormalization (the JAX package's documented choice).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cells import (LSTMState, _uniform, attn_weight_init, bernoulli_keep, dense, dense_init,
                    lstm_dropout_masks, lstm_init, lstm_step)

NUM_HEADS = 8


class AOAConsts(NamedTuple):
    v_feat: torch.Tensor       # (B, L, H) refined image features
    k_proj: torch.Tensor       # (B, L, H)
    v_proj: torch.Tensor       # (B, L, H)
    global_feat: torch.Tensor  # (B, H) mean over L of v_feat
    feat_grid: torch.Tensor    # (B, L, D)
    v_pre: torch.Tensor        # (B, L, H) image_features pre-relu


class AOAStepCache(NamedTuple):
    x_t: torch.Tensor        # (B, E + H)
    h_prev: torch.Tensor
    c_prev: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor
    z_pre: torch.Tensor      # (B, 4H)
    q: torch.Tensor          # (B, H)
    attention: torch.Tensor  # (B, L) head-mean attention
    hat: torch.Tensor        # (B, H)
    gate: torch.Tensor       # (B, H)
    proj_pre: torch.Tensor   # (B, H) GLU projection before the gate
    context: torch.Tensor    # (B, H)
    logits: torch.Tensor     # (B, V)


class AOADropoutMasks(NamedTuple):
    """The inverted-dropout masks of one training forward (1/keep or 0),
    where the JAX package's ``forward_train`` draws them (its key split
    ``ks = split(rng, 4)`` in this field order)."""

    v_feat: torch.Tensor   # (B, L, H) on the features (K/V and g recomputed from them)
    out: torch.Tensor      # (B, H) on ctx + h before the output layer
    logit: torch.Tensor    # (B, V) on the logits
    lstm: tuple            # (x_masks (4, B, E + H), h_masks (4, B, H)), all steps

    def to(self, *args, **kwargs) -> "AOADropoutMasks":
        """Every mask through ``Tensor.to(*args, **kwargs)``."""
        return AOADropoutMasks(*(f.to(*args, **kwargs) for f in self[:3]),
                               lstm=tuple(m.to(*args, **kwargs) for m in self.lstm))


def draw_dropout_masks(gen: torch.Generator, params, batch: int, cfg, rate: float):
    """Fresh masks for one forward from ``gen`` (on the params' device)."""
    keep = 1.0 - rate
    E = params["embedding"].shape[-1]
    H, V = params["output"]["kernel"].shape
    return AOADropoutMasks(
        v_feat=bernoulli_keep(gen, keep, (batch, cfg.img_feature_length, H)),
        out=bernoulli_keep(gen, keep, (batch, H)),
        logit=bernoulli_keep(gen, keep, (batch, V)),
        lstm=lstm_dropout_masks(gen, E + H, cfg.hidden_dim, rate, batch=batch))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _glu_init(gen, H):
    return {"Wpq": attn_weight_init(gen, (H, H)), "Wph": attn_weight_init(gen, (H, H)),
            "bp": torch.zeros(H), "Wgq": attn_weight_init(gen, (H, H)),
            "Wgh": attn_weight_init(gen, (H, H)), "bg": torch.zeros(H)}


def init_params(gen: torch.Generator, vocab_size: int, cfg, encoder_refine_num: int = 0):
    """Decoder params on the CPU, shapes and init laws of the JAX package."""
    E, H, D = cfg.embedding_dim, cfg.hidden_dim, cfg.img_feature_dim
    params = {
        "embedding": _uniform(gen, (vocab_size, E), math.sqrt(6.0 / (vocab_size + E))),
        "image_features": dense_init(gen, D, H),
        "feat_ln": {"scale": torch.ones(D), "bias": torch.zeros(D)},
        "lstm": lstm_init(gen, E + H, H),
        "k_proj": dense_init(gen, H, H),
        "v_proj": dense_init(gen, H, H),
        "q_proj": dense_init(gen, H, H),
        "glu": _glu_init(gen, H),
        "output": dense_init(gen, H, vocab_size),
        "refine": [],
    }
    for _ in range(encoder_refine_num):
        params["refine"].append({"q": dense_init(gen, H, H), "k": dense_init(gen, H, H),
                                 "v": dense_init(gen, H, H), "glu": _glu_init(gen, H),
                                 "ln": {"scale": torch.ones(H), "bias": torch.zeros(H)}})
    return params


def _multi_head(q, k, v, num_heads=NUM_HEADS):
    """q (B, Lq, H), k / v (B, L, H) -> (attended (B, Lq, H), head-mean
    attention (B, Lq, L))."""
    B, Lq, H = q.shape
    L = k.shape[1]
    dk = H // num_heads
    qh = q.reshape(B, Lq, num_heads, dk).transpose(1, 2)
    kh = k.reshape(B, L, num_heads, dk).transpose(1, 2)
    vh = v.reshape(B, L, num_heads, dk).transpose(1, 2)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(dk), dim=-1)   # (B, h, Lq, L)
    out = (attn @ vh).transpose(1, 2).reshape(B, Lq, H)
    return out, attn.mean(dim=1)


def _glu(g, q, hat):
    """(gate, projection) of the AOA GLU over [q; hat]."""
    gate = torch.sigmoid(q @ g["Wgq"] + hat @ g["Wgh"] + g["bg"])
    return gate, q @ g["Wpq"] + hat @ g["Wph"] + g["bp"]


def _refine_block(p, x):
    """Self-attention AOA refinement over the features (MultiHeadAttention.
    call, model.py:885-952): residual + layer norm."""
    hat, _ = _multi_head(dense(p["q"], x), dense(p["k"], x), dense(p["v"], x))
    gate, proj = _glu(p["glu"], x, hat)
    return layer_norm(gate * proj + x, p["ln"]["scale"], p["ln"]["bias"])


def prepare_consts(params, feat_grid: torch.Tensor) -> AOAConsts:
    """Encoder-side projections, run once per image. feat_grid: (B, L, D)."""
    x = layer_norm(feat_grid, params["feat_ln"]["scale"], params["feat_ln"]["bias"])
    v_pre = dense(params["image_features"], x)
    v_feat = torch.relu(v_pre)
    for block in params["refine"]:
        v_feat = _refine_block(block, v_feat)
    return _with_features(params, AOAConsts(v_feat, None, None, None, feat_grid, v_pre), v_feat)


def _with_features(params, consts: AOAConsts, v_feat) -> AOAConsts:
    """``consts`` with the features ``v_feat`` and their K, V and mean."""
    return consts._replace(v_feat=v_feat, k_proj=dense(params["k_proj"], v_feat),
                           v_proj=dense(params["v_proj"], v_feat), global_feat=v_feat.mean(dim=1))


def step(params, consts: AOAConsts, state: LSTMState, token_emb: torch.Tensor,
         lstm_masks: AOADropoutMasks | None = None):
    """One decoder step; returns (new_state, AOAStepCache). ``lstm_masks``
    (training) turns on the LSTM's dropout and the masks on ctx + h and on
    the logits; ``consts`` then holds the dropped features."""
    h_prev, c_prev = state
    x_t = torch.cat([token_emb, consts.global_feat], dim=-1)
    new_state, lstm_cache = lstm_step(params["lstm"], x_t, state,
                                      None if lstm_masks is None else lstm_masks.lstm)
    h = new_state.h
    q = dense(params["q_proj"], h)                                      # (B, H)
    hat, attn = _multi_head(q[:, None, :], consts.k_proj, consts.v_proj)
    hat, attention = hat[:, 0], attn[:, 0]
    gate, proj = _glu(params["glu"], q, hat)
    context = gate * proj
    if lstm_masks is None:
        logits = dense(params["output"], context + h)
    else:
        logits = dense(params["output"], (context + h) * lstm_masks.out) * lstm_masks.logit
    cache = AOAStepCache(x_t=x_t, h_prev=h_prev, c_prev=c_prev, h=h, c=new_state.c,
                         z_pre=lstm_cache.z_pre, q=q, attention=attention, hat=hat, gate=gate,
                         proj_pre=proj, context=context, logits=logits)
    return new_state, cache


def init_state(batch: int, hidden: int, dtype=torch.float32, *, device=None) -> LSTMState:
    zeros = torch.zeros((batch, hidden), device=device, dtype=dtype)
    return LSTMState(zeros, zeros.clone())


def forward_train(params, feat_grid: torch.Tensor, captions_in: torch.Tensor, cfg,
                  generator: torch.Generator | None = None, drop_rate: float = 0.0,
                  *, masks: AOADropoutMasks | None = None) -> torch.Tensor:
    """Teacher forcing: (B, L, D) features + (B, T) 0-based ids -> (B, T, V)
    logits. Dropout on the features (K, V and g recomputed from the dropped
    ones), the LSTM's input and state (per-sequence masks), ctx + h and the
    logits: ``masks`` when given, else drawn from ``generator`` when
    ``drop_rate > 0``; with neither there is no dropout."""
    B, T = captions_in.shape
    consts = prepare_consts(params, feat_grid)
    if masks is None and generator is not None and drop_rate > 0.0:
        masks = draw_dropout_masks(generator, params, B, cfg, drop_rate)
    if masks is not None:
        consts = _with_features(params, consts, consts.v_feat * masks.v_feat)
    embs = params["embedding"][captions_in]
    state = init_state(B, cfg.hidden_dim, embs.dtype, device=embs.device)
    logits = []
    for t in range(T):
        state, cache = step(params, consts, state, embs[:, t], masks)
        logits.append(cache.logits)
    return torch.stack(logits, dim=1)


def forward_cached_from_inputs(params, consts: AOAConsts, input_tokens_0based: torch.Tensor,
                               hidden_dim: int) -> AOAStepCache:
    """The step over precomputed 0-based input tokens (B, T), every cache
    kept: an AOAStepCache of (T, B, ...) tensors."""
    B, T = input_tokens_0based.shape
    embs = params["embedding"][input_tokens_0based]
    state = init_state(B, hidden_dim, embs.dtype, device=embs.device)
    caches = []
    for t in range(T):
        state, cache = step(params, consts, state, embs[:, t])
        caches.append(cache)
    return AOAStepCache(*(torch.stack(f, dim=0) for f in zip(*caches)))
