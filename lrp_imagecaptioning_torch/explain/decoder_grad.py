"""Decoder-side gradient backward (manual BPTT) of the gradient-family
explanation methods, batched over (image x word) rows as the decoder LRP is
(``explain/decoder_lrp.py``). It reproduces the reference's
``_lstm_decoder_backward`` with its deliberate simplifications
(explainers.py:780-832 for adaptive, 1452-1532 for grid-TD):

* the attention weights are constants (no gradient through the softmax or
  the attention MLP);
* adaptive: d_context = d_c_hat with the (1 - beta) factor dropped, and the
  sentinel branch gets no gradient (explainers.py:797-800);
* d_V is zeroed where ``image_features <= 0`` (explainers.py:803-804), the
  global feature's gradient where it is <= 0 (explainers.py:826);
* the seed is d(logit of the explained word) = 1.

Plain torch ops under no_grad, as the JAX package has no kernel here.
"""

from __future__ import annotations

import torch

from ..ops.kernels import lstm_gates_vjp
from .decoder_lrp import _rows


def _feat_grad(params, consts, b_idx, d_global, d_V):
    """d(feature grid) from the global feature's and V's gradients, both
    relu-masked: the mean's share over the L cells plus V's through W_img."""
    glob = consts.global_feat[b_idx]
    d_global = torch.where(glob <= 0, torch.zeros_like(d_global), d_global)
    d_avg = d_global @ params["global_img_feature"]["kernel"].T     # (R, D)
    L = consts.feat_grid.shape[1]
    d_feat = d_avg[:, None, :].expand(-1, L, -1) / L
    return d_feat + d_V @ params["image_features"]["kernel"].T


def grad_word_adaptive(params, consts, caches, words_0based: torch.Tensor,
                       positions: torch.Tensor | None = None):
    """Gradient of each row's word logit with respect to the CNN feature grid,
    reference semantics; arguments and returns as ``explain_word_adaptive``:
    (d_feat (B, W, L, D), d_words (B, W, T), attention (B, W, L))."""
    T, B, H = caches.h.shape
    E = params["embedding"].shape[-1]
    dev, dtype = caches.h.device, caches.h.dtype
    W, b_idx, t_idx = _rows(B, T, positions, dev)
    R = B * W
    wi, wh = params["lstm"]["wi"], params["lstm"]["wh"]

    def at_t(field):
        return field[t_idx, b_idx]

    # d(logit_word) / d(h + c_hat): the word's column of W_out
    d_hc = params["output"]["kernel"].T[words_0based.reshape(R).long()]   # (R, H)
    attention_t = at_t(caches.attention)
    d_V = attention_t[:, :, None] * d_hc[:, None, :]             # d_context = d_c_hat
    d_V = torch.where(consts.v_feat[b_idx] <= 0, torch.zeros_like(d_V), d_V)

    zero = torch.zeros((), device=dev, dtype=dtype)
    d_ht_next = torch.zeros((R, H), device=dev, dtype=dtype)
    d_ct_next = torch.zeros_like(d_ht_next)
    d_global = torch.zeros((R, E), device=dev, dtype=dtype)
    d_words = torch.zeros((R, T), device=dev, dtype=dtype)
    for i in range(T - 1, -1, -1):
        active = (t_idx >= i)[:, None]
        is_seed = (t_idx == i)[:, None]
        d_ht_next = torch.where(is_seed, d_hc, d_ht_next)
        d_ct_next = torch.where(is_seed, zero, d_ct_next)
        # one LSTM step back: K2's closed-form gradient, no cotangent on z_pre
        d_gates, _, d_ct_prev = lstm_gates_vjp(caches.z_pre[i][b_idx], caches.c_prev[i][b_idx],
                                               caches.c[i][b_idx], 0.0, d_ht_next, d_ct_next)
        d_xt = d_gates @ wi.T                                     # (R, 2E)
        d_global = d_global + torch.where(active, d_xt[:, E:], zero)
        d_words[:, i] = torch.where(active[:, 0], d_xt[:, :E].sum(dim=-1), zero)
        d_ht_next = torch.where(active, d_gates @ wh.T, zero)
        d_ct_next = torch.where(active, d_ct_prev, zero)

    d_feat = _feat_grad(params, consts, b_idx, d_global, d_V)
    L = d_feat.shape[1]
    return d_feat.reshape(B, W, L, -1), d_words.reshape(B, W, T), attention_t.reshape(B, W, L)


def grad_word_gridtd(params, consts, caches, words_0based: torch.Tensor,
                     positions: torch.Tensor | None = None):
    """grid-TD reference gradient backward (explainers.py:1452-1532), batched
    as ``grad_word_adaptive``. The seed reaches h2 only at step t; c_hat gets
    gradient only through the language-LSTM input; the context keeps the
    (1 - beta) factor, but the beta * st sentinel branch gets none
    (explainers.py:1506-1527); attention constant; relu masks on V and the
    global feature."""
    T, B, H = caches.h1.shape
    E = params["embedding"].shape[-1]
    dev, dtype = caches.h1.device, caches.h1.dtype
    W, b_idx, t_idx = _rows(B, T, positions, dev)
    R = B * W
    td, lang = params["td_lstm"], params["lang_lstm"]

    def at_t(field):
        return field[t_idx, b_idx]

    d_h2_T = params["output"]["kernel"].T[words_0based.reshape(R).long()]   # (R, H)
    v_dead = consts.v_feat[b_idx] <= 0                            # (R, L, H)

    zero = torch.zeros((), device=dev, dtype=dtype)
    d_h2_next = torch.zeros((R, H), device=dev, dtype=dtype)
    d_c2_next = torch.zeros_like(d_h2_next)
    d_h1_next = torch.zeros_like(d_h2_next)
    d_c1_next = torch.zeros_like(d_h2_next)
    d_V = torch.zeros(v_dead.shape, device=dev, dtype=dtype)
    d_global = torch.zeros((R, E), device=dev, dtype=dtype)
    d_words = torch.zeros((R, T), device=dev, dtype=dtype)
    for i in range(T - 1, -1, -1):
        active = (t_idx >= i)[:, None]
        is_seed = (t_idx == i)[:, None]
        d_h2_next = torch.where(is_seed, d_h2_T, d_h2_next)
        d_c2_next = torch.where(is_seed, zero, d_c2_next)

        def step_of(field):
            return field[i][b_idx]

        d_gates2, _, d_c2_prev = lstm_gates_vjp(step_of(caches.z2_pre), step_of(caches.c2_prev),
                                                step_of(caches.c2), 0.0, d_h2_next, d_c2_next)
        d_x2 = d_gates2 @ lang["wi"].T                            # (R, 2H): [c_hat, h1]
        d_context = d_x2[:, :H] * (1.0 - step_of(caches.beta))
        d_V_i = step_of(caches.attention)[:, :, None] * d_context[:, None, :]
        d_V_i = torch.where(v_dead, zero, d_V_i)
        d_V = d_V + torch.where(active[:, :, None], d_V_i, zero)

        d_gates1, _, d_c1_prev = lstm_gates_vjp(step_of(caches.z1_pre), step_of(caches.c1_prev),
                                                step_of(caches.c1), 0.0, d_h1_next + d_x2[:, H:],
                                                d_c1_next)
        d_x1 = d_gates1 @ td["wi"].T                              # (R, H + 2E): [h2, g, e]
        d_global = d_global + torch.where(active, d_x1[:, H:H + E], zero)
        d_words[:, i] = torch.where(active[:, 0], d_x1[:, H + E:H + 2 * E].sum(dim=-1), zero)
        d_h2_next = torch.where(active, d_gates2 @ lang["wh"].T + d_x1[:, :H], zero)
        d_c2_next = torch.where(active, d_c2_prev, zero)
        d_h1_next = torch.where(active, d_gates1 @ td["wh"].T, zero)
        d_c1_next = torch.where(active, d_c1_prev, zero)

    d_feat = _feat_grad(params, consts, b_idx, d_global, d_V)
    L = d_feat.shape[1]
    return (d_feat.reshape(B, W, L, -1), d_words.reshape(B, W, T),
            at_t(caches.attention).reshape(B, W, L))
