"""Decoder-side LRP for the adaptive-attention and grid-TD models, batched
over (image x word) rows.

The math of the reference's numpy BPTT relevance loop
(explainers.py:537-666), over the per-step caches of
``models.adaptive.forward_cached_from_inputs``. Every word position t of
every image is one row r = b*T + t; the reverse loop over steps injects a
row's seed at i == t and masks the steps i > t, so one fixed-length loop
serves every word. The four matrix steps (output layer, gate-g block,
W_glob, W_img) go through the ``lrp_linear`` kernel; the identity-weight
steps are elementwise. bias_factor = 0; stabilizer eps = 1e-7.

grid-TD (``explain_word_gridtd``, the reference's explainers.py:1190-1321)
threads the relevance through the language-LSTM gate and then the TD-LSTM
gate each step: 2 T + 3 ``lrp_linear`` launches a pass (the output layer,
the two gate blocks a step, W_glob, W_img).
"""

from __future__ import annotations

import torch

from ..ops.kernels import lrp_linear
from ..ops.lrp_core import lrp_identity


def _rows(B: int, T: int, positions: torch.Tensor | None, dev):
    """(W, row -> image, row -> explained step) for B images."""
    W = T if positions is None else positions.shape[1]
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, W).reshape(B * W)
    if positions is None:
        t_idx = torch.arange(T, device=dev).repeat(B)
    else:
        t_idx = positions.reshape(B * W).long()
    return W, b_idx, t_idx


def _gate_g_block(lstm) -> torch.Tensor:
    """The g-gate columns of [wi; wh]: the weight of the gate-g product."""
    H = lstm["wh"].shape[0]
    return torch.cat([lstm["wi"][:, 2 * H:3 * H], lstm["wh"][:, 2 * H:3 * H]], dim=0).contiguous()


def _output_seed(logits_t, words_0based, R):
    """The relevance seed: the explained word's logit, zero elsewhere."""
    word = words_0based.reshape(R, 1).long()
    return torch.zeros_like(logits_t).scatter_(1, word, logits_t.gather(1, word))


def explain_word_adaptive(params, consts, caches, words_0based: torch.Tensor,
                          positions: torch.Tensor | None = None):
    """LRP of every caption word of every image, or of the steps ``positions``.

    Args:
      params: adaptive decoder params.
      consts: AdaptiveConsts with batch B.
      caches: AdaptiveStepCache of (T, B, ...) tensors.
      words_0based: (B, W) the word to explain at each row, in model space;
        W = T, one per step, when ``positions`` is None.
      positions: (B, W) the step of each row, or None for every step (W = T).

    Returns:
      (r_feat (B, W, L, D), r_words (B, W, T), attention (B, W, L)): for row w
      of image b (the word at step positions[b, w], or at step w), the
      relevance of the CNN feature grid, the per-input-word relevance over
      steps, and the attention at that step.
    """
    T, B, H = caches.h.shape
    E = params["embedding"].shape[-1]
    dev, dtype = caches.h.device, caches.h.dtype
    W, b_idx, t_idx = _rows(B, T, positions, dev)
    R = B * W
    w_g = _gate_g_block(params["lstm"])       # rows [x; h], columns g

    def at_t(field):
        return field[t_idx, b_idx]                             # (R, ...)

    logits_t = at_t(caches.logits)
    seed = _output_seed(logits_t, words_0based, R)

    # output layer: z = W_out (h + c_hat) + b
    h_t, c_hat_t = at_t(caches.h), at_t(caches.c_hat)
    hc = h_t + c_hat_t
    r_hc = lrp_linear(seed, hc, logits_t, params["output"]["kernel"])
    r_ht_T = lrp_identity(r_hc, h_t, hc)
    r_chat = lrp_identity(r_hc, c_hat_t, hc)
    beta, context_t = at_t(caches.beta), at_t(caches.context)
    r_context = lrp_identity(r_chat, (1.0 - beta) * context_t, c_hat_t)
    r_st = lrp_identity(r_chat, beta * at_t(caches.st), c_hat_t)

    # BPTT, i = T-1 .. 0
    r_ct_next = torch.zeros((R, H), device=dev, dtype=dtype)
    r_ht_next = torch.zeros((R, H), device=dev, dtype=dtype)
    r_global = torch.zeros((R, E), device=dev, dtype=dtype)
    r_words = torch.zeros((R, T), device=dev, dtype=dtype)
    for i in range(T - 1, -1, -1):
        active = (t_idx >= i)[:, None]
        is_seed = (t_idx == i)[:, None]
        r_ct_next = torch.where(is_seed, r_st, r_ct_next)
        r_ht_next = torch.where(is_seed, r_ht_T, r_ht_next)
        z_i = caches.z_pre[i][b_idx]
        i_act = torch.sigmoid(z_i[:, :H])
        f_act = torch.sigmoid(z_i[:, H:2 * H])
        g_pre = z_i[:, 2 * H:3 * H].contiguous()
        c_i = caches.c[i][b_idx]
        r_c = r_ct_next + r_ht_next
        r_gt = lrp_identity(r_c, i_act * torch.tanh(g_pre), c_i)
        r_ct_prev = lrp_identity(r_c, f_act * caches.c_prev[i][b_idx], c_i)
        xht = torch.cat([caches.x_t[i], caches.h_prev[i]], dim=-1)[b_idx]
        r_xht = lrp_linear(r_gt, xht, g_pre, w_g)
        zero = torch.zeros((), device=dev, dtype=dtype)
        r_global = r_global + torch.where(active, r_xht[:, E:2 * E], zero)
        r_words[:, i] = torch.where(active[:, 0], r_xht[:, :E].sum(dim=-1), zero)
        r_ct_next = torch.where(active, r_ct_prev, zero)
        r_ht_next = torch.where(active, r_xht[:, 2 * E:], zero)

    # global image feature -> average feature -> grid
    feat = consts.feat_grid[b_idx]                              # (R, L, D)
    L = feat.shape[1]
    avg = consts.avg_feat[b_idx]
    r_avg = lrp_linear(r_global, avg, consts.global_pre[b_idx],
                       params["global_img_feature"]["kernel"])
    r_feat_from_avg = lrp_identity(r_avg[:, None, :], feat / L, avg[:, None, :])
    # context -> attention-weighted V, batched over L
    attention_t = at_t(caches.attention)
    r_V = lrp_identity(r_context[:, None, :], attention_t[:, :, None] * consts.v_feat[b_idx],
                       context_t[:, None, :])                   # (R, L, H)
    r_feat_from_V = lrp_linear(r_V, feat, consts.v_pre[b_idx], params["image_features"]["kernel"])
    r_feat = r_feat_from_avg + r_feat_from_V
    return (r_feat.reshape(B, W, L, -1), r_words.reshape(B, W, T),
            attention_t.reshape(B, W, L))


def explain_word_gridtd(params, consts, caches, words_0based: torch.Tensor,
                        positions: torch.Tensor | None = None):
    """grid-TD LRP of every caption word of every image, or of the steps
    ``positions``; the arguments and the returns are those of
    ``explain_word_adaptive`` (caches: GridTDStepCache of (T, B, ...)).

    The relevance threads h2 -> c_hat -> {sentinel -> c1, context -> V}
    through the language-LSTM gate and then the TD-LSTM gate each step; the
    context's relevance is emitted at every step and V's accumulates over
    time (explainers.py:1292-1299)."""
    T, B, H = caches.h1.shape
    E = params["embedding"].shape[-1]
    dev, dtype = caches.h1.device, caches.h1.dtype
    W, b_idx, t_idx = _rows(B, T, positions, dev)
    R = B * W
    w_g1 = _gate_g_block(params["td_lstm"])     # (H + 2E + H, H)
    w_g2 = _gate_g_block(params["lang_lstm"])   # (2H + H, H)

    def at_t(field):
        return field[t_idx, b_idx]

    logits_t = at_t(caches.logits)
    seed = _output_seed(logits_t, words_0based, R)
    h2_t, c_hat_t = at_t(caches.h2), at_t(caches.c_hat)
    hc = h2_t + c_hat_t
    r_hc = lrp_linear(seed, hc, logits_t, params["output"]["kernel"])
    r_h2_T = lrp_identity(r_hc, h2_t, hc)
    r_chat_T = lrp_identity(r_hc, c_hat_t, hc)

    zero = torch.zeros((), device=dev, dtype=dtype)
    r_c2_next = torch.zeros((R, H), device=dev, dtype=dtype)
    r_h2_next = torch.zeros_like(r_c2_next)
    r_c1_next = torch.zeros_like(r_c2_next)
    r_h1_next = torch.zeros_like(r_c2_next)
    r_chat_i = torch.zeros_like(r_c2_next)
    r_global = torch.zeros((R, E), device=dev, dtype=dtype)
    r_words = torch.zeros((R, T), device=dev, dtype=dtype)
    v_feat = consts.v_feat[b_idx]                              # (R, L, H)
    r_V = torch.zeros_like(v_feat)
    for i in range(T - 1, -1, -1):
        active = (t_idx >= i)[:, None]
        is_seed = (t_idx == i)[:, None]
        r_h2_next = torch.where(is_seed, r_h2_T, r_h2_next)
        r_chat_i = torch.where(is_seed, r_chat_T, r_chat_i)

        def step_of(field):
            return field[i][b_idx]

        z2, z1 = step_of(caches.z2_pre), step_of(caches.z1_pre)
        # language LSTM backward (explainers.py:1240-1262)
        c2_i = step_of(caches.c2)
        g2 = z2[:, 2 * H:3 * H].contiguous()
        r_c2 = r_c2_next + r_h2_next
        r_g2 = lrp_identity(r_c2, torch.sigmoid(z2[:, :H]) * torch.tanh(g2), c2_i)
        r_c2_prev = lrp_identity(r_c2, torch.sigmoid(z2[:, H:2 * H]) * step_of(caches.c2_prev), c2_i)
        xht2 = torch.cat([caches.x2_t[i], caches.h2_prev[i]], dim=-1)[b_idx]   # (R, 3H)
        r_xht2 = lrp_linear(r_g2, xht2, g2, w_g2)
        r_chat = r_chat_i + r_xht2[:, :H]

        # adaptive split (explainers.py:1263-1277)
        beta, c_hat_i = step_of(caches.beta), step_of(caches.c_hat)
        context_i = step_of(caches.context)
        r_st = lrp_identity(r_chat, beta * step_of(caches.st), c_hat_i)
        r_ctx = lrp_identity(r_chat, (1.0 - beta) * context_i, c_hat_i)

        # TD LSTM backward (explainers.py:1279-1299)
        c1_i = step_of(caches.c1)
        g1 = z1[:, 2 * H:3 * H].contiguous()
        r_c1 = r_c1_next + r_st + r_h1_next + r_xht2[:, H:2 * H]
        r_g1 = lrp_identity(r_c1, torch.sigmoid(z1[:, :H]) * torch.tanh(g1), c1_i)
        r_c1_prev = lrp_identity(r_c1, torch.sigmoid(z1[:, H:2 * H]) * step_of(caches.c1_prev), c1_i)
        xht1 = torch.cat([caches.x1_t[i], caches.h1_prev[i]], dim=-1)[b_idx]   # (R, 2H + 2E)
        r_xht1 = lrp_linear(r_g1, xht1, g1, w_g1)

        # V's relevance emitted this step, summed over time
        r_V_i = lrp_identity(r_ctx[:, None, :], step_of(caches.attention)[:, :, None] * v_feat,
                             context_i[:, None, :])
        r_V = r_V + torch.where(active[:, :, None], r_V_i, zero)
        r_global = r_global + torch.where(active, r_xht1[:, H:H + E], zero)
        r_words[:, i] = torch.where(active[:, 0], r_xht1[:, H + E:H + 2 * E].sum(dim=-1), zero)
        r_c2_next = torch.where(active, r_c2_prev, zero)
        r_h2_next = torch.where(active, r_xht2[:, 2 * H:] + r_xht1[:, :H], zero)
        r_c1_next = torch.where(active, r_c1_prev, zero)
        r_h1_next = torch.where(active, r_xht1[:, H + 2 * E:], zero)
        r_chat_i = torch.zeros_like(r_chat)

    feat = consts.feat_grid[b_idx]                              # (R, L, D)
    L = feat.shape[1]
    avg = consts.avg_feat[b_idx]
    r_avg = lrp_linear(r_global, avg, consts.global_pre[b_idx],
                       params["global_img_feature"]["kernel"])
    r_feat_from_avg = lrp_identity(r_avg[:, None, :], feat / L, avg[:, None, :])
    r_feat_from_V = lrp_linear(r_V, feat, consts.v_pre[b_idx], params["image_features"]["kernel"])
    r_feat = r_feat_from_avg + r_feat_from_V
    return (r_feat.reshape(B, W, L, -1), r_words.reshape(B, W, T),
            at_t(caches.attention).reshape(B, W, L))
