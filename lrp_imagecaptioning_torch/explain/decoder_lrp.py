"""Decoder-side LRP for the adaptive-attention model, batched over
(image x word) rows.

The math of the reference's numpy BPTT relevance loop
(explainers.py:537-666), over the per-step caches of
``models.adaptive.forward_cached_from_inputs``. Every word position t of
every image is one row r = b*T + t; the reverse loop over steps injects a
row's seed at i == t and masks the steps i > t, so one fixed-length loop
serves every word. The four matrix steps (output layer, gate-g block,
W_glob, W_img) go through the ``lrp_linear`` kernel; the identity-weight
steps are elementwise. bias_factor = 0; stabilizer eps = 1e-7.
"""

from __future__ import annotations

import torch

from ..ops.kernels import lrp_linear
from ..ops.lrp_core import lrp_identity


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
    W = T if positions is None else positions.shape[1]
    R = B * W
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, W).reshape(R)   # row -> image
    if positions is None:
        t_idx = torch.arange(T, device=dev).repeat(B)          # row -> explained step
    else:
        t_idx = positions.reshape(R).long()
    a_wi, a_wh = params["lstm"]["wi"], params["lstm"]["wh"]
    # gate-g weight block: rows [x; h], columns g
    w_g = torch.cat([a_wi[:, 2 * H:3 * H], a_wh[:, 2 * H:3 * H]], dim=0).contiguous()

    def at_t(field):
        return field[t_idx, b_idx]                             # (R, ...)

    logits_t = at_t(caches.logits)
    word = words_0based.reshape(R, 1).long()
    seed = torch.zeros_like(logits_t).scatter_(1, word, logits_t.gather(1, word))

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
