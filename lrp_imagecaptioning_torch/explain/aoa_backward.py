"""Decoder backward passes for the AOA decoder, batched over (image x word)
rows.

The port of the JAX package's ``explain/aoa_backward.py`` (the reference has
no AOA explainer; the JAX package extends its conventions to it):

* ``explain_word_aoa`` — epsilon-LRP with the softmax attention and the AOA
  GLU gate held constant; LayerNorm and the refinement blocks pass the
  relevance unchanged. The multi-head attended value splits its relevance
  over L by the head-mean attention (exact when the heads agree), as the
  JAX package does. Every matrix step goes through the ``lrp_linear``
  kernel (K1): the output layer, the GLU projection over [q; hat], v_proj
  over L rows a word, q_proj, the gate-g block of each BPTT step and
  ``image_features`` on the layer-normed grid: T + 5 launches a pass.
* ``grad_word_aoa`` — the true gradient d(logit of the word)/d(feature
  grid), by autograd over a recomputed forward of every row.

Both take the arguments and give the returns of
``decoder_lrp.explain_word_adaptive``.
"""

from __future__ import annotations

import torch

from ..models import aoa
from ..ops.kernels import lrp_linear
from ..ops.lrp_core import lrp_identity
from .decoder_lrp import _gate_g_block, _output_seed, _rows


def explain_word_aoa(params, consts, caches, words_0based: torch.Tensor,
                     positions: torch.Tensor | None = None):
    """AOA LRP of every caption word of every image, or of the steps
    ``positions`` -> (r_feat (B, W, L, D), r_words (B, W, T), attention (B, W, L))."""
    T, B, H = caches.h.shape
    E = params["embedding"].shape[-1]
    dev, dtype = caches.h.device, caches.h.dtype
    W, b_idx, t_idx = _rows(B, T, positions, dev)
    R = B * W
    w_g = _gate_g_block(params["lstm"])
    g = params["glu"]

    def at_t(field):
        return field[t_idx, b_idx]

    logits_t = at_t(caches.logits)
    seed = _output_seed(logits_t, words_0based, R)
    h_t, ctx_t = at_t(caches.h), at_t(caches.context)
    out = ctx_t + h_t
    r_out = lrp_linear(seed, out, logits_t, params["output"]["kernel"])
    r_ctx = lrp_identity(r_out, ctx_t, out)
    r_h_seed = lrp_identity(r_out, h_t, out)

    # GLU: context = gate * proj with the gate constant, so the relevance
    # flows to proj = q Wpq + hat Wph + bp, one linear over [q; hat]
    q_t, hat_t = at_t(caches.q), at_t(caches.hat)
    w_proj = torch.cat([g["Wpq"], g["Wph"]], dim=0).contiguous()         # (2H, H)
    r_qh = lrp_linear(r_ctx, torch.cat([q_t, hat_t], dim=-1), at_t(caches.proj_pre), w_proj)
    r_q, r_hat = r_qh[:, :H].contiguous(), r_qh[:, H:]

    # the attended value over L by the head-mean attention, then v_proj
    attention_t = at_t(caches.attention)                                 # (R, L)
    v_feat = consts.v_feat[b_idx]                                        # (R, L, H)
    v_proj = consts.v_proj[b_idx]
    r_vproj = lrp_identity(r_hat[:, None, :], attention_t[:, :, None] * v_proj,
                           hat_t[:, None, :])
    r_vfeat_from_hat = lrp_linear(r_vproj, v_feat, v_proj, params["v_proj"]["kernel"])

    # q = h Wq + bq: more relevance into h at step t
    r_h_T = r_h_seed + lrp_linear(r_q, h_t, q_t, params["q_proj"]["kernel"])

    # BPTT, gate-g path only, i = T-1 .. 0
    zero = torch.zeros((), device=dev, dtype=dtype)
    r_ct_next = torch.zeros((R, H), device=dev, dtype=dtype)
    r_ht_next = torch.zeros_like(r_ct_next)
    r_global = torch.zeros_like(r_ct_next)
    r_words = torch.zeros((R, T), device=dev, dtype=dtype)
    for i in range(T - 1, -1, -1):
        active = (t_idx >= i)[:, None]
        is_seed = (t_idx == i)[:, None]
        r_ht_next = torch.where(is_seed, r_h_T, r_ht_next)
        r_ct_next = torch.where(is_seed, zero, r_ct_next)
        z_i = caches.z_pre[i][b_idx]
        g_pre = z_i[:, 2 * H:3 * H].contiguous()
        c_i = caches.c[i][b_idx]
        r_c = r_ct_next + r_ht_next
        r_gt = lrp_identity(r_c, torch.sigmoid(z_i[:, :H]) * torch.tanh(g_pre), c_i)
        r_ct_prev = lrp_identity(r_c, torch.sigmoid(z_i[:, H:2 * H]) * caches.c_prev[i][b_idx], c_i)
        xht = torch.cat([caches.x_t[i], caches.h_prev[i]], dim=-1)[b_idx]
        r_xht = lrp_linear(r_gt, xht, g_pre, w_g)
        r_global = r_global + torch.where(active, r_xht[:, E:E + H], zero)
        r_words[:, i] = torch.where(active[:, 0], r_xht[:, :E].sum(dim=-1), zero)
        r_ct_next = torch.where(active, r_ct_prev, zero)
        r_ht_next = torch.where(active, r_xht[:, E + H:], zero)

    # the global feature is the mean over L of v_feat
    L = v_feat.shape[1]
    r_vfeat = r_vfeat_from_hat + lrp_identity(r_global[:, None, :], v_feat / L,
                                              consts.global_feat[b_idx][:, None, :])
    # image_features' input is the layer-normed grid: the rule re-weights by
    # it, and the LayerNorm then passes the relevance to the grid unchanged
    feat = consts.feat_grid[b_idx]
    x_ln = aoa.layer_norm(feat, params["feat_ln"]["scale"], params["feat_ln"]["bias"])
    r_feat = lrp_linear(r_vfeat, x_ln, consts.v_pre[b_idx], params["image_features"]["kernel"])
    return (r_feat.reshape(B, W, L, -1), r_words.reshape(B, W, T), attention_t.reshape(B, W, L))


def grad_word_aoa(params, consts, caches, words_0based: torch.Tensor,
                  positions: torch.Tensor | None = None):
    """The true gradient of each row's word logit wrt its image's feature
    grid: the decoder rerun from the cached input embeddings over all rows
    at once (each row its own sequence), then one backward of the rows'
    summed logits. r_words are zeros, as in the JAX package."""
    T, B, H = caches.h.shape
    E = params["embedding"].shape[-1]
    dev = caches.h.device
    W, b_idx, t_idx = _rows(B, T, positions, dev)
    R = B * W
    inputs = caches.x_t[:, b_idx, :E]                                    # (T, R, E)
    word = words_0based.reshape(R).long()
    with torch.enable_grad():
        feat = consts.feat_grid[b_idx].detach().requires_grad_(True)
        c = aoa.prepare_consts(params, feat)
        state = aoa.init_state(R, H, feat.dtype, device=dev)
        picked = torch.zeros(R, device=dev, dtype=feat.dtype)
        for i in range(T):
            state, cache = aoa.step(params, c, state, inputs[i])
            at_i = cache.logits.gather(1, word[:, None])[:, 0]
            picked = picked + torch.where(t_idx == i, at_i, torch.zeros_like(at_i))
        (d_feat,) = torch.autograd.grad(picked.sum(), feat)
    L = d_feat.shape[1]
    return (d_feat.reshape(B, W, L, -1),
            torch.zeros((B, W, T), device=dev, dtype=d_feat.dtype),
            caches.attention[t_idx, b_idx].reshape(B, W, L))
