"""Plain PyTorch reference of the explanation: the decoder's LRP (the
epsilon rule with bias factor 0 and stabilizer 1e-7, through the
adaptive-attention decoder of one word at a time, back through time) and
the CNN's LRPSequentialPresetA (alpha1beta0 on every conv, the signed image
layer by the split rule, winner-take-all on every max pool), after
SunJiamei/LRP-ImageCaptioning's explainers.py:537-666 and iNNvestigate's
relevance_rule.py. Imports nothing of the program.

``store`` is where a run rounds what it keeps: identity for the float32
reference, a cast for a control in a lower precision.
"""

from __future__ import annotations

import torch

from .model import conv3x3, conv3x3_transpose, decode, vgg_forward, vgg_ops

EPS = 1e-7


def stab(z: torch.Tensor) -> torch.Tensor:
    return z + torch.where(z >= 0, EPS, -EPS).to(z.dtype)


def eps_linear(r, x, z, w):
    """Relevance of x through z = x @ w (+ b): x * ((r / stab(z)) @ w^T)."""
    return x * ((r / stab(z)) @ w.T)


def eps_identity(r, x, z):
    return x * r / stab(z)


def decoder_lrp_adaptive(dec, feat, tokens1, sos1: int, n_words: int):
    """The adaptive decoder's LRP of the first ``n_words`` words of each row.

    feat (B, L, D); tokens1 (B, T) 1-based caption ids (0 after EOS). Returns
    r_feat (B, n, L, D), r_words (B, n, T) (SOS column zeroed, then each
    row over its largest |value|), attentions (B, n, L), betas (B, n)."""
    B, T = tokens1.shape
    prev = torch.cat([torch.full((B, 1), sos1, dtype=torch.long, device=tokens1.device),
                      tokens1[:, :-1].long()], dim=1)
    logits, steps, k = decode(dec, feat, (prev - 1).clamp(min=0), "adaptiveattention")
    E = dec["embedding"].shape[1]
    H = dec["output"]["kernel"].shape[0]
    w_out = dec["output"]["kernel"]
    wi, wh = dec["lstm"]["wi"], dec["lstm"]["wh"]
    w_g = torch.cat([wi[:, 2 * H:3 * H], wh[:, 2 * H:3 * H]], dim=0)
    L = feat.shape[1]
    out_feat, out_words, out_att, out_beta = [], [], [], []
    for t in range(n_words):
        s = steps[t]
        word = (tokens1[:, t].long() - 1).clamp(min=0)
        lg = s["logits"]
        seed = torch.zeros_like(lg)
        seed.scatter_(1, word[:, None], lg.gather(1, word[:, None]))
        hc = s["h"] + s["c_hat"]
        r_hc = eps_linear(seed, hc, lg, w_out)
        r_h = eps_identity(r_hc, s["h"], hc)
        r_chat = eps_identity(r_hc, s["c_hat"], hc)
        r_ctx = eps_identity(r_chat, (1.0 - s["beta"]) * s["ctx"], s["c_hat"])
        r_st = eps_identity(r_chat, s["beta"] * s["st"], s["c_hat"])
        r_c_next, r_h_next = r_st, r_h
        r_global = feat.new_zeros((B, E))
        r_words = feat.new_zeros((B, T))
        for i in range(t, -1, -1):
            si = steps[i]
            zi = si["z"]
            ig, fg, g_pre = torch.sigmoid(zi[:, :H]), torch.sigmoid(zi[:, H:2 * H]), zi[:, 2 * H:3 * H]
            r_c = r_c_next + r_h_next
            r_g = eps_identity(r_c, ig * torch.tanh(g_pre), si["c"])
            r_c_prev = eps_identity(r_c, fg * si["c_prev"], si["c"])
            r_xh = eps_linear(r_g, torch.cat([si["x"], si["h_prev"]], dim=-1), g_pre, w_g)
            r_global = r_global + r_xh[:, E:2 * E]
            r_words[:, i] = r_xh[:, :E].sum(dim=-1)
            r_c_next, r_h_next = r_c_prev, r_xh[:, 2 * E:]
        r_avg = eps_linear(r_global, k["avg"], k["g_pre"], dec["global_img_feature"]["kernel"])
        r_from_avg = eps_identity(r_avg[:, None, :], feat / L, k["avg"][:, None, :])
        r_v = eps_identity(r_ctx[:, None, :], s["alpha"][:, :, None] * k["v_feat"],
                           s["ctx"][:, None, :])
        r_from_v = eps_linear(r_v, feat, k["v_pre"], dec["image_features"]["kernel"])
        r_words[:, 0] = 0.0
        r_words = r_words / (r_words.abs().amax(dim=-1, keepdim=True) + 1e-12)
        out_feat.append(r_from_avg + r_from_v)
        out_words.append(r_words)
        out_att.append(s["alpha"])
        out_beta.append(s["beta"][:, 0])
    return (torch.stack(out_feat, 1), torch.stack(out_words, 1), torch.stack(out_att, 1),
            torch.stack(out_beta, 1))


def _safe(z: torch.Tensor) -> torch.Tensor:
    return z + (z == 0).to(z.dtype) * EPS


def wta_pool(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Relevance through a 2x2 max pool: each output's share split equally
    among the window's maxima. r (N, h, w, C), x (1 or N, 2h, 2w, C)."""
    n, h, w, C = r.shape
    xw = x.reshape(x.shape[0], h, 2, w, 2, C)
    hit = (xw == xw.amax(dim=(2, 4), keepdim=True)).to(r.dtype)
    share = r.reshape(n, h, 1, w, 1, C) / hit.sum(dim=(2, 4), keepdim=True)
    return (hit * share).reshape(n, 2 * h, 2 * w, C)


def cnn_lrp_preset_a(vgg, image, seeds, arch: str, until: str, store=None):
    """LRPSequentialPresetA of one image for many seeds.

    image (1, H, W, 3); seeds (N, h, w, C) at ``until`` -> (N, H, W, 3).
    ``store(t)`` rounds every kept tensor (params, activations, the
    denominators, quotients and relevances); None keeps float32."""
    q = store or (lambda t: t)
    vgg = {k: {n: q(t) for n, t in v.items()} for k, v in vgg.items()}
    _, inputs = vgg_forward(vgg, q(image), arch, until, keep_inputs=True)
    inputs = [q(x) for x in inputs]
    ops = vgg_ops(arch, until)
    r = q(seeds)
    for idx, (op, x) in enumerate(zip(reversed(ops), reversed(inputs))):
        if op[0] == "pool":
            r = q(wta_pool(r, x))
            continue
        k, b = vgg[op[1]]["kernel"], vgg[op[1]]["bias"]
        kp, kn = k.clamp(min=0), k.clamp(max=0)
        if idx < len(ops) - 1:
            # post-ReLU input: x >= 0, z takes the whole bias
            z = q(conv3x3(x, kp) + b)
            s = q(r / _safe(z))
            r = q(x * conv3x3_transpose(s, kp))
        else:
            xp, xn = x.clamp(min=0), x.clamp(max=0)
            z = conv3x3(xp, kp) + b.clamp(min=0) + conv3x3(xn, kn) + b.clamp(max=0)
            s = r / _safe(z)
            r = xp * conv3x3_transpose(s, kp) + xn * conv3x3_transpose(s, kn)
    return r
