"""Plain PyTorch reference of the two captioners the benchmark runs.

VGG16 (or VGG19) up to a tapped conv, then the adaptive-attention decoder
(Lu et al., 2017, "Knowing When to Look") or the grid-TD decoder (Anderson
et al., 2018, top-down attention over the grid with a visual sentinel), as
SunJiamei/LRP-ImageCaptioning builds them (model.py). Written from the
published equations in plain torch ops: NHWC images, HWIO kernels, Keras
LSTM gate order [i, f, g, o] with sigmoid and tanh. No kernel, cache or
graph of the program is used, and nothing here imports it.

The reference proper runs in float32 with TF32 off (its caller sets the
flags); the controls run it, or parts of it, one precision lower.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

VGG_BLOCKS = {
    "vgg16": [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)],
    "vgg19": [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512)],
}


def vgg_ops(arch: str, until: str) -> list:
    """[('conv', name, cin, cout) | ('pool', name)] of ``arch`` up to ``until``."""
    ops, cin = [], 3
    for block, n, ch in VGG_BLOCKS[arch]:
        for i in range(1, n + 1):
            name = f"block{block}_conv{i}"
            ops.append(("conv", name, cin, ch))
            cin = ch
            if name == until:
                return ops
        ops.append(("pool", f"block{block}_pool"))
    raise ValueError(f"{until} is not a conv of {arch}")


def conv3x3(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv, NHWC input, HWIO kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_transpose(r: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The transpose of ``conv3x3`` applied to ``r`` (its input gradient)."""
    y = F.conv_transpose2d(r.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def vgg_forward(params: dict, images: torch.Tensor, arch: str, until: str,
                keep_inputs: bool = False):
    """-> features at ``until`` (B, h, w, C); with ``keep_inputs`` also the
    input of every op, in order."""
    x, inputs = images, []
    for op in vgg_ops(arch, until):
        inputs.append(x)
        if op[0] == "pool":
            x = maxpool2(x)
        else:
            p = params[op[1]]
            x = torch.relu(conv3x3(x, p["kernel"]) + p["bias"])
    return (x, inputs) if keep_inputs else x


# -- parameters ---------------------------------------------------------------


@dataclass(frozen=True)
class Sizes:
    model: str          # 'adaptiveattention' | 'gridTD'
    arch: str           # 'vgg16' | 'vgg19'
    until: str
    E: int
    H: int
    L: int
    D: int
    V: int
    image: int


def param_layout(s: Sizes) -> dict:
    """The params tree as (shape, law) leaves, the layout the program takes
    (``{'vgg': ..., 'decoder': ...}``). Laws: ('glorot', fan_in, fan_out),
    ('zeros',), ('forget_one', H) (an LSTM bias: 1 on the forget block)."""
    E, H, D, V = s.E, s.H, s.D, s.V
    vgg = {}
    for op in vgg_ops(s.arch, s.until):
        if op[0] == "conv":
            _, name, cin, cout = op
            vgg[name] = {"kernel": ((3, 3, cin, cout), ("glorot", 9 * cin, 9 * cout)),
                         "bias": ((cout,), ("zeros",))}

    def dense(i, o):
        return {"kernel": ((i, o), ("glorot", i, o)), "bias": ((o,), ("zeros",))}

    def lstm(i):
        return {"wi": ((i, 4 * H), ("glorot", i, 4 * H)), "wh": ((H, 4 * H), ("glorot", H, 4 * H)),
                "b": ((4 * H,), ("forget_one", H))}

    def w(i, o):
        return ((i, o), ("glorot", i, o))

    dec = {"embedding": ((V, E), ("glorot", V, E)), "image_features": dense(D, H),
           "global_img_feature": dense(D, E), "output": dense(H, V)}
    if s.model == "adaptiveattention":
        dec["lstm"] = lstm(2 * E)
        dec["attn"] = {"Wv": w(H, H), "Wg": w(H, H), "Wx": w(2 * E, H), "Wh": w(H, H),
                       "Ws": w(H, H), "V": w(H, 1)}
    else:
        dec["td_lstm"] = lstm(H + 2 * E)
        dec["lang_lstm"] = lstm(2 * H)
        dec["attn"] = {"W_va": w(H, H), "W_ha": w(H, H), "W_a": w(H, 1), "W_x": w(H + 2 * E, H),
                       "W_h": w(H, H), "W_s": w(H, H)}
    return {"vgg": vgg, "decoder": dec}


def leaves(tree, prefix=""):
    """[(path, tensor)] of a nested dict, in its insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(leaves(v, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", v))
    return out


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# -- decoders -------------------------------------------------------------------


def lstm_cell(p, x, h, c, masks=None):
    """One Keras LSTM step; ``masks`` (x_masks (4, B, in), h_masks (4, B, H))
    drop the input and the state gate by gate."""
    if masks is None:
        z = x @ p["wi"] + h @ p["wh"] + p["b"]
    else:
        xm, hm = masks
        wi, wh = p["wi"].chunk(4, dim=-1), p["wh"].chunk(4, dim=-1)
        z = (torch.cat([(x * xm[g]) @ wi[g] for g in range(4)], dim=-1)
             + torch.cat([(h * hm[g]) @ wh[g] for g in range(4)], dim=-1) + p["b"])
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    h_new = torch.sigmoid(zo) * torch.tanh(c_new)
    return h_new, c_new, z


def image_consts(dec, feat, masks, model):
    """(v_pre, v_feat, v_proj, avg, g_pre, g_feat) of a (B, L, D) grid; the
    dropout masks (when training) on v_feat and on the global feature."""
    v_pre = feat @ dec["image_features"]["kernel"] + dec["image_features"]["bias"]
    v_feat = torch.relu(v_pre)
    avg = feat.mean(dim=1)
    g_pre = avg @ dec["global_img_feature"]["kernel"] + dec["global_img_feature"]["bias"]
    g_feat = torch.relu(g_pre)
    if masks is not None:
        v_feat = v_feat * masks["v_feat"]
        g_feat = g_feat * masks["global_feat"]
    wv = dec["attn"]["Wv" if model == "adaptiveattention" else "W_va"]
    return v_pre, v_feat, v_feat @ wv, avg, g_pre, g_feat


def decode(dec, feat, inputs0, model, masks=None):
    """Teacher-forced decoder over 0-based input ids (B, T) -> (logits (B, T,
    V), per-step record list). The record keeps what the LRP reads."""
    B, T = inputs0.shape
    H = dec["output"]["kernel"].shape[0]
    v_pre, v_feat, v_proj, avg, g_pre, g_feat = image_consts(dec, feat, masks, model)
    emb = dec["embedding"][inputs0]
    zeros = feat.new_zeros((B, H))
    h, c, h2, c2 = zeros, zeros, zeros, zeros
    a = dec["attn"]
    logits, steps = [], []
    for t in range(T):
        if model == "adaptiveattention":
            x = torch.cat([emb[:, t], g_feat], dim=-1)
            h_new, c_new, z = lstm_cell(dec["lstm"], x, h, c, None if masks is None
                                        else masks["lstm"])
            hp = h_new @ a["Wg"]
            att_logit = (torch.tanh(hp[:, None, :] + v_proj) @ a["V"])[..., 0]
            alpha = torch.softmax(att_logit, dim=-1)
            st = torch.tanh(c_new) * torch.sigmoid(x @ a["Wx"] + h @ a["Wh"])
            zs = torch.tanh(st @ a["Ws"] + hp) @ a["V"]
            beta = torch.softmax(torch.cat([att_logit, zs], dim=-1), dim=-1)[:, -1:]
            ctx = (alpha[:, :, None] * v_feat).sum(dim=1)
            c_hat = beta * st + (1.0 - beta) * ctx
            out_in = h_new + c_hat
            steps.append(dict(x=x, h_prev=h, c_prev=c, h=h_new, c=c_new, z=z, alpha=alpha,
                              st=st, beta=beta, ctx=ctx, c_hat=c_hat))
            h, c = h_new, c_new
        else:
            x1 = torch.cat([h2, g_feat, emb[:, t]], dim=-1)
            m1, m2 = (None, None) if masks is None else masks["lstm"]
            h1n, c1n, z1 = lstm_cell(dec["td_lstm"], x1, h, c, m1)
            hp = h1n @ a["W_ha"]
            att_logit = (torch.tanh(v_proj + hp[:, None, :]) @ a["W_a"])[..., 0]
            alpha = torch.softmax(att_logit, dim=-1)
            st = torch.tanh(c1n) * torch.sigmoid(x1 @ a["W_x"] + h @ a["W_h"])
            zs = torch.tanh(st @ a["W_s"] + hp) @ a["W_a"]
            beta = torch.softmax(torch.cat([att_logit, zs], dim=-1), dim=-1)[:, -1:]
            ctx = (alpha[:, :, None] * v_feat).sum(dim=1)
            c_hat = beta * st + (1.0 - beta) * ctx
            x2 = torch.cat([c_hat, h1n], dim=-1)
            h2n, c2n, z2 = lstm_cell(dec["lang_lstm"], x2, h2, c2, m2)
            out_in = h2n + c_hat
            steps.append(dict(alpha=alpha, beta=beta))
            h, c, h2, c2 = h1n, c1n, h2n, c2n
        if masks is not None:
            out_in = out_in * masks["out"]
        lg = out_in @ dec["output"]["kernel"] + dec["output"]["bias"]
        if masks is not None:
            lg = lg * masks["logit"]
        steps[-1]["logits"] = lg
        logits.append(lg)
    consts = dict(v_pre=v_pre, v_feat=v_feat, avg=avg, g_pre=g_pre, feat=feat)
    return torch.stack(logits, dim=1), steps, consts


def masked_ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy over (B, T - 1): the last step dropped, an
    all-zero label row (padding) adding 0; the mean over B x (T - 1)."""
    lg, yy = logits[:, :-1], y[:, :-1].to(logits.dtype)
    return -(yy * torch.log_softmax(lg, dim=-1)).sum(-1).mean()


def mask_layout(s: Sizes, B: int) -> dict:
    """Shapes of one training forward's dropout masks (inverted dropout,
    1 / keep or 0), the layout both sides take."""
    E, H, L, V = s.E, s.H, s.L, s.V
    if s.model == "adaptiveattention":
        lstm = ((4, B, 2 * E), (4, B, H))
    else:
        lstm = (((4, B, H + 2 * E), (4, B, H)), ((4, B, 2 * H), (4, B, H)))
    return {"v_feat": (B, L, H), "global_feat": (B, E), "out": (B, H), "logit": (B, V),
            "lstm": lstm}


def draw_masks(s: Sizes, B: int, rate: float, gen: torch.Generator, device) -> dict:
    """One forward's masks from ``gen``: one ``rand`` for all of them."""
    shapes = mask_layout(s, B)
    flat = []

    def walk(x):
        if isinstance(x[0], int):
            flat.append(x)
        else:
            for y in x:
                walk(y)

    for k in ("v_feat", "global_feat", "out", "logit"):
        flat.append(shapes[k])
    walk(shapes["lstm"])
    sizes = [math.prod(sh) for sh in flat]
    keep = 1.0 - rate
    u = torch.rand(sum(sizes), generator=gen, device=device)
    m = (u < keep).float() / keep
    parts = [p.reshape(sh) for p, sh in zip(torch.split(m, sizes), flat)]
    out = dict(zip(("v_feat", "global_feat", "out", "logit"), parts[:4]))
    rest = parts[4:]
    out["lstm"] = (tuple(rest) if s.model == "adaptiveattention"
                   else ((rest[0], rest[1]), (rest[2], rest[3])))
    return out


def mask_rows(m: dict, rows: slice) -> dict:
    """The masks of rows ``rows`` of the batch (the LSTM masks' batch axis
    is their second)."""
    def lstm(x):
        return x[:, rows] if isinstance(x, torch.Tensor) else tuple(lstm(y) for y in x)

    return {k: (lstm(v) if k == "lstm" else v[rows]) for k, v in m.items()}
