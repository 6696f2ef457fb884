"""Plain PyTorch reference of what each timed entry computes: one image's
explanation, a train step and an LRP-inference fine-tune step, each with
Adam as Keras configures it (element-wise clip, then the moments, bias
correction by the step count, eps outside the root). Imports nothing of
the program.
"""

from __future__ import annotations

import torch

from .lrp import cnn_lrp_preset_a, decoder_lrp_adaptive
from .model import decode, leaves, masked_ce, tree_map, vgg_forward


def encode(vgg, images, s):
    f = vgg_forward(vgg, images, s.arch, s.until)
    return f.reshape(f.shape[0], s.L, s.D)


def explain(params, images, tokens1, n_words, s, sos1, store=None, dec_dtype=None):
    """The explanation of each row: images (B, H, W, 3), tokens1 (B, T)
    1-based, ``n_words`` the words explained (a row's words beyond its own
    caption are computed and not read). Returns (maps (B, n, H, W, 3),
    r_feat (B, n, L, D), r_words (B, n, T), attentions (B, n, L), betas
    (B, n)). ``dec_dtype`` runs the encoder and the decoder in that dtype,
    ``store`` rounds the CNN LRP's tensors (the controls)."""
    vgg, dec = params["vgg"], params["decoder"]
    if dec_dtype is not None:
        vgg, dec = (tree_map(lambda t: t.to(dec_dtype), p) for p in (vgg, dec))
        images = images.to(dec_dtype)
    feat = encode(vgg, images, s)
    r_feat, r_words, att, beta = (o.float() for o in decoder_lrp_adaptive(dec, feat, tokens1, sos1,
                                                                         n_words))
    g = int(round(s.L ** 0.5))
    maps = torch.stack([
        cnn_lrp_preset_a(params["vgg"], images[b:b + 1].float(),
                         r_feat[b].reshape(n_words, g, g, s.D), s.arch, s.until, store)
        for b in range(images.shape[0])])
    return maps, r_feat, r_words, att, beta


class Adam:
    """Adam with Keras' ``clipvalue``: g clipped to [-c, c] element-wise."""

    def __init__(self, lr, b1, b2, eps, clipvalue):
        self.lr, self.b1, self.b2, self.eps, self.c = lr, b1, b2, eps, clipvalue

    def init(self, params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def step(self, params, grads, state):
        n = state["count"] + 1
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32).item() ** n
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32).item() ** n

        def one(p, g, m, v):
            g = g.clamp(-self.c, self.c)
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * g * g + self.b2 * v
            return p - self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps), m, v

        paths = [k for k, _ in leaves(params)]
        new = [one(p, g, m, v) for (_, p), (_, g), (_, m), (_, v) in zip(
            leaves(params), leaves(grads), leaves(state["mu"]), leaves(state["nu"]))]
        return (_unflat(params, paths, [x[0] for x in new]),
                {"count": n, "mu": _unflat(params, paths, [x[1] for x in new]),
                 "nu": _unflat(params, paths, [x[2] for x in new])})


def _unflat(like, paths, values):
    out = tree_map(lambda t: None, like)
    for path, v in zip(paths, values):
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node[k]
        node[last] = v
    return out


def value_and_grad(loss_fn, params):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = loss_fn(p)
    grads = torch.autograd.grad(loss, [t for _, t in leaves(p)])
    paths = [k for k, _ in leaves(p)]
    return loss.detach(), _unflat(params, paths, list(grads))


def train_loss(params, images, captions_in, y, masks, s):
    feat = encode(params["vgg"], images, s)
    logits, _, _ = decode(params["decoder"], feat, captions_in.long(), s.model, masks)
    return masked_ce(logits, y)


def train_step(params, state, opt, images, captions_in, y, masks, s):
    """-> (params, state, loss, clipped gradient as Adam takes it)."""
    loss, g = value_and_grad(lambda p: train_loss(p, images, captions_in, y, masks, s), params)
    new, state = opt.step(params, g, state)
    return new, state, loss, tree_map(lambda t: t.clamp(-opt.c, opt.c), g)


@torch.no_grad()
def relevance_weights(params, images, captions_in, s, stop1, sos1, eos1):
    """The fine-tune's (B, T, V) weights: the teacher-forced prediction's
    words; each word that is not a stop word and comes before the first
    EOS is explained (decoder and CNN LRP, float32); its map's channel mean
    over its largest |value| gives the mean as its score; the weight is
    1 + score at (step, word), 1 elsewhere. ``stop1`` (V + 1,) bool."""
    B, T = captions_in.shape
    feat = encode(params["vgg"], images, s)
    logits, _, _ = decode(params["decoder"], feat, captions_in.long(), s.model)
    words1 = logits.argmax(-1) + 1
    r_feat = decoder_lrp_adaptive(params["decoder"], feat, words1, sos1, T)[0]
    g = int(round(s.L ** 0.5))
    scores = []
    for b in range(B):
        m = cnn_lrp_preset_a(params["vgg"], images[b:b + 1], r_feat[b].reshape(T, g, g, s.D),
                             s.arch, s.until).mean(-1).flatten(1)
        top = m.abs().amax(dim=1, keepdim=True)
        scores.append(torch.where(top == 0, torch.zeros_like(m), m / top.clamp(min=1e-38))
                      .mean(1))
    scores = torch.stack(scores)
    valid = ~stop1.to(words1.device)[words1] & ~(torch.cumsum((words1 == eos1).int(), 1) > 0)
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    onehot = torch.nn.functional.one_hot(words1 - 1, s.V).to(scores.dtype)
    return 1.0 + onehot * scores[:, :, None]


def finetune_step(params, state, opt, images, captions_in, y, masks, s, stop1, sos1, eos1):
    """-> (params, state, loss, clipped gradient): the dual loss
    0.5 CE(y, logits) + 0.5 CE(y, logits * weights) under dropout."""
    w = relevance_weights(params, images, captions_in, s, stop1, sos1, eos1)

    def loss_fn(p):
        feat = encode(p["vgg"], images, s)
        logits, _, _ = decode(p["decoder"], feat, captions_in.long(), s.model, masks)
        return 0.5 * masked_ce(logits, y) + 0.5 * masked_ce(logits * w, y)

    loss, g = value_and_grad(loss_fn, params)
    new, state = opt.step(params, g, state)
    return new, state, loss, tree_map(lambda t: t.clamp(-opt.c, opt.c), g)
