"""The inputs of a run, made from its seed: the weights (on the device, in a
few large draws, in the layout ``reference.model.param_layout`` gives),
image pools, captions of natural lengths and training batches, and the
dropout masks. Both the program and the reference take what is made here.

The caption lengths of every pool are one fixed multiset (the quantiles of
the mix's normal law, rounded and clipped) put in an order drawn from the
seed, so every seed hands the program the same amount of work; the seed
draws the images, the words and the order."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

from perfbench.reference.model import leaves, param_layout

SOS, EOS, FIRST_WORD = 1, 2, 3      # 1-based ids: 'szeros', 'zeros', then the words


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for sub-stream ``stream`` of ``seed`` (any
    size of seed: it is hashed to 63 bits)."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), stream]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def make_params(sizes, seed: int, device) -> dict:
    """Every weight from one uniform draw on ``device``: glorot-uniform
    kernels and embedding, zero biases, the LSTM forget bias 1."""
    layout = param_layout(sizes)
    flat = leaves(layout)
    total = sum(math.prod(shape) for _, (shape, law) in flat if law[0] == "glorot")
    u = torch.rand(total, generator=generator(seed, 0, device), device=device) * 2.0 - 1.0
    out, at = {}, 0
    for path, (shape, law) in flat:
        n = math.prod(shape)
        if law[0] == "glorot":
            t = u[at:at + n].reshape(shape) * math.sqrt(6.0 / (law[1] + law[2]))
            at += n
        else:
            t = torch.zeros(shape, device=device)
            if law[0] == "forget_one":
                t[law[1]:2 * law[1]] = 1.0
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t.contiguous()
    return out


def natural_lengths(n: int, law: dict) -> np.ndarray:
    """The fixed multiset of ``n`` caption lengths: the normal law's
    quantiles at (i + 1/2) / n, rounded and clipped to [min, max]."""
    dist = NormalDist(law["mean"], law["std"])
    q = [dist.inv_cdf((i + 0.5) / n) for i in range(n)]
    return np.clip(np.round(q), law["min"], law["max"]).astype(np.int64)


def captions(n: int, law: dict, vocab: int, T: int, gen: torch.Generator):
    """(tokens (n, T) 1-based int64 on the host: the words, then EOS where
    the caption is shorter than T, then 0; lengths (n,)), the lengths
    ``natural_lengths`` in an order drawn from ``gen``."""
    lengths = natural_lengths(n, law)
    order = torch.randperm(n, generator=gen, device=gen.device).cpu().numpy()
    lengths = lengths[order]
    words = torch.randint(FIRST_WORD, vocab + 1, (n, T), generator=gen,
                          device=gen.device).cpu().numpy()
    pos = np.arange(T)[None, :]
    toks = np.where(pos < lengths[:, None], words, 0)
    toks = np.where(pos == lengths[:, None], EOS, toks)
    return toks.astype(np.int64), lengths


def images(n: int, size: int, gen: torch.Generator) -> torch.Tensor:
    """(n, size, size, 3) standard-normal images on the generator's device."""
    return torch.randn((n, size, size, 3), generator=gen, device=gen.device)


def training_batch(tokens1: np.ndarray, width: int, vocab: int, device):
    """The provider's training arrays from 1-based captions (words, EOS, 0):
    captions_in (B, width) 0-based ids of [SOS, words, EOS] (0 after), and
    y_onehot (B, width, vocab) float32: the next token's one-hot, zero rows
    past the caption."""
    B = tokens1.shape[0]
    full = np.zeros((B, width), np.int64)
    full[:, 0] = SOS
    n = min(tokens1.shape[1], width - 1)
    full[:, 1:n + 1] = tokens1[:, :n]
    nxt = np.zeros_like(full)
    nxt[:, :-1] = full[:, 1:]
    cap_in = torch.as_tensor(np.where(full > 0, full - 1, 0), device=device)
    nxt_t = torch.as_tensor(nxt, device=device)
    y = torch.nn.functional.one_hot((nxt_t - 1).clamp(min=0), vocab).float()
    y = y * (nxt_t > 0).float()[..., None]
    return cap_in, y
