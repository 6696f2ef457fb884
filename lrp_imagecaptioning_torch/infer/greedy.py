"""Greedy decoding with carried LSTM state.

The caller encodes the images once and passes the feature grid; the decoder
then steps T times, each step feeding back its argmax. The loop works in
0-based model space; the output is in 1-based tokenizer space (+1), with 0
after the first EOS.
"""

from __future__ import annotations

import torch


def greedy_decode(captioner, params, feat_grid: torch.Tensor, sos_id_1based: int,
                  eos_id_1based: int, max_len: int = 20):
    """feat_grid (B, L, D) -> (tokens_1based (B, max_len), logits (B, max_len, V)).

    Tokens after the first EOS are 0 (padding); the EOS itself is kept.
    ``argmax`` takes the first maximal index, as ``jnp.argmax`` does."""
    dec = captioner.decoder
    consts = captioner.prepare_consts(params, feat_grid)
    B = feat_grid.shape[0]
    emb = params["decoder"]["embedding"]
    state = dec.init_state(B, captioner.cfg.hidden_dim, feat_grid.device, feat_grid.dtype)
    token0 = torch.full((B,), sos_id_1based - 1, dtype=torch.long, device=feat_grid.device)
    done = torch.zeros(B, dtype=torch.bool, device=feat_grid.device)
    tokens, logits = [], []
    for _ in range(max_len):
        state, cache = dec.step(params["decoder"], consts, state, emb[token0])
        token0 = cache.logits.argmax(dim=-1)
        tokens.append(torch.where(done, torch.zeros_like(token0), token0 + 1))
        done = done | (token0 + 1 == eos_id_1based)
        logits.append(cache.logits)
    return torch.stack(tokens, dim=1), torch.stack(logits, dim=1)
