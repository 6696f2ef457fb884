"""Batched beam search with the reference's selection semantics
(inference.py:159-264):

* beams are pooled per step and the global top-k of all beam x vocab
  candidates is kept, ties broken to the lowest index;
* scores are cumulative log-softmax, never length-normalized;
* only beam 0 is live at t = 0 (the reference seeds ONE partial caption);
* a candidate ending in EOS records its PARENT sentence + EOS as a complete
  caption, but only when EOS is among that beam's own top-k words; partial
  beams keep expanding past EOS;
* the answer is the best complete caption if any exists, else the best
  partial one.

The encoder runs once and the (h, c) state of every beam is carried through
a Python loop over T.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _top_k(x: torch.Tensor, k: int):
    """Exact top-k (values, indices) over the last dim, lowest index first on
    ties, as k argmax passes (``torch.topk`` promises no order among ties).

    Selection runs on a finfo.min-clamped copy so -inf inputs stay selectable
    in index order while masked winners (set to -inf) fall strictly below
    every remaining candidate. Values come from the original ``x``."""
    vals, idxs = [], []
    cur = torch.clamp(x, min=torch.finfo(x.dtype).min)
    for _ in range(k):
        i = cur.argmax(dim=-1, keepdim=True)   # first maximal index
        vals.append(x.gather(-1, i)[..., 0])
        idxs.append(i[..., 0])
        cur = cur.scatter(-1, i, float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def beam_search(captioner, params, feat_grid: torch.Tensor, sos_id_1based: int,
                eos_id_1based: int, beam_size: int = 3, max_len: int = 20):
    """feat_grid (B, L, D) -> (tokens_1based (B, max_len) int64, scores (B,)).

    The output includes the trailing EOS; positions after it are 0."""
    dec = captioner.decoder
    K = beam_size
    B = feat_grid.shape[0]
    H = captioner.cfg.hidden_dim
    dev = feat_grid.device
    eos0 = eos_id_1based - 1  # model space
    emb = params["decoder"]["embedding"]

    consts = captioner.prepare_consts(params, feat_grid)
    # each image's constants K times in a row (row b * K + k), by expand: no
    # host sync, so the search can be captured in a CUDA graph
    consts_k = type(consts)(*(x[:, None].expand(B, K, *x.shape[1:]).reshape(B * K, *x.shape[1:])
                              for x in consts))

    state = dec.init_state(B * K, H, dev)
    tokens = torch.full((B, K), sos_id_1based - 1, dtype=torch.long, device=dev)
    scores = torch.full((B, K), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    seqs = torch.zeros((B, K, max_len), dtype=torch.long, device=dev)
    bc_score = torch.full((B,), NEG_INF, device=dev)
    bc_seq = torch.zeros((B, max_len), dtype=torch.long, device=dev)
    bc_len = torch.zeros((B,), dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)

    for t in range(max_len):
        new_state, cache = dec.step(params["decoder"], consts_k, state, emb[tokens.reshape(B * K)])
        logp = torch.log_softmax(cache.logits, dim=-1).reshape(B, K, -1)
        V = logp.shape[-1]
        cand = scores[:, :, None] + logp                          # (B, K, V)
        top_scores, top_idx = _top_k(cand.reshape(B, K * V), K)   # (B, K)
        parent = top_idx // V
        word0 = top_idx % V

        # complete-caption harvest: EOS counts only when it is in the beam's top-K
        kth = _top_k(logp, K)[0][:, :, K - 1]                     # (B, K)
        in_topk = logp[:, :, eos0] >= kth
        eos_cand = torch.where(in_topk, cand[:, :, eos0], torch.full_like(kth, NEG_INF))
        best_k = eos_cand.argmax(dim=1)
        best_eos_score = eos_cand[rows, best_k]
        parent_seq = seqs[rows, best_k].clone()                   # (B, max_len)
        parent_seq[:, t] = eos_id_1based
        improved = best_eos_score > bc_score
        bc_score = torch.where(improved, best_eos_score, bc_score)
        bc_seq = torch.where(improved[:, None], parent_seq, bc_seq)
        bc_len = torch.where(improved, torch.full_like(bc_len, t + 1), bc_len)

        flat_parent = (rows[:, None] * K + parent).reshape(B * K)
        state = type(new_state)(*(s[flat_parent] for s in new_state))
        seqs = seqs[rows[:, None], parent]                        # (B, K, max_len)
        seqs[:, :, t] = word0 + 1                                 # store 1-based
        tokens = word0
        scores = top_scores

    best_b = scores.argmax(dim=1)
    best_partial = seqs[rows, best_b]
    has_complete = bc_score > NEG_INF / 2
    result = torch.where(has_complete[:, None], bc_seq, best_partial)
    pos = torch.arange(max_len, device=dev)[None, :]
    mask = torch.where(has_complete[:, None], pos < bc_len[:, None],
                       torch.ones_like(result, dtype=torch.bool))
    return result * mask, torch.where(has_complete, bc_score, scores.max(dim=1).values)
