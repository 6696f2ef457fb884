"""PyTorch port: the grid-TD decoder and the decoder backwards of both
decoders, against the JAX package and against the reference recursions.

* ``models/gridtd.py`` (cached forward, beam search over its four-tensor
  state) against the JAX model on the same params;
* ``explain_word_gridtd``, ``grad_word_adaptive`` and ``grad_word_gridtd``
  batched over (image x word) rows against the JAX per-word functions at
  every step t, relative to each map's scale (1e-4);
* A4's last check: the port's ``explain_word_adaptive`` and
  ``explain_word_gridtd`` against the reference's numpy relevance
  recursions, as tests/test_lrp_parity.py re-derives them (its helpers are
  imported; the recursions are restated over the port's caches), and
  ``grad_word_gridtd``'s inert sentinel branch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.explain import decoder_grad as jgrad  # noqa: E402
from lrp_imagecaptioning_tpu.explain import decoder_lrp as jlrp  # noqa: E402
from lrp_imagecaptioning_tpu.infer.beam import beam_search as j_beam  # noqa: E402
from lrp_imagecaptioning_tpu.models import adaptive as jad  # noqa: E402
from lrp_imagecaptioning_tpu.models import gridtd as jgt  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain import decoder_grad as tgrad  # noqa: E402
from lrp_imagecaptioning_torch.explain import decoder_lrp as tlrp  # noqa: E402
from lrp_imagecaptioning_torch.infer.beam import beam_search as t_beam  # noqa: E402
from lrp_imagecaptioning_torch.models import adaptive as tad  # noqa: E402
from lrp_imagecaptioning_torch.models import gridtd as tgt  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402
from test_lrp_parity import _rule, _rule_id, _sig  # noqa: E402

torch.set_num_threads(2)

MAP_RTOL = 1e-4
E, H, D, L, V, T, B = 8, 12, 16, 9, 20, 5, 2
MODELS = {"adaptiveattention": (jad, tad), "gridTD": (jgt, tgt)}


def _assert_map_close(got, ref, rtol=MAP_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= rtol * scale, np.abs(got - ref).max() / scale


def _forward(model_type, seed=4):
    """Params, consts and caches of both packages on the same inputs."""
    jm, tm = MODELS[model_type]
    cfg = JConfig(embedding_dim=E, hidden_dim=H, img_feature_dim=D, img_feature_length=L)
    pj = jm.init_params(jax.random.PRNGKey(seed), V, cfg)
    pt = params_from_jax(pj, "cpu")
    rng = np.random.default_rng(40 + seed)
    feat = rng.normal(size=(B, L, D)).astype(np.float32)
    inputs = rng.integers(0, V, size=(B, T))
    cj = jm.prepare_consts(pj, jnp.asarray(feat))
    kj = jm.forward_cached_from_inputs(pj, cj, jnp.asarray(inputs), H)
    ct = tm.prepare_consts(pt, torch.from_numpy(feat))
    kt = tm.forward_cached_from_inputs(pt, ct, torch.from_numpy(inputs), H)
    return pj, cj, kj, pt, ct, kt, rng


def test_gridtd_cached_forward_matches_jax():
    _, _, kj, _, _, kt, _ = _forward("gridTD")
    assert type(kt).__name__ == "GridTDStepCache" and kt._fields == kj._fields
    for name, a, b in zip(kt._fields, kt, kj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-6, err_msg=name)


def test_gridtd_launches_k2_twice_a_step():
    _, _, _, pt, ct, _, _ = _forward("gridTD")
    calls = []
    orig = tgt.lstm_step
    try:
        tgt.lstm_step = lambda *a, **k: calls.append(a[1].shape[-1]) or orig(*a, **k)
        tgt.forward_cached_from_inputs(pt, ct, torch.zeros(B, T, dtype=torch.long), H)
    finally:
        tgt.lstm_step = orig
    assert calls == [H + 2 * E, 2 * H] * T     # TD-LSTM input H + 2E, language 2H


def test_gridtd_beam_search_matches_jax():
    """The port's beam search carries the four-tensor GridTDState."""
    kw = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
              img_feature_dim=128)
    jcap = j_build("gridTD", JConfig(**kw), 24)
    tcap = t_build("gridTD", TConfig(**kw), 24)
    pj = jcap.init_params(jax.random.PRNGKey(5))
    pt = params_from_jax(pj, "cpu")
    feat = np.random.default_rng(6).normal(size=(3, 16, 128)).astype(np.float32) * 3
    tok_j, sc_j = j_beam(jcap, pj, jnp.asarray(feat), 1, 2, 3, 6)
    tok_t, sc_t = t_beam(tcap, pt, torch.from_numpy(feat), 1, 2, 3, 6)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-5)


def test_gridtd_forward_train_raises():
    """grid-TD trains (tests/test_torch_gridtd_train.py); its forward_train
    raises on adaptive attention's masks, whose fields differ."""
    from lrp_imagecaptioning_torch.models.adaptive import DropoutMasks

    z = torch.zeros(1)
    with pytest.raises(TypeError, match="GridTDDropoutMasks"):
        tgt.forward_train(None, None, torch.zeros((1, 2), dtype=torch.long), None,
                          masks=DropoutMasks(z, z, z, z, (z, z)))


@pytest.mark.parametrize("model_type, port_fn, jax_fn", [
    ("gridTD", tlrp.explain_word_gridtd, jlrp.explain_word_gridtd),
    ("adaptiveattention", tgrad.grad_word_adaptive, jgrad.grad_word_adaptive),
    ("gridTD", tgrad.grad_word_gridtd, jgrad.grad_word_gridtd),
], ids=["lrp-gridTD", "grad-adaptive", "grad-gridTD"])
def test_decoder_backward_matches_jax_every_t(model_type, port_fn, jax_fn):
    pj, cj, kj, pt, ct, kt, rng = _forward(model_type)
    words = rng.integers(0, V, size=(B, T))
    r_feat, r_words, att = port_fn(pt, ct, kt, torch.from_numpy(words))
    assert r_feat.shape == (B, T, L, D) and r_words.shape == (B, T, T) and att.shape == (B, T, L)
    # positions=: a subset of the steps, in any order, gives the same rows
    pos = torch.tensor([[3, 0], [4, 2]])
    sub = port_fn(pt, ct, kt, torch.from_numpy(words).gather(1, pos), positions=pos)
    explain = jax.jit(jax_fn, static_argnums=(5,))
    for b in range(B):
        cb = jax.tree.map(lambda x: x[b], cj)
        kb = jax.tree.map(lambda x: x[:, b], kj)
        for t in range(T):
            rf, rw, a = explain(pj, cb, kb, jnp.int32(t), jnp.int32(words[b, t]), T)
            _assert_map_close(r_feat[b, t], rf)
            _assert_map_close(r_words[b, t, :t + 1], np.asarray(rw)[:t + 1])
            np.testing.assert_allclose(att[b, t].numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)
        for w in range(2):
            torch.testing.assert_close(sub[0][b, w], r_feat[b, pos[b, w]], rtol=1e-6, atol=1e-7)


# -- A4: the reference recursions (tests/test_lrp_parity.py), on the port --


RC = dict(embedding_dim=6, hidden_dim=5, img_feature_length=4, img_feature_dim=7)
RV, RT = 11, 4


def _port_forward(model_type, seed):
    jm, tm = MODELS[model_type]
    Hr, Lr, Dr = RC["hidden_dim"], RC["img_feature_length"], RC["img_feature_dim"]
    pt = params_from_jax(jm.init_params(jax.random.PRNGKey(seed), RV, JConfig(**RC)), "cpu")
    rng = np.random.default_rng(seed)
    consts = tm.prepare_consts(pt, torch.from_numpy(rng.normal(size=(1, Lr, Dr)).astype(np.float32)))
    caches = tm.forward_cached_from_inputs(pt, consts,
                                           torch.from_numpy(rng.integers(0, RV, size=(1, RT))), Hr)

    def np64(tree):
        if isinstance(tree, dict):
            return {k: np64(v) for k, v in tree.items()}
        return tree.numpy().astype(np.float64)

    c64 = type(consts)(*(np64(x)[0] for x in consts))
    k64 = type(caches)(*(np64(x)[:, 0] for x in caches))
    return pt, consts, caches, np64(pt), c64, k64


def test_port_adaptive_lrp_matches_reference_recursion():
    Hr, Er, Lr, Dr = RC["hidden_dim"], RC["embedding_dim"], RC["img_feature_length"], RC["img_feature_dim"]
    pt, consts_t, caches_t, p, consts, caches = _port_forward("adaptiveattention", 0)
    t_explain, word = 2, 7
    logits_t = caches.logits[t_explain]
    seed = np.zeros(RV)
    seed[word] = logits_t[word]
    hc = caches.h[t_explain] + caches.c_hat[t_explain]
    r_ht_ctx = _rule(seed, hc, logits_t, p["output"]["kernel"])
    r_ht, r_ct = np.zeros((RT + 1, Hr)), np.zeros((RT + 1, Hr))
    r_ht[t_explain + 1] = _rule_id(r_ht_ctx, caches.h[t_explain], hc)
    r_chat = _rule_id(r_ht_ctx, caches.c_hat[t_explain], hc)
    beta = caches.beta[t_explain][0]
    r_context = _rule_id(r_chat, (1 - beta) * caches.context[t_explain], caches.c_hat[t_explain])
    r_ct[t_explain + 1] = _rule_id(r_chat, beta * caches.st[t_explain], caches.c_hat[t_explain])
    wi, wh = p["lstm"]["wi"], p["lstm"]["wh"]
    w_g = np.vstack([wi[:, 2 * Hr:3 * Hr], wh[:, 2 * Hr:3 * Hr]])
    r_glob, r_word_emb = np.zeros(Er), np.zeros(RT)
    for i in range(t_explain, -1, -1):
        r_c = r_ct[i + 1] + r_ht[i + 1]
        g_pre = caches.z_pre[i][2 * Hr:3 * Hr]
        r_g = _rule_id(r_c, _sig(caches.z_pre[i][:Hr]) * np.tanh(g_pre), caches.c[i])
        r_ct[i] = _rule_id(r_c, _sig(caches.z_pre[i][Hr:2 * Hr]) * caches.c_prev[i], caches.c[i])
        r_xht = _rule(r_g, np.concatenate([caches.x_t[i], caches.h_prev[i]]), g_pre, w_g)
        r_ht[i] = r_xht[2 * Er:]
        r_glob += r_xht[Er:2 * Er]
        r_word_emb[i] = r_xht[:Er].sum()
    r_avg = _rule(r_glob, consts.avg_feat, consts.global_pre, p["global_img_feature"]["kernel"])
    r_feat_np = np.zeros((Lr, Dr))
    for k in range(Lr):
        r_feat_np[k] = _rule_id(r_avg, consts.feat_grid[k] / Lr, consts.avg_feat)
        r_V = _rule_id(r_context, consts.v_feat[k] * caches.attention[t_explain][k],
                       caches.context[t_explain])
        r_feat_np[k] += _rule(r_V, consts.feat_grid[k], consts.v_pre[k], p["image_features"]["kernel"])

    pos = torch.tensor([[t_explain]])
    r_feat, r_words, att = tlrp.explain_word_adaptive(pt, consts_t, caches_t,
                                                      torch.tensor([[word]]), pos)
    np.testing.assert_allclose(r_feat[0, 0].numpy(), r_feat_np, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(att[0, 0].numpy(), caches.attention[t_explain], rtol=1e-5)
    np.testing.assert_allclose(r_words[0, 0, :t_explain + 1].numpy(), r_word_emb[:t_explain + 1],
                               rtol=2e-3, atol=1e-5)
    assert np.abs(r_feat_np).sum() > 0


def test_port_gridtd_lrp_matches_reference_recursion():
    Hr, Er, Lr, Dr = RC["hidden_dim"], RC["embedding_dim"], RC["img_feature_length"], RC["img_feature_dim"]
    pt, consts_t, caches_t, p, consts, c = _port_forward("gridTD", 1)
    t_ex, word = 2, 4
    logits_t = c.logits[t_ex]
    seed = np.zeros(RV)
    seed[word] = logits_t[word]
    hc = c.h2[t_ex] + c.c_hat[t_ex]
    r_hc = _rule(seed, hc, logits_t, p["output"]["kernel"])
    r_h2, r_h1, r_c1, r_c2, r_chat = (np.zeros((RT + 1, Hr)) for _ in range(5))
    r_h2[t_ex + 1] = _rule_id(r_hc, c.h2[t_ex], hc)
    r_chat[t_ex] = _rule_id(r_hc, c.c_hat[t_ex], hc)
    w_g1 = np.vstack([p["td_lstm"]["wi"][:, 2 * Hr:3 * Hr], p["td_lstm"]["wh"][:, 2 * Hr:3 * Hr]])
    w_g2 = np.vstack([p["lang_lstm"]["wi"][:, 2 * Hr:3 * Hr], p["lang_lstm"]["wh"][:, 2 * Hr:3 * Hr]])
    r_glob, r_words_np, r_V = np.zeros(Er), np.zeros(RT), np.zeros((Lr, Hr))
    for i in range(t_ex, -1, -1):
        rc2 = r_c2[i + 1] + r_h2[i + 1]
        g2 = c.z2_pre[i][2 * Hr:3 * Hr]
        r_g2 = _rule_id(rc2, _sig(c.z2_pre[i][:Hr]) * np.tanh(g2), c.c2[i])
        r_c2[i] = _rule_id(rc2, _sig(c.z2_pre[i][Hr:2 * Hr]) * c.c2_prev[i], c.c2[i])
        r_x2 = _rule(r_g2, np.concatenate([c.x2_t[i], c.h2_prev[i]]), g2, w_g2)
        r_h1[i + 1] += r_x2[Hr:2 * Hr]
        r_h2[i] += r_x2[2 * Hr:]
        r_chat[i] += r_x2[:Hr]
        beta = c.beta[i][0]
        r_st = _rule_id(r_chat[i], beta * c.st[i], c.c_hat[i])
        r_ctx = _rule_id(r_chat[i], (1 - beta) * c.context[i], c.c_hat[i])
        for k in range(Lr):
            r_V[k] += _rule_id(r_ctx, consts.v_feat[k] * c.attention[i][k], c.context[i])
        rc1 = r_c1[i + 1] + r_st + r_h1[i + 1]
        g1 = c.z1_pre[i][2 * Hr:3 * Hr]
        r_g1 = _rule_id(rc1, _sig(c.z1_pre[i][:Hr]) * np.tanh(g1), c.c1[i])
        r_c1[i] = _rule_id(rc1, _sig(c.z1_pre[i][Hr:2 * Hr]) * c.c1_prev[i], c.c1[i])
        r_x1 = _rule(r_g1, np.concatenate([c.x1_t[i], c.h1_prev[i]]), g1, w_g1)
        r_h2[i] += r_x1[:Hr]
        r_glob += r_x1[Hr:Hr + Er]
        r_words_np[i] = r_x1[Hr + Er:Hr + 2 * Er].sum()
        r_h1[i] += r_x1[Hr + 2 * Er:]
    r_avg = _rule(r_glob, consts.avg_feat, consts.global_pre, p["global_img_feature"]["kernel"])
    r_feat_np = np.zeros((Lr, Dr))
    for k in range(Lr):
        r_feat_np[k] = _rule_id(r_avg, consts.feat_grid[k] / Lr, consts.avg_feat)
        r_feat_np[k] += _rule(r_V[k], consts.feat_grid[k], consts.v_pre[k], p["image_features"]["kernel"])

    r_feat, r_words, att = tlrp.explain_word_gridtd(pt, consts_t, caches_t, torch.tensor([[word]]),
                                                    torch.tensor([[t_ex]]))
    np.testing.assert_allclose(r_feat[0, 0].numpy(), r_feat_np, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(att[0, 0].numpy(), c.attention[t_ex], rtol=1e-5)
    np.testing.assert_allclose(r_words[0, 0, :t_ex + 1].numpy(), r_words_np[:t_ex + 1],
                               rtol=2e-3, atol=1e-5)


def test_port_gridtd_gradient_sentinel_branch_inert():
    """The reference's grid-TD gradient never propagates the beta * st
    branch into c1 (explainers.py:1506-1527): perturbing the cached sentinel
    must not change the gradient map."""
    pt, consts, caches, _, _, _ = _port_forward("gridTD", 1)
    word, pos = torch.tensor([[4]]), torch.tensor([[2]])
    d1, _, _ = tgrad.grad_word_gridtd(pt, consts, caches, word, pos)
    d2, _, _ = tgrad.grad_word_gridtd(pt, consts, caches._replace(st=caches.st + 3.14), word, pos)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    assert d1.abs().sum() > 0
