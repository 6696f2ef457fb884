"""PyTorch port: the training path against the JAX package on the CPU.

The size of tests/test_train.py: VGG16 cut at block2_conv1 (8x8 images ->
4x4x128 grid), E = H = 16, vocab 32, batch 4, T = 7. Params come from the
JAX package's init; inputs are made with numpy and given to both.

Tolerances, each with its reason:
* the forward and the losses: 1e-5 of the logits' scale and rel 1e-6, f32
  sums in another order;
* gradients: 1e-4 of each leaf's max |g| (the backward sums in yet other
  orders, through a VGG);
* Adam's first step is lr sign(g) wherever |g| >> eps, so a whole step is
  compared only where |g| > 1e-3 max |g|; the optimizer itself is compared
  on the same gradients, at rel 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.infer.greedy import greedy_decode as j_greedy  # noqa: E402
from lrp_imagecaptioning_tpu.models import cells as jcells  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import (  # noqa: E402
    masked_accuracy as j_accuracy,
    masked_ce_from_logits as j_masked_ce,
)
from lrp_imagecaptioning_tpu.train import optimizer as jopt  # noqa: E402
from lrp_imagecaptioning_tpu.train.step import make_train_step as j_make_train_step  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.infer.greedy import greedy_decode as t_greedy  # noqa: E402
from lrp_imagecaptioning_torch.models import adaptive as tad  # noqa: E402
from lrp_imagecaptioning_torch.models import cells as tcells  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import (  # noqa: E402
    masked_accuracy as t_accuracy,
    masked_ce_from_logits as t_masked_ce,
)
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.train import checkpoint as tckpt  # noqa: E402
from lrp_imagecaptioning_torch.train import optimizer as topt  # noqa: E402
from lrp_imagecaptioning_torch.train import step as tstep  # noqa: E402
from lrp_imagecaptioning_torch.weights import opt_state_from_jax, params_from_jax  # noqa: E402

torch.set_num_threads(2)

KW = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
          img_feature_dim=128, sentence_length=6, batch_size=4, drop_rate=0.0)
VOCAB, B, T = 32, 4, 7
_CACHE = {}


def _caps(**over):
    """(JAX captioner, port captioner, JAX params, port params), params from
    the JAX init at key 0; memoised per config."""
    key = tuple(sorted(over.items()))
    if key not in _CACHE:
        jcap = j_build("adaptiveattention", JConfig(**KW, image_size=(8, 8)).replace(**over),
                       VOCAB)
        tcap = t_build("adaptiveattention", TConfig(**KW).replace(**over), VOCAB)
        pj = _CACHE[()][2] if () in _CACHE else jcap.init_params(jax.random.PRNGKey(0))
        _CACHE[key] = (jcap, tcap, pj, params_from_jax(pj, "cpu"))
    return _CACHE[key]


def _batch(seed, batch=B, steps=T):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, 8, 8, 3)).astype(np.float32)
    caps = rng.integers(0, VOCAB, size=(batch, steps)).astype(np.int32)
    labels = rng.integers(0, VOCAB, size=(batch, steps))
    y = np.eye(VOCAB, dtype=np.float32)[labels]
    y[0, -2:] = 0                      # padding rows
    return images, caps, y


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if not t.is_floating_point() else t


def _walk(a, b, fn, path=""):
    """fn(path, jax leaf as numpy, port leaf as numpy) over two param trees."""
    if isinstance(a, dict):
        for k in a:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    else:
        fn(path, np.asarray(a), b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b))


def _close_to_scale(got, ref, tol):
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max() / scale


def _jax_masks(rng_key, pj, batch, rate):
    """The masks of the JAX forward_train at this key, drawn as it draws them."""
    ks = jax.random.split(rng_key, 5)
    keep = 1.0 - rate
    H, V = pj["decoder"]["output"]["kernel"].shape
    E = pj["decoder"]["embedding"].shape[-1]

    def bern(k, shape):
        return np.asarray(jax.random.bernoulli(k, keep, shape), np.float32) / keep

    lstm = jcells.lstm_dropout_masks(ks[4], 2 * E, KW["hidden_dim"], rate, batch=batch)
    return tad.DropoutMasks(
        v_feat=_t(bern(ks[0], (batch, KW["img_feature_length"], H))),
        global_feat=_t(bern(ks[1], (batch, E))), out=_t(bern(ks[2], (batch, H))),
        logit=_t(bern(ks[3], (batch, V))), lstm=tuple(_t(np.asarray(m)) for m in lstm))


def test_lstm_step_with_jax_masks():
    rng = np.random.default_rng(1)
    pj = jcells.lstm_init(jax.random.PRNGKey(3), 10, 12)
    pt = params_from_jax(pj, "cpu")
    x, h, c = (rng.normal(size=s).astype(np.float32) for s in [(5, 10), (5, 12), (5, 12)])
    masks = jcells.lstm_dropout_masks(jax.random.PRNGKey(4), 10, 12, 0.5, batch=5)
    sj, cj = jcells.lstm_step(pj, x, jcells.LSTMState(h, c), masks)
    st, ct = tcells.lstm_step(pt, _t(x), tcells.LSTMState(_t(h), _t(c)),
                              tuple(_t(np.asarray(m)) for m in masks))
    for got, ref in ((ct.z_pre, cj.z_pre), (st.h, sj.h), (st.c, sj.c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_lstm_dropout_masks_shapes_and_rate():
    gen = torch.Generator().manual_seed(0)
    xm, hm = tcells.lstm_dropout_masks(gen, 300, 200, 0.25, batch=8)
    assert xm.shape == (4, 8, 300) and hm.shape == (4, 8, 200)
    assert set(torch.unique(xm).tolist()) == {0.0, np.float32(1.0 / 0.75)}
    assert abs((xm > 0).float().mean().item() - 0.75) < 0.02


@pytest.mark.parametrize("dropout", ["none", "jax_masks"])
def test_forward_train_matches_jax(dropout):
    jcap, tcap, pj, pt = _caps(drop_rate=0.5)
    images, caps, _ = _batch(2)
    key = jax.random.PRNGKey(5) if dropout == "jax_masks" else None
    ref = np.asarray(jcap.forward_train(pj, jnp.asarray(images), jnp.asarray(caps), key))
    masks = _jax_masks(key, pj, B, 0.5) if key is not None else None
    got = tcap.forward_train(pt, _t(images), _t(caps), None, masks).numpy()
    assert got.shape == (B, T, VOCAB)
    _close_to_scale(got, ref, 1e-5)


def test_forward_train_draws_dropout_from_the_generator():
    _, tcap, _, pt = _caps(drop_rate=0.5)
    images, caps, _ = _batch(3)
    run = lambda seed: tcap.forward_train(pt, _t(images), _t(caps),  # noqa: E731
                                          torch.Generator().manual_seed(seed))
    plain = tcap.forward_train(pt, _t(images), _t(caps), None)
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1)) and not torch.equal(run(0), plain)


@pytest.mark.parametrize("name", ["masked_ce", "masked_accuracy"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    logits[0, 1] -= 3.0                                   # a step whose logits sum is negative
    y = np.eye(11, dtype=np.float32)[rng.integers(0, 11, size=(3, 5))]
    y[1, 2:] = 0
    logits[2, 0] = np.where(y[2, 0] > 0, 5.0, logits[2, 0])   # one sure hit
    fj, ft = {"masked_ce": (j_masked_ce, t_masked_ce),
              "masked_accuracy": (j_accuracy, t_accuracy)}[name]
    ref = float(fj(jnp.asarray(logits), jnp.asarray(y)))
    got = float(ft(_t(logits), _t(y)))
    assert got == pytest.approx(ref, rel=1e-6)


def test_masked_ce_all_padding_rows_give_zero():
    logits = torch.randn(2, 4, 6)
    assert float(t_masked_ce(logits, torch.zeros(2, 4, 6))) == 0.0


def _leafwise_grad_check(gj, gt, tol=1e-4):
    def check(path, a, b):
        assert b.shape == a.shape, path
        _close_to_scale(b, a, tol)

    _walk(gj, gt, check)


def test_loss_gradients_match_jax_every_leaf():
    jcap, tcap, pj, pt = _caps()
    images, caps, y = _batch(7)
    lj, gj = jax.value_and_grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps),
                                           jnp.asarray(y))
    lt, _, gt = tstep.value_and_grad(
        lambda p: (tcap.loss(p, _t(images), _t(caps), _t(y)), None), pt)
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    _leafwise_grad_check(gj, gt)


def test_loss_gradients_with_dropout_match_jax():
    """The dropout path's backward (the gate-by-gate masked products into
    K2, the masked features, h + c_hat and logits) with JAX's own masks."""
    jcap, tcap, pj, pt = _caps(drop_rate=0.5)
    images, caps, y = _batch(14)
    key = jax.random.PRNGKey(6)
    lj, gj = jax.value_and_grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps),
                                           jnp.asarray(y), key)
    masks = _jax_masks(key, pj, B, 0.5)
    lt, _, gt = tstep.value_and_grad(
        lambda p: (tcap.loss(p, _t(images), _t(caps), _t(y), None, masks), None), pt)
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    _leafwise_grad_check(gj, gt)


def _same_grads(seed, pj, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32), pj)


@pytest.mark.parametrize("grad_scale", [0.01, 1.0], ids=["inside_clip", "clipped"])
def test_optimizer_matches_optax_over_three_steps(grad_scale):
    """Gradients mostly inside the clip value 0.1, and mostly clipped to it."""
    _, _, pj, _ = _caps()
    pj = pj["decoder"]
    opt_j = jopt.make_optimizer("adaptiveattention", 1e-3)
    opt_t = topt.make_optimizer("adaptiveattention", 1e-3)
    sj, st = opt_j.init(pj), opt_t.init(params_from_jax(pj, "cpu"))
    p_j, p_t = pj, params_from_jax(pj, "cpu")
    for k in range(3):
        g = _same_grads(10 + k, pj, grad_scale)
        uj, sj = opt_j.update(g, sj, p_j)
        p_j = jax.tree.map(lambda a, b: a + b, p_j, uj)
        ut, st = opt_t.update(params_from_jax(g, "cpu"), st, p_t)
        p_t = topt.apply_updates(p_t, ut)
    _walk(p_j, p_t, lambda path, a, b: np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9))
    adam = sj[1].inner_state[0]
    assert st["count"] == int(adam.count) == 3
    for name in ("mu", "nu"):
        _walk(getattr(adam, name), st[name],
              lambda path, a, b: np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12))


def test_make_optimizer_has_only_the_ported_model():
    assert topt.make_optimizer("adaptiveattention", 1e-3).b1 == 0.9
    with pytest.raises(NotImplementedError, match="gridTD"):
        topt.make_optimizer("gridTD", 1e-3)


def test_set_learning_rate():
    _, _, _, pt = _caps()
    opt = topt.make_optimizer("adaptiveattention", 1e-3)
    state = opt.init(pt)
    assert topt.get_learning_rate(state) == pytest.approx(1e-3)
    half = topt.set_learning_rate(state, 5e-4)
    assert topt.get_learning_rate(half) == pytest.approx(5e-4)
    assert topt.get_learning_rate(state) == pytest.approx(1e-3)   # the old state is kept
    g = tstep.tree_map(torch.ones_like, pt)
    u_full, _ = opt.update(g, state, pt)
    u_half, _ = opt.update(g, half, pt)
    torch.testing.assert_close(u_half["decoder"]["output"]["bias"],
                               0.5 * u_full["decoder"]["output"]["bias"])


def _assert_step_updates_match(p0, pj_new, pt_new, gj, tol):
    """The updates (new - old params) where |g| > 1e-3 max |g| over all leaves:
    near |g| ~ eps = 1e-8 Adam's update g / (|g| + eps) is not sign-like."""
    g_max = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(gj))
    checked = []

    def check(path, a0, aj, at, g):
        big = np.abs(g) > 1e-3 * g_max
        if big.any():
            checked.append(path)
            _close_to_scale((at - a0)[big], (aj - a0)[big], tol)

    def walk(a0, aj, at, g, path=""):
        if isinstance(a0, dict):
            for k in a0:
                walk(a0[k], aj[k], at[k], g[k], f"{path}/{k}")
        else:
            check(path, np.asarray(a0), np.asarray(aj), at.numpy(), np.asarray(g))

    walk(p0, pj_new, pt_new, gj)
    assert len(checked) > 10, checked


def test_train_step_matches_jax():
    jcap, tcap, pj, pt = _caps()
    images, caps, y = _batch(8)
    lr = 1e-3
    opt_j, opt_t = jopt.make_optimizer("adaptiveattention", lr), topt.make_optimizer(
        "adaptiveattention", lr)
    jstep = j_make_train_step(jcap, opt_j, donate=False)
    pj1, _, mj = jstep(pj, opt_j.init(pj), jnp.asarray(images), jnp.asarray(caps),
                       jnp.asarray(y), jax.random.PRNGKey(0))
    pt1, st1, mt = tstep.make_train_step(tcap, opt_t)(pt, opt_t.init(pt), _t(images), _t(caps),
                                                      _t(y), torch.Generator().manual_seed(0))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-6)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]), rel=1e-6)
    assert st1["count"] == 1
    gj = jax.grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y))
    _assert_step_updates_match(pj, pj1, pt1, gj, 1e-4)


def test_train_step_continues_a_jax_state():
    """Two JAX steps, then the third on each side from JAX's params and Adam
    state (no longer sign-like): the updates agree."""
    jcap, tcap, pj, _ = _caps()
    lr = 1e-3
    opt_j, opt_t = jopt.make_optimizer("adaptiveattention", lr), topt.make_optimizer(
        "adaptiveattention", lr)
    jstep = j_make_train_step(jcap, opt_j, donate=False)
    p, s = pj, opt_j.init(pj)
    for seed in (9, 10):
        images, caps, y = _batch(seed)
        p, s, _ = jstep(p, s, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y),
                        jax.random.PRNGKey(0))
    images, caps, y = _batch(11)
    pj3, sj3, mj = jstep(p, s, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y),
                         jax.random.PRNGKey(0))
    adam = s[1].inner_state[0]
    st = opt_state_from_jax(adam.count, jax.tree.map(np.asarray, adam.mu),
                            jax.tree.map(np.asarray, adam.nu), s[1].hyperparams["learning_rate"],
                            "cpu")
    assert st["count"] == 2 and st["learning_rate"] == pytest.approx(lr)
    pt3, st3, mt = tstep.make_train_step(tcap, opt_t)(params_from_jax(p, "cpu"), st, _t(images),
                                                      _t(caps), _t(y), None)
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-6)
    gj = jax.grad(jcap.loss)(p, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y))
    _assert_step_updates_match(p, pj3, pt3, gj, 1e-3)
    _walk(sj3[1].inner_state[0].nu, st3["nu"],
          lambda path, a, b: _close_to_scale(b, a, 1e-4))


def test_forward_train_generator_draws_the_masks_it_applies():
    """A generator draws ``draw_dropout_masks``' masks, in its order; the step
    applies them once (its logits are the masked ones)."""
    _, tcap, _, pt = _caps(drop_rate=0.5)
    images, caps, _ = _batch(20)
    drawn = tcap.forward_train(pt, _t(images), _t(caps), torch.Generator().manual_seed(4))
    masks = tad.draw_dropout_masks(torch.Generator().manual_seed(4), pt["decoder"], B,
                                   tcap.cfg, 0.5)
    given = tcap.forward_train(pt, _t(images), _t(caps), None, masks)
    assert torch.equal(drawn, given)
    dropped = (masks.logit == 0)[:, None, :].expand_as(given)
    assert bool(dropped.any()) and bool((given[dropped] == 0).all())


def test_remat_encoder_same_loss_and_grads():
    _, tcap, _, pt = _caps()
    _, tcap_remat, _, _ = _caps(remat_encoder=True)
    images, caps, y = _batch(12, batch=2, steps=5)
    args = (_t(images), _t(caps), _t(y))
    l0, _, g0 = tstep.value_and_grad(lambda p: (tcap.loss(p, *args), None), pt)
    l1, _, g1 = tstep.value_and_grad(lambda p: (tcap_remat.loss(p, *args), None), pt)
    assert float(l0) == float(l1)
    _walk(g0, g1, lambda path, a, b: np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9))


def test_bf16_compute_dtype_loss_matches_jax():
    """bf16 conv operands, f32 params and gradients: the loss within bf16
    rounding of JAX's bf16 loss (both round the same operands to bf16; rel
    1e-2 is a few bf16 ulps through 3 convs)."""
    jcap, tcap, pj, pt = _caps(compute_dtype="bfloat16")
    images, caps, y = _batch(13)
    lj = float(jcap.loss(pj, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y)))
    lt, _, gt = tstep.value_and_grad(
        lambda p: (tcap.loss(p, _t(images), _t(caps), _t(y)), None), pt)
    assert float(lt) == pytest.approx(lj, rel=1e-2)
    for g in tstep.tree_leaves(gt):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_token_exact(seed):
    jcap, tcap, pj, pt = _caps()
    rng = np.random.default_rng(30 + seed)
    feat = rng.normal(size=(5, 16, 128)).astype(np.float32)
    tj, _ = j_greedy(jcap, pj, jnp.asarray(feat), 1, 2, max_len=8)
    # an EOS the decoder emits: the second word of caption 0
    eos = int(np.asarray(tj)[0, 1])
    for eos_id in (2, eos):
        tj, lj = j_greedy(jcap, pj, jnp.asarray(feat), 1, eos_id, max_len=8)
        tt, lt = t_greedy(tcap, pt, _t(feat), 1, eos_id, max_len=8)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        _close_to_scale(lt.numpy(), np.asarray(lj), 1e-5)
    # the EOS is kept and zeros follow it; caption 0 ends at step 1 or before
    tt = tt.numpy()
    for row in tt:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0] + 1:] == 0).all()
    assert np.flatnonzero(tt[0] == eos)[0] <= 1


def test_checkpoint_roundtrip_and_latest(tmp_path):
    _, _, _, pt = _caps()
    opt = topt.make_optimizer("adaptiveattention", 1e-3)
    g = tstep.tree_map(torch.ones_like, pt)
    _, state = opt.update(g, opt.init(pt), pt)
    d = str(tmp_path / "ckpts")
    assert tckpt.latest_checkpoint(d) is None
    tckpt.save_checkpoint(d, 0, pt, state, metric=0.1)
    path = tckpt.save_checkpoint(d, 3, pt, state, metric=0.3)
    latest = tckpt.latest_checkpoint(d)
    assert latest == path and latest.endswith("ckpt_03_0.3000.npz")
    assert tckpt.ckpt_name(7, None) == "ckpt_07"
    params, restored = tckpt.restore_checkpoint(latest, "cpu")
    _walk(pt, params, lambda path, a, b: np.testing.assert_array_equal(b, a))
    assert restored["count"] == 1 and restored["learning_rate"] == pytest.approx(1e-3)
    _walk(state["nu"], restored["nu"], lambda path, a, b: np.testing.assert_array_equal(b, a))


def test_run_stepped_steps_runs_every_batch_in_order():
    """One step a batch, ragged batches included, each placed on the device,
    the params and state threaded through, every step's metrics recorded."""
    sizes = [4, 4, 2, 4]

    def batches():
        for s in sizes:
            yield ((np.full((s, 3), s), np.zeros((s, 2))), np.zeros((s, 5)))
        raise AssertionError("pulled a batch too many")

    calls, recorded = [], []

    def step_fn(p, o, imgs, cap, y, rng):
        calls.append((imgs.shape[0], cap.shape[0], y.shape[0], rng))
        return p + 1, o + [p], {"loss": float(imgs.shape[0])}

    p, o = tstep.run_stepped_steps(batches(), 3, lambda a: a[:, :1], step_fn, "g", 0, [],
                                   recorded.append)
    assert calls == [(4, 4, 4, "g"), (4, 4, 4, "g"), (2, 2, 2, "g")]
    assert (p, o) == (3, [0, 1, 2])
    assert recorded == [{"loss": 4.0}, {"loss": 4.0}, {"loss": 2.0}]


def test_metric_accumulator_means_over_steps():
    record, finalize = tstep.metric_accumulator()
    record({"loss": torch.tensor([1.0, 3.0]), "accuracy": torch.tensor([0.5, 0.5])})
    record({"loss": torch.tensor(2.0), "accuracy": torch.tensor(1.0)})
    assert finalize(3) == {"loss": pytest.approx(2.0), "accuracy": pytest.approx(2.0 / 3)}


@pytest.mark.parametrize("batch,hidden", [(3, 4), (7, 12)])
def test_lstm_gates_vjp_matches_autograd(batch, hidden):
    """K2's backward (torch ops) against autograd through its plain version,
    in f64, with cotangents on all three outputs."""
    gen = torch.Generator().manual_seed(batch)
    zx, zh = (torch.randn(batch, 4 * hidden, generator=gen, dtype=torch.float64,
                          requires_grad=True) for _ in range(2))
    b = torch.randn(4 * hidden, generator=gen, dtype=torch.float64, requires_grad=True)
    c = torch.randn(batch, hidden, generator=gen, dtype=torch.float64, requires_grad=True)
    outs = kernels.lstm_gates_plain(zx, zh, b, c)
    cot = [torch.randn(o.shape, generator=gen, dtype=torch.float64) for o in outs]
    want = torch.autograd.grad(outs, (zx, zh, b, c), cot)
    z_pre, _, c_new = (o.detach() for o in outs)
    dz, dbias, dc_prev = kernels.lstm_gates_vjp(z_pre, c.detach(), c_new, *cot)
    for got, ref in zip((dz, dz, dbias, dc_prev), want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_no_grad_only_raises_under_grad_mode():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        kernels._no_grad_only("lrp_linear", x, None)
    with torch.no_grad():
        kernels._no_grad_only("lrp_linear", x, None)
    kernels._no_grad_only("lrp_linear", x.detach(), None)
