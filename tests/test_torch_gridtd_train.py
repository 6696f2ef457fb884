"""PyTorch port: grid-TD training against the JAX package on the CPU.

The size of tests/test_torch_train.py: VGG16 cut at block2_conv1 (8x8 images
-> 4x4x128 grid), E = H = 16, vocab 32, batch 4, T = 7; params from the JAX
init, inputs made with numpy and given to both.

Tolerances, each with its reason (those of tests/test_torch_train.py):
* the forward and the losses: 1e-5 of the logits' scale and rel 1e-6, f32
  sums in another order;
* gradients: 1e-4 of each leaf's max |g| (the backward sums in yet other
  orders, through a VGG);
* Adam over given gradients: rel 1e-6; a whole train step's update is lr
  sign(g) on its first step, so it is compared where |g| > 1e-3 max |g|, at
  1e-4 of its scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models import cells as jcells  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import keras_categorical_ce as j_kce  # noqa: E402
from lrp_imagecaptioning_tpu.train import optimizer as jopt  # noqa: E402
from lrp_imagecaptioning_tpu.train.step import make_train_step as j_make_train_step  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.models import gridtd as tgt  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import keras_categorical_ce as t_kce  # noqa: E402
from lrp_imagecaptioning_torch.train import optimizer as topt  # noqa: E402
from lrp_imagecaptioning_torch.train import step as tstep  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

KW = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
          img_feature_dim=128, sentence_length=6, batch_size=4, drop_rate=0.0)
VOCAB, B, T = 32, 4, 7
LOSS_MODES = ["from_logits", "keras_categorical"]
_CACHE = {}


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if not t.is_floating_point() else t


def _caps(**over):
    """(JAX captioner, port captioner, JAX params, port params) of grid-TD,
    params from the JAX init at key 1; memoised per config."""
    key = tuple(sorted(over.items()))
    if key not in _CACHE:
        jcap = j_build("gridTD", JConfig(**KW, image_size=(8, 8)).replace(**over), VOCAB)
        tcap = t_build("gridTD", TConfig(**KW).replace(**over), VOCAB)
        pj = _CACHE[()][2] if () in _CACHE else jcap.init_params(jax.random.PRNGKey(1))
        _CACHE[key] = (jcap, tcap, pj, params_from_jax(pj, "cpu"))
    return _CACHE[key]


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(B, 8, 8, 3)).astype(np.float32)
    caps = rng.integers(0, VOCAB, size=(B, T)).astype(np.int32)
    y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(B, T))]
    y[0, -2:] = 0                      # padding rows
    return images, caps, y


def _walk(a, b, fn, path=""):
    if isinstance(a, dict):
        for k in a:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    else:
        fn(path, np.asarray(a), b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b))


def _close_to_scale(got, ref, tol):
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max() / scale


def _jax_masks(rng_key, pj, rate):
    """The masks of the JAX grid-TD forward_train at this key, drawn as it
    draws them (models/gridtd.py:167-188)."""
    ks = jax.random.split(rng_key, 6)
    keep = 1.0 - rate
    H, V = pj["decoder"]["output"]["kernel"].shape
    E = pj["decoder"]["embedding"].shape[-1]

    def bern(k, shape):
        return _t(np.asarray(jax.random.bernoulli(k, keep, shape), np.float32) / keep)

    td = jcells.lstm_dropout_masks(ks[4], H + 2 * E, KW["hidden_dim"], rate, batch=B)
    lang = jcells.lstm_dropout_masks(ks[5], 2 * H, KW["hidden_dim"], rate, batch=B)
    return tgt.GridTDDropoutMasks(
        v_feat=bern(ks[0], (B, KW["img_feature_length"], H)), global_feat=bern(ks[1], (B, E)),
        out=bern(ks[2], (B, H)), logit=bern(ks[3], (B, V)),
        lstm=tuple(tuple(_t(np.asarray(m)) for m in pair) for pair in (td, lang)))


@pytest.mark.parametrize("dropout", ["none", "jax_masks"])
def test_forward_train_matches_jax(dropout):
    jcap, tcap, pj, pt = _caps(drop_rate=0.5)
    images, caps, _ = _batch(2)
    key = jax.random.PRNGKey(5) if dropout == "jax_masks" else None
    ref = np.asarray(jcap.forward_train(pj, jnp.asarray(images), jnp.asarray(caps), key))
    masks = _jax_masks(key, pj, 0.5) if key is not None else None
    got = tcap.forward_train(pt, _t(images), _t(caps), None, masks=masks).numpy()
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
    masks = tgt.draw_dropout_masks(torch.Generator().manual_seed(0), pt["decoder"], B,
                                   tcap.cfg, 0.5)
    assert masks.lstm[0][0].shape == (4, B, 16 + 2 * 16) and masks.lstm[1][0].shape == (4, B, 32)
    assert masks.out.shape == (B, 16) and masks.logit.shape == (B, VOCAB)


def test_keras_categorical_ce_matches_jax_with_a_negative_sum():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) + 0.3
    logits[0, 1] -= 3.0                       # a step whose logits sum below 0
    logits[1, 2] = 0.0                        # a step whose logits sum to exactly 0
    y = np.eye(11, dtype=np.float32)[rng.integers(0, 11, size=(3, 5))]
    y[2, 3:] = 0
    assert logits[0, 1].sum() < 0
    lj, gj = jax.value_and_grad(j_kce)(jnp.asarray(logits), jnp.asarray(y))
    lt = _t(logits).requires_grad_()
    loss = t_kce(lt, _t(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(lj), rel=1e-6)
    assert np.isfinite(lt.grad.numpy()).all()
    _close_to_scale(lt.grad.numpy(), np.asarray(gj), 1e-6)


@pytest.mark.parametrize("loss_mode", LOSS_MODES)
def test_loss_gradients_match_jax_every_leaf(loss_mode):
    jcap, tcap, pj, pt = _caps(loss_mode=loss_mode)
    assert (tcap.loss_fn() is t_kce) == (loss_mode == "keras_categorical")
    images, caps, y = _batch(7)
    lj, gj = jax.value_and_grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps),
                                           jnp.asarray(y))
    lt, _, gt = tstep.value_and_grad(
        lambda p: (tcap.loss(p, _t(images), _t(caps), _t(y)), None), pt)
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    leaves = []

    def check(path, a, b):
        assert b.shape == a.shape, path
        _close_to_scale(b, a, 1e-4)
        leaves.append(path)

    _walk(gj, gt, check)
    assert len(leaves) == len(jax.tree.leaves(gj))


def test_loss_gradients_with_dropout_match_jax():
    jcap, tcap, pj, pt = _caps(drop_rate=0.5, loss_mode="keras_categorical")
    images, caps, y = _batch(14)
    key = jax.random.PRNGKey(6)
    lj, gj = jax.value_and_grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps),
                                           jnp.asarray(y), key)
    masks = _jax_masks(key, pj, 0.5)
    lt, _, gt = tstep.value_and_grad(
        lambda p: (tcap.loss(p, _t(images), _t(caps), _t(y), None, masks=masks), None), pt)
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    _walk(gj, gt, lambda path, a, b: _close_to_scale(b, a, 1e-4))


def test_adam_beta1_08_matches_optax_over_three_steps():
    _, _, pj, _ = _caps()
    pj = pj["decoder"]
    opt_j, opt_t = jopt.make_optimizer("gridTD", 1e-3), topt.make_optimizer("gridTD", 1e-3)
    assert opt_t.b1 == 0.8 and opt_t.b2 == 0.999
    sj, st = opt_j.init(pj), opt_t.init(params_from_jax(pj, "cpu"))
    p_j, p_t = pj, params_from_jax(pj, "cpu")
    for k in range(3):
        rng = np.random.default_rng(20 + k)
        g = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.05).astype(np.float32), pj)
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


@pytest.mark.parametrize("loss_mode", LOSS_MODES)
def test_train_step_matches_jax(loss_mode):
    jcap, tcap, pj, pt = _caps(loss_mode=loss_mode)
    images, caps, y = _batch(8)
    opt_j, opt_t = jopt.make_optimizer("gridTD", 1e-3), topt.make_optimizer("gridTD", 1e-3)
    pj1, _, mj = j_make_train_step(jcap, opt_j, donate=False)(
        pj, opt_j.init(pj), jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y),
        jax.random.PRNGKey(0))
    pt1, st1, mt = tstep.make_train_step(tcap, opt_t)(pt, opt_t.init(pt), _t(images), _t(caps),
                                                      _t(y), torch.Generator().manual_seed(0))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-6)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]), rel=1e-6)
    assert st1["count"] == 1
    gj = jax.grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y))
    g_max = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(gj))
    checked = []

    def check(a0, aj, at, g, path=""):
        if isinstance(a0, dict):
            for k in a0:
                check(a0[k], aj[k], at[k], g[k], f"{path}/{k}")
            return
        big = np.abs(np.asarray(g)) > 1e-3 * g_max
        if big.any():
            checked.append(path)
            a0 = np.asarray(a0)
            _close_to_scale((at.numpy() - a0)[big], (np.asarray(aj) - a0)[big], 1e-4)

    check(pj, pj1, pt1, gj)
    assert len(checked) > 10, checked

