"""PyTorch port: K steps a call (``--steps-per-call``) against the JAX
package's ``make_multi_*`` on the CPU, and against the port's own chained
single steps.

The size of tests/test_train.py: VGG16 cut at block2_conv1 (8x8 images ->
4x4x128 grid), E = H = 16, vocab 32, batch 4, T = 7. Params come from the
JAX package's init (``weights.params_from_jax``); batches are made with
numpy and given to both; the dropout masks are the JAX package's draws for
its keys, fed to the port.

Tolerances, each with its reason:

* against the JAX package after K steps, at lr 1e-3 (as tests/test_train.py
  runs its scan): the losses at rel 1e-5 (tests/test_train.py holds its
  scan against its singles so), and the K steps' update (params - params
  before) against the JAX package's (``torch_parallel_worker.update_dists``,
  as the mesh checks hold a step): the 2-norm of their distance within
  UPDATE_DIST of the JAX update's, the largest of a leaf within
  UPDATE_LEAF_DIST, and the share of params apart by over lr / 2 (Adam's
  first steps move a param by about lr; one whose gradient is rounding
  noise may take the other sign under the other order of the sums) under
  UPDATE_APART. A step's loss is taken before its update, so only the
  params see the last step; a call with its last update dropped, or with
  step 1's bias corrections at every step, lies ~0.3 of the update's norm
  away and half its params apart (``test_update_check_rejects_a_wrong_call``);
* the port's K-step call against its own K chained single steps: bit for
  bit on the CPU (the same function, and the masks drawn in the singles'
  order);
* the sharded calls on two CPU slots against the JAX package's on two
  virtual devices as the one-device calls; two gloo processes against one
  as tests/test_torch_parallel.py holds them.

The entry points (the trainer, the fine-tuner, the CLI) at K = 2 are in
tests/test_torch_multi_step_entry.py.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu import parallel as jpar  # noqa: E402
from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models import cells as jcells  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.train import lrp_finetune as jft  # noqa: E402
from lrp_imagecaptioning_tpu.train import optimizer as jopt  # noqa: E402
from lrp_imagecaptioning_tpu.train import step as jstep  # noqa: E402
from lrp_imagecaptioning_torch import parallel as tpar  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.models import adaptive as tad  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.train import lrp_finetune as tft  # noqa: E402
from lrp_imagecaptioning_torch.train import optimizer as topt  # noqa: E402
from lrp_imagecaptioning_torch.train import step as tstep  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_leaves  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_parallel_worker as worker  # noqa: E402
KW = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
          img_feature_dim=128, sentence_length=6, batch_size=4)
VOCAB, B, T, LR = 32, 4, 7, 1e-3
# the K steps' update against the JAX package's (the module's docstring): the
# CPU read 3.9e-6 to 1.2e-5 whole and 1.9e-5 to 1.4e-4 the largest leaf over
# the four calls below, no param apart; about 8x the largest reading
UPDATE_DIST, UPDATE_LEAF_DIST, UPDATE_APART = 1e-4, 1e-3, 1e-3
STOP = np.zeros(VOCAB + 1, bool)
STOP[5] = True
_CACHE = {}


def _models(drop_rate):
    if drop_rate not in _CACHE:
        jcap = j_build("adaptiveattention", JConfig(**KW, drop_rate=drop_rate, image_size=(8, 8)),
                       VOCAB)
        tcap = t_build("adaptiveattention", TConfig(**KW, drop_rate=drop_rate), VOCAB)
        pj = _CACHE[0.0][2] if 0.0 in _CACHE else jcap.init_params(jax.random.PRNGKey(0))
        _CACHE[drop_rate] = (jcap, tcap, pj, params_from_jax(pj, "cpu"))
    return _CACHE[drop_rate]


def _batches(seed, K, batch=B):
    """K batches (images, captions in, one-hot labels), stacked on axis 0."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(K, batch, 8, 8, 3)).astype(np.float32)
    caps = rng.integers(0, VOCAB, size=(K, batch, T)).astype(np.int32)
    y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(K, batch, T))]
    y[:, 0, -2:] = 0                   # padding rows
    y[:, 1, -4:] = 0
    return images, caps, y


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if not t.is_floating_point() else t


def _jax_masks(key, pj, batch, rate=0.5):
    """adaptive.forward_train's masks at ``key``, drawn as the JAX package
    draws them (its sharded step draws the same for the global batch)."""
    ks = jax.random.split(key, 5)
    keep = 1.0 - rate
    H, V = pj["decoder"]["output"]["kernel"].shape
    E = pj["decoder"]["embedding"].shape[-1]

    def bern(k, shape):
        return _t(np.asarray(jax.random.bernoulli(k, keep, shape), np.float32) / keep)

    lstm = jcells.lstm_dropout_masks(ks[4], 2 * E, KW["hidden_dim"], rate, batch=batch)
    return tad.DropoutMasks(v_feat=bern(ks[0], (batch, KW["img_feature_length"], H)),
                            global_feat=bern(ks[1], (batch, E)), out=bern(ks[2], (batch, H)),
                            logit=bern(ks[3], (batch, V)),
                            lstm=tuple(_t(np.asarray(m)) for m in lstm))


def _assert_update_close(pt, pt1, ref):
    """The port's K-step update (``pt`` -> ``pt1``) against a reference's
    from the same params (to ``ref``: the JAX package's params, or the
    port's)."""
    d = worker.update_dists(pt, pt1, params_from_jax(ref, "cpu"), LR)
    assert (d["dist"] <= UPDATE_DIST and d["leaf_dist"] <= UPDATE_LEAF_DIST
            and d["apart"] <= UPDATE_APART), d


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# -- the one-device multi steps ------------------------------------------------------


def _jax_multi_train(K=3):
    """The JAX package's scan of K train steps with dropout from its init,
    on seeded batches: (the port's stacks, JAX's masks for its keys, its
    params after, its metrics); made once."""
    if ("jax_multi", K) not in _CACHE:
        jcap, _, pj, _ = _models(0.5)
        images, caps, y = _batches(1, K)
        keys = jax.random.split(jax.random.PRNGKey(1), K)
        opt_j = jopt.make_optimizer("adaptiveattention", LR)
        pj1, _, mj = jstep.make_multi_train_step(jcap, opt_j, donate=False)(
            pj, opt_j.init(pj), jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y), keys)
        _CACHE[("jax_multi", K)] = ([_t(a) for a in (images, caps, y)],
                                    [_jax_masks(k, pj, B) for k in keys], pj1, mj)
    return _CACHE[("jax_multi", K)]


def test_multi_train_step_matches_jax():
    """K = 3 steps with dropout in one call against the JAX package's scan,
    on JAX's masks for its keys."""
    _, tcap, _, pt = _models(0.5)
    K = 3
    stacks, masks, pj1, mj = _jax_multi_train(K)
    opt_t = topt.make_optimizer("adaptiveattention", LR)
    pt1, st1, mt = tstep.make_multi_train_step(tcap, opt_t)(pt, opt_t.init(pt), *stacks, None,
                                                           masks=masks)
    assert mt["loss"].shape == (K,) and st1["count"] == K
    np.testing.assert_allclose(mt["loss"].numpy(), np.asarray(mj["loss"]), rtol=1e-5)
    np.testing.assert_allclose(mt["accuracy"].numpy(), np.asarray(mj["accuracy"]), rtol=1e-6)
    _assert_update_close(pt, pt1, pj1)


@pytest.mark.parametrize("wrong", ["last_update_dropped", "stale_bias_corrections"])
def test_update_check_rejects_a_wrong_call(wrong, monkeypatch):
    """The check the K-step calls are held to against the JAX package fails
    for a call that drops its last update (K - 1 steps) or whose every step
    takes step 1's bias corrections, though each call's losses but the
    last step's (dropped) are the JAX package's as the right call's are."""
    _, tcap, _, pt = _models(0.5)
    K = 3
    stacks, masks, pj1, mj = _jax_multi_train(K)
    opt_t = topt.make_optimizer("adaptiveattention", LR)
    multi = tstep.make_multi_train_step(tcap, opt_t)
    if wrong == "last_update_dropped":
        stacks, masks = [x[:K - 1] for x in stacks], masks[:K - 1]
    else:
        real = topt.Adam.step_scalars
        monkeypatch.setattr(topt.Adam, "step_scalars", lambda self, count, lr: real(self, 1, lr))
    pt1, _, mt = multi(pt, opt_t.init(pt), *stacks, None, masks=masks)
    np.testing.assert_allclose(mt["loss"][:2].numpy(), np.asarray(mj["loss"])[:2], rtol=1e-5)
    with pytest.raises(AssertionError):
        _assert_update_close(pt, pt1, pj1)
    d = worker.update_dists(pt, pt1, params_from_jax(pj1, "cpu"), LR)
    assert d["dist"] > 1e3 * UPDATE_DIST and d["apart"] > 1e2 * UPDATE_APART, d


@pytest.mark.parametrize("path", ["train", "finetune"])
def test_multi_step_equals_chained_single_steps(path):
    """One K-step call, its masks drawn from a generator, against K single
    steps drawing from a generator of the same seed: bit for bit; and the
    masks the call draws step by step (``drawn_masks``, the card's route)
    are the singles' draws."""
    _, tcap, _, pt = _models(0.5)
    opt = topt.make_optimizer("adaptiveattention", 1e-3)
    K = 3 if path == "train" else 2
    stacks = [_t(a) for a in _batches(2, K)]
    if path == "train":
        single, multi = tstep.make_train_step(tcap, opt), tstep.make_multi_train_step(tcap, opt)
    else:
        single = tft.make_lrp_finetune_step(tcap, opt, STOP, 1, 2)
        multi = tft.make_multi_lrp_finetune_step(tcap, opt, STOP, 1, 2)
    p, s = pt, opt.init(pt)
    gen = torch.Generator().manual_seed(3)
    losses = []
    for k in range(K):
        p, s, m = single(p, s, *(x[k] for x in stacks), gen)
        losses.append(m["loss"])
    pm, sm, mm = multi(pt, opt.init(pt), *stacks, torch.Generator().manual_seed(3))
    assert torch.equal(mm["loss"], torch.stack(losses)) and sm["count"] == s["count"] == K
    _assert_equal(pm, p)
    _assert_equal(sm["nu"], s["nu"])
    masks = tstep.drawn_masks(tcap, pt, B, K, torch.Generator().manual_seed(3))
    pg, _, mg = multi(pt, opt.init(pt), *stacks, None, masks=masks)
    assert torch.equal(mg["loss"], mm["loss"])
    _assert_equal(pg, pm)


def test_multi_lrp_finetune_step_matches_jax():
    """K = 2 fine-tune steps in one call (each step's LRP weights from the
    params the step before wrote) against the JAX package's scan, without
    dropout."""
    jcap, tcap, pj, pt = _models(0.0)
    K = 2
    images, caps, y = _batches(4, K)
    opt_j, opt_t = (m.make_optimizer("adaptiveattention", LR) for m in (jopt, topt))
    pj1, _, mj = jft.make_multi_lrp_finetune_step(jcap, opt_j, STOP, 1, 2, "mean", donate=False)(
        pj, opt_j.init(pj), jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y),
        jax.random.split(jax.random.PRNGKey(0), K))
    pt1, st1, mt = tft.make_multi_lrp_finetune_step(tcap, opt_t, STOP, 1, 2, "mean")(
        pt, opt_t.init(pt), _t(images), _t(caps), _t(y), None)
    assert st1["count"] == K
    np.testing.assert_allclose(mt["loss"].numpy(), np.asarray(mj["loss"]), rtol=1e-5)
    np.testing.assert_allclose(mt["accuracy"].numpy(), np.asarray(mj["accuracy"]), rtol=1e-6)
    _assert_update_close(pt, pt1, pj1)


def test_multi_step_after_set_learning_rate_uses_the_new_rate():
    """The scalars a step reads follow the state: a K-step call after
    ``set_learning_rate`` equals K single steps at the new rate (and not
    the old), and the count advances by K from the state's."""
    _, tcap, _, pt = _models(0.0)
    opt = topt.make_optimizer("adaptiveattention", 1e-3)
    stacks = [_t(a) for a in _batches(5, 2)]
    p0, s0, _ = tstep.make_train_step(tcap, opt)(pt, opt.init(pt), *(x[0] for x in stacks), None)
    s0 = topt.set_learning_rate(s0, 2e-4)
    pm, sm, _ = tstep.make_multi_train_step(tcap, opt)(p0, s0, *stacks, None)
    assert sm["count"] == 3 and topt.get_learning_rate(sm) == pytest.approx(2e-4)
    p, s = p0, s0
    for k in range(2):
        p, s, _ = tstep.make_train_step(tcap, opt)(p, s, *(x[k] for x in stacks), None)
    _assert_equal(pm, p)
    stale, _ = tstep.chain_steps(tstep.make_train_step(tcap, opt), p0,
                                 topt.set_learning_rate(s0, 1e-3), stacks, None)[:2]
    assert not torch.equal(tree_leaves(stale)[0], tree_leaves(pm)[0])


@pytest.mark.parametrize("count, lr", [(1, 1e-3), (3, 2e-4), (1000, 1e-6)])
def test_adam_moments_from_step_scalars_equal_update(count, lr):
    """``Adam.moments`` on ``step_scalars`` (what a replayed step reads) is
    ``Adam.update`` bit for bit, and the scalars are optax's bias
    corrections and rate in float32."""
    opt = topt.make_optimizer("gridTD", lr)
    rng = np.random.default_rng(count)
    g, mu, nu = ({"w": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)) * s}
                 for s in (0.3, 0.01, 1e-4))
    nu["w"] = nu["w"].abs()
    state = {"count": count - 1, "mu": mu, "nu": nu, "learning_rate": topt._f32(lr)}
    updates, new = opt.update(g, state)
    scalars = opt.step_scalars(count, state["learning_rate"])
    u2, mu2, nu2 = opt.moments(g, mu, nu, *scalars)
    assert torch.equal(updates["w"], u2["w"]) and torch.equal(new["nu"]["w"], nu2["w"])
    assert all(x.dtype == torch.float32 and x.dim() == 0 for x in scalars)
    bc1, bc2, rate = (float(x) for x in scalars)
    assert bc1 == float(np.float32(1) - np.float32(np.float32(0.8) ** np.float64(count)))
    assert bc2 == float(np.float32(1) - np.float32(np.float32(0.999) ** np.float64(count)))
    assert rate == float(np.float32(lr))


# -- the stepped driver ---------------------------------------------------------------


@pytest.mark.parametrize("sizes, K, want", [
    ([4, 4, 4, 2, 4, 4], 2, [("multi", 4), ("single", 4), ("single", 2), ("multi", 4)]),
    ([4, 4, 4, 4, 4], 2, [("multi", 4), ("multi", 4), ("single", 4)]),
    ([4, 4, 4, 2], 4, [("single", 4), ("single", 4), ("single", 4), ("single", 2)]),
    ([4, 4, 4], 4, [("single", 4), ("single", 4), ("single", 4)])])
def test_run_stepped_steps_stacks_and_tails_as_jax(sizes, K, want):
    """Stacks of K to ``multi_fn`` (placed by ``place_stacked``), a K-group
    holding a short batch and the ragged tail as singles, every call's
    metrics recorded, the state threaded through; the JAX package's driver
    makes the same calls."""
    def batches():
        for s in sizes:
            yield ((np.full((s, 2), s), np.zeros((s, 3))), np.zeros((s, 5)))
        raise AssertionError("pulled a batch too many")

    calls = {"torch": [], "jax": []}

    def multi_fn(side):
        def fn(p, o, imgs, cap, y, rng):
            assert imgs.shape[:2] == cap.shape[:2] == y.shape[:2]
            calls[side].append(("multi", imgs.shape[1]))
            return p + imgs.shape[0], o, {"loss": np.zeros(imgs.shape[0])}
        return fn

    def single_fn(side):
        def fn(p, o, imgs, cap, y, rng):
            calls[side].append(("single", imgs.shape[0]))
            return p + 1, o, {"loss": 0.0}
        return fn

    recorded = []
    p, _ = tstep.run_stepped_steps(batches(), len(sizes), lambda a: a, single_fn("torch"), "g",
                                   0, None, recorded.append, K, multi_fn("torch"),
                                   lambda a: a[:, :, :1])
    jstep.run_stepped_steps(batches(), len(sizes), K, lambda a: a, lambda n: np.zeros(n),
                            multi_fn("jax"), single_fn("jax"), 0, None, lambda m: None)
    assert calls["torch"] == calls["jax"] == want
    assert p == len(sizes) and len(recorded) == len(want)


# -- over a mesh -------------------------------------------------------------------------


def test_sharded_multi_train_step_matches_jax_sharded():
    """K = 2 sharded steps in one call on two CPU slots against the JAX
    package's sharded scan on two devices, on JAX's masks for the global
    batch; the stacks split on axis 1 as JAX's ``stacked_batch_sharding``
    splits them."""
    jcap, tcap, pj, pt = _models(0.5)
    K = 2
    images, caps, y = _batches(7, K)
    keys = jax.random.split(jax.random.PRNGKey(2), K)
    opt_j, opt_t = (m.make_optimizer("adaptiveattention", LR) for m in (jopt, topt))
    jmesh = jpar.make_mesh(2)
    jmulti, jplace = jstep.make_sharded_multi_train_step(jcap, opt_j, jmesh, params_template=pj,
                                                         donate=False)
    stack = jpar.stacked_batch_sharding(jmesh)
    jimages = jax.device_put(images, stack)
    pj1, _, mj = jmulti(*jplace(pj, opt_j.init(pj)), jimages, jax.device_put(caps, stack),
                        jax.device_put(y, stack), keys)
    mesh = tpar.make_mesh(devices=["cpu"] * 2)
    placed = tpar.stacked_batch_sharding(mesh).place(images)
    want = sorted((s.index[1].start, np.asarray(s.data)) for s in jimages.addressable_shards)
    assert placed.axis == 1 and placed.global_rows == B and placed.offset == 0
    assert [start for start, _ in want] == [0, B // 2]
    for shard, (_, data) in zip(placed.shards, want):
        np.testing.assert_array_equal(shard.numpy(), data)
    multi, place = tstep.make_sharded_multi_train_step(tcap, opt_t, mesh)
    pt1, st1, mt = multi(*place(pt, opt_t.init(pt)), placed, caps, y, None,
                         masks=[_jax_masks(k, pj, B) for k in keys])
    assert st1["count"] == K
    np.testing.assert_allclose(mt["loss"].numpy(), np.asarray(mj["loss"]), rtol=1e-5)
    np.testing.assert_allclose(mt["accuracy"].numpy(), np.asarray(mj["accuracy"]), rtol=1e-6)
    _assert_update_close(pt, pt1, pj1)


def test_sharded_multi_lrp_finetune_step_matches_jax_sharded():
    """K = 2 sharded fine-tune steps in one call on two CPU slots against
    the JAX package's sharded scan on two devices, without dropout; and
    against the port's K chained sharded steps, bit for bit."""
    jcap, tcap, pj, pt = _models(0.0)
    K = 2
    images, caps, y = _batches(8, K)
    opt_j, opt_t = (m.make_optimizer("adaptiveattention", LR) for m in (jopt, topt))
    jmesh = jpar.make_mesh(2)
    stack = jpar.stacked_batch_sharding(jmesh)
    pj1, _, mj = jft.make_sharded_multi_lrp_finetune_step(jcap, opt_j, jmesh, STOP, 1, 2,
                                                          donate=False)(
        pj, opt_j.init(pj), *(jax.device_put(a, stack) for a in (images, caps, y)),
        jax.random.split(jax.random.PRNGKey(0), K))
    mesh = tpar.make_mesh(devices=["cpu"] * 2)
    pt1, _, mt = tft.make_sharded_multi_lrp_finetune_step(tcap, opt_t, mesh, STOP, 1, 2)(
        pt, opt_t.init(pt), images, caps, y, None)
    np.testing.assert_allclose(mt["loss"].numpy(), np.asarray(mj["loss"]), rtol=1e-5)
    np.testing.assert_allclose(mt["accuracy"].numpy(), np.asarray(mj["accuracy"]), rtol=1e-6)
    _assert_update_close(pt, pt1, pj1)
    step = tft.make_sharded_lrp_finetune_step(tcap, opt_t, mesh, STOP, 1, 2)
    p, s = pt, opt_t.init(pt)
    for k in range(K):
        p, s, m = step(p, s, images[k], caps[k], y[k], None)
    assert float(m["loss"]) == float(mt["loss"][-1])
    _assert_equal(p, pt1)


def test_two_processes_stack_their_rows_over_gloo():
    """Two processes over gloo, each stacking its own rows of K = 2 global
    batches (``global_stacked_batch_from_local``: axis 1 split, K whole,
    its offset in the global batch) and running one sharded 2-step call:
    both end on the one-process call's losses and params, and on the
    chained sharded steps'."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    outs = [os.path.join(os.environ.get("TMPDIR", "/tmp"), f"lrpic_stack_{os.getpid()}_{r}.npz")
            for r in range(2)]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               "--stacked", str(r), "2", str(port), outs[r]], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    ref = worker.run_stacked(None, 1, None)
    for r, out in enumerate(outs):
        with np.load(out) as got:
            assert got["layout"].tolist() == [1, worker.GLOBAL_BATCH, r * worker.GLOBAL_BATCH // 2]
            np.testing.assert_array_equal(got["rows"], ref["stack"][:, r * 4:(r + 1) * 4])
            np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
            np.testing.assert_allclose(got["losses"], ref["chained_losses"], rtol=1e-5)
            assert np.abs(got["params"] - ref["params"]).max() <= 2.5e-3
            assert np.mean(np.abs(got["params"] - ref["params"]) > 1e-6) < 1e-3
        os.remove(out)
