"""PyTorch port: scale-out over several devices (``parallel/``, the sharded
train and fine-tune steps, the mesh and word-sharded Explainer and
CaptionService, several-device export serving, the CLI's mesh flags)
against the one-device port and the JAX package's sharded programs, on
the CPU.

The port's mesh here is 2 or 4 CPU slots (``make_mesh(devices=["cpu"] *
N)``), the JAX package's the virtual CPU devices ``tests/conftest.py``
forces. Sizes are the training and engine tests': VGG16 cut at
block2_conv1, 8x8 images, E = H = 16.

Tolerances, each with its reason:

* the sharded loss against the one-device loss at rel 1e-5 (the slots'
  weighted means sum in another order); accuracies exactly (sums of
  counts);
* the sharded gradient against the one-device gradient within 1e-5 of each
  leaf's scale, the scale floored at 1e-3 of the largest leaf's: a leaf
  whose gradient is 0 in exact arithmetic (the AOA key projection's bias:
  softmax ignores a shift) holds only rounding, ~1e-9 where the largest
  leaf's is ~0.5;
* a whole step against the JAX package's as tests/test_torch_train.py
  holds it: the update where |g| > 1e-3 max |g|, at 1e-4 of scale;
* explanations as tests/test_torch_explainer.py holds them: captions
  token-exact, every array within 1e-4 of its scale.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu import parallel as jpar  # noqa: E402
from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.explain.engine import Explainer as JExplainer  # noqa: E402
from lrp_imagecaptioning_tpu.infer.serving import CaptionService as JService  # noqa: E402
from lrp_imagecaptioning_tpu.models import cells as jcells  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.train import lrp_finetune as jft  # noqa: E402
from lrp_imagecaptioning_tpu.train import optimizer as jopt  # noqa: E402
from lrp_imagecaptioning_tpu.train.step import make_sharded_train_step as j_sharded  # noqa: E402
from lrp_imagecaptioning_torch import cli  # noqa: E402
from lrp_imagecaptioning_torch import parallel as tpar  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.infer.export import ExportedCaptioner, export_serving  # noqa: E402
from lrp_imagecaptioning_torch.infer.serving import CaptionService  # noqa: E402
from lrp_imagecaptioning_torch.models import adaptive as tad  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.train import lrp_finetune as tft  # noqa: E402
from lrp_imagecaptioning_torch.train import optimizer as topt  # noqa: E402
from lrp_imagecaptioning_torch.train import step as tstep  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
TRAIN = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
             img_feature_dim=128, sentence_length=6, batch_size=4)
ENGINE = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
              img_feature_dim=128, sentence_length=5)
VOCAB_TRAIN, VOCAB_ENGINE = 32, 16
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")
_CACHE = {}


def cpu_mesh(n):
    return tpar.make_mesh(devices=["cpu"] * n)


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if not t.is_floating_point() else t


def _batch(seed, batch=4, steps=7, vocab=VOCAB_TRAIN):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, 8, 8, 3)).astype(np.float32)
    caps = rng.integers(0, vocab, size=(batch, steps)).astype(np.int32)
    y = np.eye(vocab, dtype=np.float32)[rng.integers(0, vocab, size=(batch, steps))]
    y[0, -2:] = 0                      # padding rows, more in the first slot's
    y[1, -4:] = 0
    return images, caps, y


def _train_models(model_type, drop_rate):
    key = (model_type, drop_rate)
    if key not in _CACHE:
        jcap = j_build(model_type, JConfig(**TRAIN, drop_rate=drop_rate, image_size=(8, 8)),
                       VOCAB_TRAIN)
        tcap = t_build(model_type, TConfig(**TRAIN, drop_rate=drop_rate), VOCAB_TRAIN)
        pj = jcap.init_params(jax.random.PRNGKey(0))
        _CACHE[key] = (jcap, tcap, pj, params_from_jax(pj, "cpu"))
    return _CACHE[key]


def _jax_masks(key, pj, batch, rate):
    """adaptive.forward_train's masks at this key for ``batch`` rows, drawn as
    the JAX package draws them (its sharded step draws the same: threefry's
    bits do not depend on the partitioning)."""
    ks = jax.random.split(key, 5)
    keep = 1.0 - rate
    H, V = pj["decoder"]["output"]["kernel"].shape
    E = pj["decoder"]["embedding"].shape[-1]

    def bern(k, shape):
        return _t(np.asarray(jax.random.bernoulli(k, keep, shape), np.float32) / keep)

    lstm = jcells.lstm_dropout_masks(ks[4], 2 * E, TRAIN["hidden_dim"], rate, batch=batch)
    return tad.DropoutMasks(v_feat=bern(ks[0], (batch, TRAIN["img_feature_length"], H)),
                            global_feat=bern(ks[1], (batch, E)), out=bern(ks[2], (batch, H)),
                            logit=bern(ks[3], (batch, V)),
                            lstm=tuple(_t(np.asarray(m)) for m in lstm))


class Recorder:
    """An optimizer that keeps the gradient it is handed and changes nothing."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params=None):
        self.grads = grads
        return tree_map(torch.zeros_like, grads), state


def _assert_grads_close(got, ref, tol=1e-5):
    leaves = [(g.numpy(), r.numpy()) for g, r in zip(tree_leaves(got), tree_leaves(ref))]
    floor = 1e-3 * max(np.abs(r).max() for _, r in leaves)
    for g, r in leaves:
        scale = max(np.abs(r).max(), floor)
        assert np.abs(g - r).max() <= tol * scale, (np.abs(g - r).max(), scale)


def _assert_updates_match(p0, pj_new, pt_new, gj, tol=1e-4):
    """The updates (new - old params) where |g| > 1e-3 max |g|: near |g| ~
    eps Adam's update g / (|g| + eps) is not sign-like."""
    g_max = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(gj))
    checked = 0
    for a0, aj, at, g in zip(jax.tree.leaves(p0), jax.tree.leaves(pj_new), tree_leaves(pt_new),
                             jax.tree.leaves(gj)):
        big = np.abs(np.asarray(g)) > 1e-3 * g_max
        if big.any():
            checked += 1
            ref = (np.asarray(aj) - np.asarray(a0))[big]
            got = (at.numpy() - np.asarray(a0))[big]
            assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    assert checked > 10


# -- the mesh layer ---------------------------------------------------------------


@pytest.mark.parametrize("n, model_parallel", [(2, 1), (4, 1), (4, 2), (8, 4)])
def test_make_mesh_matches_jax(n, model_parallel):
    jm = jpar.make_mesh(n, model_parallel=model_parallel)
    tm = tpar.make_mesh(n, model_parallel=model_parallel, devices=["cpu"] * 8)
    assert dict(jm.shape) == tm.shape and tuple(jm.axis_names) == tm.axis_names
    assert tm.devices.shape == jm.devices.shape and tm.size == jm.size
    assert len(tm.slots) == n // model_parallel


def test_make_mesh_raises_as_jax():
    with pytest.raises(ValueError, match="only"):
        jpar.make_mesh(1024)
    with pytest.raises(ValueError, match="only"):
        tpar.make_mesh(1024, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="model_parallel"):
        tpar.make_mesh(3, model_parallel=2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():   # no silent fall back to the CPU
        with pytest.raises(ValueError, match="no CUDA device"):
            tpar.make_mesh()


@pytest.mark.parametrize("global_batch, count", [(8, 1), (8, 2), (12, 4), (6, 3)])
def test_process_batch_slice_matches_jax(global_batch, count):
    for index in range(count):
        assert tpar.process_batch_slice(global_batch, index, count) == \
            jpar.process_batch_slice(global_batch, process_index=index, process_count=count)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.process_batch_slice(global_batch + 1, 0, 2 * count)
    assert tpar.process_batch_slice(8) == slice(0, 8)    # one process: the whole batch
    assert tpar.initialize_distributed() == 1 == jpar.initialize_distributed()


@pytest.mark.parametrize("shard_vocab", [False, True])
def test_placements_mirror_jax(shard_vocab):
    """The partition specs of the decoder params are the JAX package's, the
    Adam moments mirror the params; the batch splits in contiguous rows over
    the data axis; with shard_vocab the embedding and the output projection
    split on the vocabulary over the model axis, and join again."""
    _, _, pj, pt = _train_models("adaptiveattention", 0.0)
    jspecs = jpar.mesh.decoder_param_pspecs(pj["decoder"], shard_vocab)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)   # noqa: E731
    assert [tuple(s) for s in jax.tree.leaves(jspecs, is_leaf=is_spec)] == \
        _spec_leaves(tpar.decoder_param_pspecs(pt["decoder"], shard_vocab))
    mesh = tpar.make_mesh(devices=["cpu"] * 4, model_parallel=2)
    state = topt.make_optimizer("adaptiveattention", 1e-3).init(pt)
    shard = tpar.opt_state_shardings(mesh, state, pt, shard_vocab)
    assert shard["mu"] == shard["nu"] == tpar.param_shardings(mesh, pt, shard_vocab)
    assert shard["count"] == tpar.replicated(mesh)
    images = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    s = tpar.shard_batch(mesh, images)
    assert s.global_rows == 8 and s.rows == [slice(0, 4), slice(4, 8)]
    np.testing.assert_array_equal(torch.cat(s.shards).numpy(), images)
    placed = tpar.place_params(mesh, pt, shard_vocab)
    emb, kernel = placed["decoder"]["embedding"], placed["decoder"]["output"]["kernel"]
    if shard_vocab:
        assert isinstance(emb, tpar.VocabSlices) and [e.shape for e in emb] == [(16, 16)] * 2
        assert [k.shape for k in kernel] == [(16, 16)] * 2
        back = tpar.gather_params(placed, "cpu")
        for a, b in zip(tree_leaves(back), tree_leaves(pt)):
            assert torch.equal(a, b)
    else:
        assert torch.equal(emb, pt["decoder"]["embedding"])


def _spec_leaves(tree):
    """A spec tree's leaves (tuples) in sorted key order, as JAX flattens."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


# -- the sharded steps ----------------------------------------------------------------


@pytest.mark.parametrize("model_type, slots", [("adaptiveattention", 2), ("adaptiveattention", 4),
                                               ("gridTD", 2), ("aoa", 4)])
def test_sharded_train_step_equals_one_device(model_type, slots):
    """With dropout from one generator: the loss, the accuracy and the
    summed gradient (before the clip) of the one-device step on the global
    batch."""
    _, tcap, _, pt = _train_models(model_type, 0.5)
    images, caps, y = _batch(1)
    one, shard = Recorder(), Recorder()
    _, _, m1 = tstep.make_train_step(tcap, one)(pt, None, _t(images), _t(caps), _t(y),
                                                torch.Generator().manual_seed(3))
    step, _ = tstep.make_sharded_train_step(tcap, shard, cpu_mesh(slots))
    _, _, m2 = step(pt, None, images, caps, y, torch.Generator().manual_seed(3))
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["accuracy"]) == float(m1["accuracy"])
    _assert_grads_close(shard.grads, one.grads)


def test_sharded_train_step_matches_jax_sharded():
    """Two slots against the JAX package's sharded step on two devices, on
    JAX's dropout draws for the global batch: loss and accuracy, and the
    clipped Adam update."""
    jcap, tcap, pj, pt = _train_models("adaptiveattention", 0.5)
    images, caps, y = _batch(2)
    key = jax.random.PRNGKey(7)
    opt_j, opt_t = (m.make_optimizer("adaptiveattention", 1e-3) for m in (jopt, topt))
    jmesh = jpar.make_mesh(2)
    jstep, jplace = j_sharded(jcap, opt_j, jmesh, params_template=pj, donate=False)
    p, s = jplace(pj, opt_j.init(pj))
    pj1, _, mj = jstep(p, s, *jpar.shard_batch(jmesh, images, caps, y), key)
    tstep_, place = tstep.make_sharded_train_step(tcap, opt_t, cpu_mesh(2))
    pt1, st1, mt = tstep_(*place(pt, opt_t.init(pt)), images, caps, y, None,
                          masks=_jax_masks(key, pj, 4, 0.5))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]), rel=1e-6)
    assert st1["count"] == 1
    gj = jax.grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y), key)
    _assert_updates_match(pj, pj1, pt1, gj)


@pytest.mark.parametrize("model_type, data, model, loss_mode", [
    ("adaptiveattention", 1, 2, "from_logits"), ("adaptiveattention", 2, 2, "from_logits"),
    ("gridTD", 2, 2, "keras_categorical"), ("aoa", 1, 3, "from_logits")])
def test_shard_vocab_step_equals_one_device(model_type, data, model, loss_mode):
    """The vocabulary split over the model axis (3 slots: uneven slices of
    32): with dropout from one generator, the one-device step's loss,
    accuracy and gradient, the vocabulary leaves joined again; Adam's
    moments follow the slices."""
    cfg = dict(TRAIN, drop_rate=0.5, loss_mode=loss_mode)
    tcap = t_build(model_type, TConfig(**cfg), VOCAB_TRAIN)
    pt = _train_models(model_type, 0.5)[3]
    images, caps, y = _batch(5)
    one, shard = Recorder(), Recorder()
    _, _, m1 = tstep.make_train_step(tcap, one)(pt, None, _t(images), _t(caps), _t(y),
                                                torch.Generator().manual_seed(6))
    mesh = tpar.make_mesh(devices=["cpu"] * (data * model), model_parallel=model)
    step, place = tstep.make_sharded_train_step(tcap, shard, mesh, shard_vocab=True)
    opt = topt.make_optimizer(model_type, 1e-3)
    placed, state = place(pt, opt.init(pt))
    assert [k.shape[1] for k in placed["decoder"]["output"]["kernel"]] == \
        [t.shape[1] for t in torch.tensor_split(pt["decoder"]["output"]["kernel"], model, 1)]
    _, _, m2 = step(placed, None, images, caps, y, torch.Generator().manual_seed(6))
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["accuracy"]) == float(m1["accuracy"])
    _assert_grads_close(tpar.gather_params(shard.grads, "cpu"), one.grads)
    # a real step: the moments stay split as their params
    real, _ = tstep.make_sharded_train_step(tcap, opt, mesh, shard_vocab=True)
    p2, s2, _ = real(placed, state, images, caps, y, None)
    assert isinstance(s2["mu"]["decoder"]["embedding"], tpar.VocabSlices)
    assert isinstance(p2["decoder"]["output"]["bias"], tpar.VocabSlices)


def test_shard_vocab_step_matches_jax_dryrun():
    """The JAX package's multichip dryrun layout (data 2 x model 2, the
    vocabulary split) against the port's, on JAX's dropout draws: loss,
    accuracy and the clipped Adam update of every param, the vocabulary
    leaves joined."""
    jcap, tcap, pj, pt = _train_models("adaptiveattention", 0.5)
    images, caps, y = _batch(6)
    key = jax.random.PRNGKey(8)
    opt_j, opt_t = (m.make_optimizer("adaptiveattention", 1e-3) for m in (jopt, topt))
    jmesh = jpar.make_mesh(4, model_parallel=2)
    jstep, jplace = j_sharded(jcap, opt_j, jmesh, shard_vocab=True, params_template=pj,
                              opt_state_template=opt_j.init(pj), donate=False)
    p, s = jplace(pj, opt_j.init(pj))
    pj1, _, mj = jstep(p, s, *jpar.shard_batch(jmesh, images, caps, y), key)
    mesh = tpar.make_mesh(devices=["cpu"] * 4, model_parallel=2)
    step, place = tstep.make_sharded_train_step(tcap, opt_t, mesh, shard_vocab=True)
    pt1, _, mt = step(*place(pt, opt_t.init(pt)), images, caps, y, None,
                      masks=_jax_masks(key, pj, 4, 0.5))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]), rel=1e-6)
    gj = jax.grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y), key)
    _assert_updates_match(pj, pj1, tpar.gather_params(pt1, "cpu"), gj)


def test_sharded_eval_step_equals_one_device():
    _, tcap, _, pt = _train_models("gridTD", 0.0)
    images, caps, y = _batch(3, batch=5)       # 5 rows over 2 slots: a ragged split
    m1 = tstep.make_eval_step(tcap)(pt, _t(images), _t(caps), _t(y))
    m2 = tstep.make_sharded_eval_step(tcap, cpu_mesh(2))(pt, _t(images), _t(caps), _t(y))
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["accuracy"]) == float(m1["accuracy"])


STOP = np.zeros(VOCAB_TRAIN + 1, bool)
STOP[5] = True


def test_sharded_finetune_step_equals_one_device_and_jax():
    """LRP-inference fine-tuning on two slots: the one-device step's loss
    and summed gradient (dropout from one generator), and without dropout
    the JAX package's sharded step's loss and accuracy."""
    _, tcap, _, pt = _train_models("adaptiveattention", 0.5)
    images, caps, y = _batch(4)
    one, shard = Recorder(), Recorder()
    _, _, m1 = tft.make_lrp_finetune_step(tcap, one, STOP, 1, 2, "mean")(
        pt, None, _t(images), _t(caps), _t(y), torch.Generator().manual_seed(4))
    _, _, m2 = tft.make_sharded_lrp_finetune_step(tcap, shard, cpu_mesh(2), STOP, 1, 2, "mean")(
        pt, None, images, caps, y, torch.Generator().manual_seed(4))
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["accuracy"]) == float(m1["accuracy"])
    _assert_grads_close(shard.grads, one.grads)

    jcap, tcap0, pj, pt0 = _train_models("adaptiveattention", 0.0)
    opt_j, opt_t = (m.make_optimizer("adaptiveattention", 1e-6) for m in (jopt, topt))
    jmesh = jpar.make_mesh(2)
    jstep = jft.make_sharded_lrp_finetune_step(jcap, opt_j, jmesh, STOP, 1, 2, "mean",
                                               donate=False)
    _, _, mj = jstep(pj, opt_j.init(pj), *jpar.shard_batch(jmesh, images, caps, y),
                     jax.random.PRNGKey(0))
    _, _, mt = tft.make_sharded_lrp_finetune_step(tcap0, opt_t, cpu_mesh(2), STOP, 1, 2)(
        pt0, opt_t.init(pt0), images, caps, y, None)
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]), rel=1e-6)


def _accuracy_targets(tcap, pt, images, caps, y, seed, hits):
    """``y`` relabelled so that the accuracy is known and not 0: at each
    valid step of a row in ``hits`` the one-device forward's argmax (dropout
    from ``seed``) where it leads the runner-up by far more than rounding,
    at every other step its argmin. Returns (y, each row's correct steps,
    each row's valid steps)."""
    with torch.no_grad():
        logits = tcap.forward_train(pt, _t(images), _t(caps),
                                    torch.Generator().manual_seed(seed))[:, :-1]
    top = logits.topk(2, -1)
    hit = torch.zeros(logits.shape[:2], dtype=torch.bool)
    hit[hits] = True
    hit &= (top.values[..., 0] - top.values[..., 1]) > 1e-3 * float(logits.abs().max())
    valid = y[:, :-1].sum(-1) > 0
    y = y.copy()
    y[:, :-1] = np.eye(y.shape[-1], dtype=np.float32)[
        torch.where(hit, top.indices[..., 0], logits.argmin(-1)).numpy()] * valid[..., None]
    return y, (hit.numpy() & valid).sum(1), valid.sum(1)


@pytest.mark.parametrize("path", ["train", "finetune", "shard_vocab"])
def test_sharded_accuracy_is_a_ratio_of_sums(path):
    """Two data slots whose accuracies are not 0 and differ, over unequal
    padding (the first slot's rows are the shorter): the sharded accuracy is
    the one-device ratio of sums, which the mean of the slots' ratios is
    not."""
    _, tcap, _, pt = _train_models("adaptiveattention", 0.5)
    images, caps, y = _batch(7)
    y, correct, valid = _accuracy_targets(tcap, pt, images, caps, y, 8, hits=[0, 1, 2])
    want = correct.sum() / valid.sum()
    slot_mean = (correct[:2].sum() / valid[:2].sum() + correct[2:].sum() / valid[2:].sum()) / 2
    assert want > 0 and abs(slot_mean - want) > 0.05
    params = pt
    if path == "finetune":
        single = tft.make_lrp_finetune_step(tcap, Recorder(), STOP, 1, 2, "mean")
        sharded = tft.make_sharded_lrp_finetune_step(tcap, Recorder(), cpu_mesh(2), STOP, 1, 2,
                                                     "mean")
    else:
        single = tstep.make_train_step(tcap, Recorder())
        mesh = cpu_mesh(2) if path == "train" else tpar.make_mesh(devices=["cpu"] * 4,
                                                                  model_parallel=2)
        sharded = tstep.make_sharded_train_step(tcap, Recorder(), mesh,
                                                shard_vocab=path == "shard_vocab")[0]
        if path == "shard_vocab":
            params = tpar.place_params(mesh, pt, shard_vocab=True)
    _, _, m1 = single(pt, None, _t(images), _t(caps), _t(y), torch.Generator().manual_seed(8))
    _, _, m2 = sharded(params, None, images, caps, y, torch.Generator().manual_seed(8))
    assert float(m2["accuracy"]) == float(m1["accuracy"])
    assert float(m1["accuracy"]) == pytest.approx(want, rel=1e-6)


def test_two_processes_over_gloo_equal_one():
    """Two processes, each with its half of the global batch, joined over
    gloo: both end on the one-process run's losses and params (the dropout
    of the global batch drawn in each from one seed)."""
    sys.path.insert(0, HERE)
    import torch_parallel_worker as worker

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(os.environ.get("TMPDIR", "/tmp"), f"lrpic_gloo_{os.getpid()}_{r}.npz")
            for r in range(2)]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               str(r), "2", str(port), outs[r]], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    ref_losses, ref_params = worker.run(None, 1, None)
    for out in outs:
        with np.load(out) as got:
            np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5)
            # two Adam steps move each param by ~2 lr; a gradient element
            # near 0 can take the other sign under another sum order
            assert np.abs(got["params"] - ref_params).max() <= 2.5e-3
            assert np.mean(np.abs(got["params"] - ref_params) > 1e-6) < 1e-3
        os.remove(out)


# -- the Explainer, the service, export ----------------------------------------------------


class PP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, VOCAB_ENGINE + 1)}
    word_of[1], word_of[2] = "szeros", "zeros"


def _engine_models():
    if "engine" not in _CACHE:
        jcap = j_build("adaptiveattention", JConfig(drop_rate=0.0, image_size=(8, 8), **ENGINE),
                       VOCAB_ENGINE)
        pj = jcap.init_params(jax.random.PRNGKey(3))
        tcap = t_build("adaptiveattention", TConfig(image_size=(8, 8), **ENGINE), VOCAB_ENGINE)
        _CACHE["engine"] = (jcap, pj, tcap, params_from_jax(pj, "cpu"))
    return _CACHE["engine"]


def _images(n, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, 8, 8, 3)) * 40).astype(np.float32)


def _rel(got, ref):
    scale = np.abs(ref).max() if ref.size else 0.0
    return 0.0 if scale == 0 else float(np.abs(got - ref).max() / scale)


def _assert_same(got, ref, rtol=1e-4):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = (e if isinstance(e, dict) else vars(e) for e in (g, r))
        assert g["words"] == r["words"] and g["caption"] == r["caption"]
        for name in FIELDS:
            a, b = np.asarray(g[name]), np.asarray(r[name])
            assert a.shape == b.shape and np.isfinite(a).all(), name
            assert _rel(a, b) <= rtol, (name, _rel(a, b))


TOKENS = np.array([[5, 2, 0, 0, 0], [5, 7, 6, 2, 0], [5, 7, 2, 0, 0], [5, 7, 6, 8, 3],
                   [6, 2, 0, 0, 0], [9, 8, 7, 2, 0]], np.int32)


def test_mesh_explainer_matches_jax_mesh():
    """analyze_many and analyze_batch split over two slots against the JAX
    Explainer on a two-device mesh: decoded and given captions; an
    indivisible batch raises as in JAX."""
    jcap, pj, tcap, pt = _engine_models()
    kw = dict(method="lrp", beam_size=2, word_buckets=(2,))
    jex = JExplainer(jcap, pj, PP(), mesh=jpar.make_mesh(2), **kw)
    tex = Explainer(tcap, pt, PP(), mesh=cpu_mesh(2), batch_size=4, device="cpu", **kw)
    images = _images(6)
    _assert_same(tex.analyze_many(images, TOKENS, batch_size=4),
                 jex.analyze_many(images, TOKENS, batch_size=4))
    _assert_same(tex.analyze_many(images[:3]), jex.analyze_many(images[:3], batch_size=4))
    batch = tex.analyze_batch(images[:4])
    _assert_same(batch, jex.analyze_batch(images[:4]))
    # one host copy of a dispatch's outputs, its rows' fields views of it
    one = Explainer(tcap, pt, PP(), beam_size=2, word_buckets=(2,), device="cpu")
    for rows in (batch, one.analyze_batch(images[:4])):
        assert len({id(e.relevance_maps.base) for e in rows}) == 1
    with pytest.raises(ValueError, match="not divisible"):
        tex.analyze_many(images, TOKENS, batch_size=3)
    assert tex._sub_batch_ladder(8) == jex._sub_batch_ladder(8) == (8, 4, 2)


@pytest.mark.parametrize("method", ["lrp", "gradient"])
def test_word_sharded_analyze_matches_jax(method):
    """One image's words over two and four slots (the bucket rounded up,
    surplus positions clamped and dropped) against the JAX word-sharded
    analyze and the port's unsharded one."""
    jcap, pj, tcap, pt = _engine_models()
    image = _images(1, seed=4)[0]
    jex = JExplainer(jcap, pj, PP(), method=method, beam_size=2, mesh=jpar.make_mesh(2),
                     shard_words=True)
    plain = Explainer(tcap, pt, PP(), method=method, beam_size=2, device="cpu")
    for toks in (TOKENS[1], TOKENS[3], None):
        want = jex.analyze(image, toks)
        _assert_same([plain.analyze(image, toks)], [want])
        for slots in (2, 4):
            tex = Explainer(tcap, pt, PP(), method=method, beam_size=2, mesh=cpu_mesh(slots),
                            shard_words=True, batch_size=4, device="cpu")
            _assert_same([tex.analyze(image, toks)], [want])


def test_mesh_service_matches_jax_mesh():
    """CaptionService over two slots: captions and explanations against the
    JAX service on a two-device mesh; with shard_words a one-image explain
    takes the word-sharded path. Warm-up captures every graph."""
    jcap, pj, tcap, pt = _engine_models()
    images = _images(5, seed=2)
    jsvc = JService(jcap, pj, PP(), batch_size=4, beam_size=2, mesh=jpar.make_mesh(2),
                    shard_words=True)
    tsvc = CaptionService(tcap, pt, PP(), batch_size=4, beam_size=2, mesh=cpu_mesh(2),
                          shard_words=True, device="cpu").warmup(explain=True)
    assert tsvc.caption(images) == jsvc.caption(images)
    _assert_same(tsvc.explain(images), jsvc.explain(images))
    _assert_same(tsvc.explain(images[:1]), jsvc.explain(images[:1]))
    assert tsvc.graph_stats() == {"captures": 0, "pool_bytes": 0}   # the CPU has none


def test_exported_captioner_over_two_slots_equals_one(tmp_path):
    """ExportedCaptioner(devices=["cpu", "cpu"]): chunks dealt to two slots,
    each with its params replica, the same answers as one device."""
    _, _, tcap, pt = _engine_models()
    out = str(tmp_path / "art")
    export_serving(tcap, pt, PP(), out, batch_size=2, beam_size=2, method="lrp",
                   word_buckets=(), device="cpu")
    one = ExportedCaptioner(out, device="cpu")
    two = ExportedCaptioner(out, devices=["cpu", "cpu"], device="cpu")
    assert len(two._slots) == 2 and two._slots[0].graphs is None
    images = _images(5, seed=3)
    assert two.caption(images) == one.caption(images)
    _assert_same(two.explain(images), one.explain(images), rtol=0.0)


# -- the CLI ------------------------------------------------------------------------------

SETS = {"image_size": "8,8", "layer_name": "block2_conv1", "img_feature_length": "16",
        "img_feature_dim": "128", "embedding_dim": "16", "hidden_dim": "16",
        "sentence_length": "5", "words_min_occur": "1", "rare_words_handling": "nothing"}


def _cli_args(root):
    args = ["--dataset-root", root, "--batch-size", "4", "--device", "cpu"]
    for k, v in SETS.items():
        args += ["--set", f"{k}={v}"]
    return args


def test_cli_train_num_devices_and_serve_mesh(tmp_path, monkeypatch):
    """``train --num-devices 2 --device cpu`` trains over two CPU slots and
    writes its checkpoint; ``serve --mesh 2 --shard-words`` on that
    checkpoint answers a one-image /explain through the word-sharded path."""
    from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k

    monkeypatch.chdir(tmp_path)
    write_mini_flickr30k("mini")
    cli.main(["train", *_cli_args("mini"), "--label", "mesh", "--epochs", "1",
              "--num-devices", "2"])
    ckpt = [f for f in os.listdir("results/flickr30k/training-results/mesh")
            if f.startswith("ckpt_00_")]
    assert len(ckpt) == 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["serve", *_cli_args("mini"), "--weights",
            f"results/flickr30k/training-results/mesh/{ckpt[0]}", "--port", str(port),
            "--serve-seconds", "4", "--with-explain", "--mesh", "2", "--shard-words"]
    server = threading.Thread(target=cli.main, args=(argv,))
    server.start()
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=2) as r:
                    if json.load(r)["ok"]:
                        break
            except OSError:
                assert time.time() < deadline
                time.sleep(0.2)
        import io

        buf = io.BytesIO()
        np.save(buf, _images(1))
        req = urllib.request.Request(f"{base}/explain", data=buf.getvalue(),
                                     headers={"Content-Type": "application/x-npy"})
        with urllib.request.urlopen(req, timeout=120) as r:
            z = np.load(io.BytesIO(r.read()))
            assert z["relevance_maps_0"].shape == (len(z["words_0"]), 8, 8, 3)
    finally:
        server.join(timeout=60)
    assert not server.is_alive()
