"""PyTorch port: one rank's K-step call in a process group of one slot a
process (``train.step.rank_multi``), the step a card captures with the
group's all-reduce inside, run eagerly on the CPU over gloo.

Two gloo processes (``tests/torch_parallel_worker.py --group``) each run
the rank body through its per-step copy-in of the rank's rows, its rows of
the global batch's dropout masks and Adam's scalars (``graphs.StepGraph``
without a graph), over K = 2 global batches, beside the package's sharded
K-step call, which under gloo chains the sharded steps. The size of
tests/test_torch_multi_step.py: VGG16 cut at block2_conv1 (8x8 images),
E = H = 16, vocab 32, global batch 4 (2 rows a process), T = 7; the params
from the JAX package's init.

Tolerances, each with its reason:

* the rank call against the chained sharded call in the same process: bit
  for bit (the same functions on the same rows, masks and scalars, in the
  same order), params, moments, losses, accuracies and the count;
* against the JAX package's ``make_sharded_multi_train_step`` /
  ``make_sharded_multi_lrp_finetune_step`` on two CPU devices, at lr 1e-3:
  the losses at rel 1e-5, the accuracies at rel 1e-6, the K steps' update
  within tests/test_torch_multi_step.py's bounds (UPDATE_DIST,
  UPDATE_LEAF_DIST, UPDATE_APART, its module docstring), the train step
  on the JAX package's masks for its keys, the fine-tune step without
  dropout (as that file holds them).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu import parallel as jpar  # noqa: E402
from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models import cells as jcells  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.train import lrp_finetune as jft  # noqa: E402
from lrp_imagecaptioning_tpu.train import optimizer as jopt  # noqa: E402
from lrp_imagecaptioning_tpu.train import step as jstep  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.graphs import StepGraph  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.parallel import make_mesh  # noqa: E402
from lrp_imagecaptioning_torch.train import optimizer as topt  # noqa: E402
from lrp_imagecaptioning_torch.train import step as tstep  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_leaves  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_parallel_worker as worker  # noqa: E402

KW = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
          img_feature_dim=128, sentence_length=6, batch_size=4)
VOCAB, B, T, K, LR = 32, 4, 7, 2, 1e-3
# tests/test_torch_multi_step.py's bounds on the K steps' update against JAX's
UPDATE_DIST, UPDATE_LEAF_DIST, UPDATE_APART = 1e-4, 1e-3, 1e-3
STOP = np.zeros(VOCAB + 1, bool)
STOP[5] = True   # the worker's stop table
PATHS = ("train", "finetune", "finetune_dropout")


def _batches(seed):
    """K global batches (images, captions in, one-hot labels), stacked on
    axis 0, two rows with padding."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(K, B, 8, 8, 3)).astype(np.float32)
    caps = rng.integers(0, VOCAB, size=(K, B, T)).astype(np.int64)
    y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(K, B, T))]
    y[:, 0, -2:] = 0
    y[:, 3, -4:] = 0
    return images, caps, y


def _jax_masks(key, pj, rate=0.5):
    """The JAX package's masks of one train forward over the global batch at
    ``key`` (its sharded step draws these), leaf by leaf in the port's
    ``DropoutMasks`` order."""
    ks = jax.random.split(key, 5)
    keep = 1.0 - rate
    H, V = pj["decoder"]["output"]["kernel"].shape
    E = pj["decoder"]["embedding"].shape[-1]

    def bern(k, shape):
        return np.asarray(jax.random.bernoulli(k, keep, shape), np.float32) / keep

    lstm = jcells.lstm_dropout_masks(ks[4], 2 * E, KW["hidden_dim"], rate, batch=B)
    return [bern(ks[0], (B, KW["img_feature_length"], H)), bern(ks[1], (B, E)),
            bern(ks[2], (B, H)), bern(ks[3], (B, V)), *(np.asarray(m) for m in lstm)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two gloo processes' results and the JAX package's sharded K-step
    calls on two devices, computed while the processes run."""
    tmp = tmp_path_factory.mktemp("group")
    images, caps, y = _batches(11)
    jcaps = {rate: j_build("adaptiveattention", JConfig(**KW, drop_rate=rate, image_size=(8, 8)),
                           VOCAB) for rate in (0.5, 0.0)}
    pj = jcaps[0.0].init_params(jax.random.PRNGKey(0))
    pt = params_from_jax(pj, "cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), K)
    inputs = {"images": images, "caps": caps, "y": y,
              "cfg": json.dumps(dict(KW, vocab=VOCAB, lr=LR))}
    inputs.update({f"p{i}": x.numpy() for i, x in enumerate(tree_leaves(pt))})
    inputs.update({f"m{k}_{i}": m for k, key in enumerate(keys)
                   for i, m in enumerate(_jax_masks(key, pj))})
    np.savez(tmp / "in.npz", **inputs)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               "--group", str(r), "2", str(port), str(tmp / "in.npz"),
                               str(tmp / f"out{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        jmesh = jpar.make_mesh(2)
        stack = jpar.stacked_batch_sharding(jmesh)
        placed = [jax.device_put(a, stack) for a in (images, caps.astype(np.int32), y)]
        jax_out = {}
        opt_j = jopt.make_optimizer("adaptiveattention", LR)
        multi, place = jstep.make_sharded_multi_train_step(jcaps[0.5], opt_j, jmesh,
                                                           params_template=pj, donate=False)
        jax_out["train"] = multi(*place(pj, opt_j.init(pj)), *placed, keys)
        jax_out["finetune"] = jft.make_sharded_multi_lrp_finetune_step(
            jcaps[0.0], opt_j, jmesh, STOP, 1, 2, donate=False)(
            pj, opt_j.init(pj), *placed, jax.random.split(jax.random.PRNGKey(0), K))
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = []
    for r in range(2):
        with np.load(tmp / f"out{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return pt, ranks, jax_out


@pytest.mark.parametrize("path", PATHS)
def test_rank_body_ends_on_the_chained_sharded_call(group, path):
    """Each rank's K-step call through the rank body ends bit for bit on the
    package's chained sharded call (params, moments, losses, accuracies,
    count), and the two ranks on one another (one all-reduced update)."""
    _, ranks, _ = group
    for r, z in enumerate(ranks):
        assert bool(z[f"{path}_equal"]), (path, r)
        assert z[f"{path}_losses"].shape == (K,)
    names = [k for k in ranks[0] if k.startswith(f"{path}_p")]
    assert names
    for name in names + [f"{path}_losses", f"{path}_acc"]:
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])


@pytest.mark.parametrize("path", ["train", "finetune"])
def test_rank_body_matches_jax_sharded_multi_step(group, path):
    """The rank call's losses, accuracies and K steps' update against the
    JAX package's sharded K-step call on two devices."""
    pt, ranks, jax_out = group
    pj1, _, mj = jax_out[path]
    leaves = tree_leaves(pt)
    for r, z in enumerate(ranks):
        np.testing.assert_allclose(z[f"{path}_losses"], np.asarray(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(z[f"{path}_acc"], np.asarray(mj["accuracy"]), rtol=1e-6)
        got = [torch.from_numpy(z[f"{path}_p{i}"]) for i in range(len(leaves))]
        d = worker.update_dists(leaves, got, tree_leaves(params_from_jax(pj1, "cpu")), LR)
        assert (d["dist"] <= UPDATE_DIST and d["leaf_dist"] <= UPDATE_LEAF_DIST
                and d["apart"] <= UPDATE_APART), (r, d)


def test_gloo_and_meshes_without_a_group_do_not_take_the_rank_call():
    """A mesh without a process group is never a rank of one: of one slot
    it takes the one-device call, of two the chained sharded steps; the
    package's sharded K-step call there has no graph. A gloo group of CPU
    slots chains too: its ranks' chained call is what the test above holds
    the rank call to."""
    cap = t_build("adaptiveattention", TConfig(**KW, drop_rate=0.5), VOCAB)
    opt = topt.make_optimizer("adaptiveattention", LR)
    for n in (1, 2):
        mesh = make_mesh(devices=["cpu"] * n)
        assert tstep.one_device_mesh(mesh) == (n == 1)
        assert not tstep.one_card_a_process(mesh)
        multi, _ = tstep.make_sharded_multi_train_step(cap, opt, mesh)
        assert not hasattr(multi, "graph")


def test_step_graph_on_the_cpu_runs_its_body_and_releases():
    """On the CPU a StepGraph runs its body on its static tensors: a call is
    the chained single steps bit for bit, and after ``release`` (its
    tensors dropped, nothing captured) a call sets them up anew and gives
    the same."""
    cap = t_build("adaptiveattention", TConfig(**KW, drop_rate=0.5), VOCAB)
    opt = topt.make_optimizer("adaptiveattention", LR)
    params = cap.init_params(0, device="cpu")
    stacks = [torch.from_numpy(a) for a in _batches(12)]
    stacks[1] = stacks[1].long()
    graph = StepGraph(tstep.graph_body(opt, tstep.train_grads(cap)), opt)
    masks = tstep.drawn_masks(cap, params, B, K, torch.Generator().manual_seed(3))
    want, want_state, want_m = tstep.chain_steps(tstep.make_train_step(cap, opt), params,
                                                 opt.init(params), stacks, None, masks)
    for _ in range(2):
        got, state, m = graph(params, opt.init(params), stacks, masks)
        assert graph.captures == 0 and graph.graph is None and state["count"] == K
        assert torch.equal(m["loss"], want_m["loss"])
        for a, b in zip(tree_leaves((got, state["mu"], state["nu"])),
                        tree_leaves((want, want_state["mu"], want_state["nu"]))):
            assert torch.equal(a, b)
        graph.release()
        assert graph.key is None and graph.params is None
