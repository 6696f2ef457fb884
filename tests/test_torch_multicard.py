"""PyTorch port over several cards (marker ``cuda``; skips with fewer than
two cards, so here and on a one-card machine):

* each kernel launched on every card in turn, cuda:0 first: its launch on
  a second card must not rest on a setting made on the first (the dynamic
  shared memory that K3 and K4 opt in to is a setting of each device's
  context); each held to its plain version on the same card, K1 and K3 at
  1e-5 of scale (f32), K4 at 1e-2 (bf16 storage), K2 at 1e-6;
* the sharded train and fine-tune steps on a mesh of two cards against
  the one-device step on cuda:0, at the CPU tests' size: loss at rel 1e-5,
  gradients within 1e-4 of each leaf's scale (the card tests' bound;
  cuDNN sums in another order at another batch);
* the mesh Explainer over two cards against one card, f32 and bf16
  storage, on two calls with other images (the second replays the graphs
  the first captured, on each card; an empty capture is an error):
  captions token-exact, every array within 1e-4 of its scale (f32) or
  1e-2 (bf16 storage);
* an artifact exported on cuda:0 served over two cards (its programs
  moved to the second by ``move_to_device_pass``) against one card, two
  calls of two chunks each: the same programs on the same shapes, so
  captions token-exact and every array within 1e-6 of its scale.

* NCCL groups of one process a block of cards (2 ranks of one card, 4 of
  one, 2 of two), started by a real ``torchrun --nproc-per-node N``
  (``torch_parallel_worker.launch``; its agent serves the rendezvous
  store), each rank's mesh from the default ``make_multihost_mesh()``: two
  sharded train steps (the Trainer's) and one fine-tune step on its rows,
  each against the one-device step on rank 0's card from the same params
  and dropout at the bounds above; the ranks' params bit for bit equal
  after each step (they apply one all-reduced gradient);
* two ``torchrun`` agents of one rank each on one host
  (``LOCAL_WORLD_SIZE=1``), both claiming every card, refused with
  ``ValueError`` before the group is joined, so before any NCCL call;
* two such agents, each seeing only its own card (``CUDA_VISIBLE_DEVICES``
  a rank): both ranks at cuda:0 of distinct cards, accepted (a card is
  known by its UUID), the steps as above;
* the Trainer's K-step call (``steps_per_call`` 4) in NCCL groups of 2 and
  4 ranks, one a card, and the sharded fine-tune's (K = 2) at 2 ranks:
  each step replayed from one captured rank step with its all-reduce, one
  capture a rank, bit for bit the K sharded steps chained from the same
  state and dropout, against K chained one-device steps (losses at rel 1e-5,
  the update within chip_smoke's TOL_MESH_GRAD by the 2-norm), the ranks'
  params bit for bit, launches K x one step's. Each rank's hang guard
  (``torch_parallel_worker.GUARD_S``) ends a hung group with its stacks in
  the log inside ``finish``'s timeout.

Nothing here imports JAX: ``pytest --noconftest -m cuda`` runs it on a
machine without JAX.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.infer.export import ExportedCaptioner, export_serving  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.parallel import make_mesh  # noqa: E402
from lrp_imagecaptioning_torch.train import lrp_finetune, step  # noqa: E402
from lrp_imagecaptioning_torch.weights import tree_leaves, tree_map  # noqa: E402

CFG = FlickrConfig(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1",
                   img_feature_length=16, img_feature_dim=128, sentence_length=6, batch_size=4,
                   drop_rate=0.5)
VOCAB, B, T = 32, 4, 7
STOP = np.zeros(VOCAB + 1, bool)
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")


def _rel(got, ref):
    got, ref = (torch.as_tensor(np.asarray(a, np.float32)) if not torch.is_tensor(a)
                else a.float().cpu() for a in (got, ref))
    if not ref.numel():
        return 0.0
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


@pytest.fixture(autouse=True)
def _cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a mesh over cards and a launch on a second card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cards_in_turn():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
def test_every_kernel_launches_on_every_card():
    """At shapes that take K3's big tile and K4's widest launch (both above
    48 KB of shared memory a block)."""
    rng = np.random.default_rng(30)

    def t(*shape, scale=1.0, positive=False):
        a = rng.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(np.abs(a) if positive else a)

    x = t(5, 28, 28, 64, positive=True)
    k, b, r = t(3, 3, 64, 128, scale=0.1), t(128, scale=0.1), t(5, 28, 28, 128)
    lin_x, lin_w, lin_r = t(160, 512), t(512, 7003), t(160, 7003)
    zx, zh, bias, c = t(24, 2048), t(24, 2048), t(2048), t(24, 512)
    x4 = t(1, 56, 56, 64, positive=True)
    k4, b4, r4 = t(3, 3, 64, 64, scale=0.1), t(64, scale=0.1), t(20, 56, 56, 64)
    for dev in _cards_in_turn():
        on = lambda *a: [v.to(dev) for v in a]   # noqa: E731
        before = {f.__name__: f.launches for f in kernels.KERNELS}
        xd, kd, bd, rd = on(x, k, b, r)
        got = kernels.conv3x3_fused(xd, rd, kd, None, mode="multiply")
        assert _rel(got, kernels.conv3x3_fused_plain(xd, rd, kd, None, mode="multiply")) < 1e-5
        xl, wl, rl = on(lin_x, lin_w, lin_r)
        got = kernels.lrp_linear(rl, xl, xl @ wl, wl)
        assert _rel(got, kernels.lrp_linear_plain(rl, xl, xl @ wl, wl)) < 1e-5
        got = kernels.lstm_gates(*on(zx, zh, bias, c))
        for g, w in zip(got, kernels.lstm_gates_plain(*on(zx, zh, bias, c))):
            assert _rel(g, w) < 1e-6
        xb, kb, bb, rb = (v.bfloat16() for v in on(x4, k4, b4, r4))
        got = kernels.lrp_a1b0_fused(rb, xb, kb, bb)
        assert _rel(got, kernels.lrp_a1b0_fused_plain(rb, xb, kb, bb)) < 1e-2
        assert {f.__name__: f.launches - before[f.__name__] for f in kernels.KERNELS} == \
            {"lrp_linear": 1, "lstm_gates": 1, "conv3x3_fused": 1, "lrp_a1b0_fused": 1}, dev


class _Recorder:
    def __init__(self):
        self.grads = None

    def update(self, grads, state, params=None):
        self.grads = grads
        return tree_map(torch.zeros_like, grads), state


def _batch(seed, dev):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(B, 8, 8, 3)).astype(np.float32) * 40)
    caps = torch.from_numpy(rng.integers(0, VOCAB, size=(B, T)))
    y = torch.from_numpy(np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(B, T))])
    y[0, -3:] = 0
    return images.to(dev), caps.to(dev), y.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["train", "finetune"])
def test_sharded_steps_over_two_cards(path):
    dev = torch.device("cuda", 0)
    cap = build_captioner("adaptiveattention", CFG, VOCAB)
    params = cap.init_params(seed=0, device=dev)
    mesh = make_mesh(devices=_cards_in_turn()[:2])
    one, shard = _Recorder(), _Recorder()
    if path == "train":
        single, sharded = step.make_train_step(cap, one), step.make_sharded_train_step(
            cap, shard, mesh)[0]
    else:
        single = lrp_finetune.make_lrp_finetune_step(cap, one, STOP, 1, 2)
        sharded = lrp_finetune.make_sharded_lrp_finetune_step(cap, shard, mesh, STOP, 1, 2)
    batch = _batch(1, dev)
    _, _, m1 = single(params, None, *batch, torch.Generator(device=dev).manual_seed(3))
    _, _, m2 = sharded(params, None, *batch, torch.Generator(device=dev).manual_seed(3))
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["accuracy"]) == float(m1["accuracy"])
    leaves = list(zip(tree_leaves(shard.grads), tree_leaves(one.grads)))
    floor = 1e-3 * max(float(r.abs().max()) for _, r in leaves)
    for g, r in leaves:
        assert g.device == dev
        assert float((g - r).abs().max()) <= 1e-4 * max(float(r.abs().max()), floor)


class _PP:
    SOS_TOKEN, EOS_TOKEN = "szeros", "zeros"
    SOS_TOKEN_LABEL_ENCODED, EOS_TOKEN_LABEL_ENCODED = 1, 2
    word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}
    word_of[1], word_of[2] = "szeros", "zeros"


@pytest.mark.cuda
@pytest.mark.filterwarnings("error:The CUDA Graph is empty")
@pytest.mark.parametrize("storage_dtype, tol", [(None, 1e-4), (torch.bfloat16, 1e-2)])
def test_mesh_explainer_over_two_cards(storage_dtype, tol):
    cfg = FlickrConfig(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1",
                       img_feature_length=16, img_feature_dim=128, sentence_length=5,
                       image_size=(8, 8))
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device="cuda:0")
    kw = dict(beam_size=2, word_buckets=(2,), batch_size=4, storage_dtype=storage_dtype)
    one = Explainer(cap, params, _PP(), device="cuda:0", **kw)
    two = Explainer(cap, params, _PP(), mesh=make_mesh(devices=_cards_in_turn()[:2]), **kw)
    for seed in (5, 6):
        images = (np.random.default_rng(seed).normal(size=(4, 8, 8, 3)) * 40).astype(np.float32)
        want, got = one.analyze_batch(images), two.analyze_batch(images)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.words == w.words and g.caption == w.caption
            for name in FIELDS:
                a, b = (np.asarray(getattr(e, name), np.float32) for e in (g, w))
                assert a.shape == b.shape and np.isfinite(a).all(), name
                assert _rel(a, b) <= tol, (seed, name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.filterwarnings("error:The CUDA Graph is empty")
def test_exported_over_two_cards(tmp_path):
    cfg = FlickrConfig(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1",
                       img_feature_length=16, img_feature_dim=128, sentence_length=5,
                       image_size=(8, 8))
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device="cuda:0")
    out = str(tmp_path / "artifact")
    export_serving(cap, params, _PP(), out, batch_size=3, beam_size=2, method="lrp",
                   word_buckets=(2,), device="cuda:0")
    one = ExportedCaptioner(out, device="cuda:0")
    two = ExportedCaptioner(out, devices=2, device="cuda:0")
    assert two.devices == _cards_in_turn()[:2]
    for seed in (7, 8):
        images = (np.random.default_rng(seed).normal(size=(6, 8, 8, 3)) * 40).astype(np.float32)
        want, got = one.explain(images), two.explain(images)
        assert two.caption(images) == one.caption(images)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g["words"] == w["words"] and g["caption"] == w["caption"]
            for name in FIELDS:
                a, b = (np.asarray(e[name], np.float32) for e in (g, w))
                assert a.shape == b.shape and np.isfinite(a).all(), name
                assert _rel(a, b) <= 1e-6, (seed, name, _rel(a, b))


HERE = os.path.dirname(os.path.abspath(__file__))


def _group(tmp_path, n, nodes=1, cards=None, steps="train,train,finetune"):
    """``n`` ranks a node of ``torch_parallel_worker.py --rank`` at the
    small size under ``torchrun``: ``steps`` (two train steps and a
    fine-tune step), rank 0 against one device. -> (agents' logs, return
    codes, each rank's results)."""
    sys.path.insert(0, HERE)
    import torch_parallel_worker as worker

    prefix = str(tmp_path / "rank")
    done = worker.finish(worker.launch(n, ["--rank", prefix, "--steps", steps],
                                       cards=cards, nodes=nodes, cwd=tmp_path), timeout=300)
    logs, rcs = [d[0] for d in done], [d[1] for d in done]
    ranks = [worker.load_rank(f"{prefix}{r}.npz") for r in range(n * nodes)
             if os.path.exists(f"{prefix}{r}.npz")]
    return logs, rcs, ranks


@pytest.mark.cuda
@pytest.mark.parametrize("ranks, cards_a_rank", [(2, 1), (4, 1), (2, 2)])
def test_nccl_group_one_process_a_block_of_cards(tmp_path, ranks, cards_a_rank):
    if torch.cuda.device_count() < ranks * cards_a_rank:
        pytest.skip(f"needs {ranks * cards_a_rank} cards")
    logs, rcs, got = _group(tmp_path, ranks, cards=ranks * cards_a_rank)
    assert rcs == [0] and len(got) == ranks, logs
    for r, z in enumerate(got):
        assert z["mesh"] == [[f"cuda:{r * cards_a_rank + j}"] for j in range(cards_a_rank)]
    ref = got[0]
    for k in range(3):   # train, train, fine-tune
        assert ref[f"{k}_loss_rel"] <= 1e-5, (k, ref[f"{k}_loss_rel"])
        assert ref[f"{k}_leaf_dist"] <= 1e-4, (k, ref[f"{k}_leaf_dist"])
        for r, z in enumerate(got):
            assert z[f"{k}_loss"] == ref[f"{k}_loss"] and z[f"{k}_acc"] == ref[f"{k}_ref_acc"]
            assert z[f"{k}_digest"] == ref[f"{k}_digest"], (k, r)


# chip_smoke.TOL_MESH_GRAD: the sharded gradient's distance from one
# device's by the 2-norm, here held on the update of K steps
TOL_MESH_GRAD = 4.5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_nccl_group_k_steps_a_call(tmp_path, ranks):
    """The Trainer's K-step call (``steps_per_call`` 4) in NCCL groups of
    one process a card: each step the replay of one captured rank step with
    its all-reduce (``train.step.rank_multi``), one capture a rank, bit for
    bit the K sharded steps chained from the same state and dropout (cuDNN's
    deterministic algorithms); against
    K chained one-device steps on rank 0: the losses at rel 1e-5, the K
    steps' update within TOL_MESH_GRAD by the 2-norm; the ranks' params bit
    for bit; each rank's launches K x one step's at its rows."""
    if torch.cuda.device_count() < ranks:
        pytest.skip(f"needs {ranks} cards")
    logs, rcs, got = _group(tmp_path, ranks, cards=ranks, steps="train,multi")
    assert rcs == [0] and len(got) == ranks, logs
    ref = got[0]
    assert ref["1_loss_rel"] <= 1e-5, ref["1_loss_rel"]
    assert ref["1_grad_dist"] <= TOL_MESH_GRAD, ref["1_grad_dist"]
    for z in got:
        assert z["1_captures"] == 1 and z["1_chained_equal"], z["1_chained_dist"]
        assert z["1_launches"] == {"lrp_linear": 0, "lstm_gates": 4 * 7, "conv3x3_fused": 0,
                                   "lrp_a1b0_fused": 0}
        assert z["1_digest"] == ref["1_digest"] and z["1_acc"] == ref["1_ref_acc"]


@pytest.mark.cuda
def test_nccl_group_k_finetune_steps_a_call(tmp_path):
    """The sharded fine-tune's K-step call (K = 2) in a NCCL group of two
    processes, one a card, as the train step's above: one capture a rank,
    against K chained one-device fine-tune steps on rank 0, the ranks'
    params bit for bit, each rank's launches K x those of its sharded
    fine-tune step (step 0) at its rows."""
    logs, rcs, got = _group(tmp_path, 2, cards=2, steps="finetune,multi_finetune")
    assert rcs == [0] and len(got) == 2, logs
    ref = got[0]
    assert ref["1_K"] == 2
    assert ref["1_loss_rel"] <= 1e-5, ref["1_loss_rel"]
    assert ref["1_grad_dist"] <= TOL_MESH_GRAD, ref["1_grad_dist"]
    for z in got:
        assert z["1_captures"] == 1 and z["1_chained_equal"], z["1_chained_dist"]
        assert z["1_launches"] == {k: 2 * v for k, v in z["0_launches"].items()}
        assert z["1_launches"]["conv3x3_fused"] > 0 and z["1_launches"]["lrp_linear"] > 0
        assert z["1_digest"] == ref["1_digest"] and z["1_acc"] == ref["1_ref_acc"]


@pytest.mark.cuda
def test_two_ranks_claiming_every_card_raise_before_nccl(tmp_path):
    logs, rcs, got = _group(tmp_path, 1, nodes=2)
    assert rcs == [0, 0] and len(got) == 2, logs
    for z in got:
        assert not z["initialized"]
        assert z["error"].startswith("processes 0 and 1 both hold card "), z["error"]
        assert "(cuda:0 in process 0, cuda:0 in process 1)" in z["error"]


@pytest.mark.cuda
def test_ranks_each_seeing_only_their_own_card(tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards")
    logs, rcs, got = _group(tmp_path, 1, nodes=2, cards=[[0], [1]])
    assert rcs == [0, 0] and len(got) == 2, logs
    assert [z["mesh"] for z in got] == [[["cuda:0"]]] * 2
    for k in range(3):
        assert got[0][f"{k}_loss_rel"] <= 1e-5 and got[0][f"{k}_leaf_dist"] <= 1e-4, k
        assert got[0][f"{k}_digest"] == got[1][f"{k}_digest"], k
