#!/usr/bin/env python3
"""The port's several-process runs: one launcher and one rank.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT.npz
    python tests/torch_parallel_worker.py --stacked RANK WORLD PORT OUT.npz
    python tests/torch_parallel_worker.py --group RANK WORLD PORT IN.npz OUT.npz
    python tests/torch_parallel_worker.py --claims OUT
    python tests/torch_parallel_worker.py --rank OUT [--size small|full]
        [--backend nccl|gloo] [--steps train,finetune,multi,multi_finetune]
        [--reps N] [--guard SECONDS]

The first joins a gloo group of WORLD processes at localhost:PORT
(``parallel.initialize_distributed``), builds a one-slot CPU mesh inside it
(``make_multihost_mesh``), loads only its ``process_batch_slice`` rows of a
seeded global batch (``shard_global_batch``) and runs two sharded train
steps with dropout drawn for the global batch from one seeded generator.
Writes its losses and final params to OUT. ``run(None, ...)`` computes the
same in this process on the whole batch, without a group: the reference
``tests/test_torch_parallel.py`` holds the processes to. ``--stacked`` does
the same for one K-step call over stacks of K global batches, each process
stacking its own rows (``run_stacked``; ``tests/test_torch_multi_step.py``).
``--group`` runs one rank's captured K-step body eagerly beside the chained
sharded call on given params, batches and masks (``run_group``;
``tests/test_torch_multi_step_group.py``).

``--claims`` and ``--rank`` are ranks of a group that ``launch`` starts
under ``torchrun`` (``torch.distributed.run``), which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` and serves the rendezvous store from its agent; each rank
writes ``OUT<RANK>.npz`` (``.json``). ``--claims`` (gloo, on the CPU)
writes what the group's ownership check says of given layouts
(``claim_errors``). ``--rank`` runs the sharded steps on the default mesh
(``rank_worker``); ``load_rank`` reads what it writes. The card tests
(``tests/test_torch_multicard.py``), ``chip_smoke.py``'s phase 14f and
``scripts/slot_issue_timing.py`` start it. A ``--rank`` rank that has not
ended after ``--guard`` seconds (default GUARD_S) prints every thread's
stack and exits 1, and a rank that ``torchrun`` stops prints its stacks
too: a group that hangs ends with where each rank stood in the log.
"""

import argparse
import faulthandler
import hashlib
import json
import math
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.parallel import (initialize_distributed, make_mesh,  # noqa: E402
                                                make_multihost_mesh, process_batch_slice,
                                                shard_global_batch)
from lrp_imagecaptioning_torch.train.optimizer import make_optimizer  # noqa: E402
from lrp_imagecaptioning_torch.train.step import make_sharded_train_step  # noqa: E402
from lrp_imagecaptioning_torch.weights import tree_leaves  # noqa: E402

GLOBAL_BATCH, VOCAB, STEPS = 8, 32, 2
CFG = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
           img_feature_dim=128, sentence_length=6, batch_size=GLOBAL_BATCH, drop_rate=0.5)
MULTI_K = 4   # --rank's "multi": steps a call (the Trainer's steps_per_call)
MULTI_FINETUNE_K = 2   # --rank's "multi_finetune": the sharded fine-tune's steps a call
GUARD_S = 240   # --rank's hang guard: inside ``finish``'s 300 and 600 s
# --rank's sizes: (FlickrConfig's fields, vocabulary, image side). "full" is
# FlickrConfig's VGG16 at full width: E = H = 512, T = 21, global batch 32
SIZES = {"small": (CFG, VOCAB, 8), "full": ({}, 7003, 224)}
SOS, EOS = 1, 2   # 1-based token ids


def global_batch(batch=GLOBAL_BATCH, side=8, steps=7, vocab=VOCAB, seed=0):
    """(images, captions in, one-hot labels) from ``seed``; a caption of row 1
    ends three steps early (its last label rows are zero)."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, side, side, 3)).astype(np.float32)
    caps = rng.integers(0, vocab, size=(batch, steps)).astype(np.int64)
    y = np.zeros((batch, steps, vocab), np.float32)
    np.put_along_axis(y, rng.integers(0, vocab, size=(batch, steps, 1)), 1.0, axis=-1)
    y[1, -3:] = 0
    return images, caps, y


def run(rank, world, port):
    """(losses, flat params) after STEPS steps: as process ``rank`` of
    ``world`` joined at ``port``, or (rank None) alone on the global batch."""
    torch.set_num_threads(1)
    if rank is None:
        mesh, rows = make_mesh(devices=["cpu"]), slice(None)
    else:
        initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
        mesh, rows = make_multihost_mesh(devices=["cpu"]), process_batch_slice(GLOBAL_BATCH)
    cap = build_captioner("adaptiveattention", FlickrConfig(**CFG), VOCAB)
    opt = make_optimizer("adaptiveattention", 1e-3)
    step, place = make_sharded_train_step(cap, opt, mesh)
    params = cap.init_params(0, device="cpu")
    params, state = place(params, opt.init(params))
    batch = shard_global_batch(mesh, *(a[rows] for a in global_batch()),
                               global_batch=GLOBAL_BATCH)
    gen = torch.Generator().manual_seed(5)
    losses = []
    for _ in range(STEPS):
        params, state, m = step(params, state, *batch, gen)
        losses.append(float(m["loss"]))
    return np.asarray(losses), torch.cat([p.reshape(-1) for p in tree_leaves(params)]).numpy()


def run_stacked(rank, world, port, K=2):
    """One K-step call of the sharded train step (``--steps-per-call``) over
    K global batches (seeds 0..K-1), as process ``rank`` of ``world``, each
    process stacking its own rows (``global_stacked_batch_from_local``), or
    (rank None) alone on the whole stacks, where the K chained sharded steps
    run beside. -> {losses, params (flat), layout [axis, global rows,
    offset], rows: this process's image stack; alone also stack: the whole
    image stack, chained_losses}."""
    from lrp_imagecaptioning_torch.parallel import global_stacked_batch_from_local
    from lrp_imagecaptioning_torch.train.step import make_sharded_multi_train_step

    torch.set_num_threads(1)
    if rank is None:
        mesh, rows = make_mesh(devices=["cpu"]), slice(None)
    else:
        initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
        mesh, rows = make_multihost_mesh(devices=["cpu"]), process_batch_slice(GLOBAL_BATCH)
    cap = build_captioner("adaptiveattention", FlickrConfig(**CFG), VOCAB)
    opt = make_optimizer("adaptiveattention", 1e-3)
    multi, place = make_sharded_multi_train_step(cap, opt, mesh)
    params0, state0 = place(*(lambda p: (p, opt.init(p)))(cap.init_params(0, device="cpu")))
    stacks = [np.stack(a) for a in zip(*(global_batch(seed=k) for k in range(K)))]
    local = [global_stacked_batch_from_local(mesh, a[:, rows], global_batch=GLOBAL_BATCH)
             for a in stacks]
    params, _, m = multi(params0, state0, *local, torch.Generator().manual_seed(5))
    out = {"losses": m["loss"].numpy(), "params": flat(params), "rows": local[0].shards[0].numpy(),
           "layout": np.asarray([local[0].axis, local[0].global_rows, local[0].offset])}
    if rank is None:
        step, _ = make_sharded_train_step(cap, opt, mesh)
        gen, losses, p, s = torch.Generator().manual_seed(5), [], params0, state0
        for k in range(K):
            p, s, m = step(p, s, *(a[k] for a in stacks), gen)
            losses.append(float(m["loss"]))
        out.update(stack=stacks[0], chained_losses=np.asarray(losses))
    return out


def run_group(rank, world, port, inputs) -> dict:
    """Process ``rank`` of a gloo group of ``world`` on the CPU, one slot
    each, over the K global batches of the ``inputs`` npz (``images``,
    ``caps``, ``y`` stacked (K, B, ...), the params' leaves ``p<i>``, the
    train steps' dropout masks of the global batch ``m<k>_<i>``, the config
    ``cfg`` as JSON: FlickrConfig's fields, ``vocab``, ``lr``). For each
    path it runs one rank's K-step call through its per-step copy-in, the
    body the card captures run eagerly (``train.step.rank_multi``), and the
    sharded K-step call of the package (under gloo the sharded steps
    chained), both from the same state on this process's rows:

    * ``train``: the train step with the given masks;
    * ``finetune``: the fine-tune step without dropout;
    * ``finetune_dropout``: the fine-tune step with dropout drawn from one
      seeded generator.

    -> per path the rank call's losses, accuracies and params' leaves, the
    chained call's losses, and whether the two ended bit for bit equal
    (params, moments, losses, accuracies, count)."""
    from lrp_imagecaptioning_torch.models.adaptive import DropoutMasks
    from lrp_imagecaptioning_torch.parallel import global_stacked_batch_from_local
    from lrp_imagecaptioning_torch.train.lrp_finetune import (
        make_lrp_finetune_step, make_sharded_multi_lrp_finetune_step, sharded_finetune_grads)
    from lrp_imagecaptioning_torch.train.step import (make_sharded_multi_train_step, rank_multi,
                                                      sharded_train_grads)
    from lrp_imagecaptioning_torch.weights import tree_unflatten

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_multihost_mesh(devices=["cpu"])
    with np.load(inputs) as z:
        data = {k: z[k] for k in z.files}
    cfg = json.loads(str(data["cfg"]))
    vocab, lr, B = cfg.pop("vocab"), cfg.pop("lr"), data["images"].shape[1]
    K = data["images"].shape[0]
    rows = process_batch_slice(B)
    local = [global_stacked_batch_from_local(mesh, torch.from_numpy(data[a][:, rows]),
                                             global_batch=B) for a in ("images", "caps", "y")]
    n = sum(k.startswith("p") for k in data)
    leaves = [torch.from_numpy(data[f"p{i}"]) for i in range(n)]
    masks = [DropoutMasks(*(torch.from_numpy(data[f"m{k}_{i}"]) for i in range(4)),
                          lstm=tuple(torch.from_numpy(data[f"m{k}_{i}"]) for i in (4, 5)))
             for k in range(K)]
    opt = make_optimizer("adaptiveattention", lr)
    stop = np.zeros(vocab + 1, bool)
    stop[5] = True
    out = {}
    for path, drop in (("train", 0.5), ("finetune", 0.0), ("finetune_dropout", 0.5)):
        cap = build_captioner("adaptiveattention", FlickrConfig(**cfg, drop_rate=drop), vocab)
        params = tree_unflatten(cap.init_params(0, device="cpu"), leaves)
        if path == "train":
            grads_of = sharded_train_grads(cap, mesh)
            chained = make_sharded_multi_train_step(cap, opt, mesh)[0]
        else:
            phases = make_lrp_finetune_step(cap, opt, stop, SOS, EOS).phases
            grads_of = sharded_finetune_grads(cap, mesh, phases)
            chained = make_sharded_multi_lrp_finetune_step(cap, opt, mesh, stop, SOS, EOS)
        given = masks if path == "train" else None
        ends = []
        for call in (rank_multi(cap, opt, mesh, grads_of), chained):
            gen = torch.Generator().manual_seed(5) if path == "finetune_dropout" else None
            p, st, m = call(params, opt.init(params), *local, gen, masks=given)
            ends.append((p, tree_leaves((p, st["mu"], st["nu"])), m, st["count"]))
        (p, mine, m, count), (_, theirs, mc, count_c) = ends
        out.update({f"{path}_losses": m["loss"].numpy(), f"{path}_acc": m["accuracy"].numpy(),
                    f"{path}_chained_losses": mc["loss"].numpy(),
                    f"{path}_equal": count == count_c == K and all(
                        torch.equal(a, b) for a, b in zip(mine, theirs))
                    and torch.equal(m["loss"], mc["loss"])
                    and torch.equal(m["accuracy"], mc["accuracy"])})
        out.update({f"{path}_p{i}": x.numpy() for i, x in enumerate(tree_leaves(p))})
    return out


# -- the launcher -------------------------------------------------------------------------


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def launch(n, args, cards=None, nodes=1, cwd=None):
    """``n`` ranks a node of this script with ``args``, under ``torchrun``
    on this host: ``nodes`` agents (node ranks 0..nodes-1) meet at one free
    port, so each rank has ``LOCAL_WORLD_SIZE`` n. ``cards``: all visible
    cards where None, the first ``cards`` where an int, or for each node the
    indices of the cards it sees (``CUDA_VISIBLE_DEVICES`` a node).
    -> the agents' processes."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    visible = os.environ.get("CUDA_VISIBLE_DEVICES",
                             ",".join(map(str, range(torch.cuda.device_count())))).split(",")
    if isinstance(cards, int):
        cards = [range(cards)] * nodes
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(nodes), "--node-rank",
         str(node), "--nproc-per-node", str(n), "--master-addr", "localhost", "--master-port",
         port, os.path.abspath(__file__), *map(str, args)], cwd=cwd,
        env=env if cards is None else dict(
            env, CUDA_VISIBLE_DEVICES=",".join(visible[i] for i in cards[node])),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for node in range(nodes)]


def finish(procs, timeout=600):
    """[(output, return code)] of ``launch``'s agents, each ended."""
    done = []
    try:
        for p in procs:
            done.append((p.communicate(timeout=timeout)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()   # the agent stops its ranks
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    return done


# -- the ranks -----------------------------------------------------------------------------


def claim_errors():
    """Two ranks on the CPU, the cards they see stood in for (each card
    named only, by its index and id). What the group's ownership check says
    (None where it accepts) of:

    * joining under NCCL where both ranks see one card (the split refuses
      it), and where both claim the same two (``LOCAL_WORLD_SIZE=1``: the
      clash is refused), each before NCCL is called;
    * joining over gloo where each rank sees only its own card: the card
      ``local_devices()`` gives it despite ``LOCAL_WORLD_SIZE=2``;
    * in that gloo group: process 0 owning one device more than the other
      (``make_multihost_mesh``); card lists that share a card, under gloo,
      which may share it, and under NCCL, which may not; each process's
      one card at index 0, distinct cards, under NCCL."""
    from lrp_imagecaptioning_torch.parallel import distributed

    rank, host = int(os.environ["RANK"]), socket.gethostname()

    def error(check):
        try:
            check()
        except ValueError as e:
            return str(e)
        return None

    def sees(ids, local=None):
        distributed.cuda_devices = lambda: [torch.device("cuda", i) for i in range(len(ids))]
        distributed._card_id = lambda i: ids[i]
        os.environ.update(local or {})

    env = dict(os.environ)
    sees(["GPU-0"])
    out = [error(lambda: initialize_distributed(auto=True, backend="nccl"))]
    sees(["GPU-0", "GPU-1"], dict(LOCAL_RANK="0", LOCAL_WORLD_SIZE="1"))
    out.append(error(lambda: initialize_distributed(auto=True, backend="nccl")))
    os.environ.clear()
    os.environ.update(env)
    sees([f"GPU-{rank}"])
    initialize_distributed(auto=True, backend="gloo")
    out.append([str(d) for d in distributed.local_devices()])
    shared = [host, 2, {f"GPU-{rank}": 0, f"GPU-{rank + 1}": 1}]
    return out + [error(lambda: make_multihost_mesh(devices=["cpu"] * (2 if rank == 0 else 1))),
                  error(lambda: distributed._check_group(shared, "gloo")),
                  error(lambda: distributed._check_group(shared, "nccl")),
                  error(lambda: distributed._check_group([host, 1, {f"GPU-{rank}": 0}], "nccl"))]


def caption_dataset(cfg, vocab):
    """A caption dataset whose training vocabulary under the config's
    ``words_min_occur`` is ``vocab`` (its words, SOS and EOS): five
    10-word captions an image over the word list, each word that often
    or more; one validation and one test image."""
    from lrp_imagecaptioning_torch.data.datasets import Dataset, Datum

    rng = np.random.default_rng(0)
    words = np.array([f"w{i:04d}" for i in range(vocab - 2)])
    least = len(words) * cfg.words_min_occur
    images = math.ceil(least / 50)
    seq = np.concatenate([np.repeat(np.arange(len(words)), cfg.words_min_occur),
                          rng.integers(0, len(words), images * 50 - least)])
    caps = [" ".join(words[row]) for row in rng.permutation(seq).reshape(-1, 10)]

    def split(name, n, captions):
        out = []
        for i in range(n):
            fn = f"{name}_{i:04d}.jpg"
            five = tuple(captions[5 * i:5 * i + 5])
            out += [Datum(fn, fn, c, five) for c in (five if name == "train" else five[:1])]
        return out

    ds = Dataset(cfg)
    ds.training_set = split("train", images, caps)
    ds.validation_set, ds.test_set = (split(name, 1, caps[:5]) for name in ("val", "test"))
    return ds


class Recording:
    """An optimizer that keeps the last gradient it is handed."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None):
        self.grads = grads
        return self.opt.update(grads, state, params)


def flat(params) -> np.ndarray:
    return torch.cat([p.reshape(-1) for p in tree_leaves(params)]).float().cpu().numpy()


def leaf_dists(got, ref):
    """(the largest 2-norm of a gradient leaf's distance from the
    reference's over the reference leaf's, the largest |distance| of a leaf
    over its scale); a leaf's norm and scale floored at 1e-3 of the largest
    leaf's (a leaf that is 0 in exact arithmetic holds only rounding)."""
    pairs = [(g.float(), r.float().to(g.device)) for g, r in zip(tree_leaves(got),
                                                                 tree_leaves(ref))]
    norm_floor = 1e-3 * max(float(r.norm()) for _, r in pairs)
    floor = 1e-3 * max(float(r.abs().max()) for _, r in pairs)
    return (max(float((g - r).norm()) / max(float(r.norm()), norm_floor, 1e-30)
                for g, r in pairs),
            max(float((g - r).abs().max()) / max(float(r.abs().max()), floor, 1e-30)
                for g, r in pairs))


def against(got, ref, lr) -> dict:
    """A sharded step's ``got`` = (params, metrics, gradient) against the
    one-device step's ``ref``: the loss's relative distance, the gradient's
    ``leaf_dists``, and the params after the step: the share apart by over
    lr / 2 (Adam's first step moves a param ~lr, so a flip is ~2 lr) and the
    largest distance."""
    (p, m, g), (rp, rm, rg) = got, ref
    grad_dist, leaf_dist = leaf_dists(g, rg)
    diff = np.abs(flat(p) - flat(rp))
    return {"ref_loss": float(rm["loss"]), "ref_acc": float(rm["accuracy"]),
            "loss_rel": abs(float(m["loss"]) - float(rm["loss"])) / abs(float(rm["loss"])),
            "grad_dist": grad_dist, "leaf_dist": leaf_dist,
            "apart": float(np.mean(diff > lr / 2)), "largest": float(diff.max())}


def update_dists(params0, got, ref, lr) -> dict:
    """Two K-step calls' params ``got`` and ``ref`` from ``params0``, by
    their updates (params - params0), in float64: the 2-norm of the
    distance over the reference update's, whole (``dist``) and the largest
    of a leaf (``leaf_dist``, ``leaf_dists``'); and the share of params
    apart by over lr / 2 (``apart``: Adam's early steps move a param by
    about lr, so one whose gradient takes the other sign lies ~2 lr away)."""
    base = [x.double() for x in tree_leaves(params0)]
    update = [x.double() - b for x, b in zip(tree_leaves(got), base)]
    ref_update = [x.double() - b for x, b in zip(tree_leaves(ref), base)]
    diff = torch.cat([(u - r).abs().reshape(-1) for u, r in zip(update, ref_update)])
    whole = math.sqrt(sum(float(r.norm()) ** 2 for r in ref_update))
    return {"dist": float(diff.norm()) / max(whole, 1e-30),
            "leaf_dist": leaf_dists(update, ref_update)[0],
            "apart": float((diff > lr / 2).double().mean())}


def against_multi(params0, got, ref, lr) -> dict:
    """A K-step call's ``got`` = (params, metrics) against K chained
    one-device steps' ``ref`` from ``params0``: the losses' largest relative
    distance, the first step's reference accuracy, the K steps' update
    (params - params0) by ``leaf_dists`` (in ``grad_dist`` / ``leaf_dist``),
    and the params: the share apart by over lr / 2 and the largest
    distance."""
    (p, m), (rp, rm) = got, ref
    base = [x.float() for x in tree_leaves(params0)]
    update = [x.float() - b for x, b in zip(tree_leaves(p), base)]
    ref_update = [x.float().to(b.device) - b for x, b in zip(tree_leaves(rp), base)]
    grad_dist, leaf_dist = leaf_dists(update, ref_update)
    diff = np.abs(flat(p) - flat(rp))
    losses, ref_losses = m["loss"].cpu().double(), rm["loss"].cpu().double()
    return {"ref_loss": float(rm["loss"][0]), "ref_acc": float(rm["accuracy"][0]),
            "ref_losses": ref_losses.numpy(),
            "loss_rel": float(((losses - ref_losses).abs() / ref_losses.abs()).max()),
            "grad_dist": grad_dist, "leaf_dist": leaf_dist,
            "apart": float(np.mean(diff > lr / 2)), "largest": float(diff.max())}


def rank_worker(out, size="small", backend="nccl", steps=("train",), reps=0) -> int:
    """One rank of a group that ``launch`` started: joins it
    (``initialize_distributed(auto=True)``) and builds a Trainer
    (``multihost=True``) on the default mesh ``make_multihost_mesh()``, or,
    under gloo, on the first card (or the CPU) that two ranks may share.
    From the Trainer's params, on this process's rows of the seeded global
    batch, it runs ``steps`` in turn, each from the last one's params:
    ``train`` is the Trainer's sharded train step, ``finetune`` the sharded
    LRP-inference fine-tune step (K2, K1, K3). Each step runs once counted
    (its kernels' launches, its wall and host ms, the ranks starting
    together), again with a recording optimizer on the same dropout (the
    all-reduced gradient), and ``reps`` times more timed; rank 0 also runs
    the one-device step on its first card at the global batch from the same
    params and dropout (``against``).

    ``multi`` is the Trainer's K-step call (``steps_per_call`` MULTI_K),
    ``multi_finetune`` the sharded fine-tune's
    (``make_sharded_multi_lrp_finetune_step``, MULTI_FINETUNE_K), each over
    K seeded global batches: in a NCCL group of one card a process each
    step replayed from one captured rank step with its all-reduce
    (``train.step.rank_multi``; ``captures`` counts its captures), else the
    sharded steps chained (``captures`` -1). After one call that captures,
    the counted call is held in every rank to the K sharded steps chained
    from the same state and dropout (``chained_equal``: params and losses
    bit for bit; ``chained_dist``: ``update_dists``' 2-norm), and on rank 0
    to K chained one-device steps (``against_multi``), all with cuDNN's
    deterministic algorithms. With
    ``reps``, a new call of the same kind and the chained sharded steps
    (``train.step.sharded_multi``) are then timed alike with cuDNN's
    default algorithms, in turn: ms a step, the capture's s, the peak GiB
    of a call and the host's share of a call.

    Writes ``OUT<RANK>.npz``; where the group refuses this process's cards,
    the error and whether the group was joined (the rank ends with 0, so
    that ``torchrun`` stops no rank before it has written its error). The
    StepGraphs are released before the group is destroyed
    (``graphs.release_step_graphs``)."""
    import torch.distributed as dist

    from lrp_imagecaptioning_torch.graphs import release_step_graphs
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.train.lrp_finetune import (
        make_lrp_finetune_step, make_sharded_lrp_finetune_step,
        make_sharded_multi_lrp_finetune_step, sharded_finetune_grads)
    from lrp_imagecaptioning_torch.train.step import (chain_steps, make_sharded_multi_train_step,
                                                      make_train_step, sharded_multi,
                                                      sharded_train_grads)
    from lrp_imagecaptioning_torch.train.trainer import Trainer

    out = f"{out}{os.environ['RANK']}.npz"
    card = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if backend == "gloo" and card.type == "cuda":
        torch.cuda.set_device(card)
    try:
        initialize_distributed(auto=True, backend=backend)
    except ValueError as e:
        np.savez(out, error=str(e), initialized=dist.is_initialized())
        return 0
    try:
        mesh = make_multihost_mesh() if backend == "nccl" else make_multihost_mesh(devices=[card])
        dev, rank = mesh.primary, mesh.process_index
        fields, vocab, side = SIZES[size]
        cfg = FlickrConfig(**fields)
        t = Trainer("adaptiveattention", cfg, caption_dataset(cfg, vocab), label=f"rank{rank}",
                    seed=0, eval_metrics=False, mesh=mesh, multihost=True,
                    steps_per_call=MULTI_K)
        assert t.provider.vocab_size == vocab, t.provider.vocab_size
        whole = [torch.from_numpy(a) for a in global_batch(cfg.batch_size, side,
                                                           cfg.sentence_length + 1, vocab)]
        rows = process_batch_slice(cfg.batch_size)
        batch = [t._place(a[rows]) for a in whole]
        whole = [t._typed(a).to(dev) for a in whole]
        stop = np.zeros(vocab + 1, bool)
        sharded = {"train": lambda o: make_sharded_train_step(t.captioner, o, mesh)[0],
                   "finetune": lambda o: make_sharded_lrp_finetune_step(t.captioner, o, mesh,
                                                                        stop, SOS, EOS)}
        single = {"train": lambda o: make_train_step(t.captioner, o),
                  "finetune": lambda o: make_lrp_finetune_step(t.captioner, o, stop, SOS, EOS)}
        counted = {"train": t._train_step, "finetune": sharded["finetune"](t.optimizer)}
        phases = make_lrp_finetune_step(t.captioner, t.optimizer, stop, SOS, EOS).phases
        # the K-step calls: (the step, K, a new call, the K sharded steps chained)
        multis = {
            "multi": ("train", MULTI_K,
                      lambda: make_sharded_multi_train_step(t.captioner, t.optimizer, mesh)[0],
                      lambda: sharded_multi(t.captioner, t.optimizer, mesh,
                                            sharded_train_grads(t.captioner, mesh))),
            "multi_finetune": ("finetune", MULTI_FINETUNE_K,
                               lambda: make_sharded_multi_lrp_finetune_step(
                                   t.captioner, t.optimizer, mesh, stop, SOS, EOS),
                               lambda: sharded_multi(t.captioner, t.optimizer, mesh,
                                                     sharded_finetune_grads(t.captioner, mesh,
                                                                            phases)))}
        params, state, gen = t.params, t.opt_state, t.generator
        got = {"mesh": json.dumps([[str(d) for d in row] for row in mesh.devices]),
               "steps": json.dumps(list(steps))}

        def sync():
            for d in mesh.slots:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        def timed(step, dropout, inputs=None):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            result = step(params, state, *(batch if inputs is None else inputs), dropout)
            host = time.perf_counter() - t0
            sync()
            return result, (time.perf_counter() - t0) * 1e3, host * 1e3

        stacks = [np.stack(a) for a in zip(*(global_batch(cfg.batch_size, side,
                                                         cfg.sentence_length + 1, vocab, seed=j)
                                             for j in range(MULTI_K)))]
        for k, name in enumerate(steps):
            drawn = gen.get_state()

            def again():
                g = torch.Generator(device=dev)
                g.set_state(drawn)
                return g

            if name in multis:
                key, K, fresh, chained = multis[name]
                multi = t._multi_step if name == "multi" else fresh()
                # cuDNN's deterministic algorithms for the K-step call and its
                # reference: with the default ones two eager chains on one
                # input already part in the weight gradients' last bits,
                # which K Adam steps amplify (chip_smoke.py 6c)
                torch.backends.cudnn.deterministic = True
                local = [t._place_stacked(a[:K, rows]) for a in stacks]
                multi(params, state, *local, torch.Generator(device=dev).manual_seed(99))
                kernels.reset_launches()
                (new_params, new_state, m), ms, host = timed(multi, gen, local)
                launches = {w.__name__: w.launches for w in kernels.KERNELS}
                graph = getattr(multi, "graph", None)   # none where steps chain
                got.update({f"{k}_loss": float(m["loss"][0]), f"{k}_acc": float(m["accuracy"][0]),
                            f"{k}_losses": m["loss"].cpu().numpy(), f"{k}_ms": ms, f"{k}_K": K,
                            f"{k}_host_ms": host, f"{k}_launches": json.dumps(launches),
                            f"{k}_captures": -1 if graph is None else graph.captures,
                            f"{k}_digest": hashlib.sha256(flat(new_params).tobytes()).hexdigest()})
                # the K sharded steps chained from the same state and dropout
                chained_params, _, chained_m = chained()(params, state, *local, again())
                got.update({f"{k}_chained_equal": bool(
                    np.array_equal(flat(chained_params), flat(new_params))
                    and torch.equal(chained_m["loss"].cpu(), m["loss"].cpu())),
                            f"{k}_chained_dist": update_dists(
                                params, new_params, chained_params,
                                t.optimizer.learning_rate)["dist"]})
                del chained_params
                if rank == 0:
                    ref_params, _, ref_m = chain_steps(
                        single[key](t.optimizer), params, state,
                        [t._typed(a[:K], stacked=True).to(dev) for a in stacks], again())
                    got.update({f"{k}_{field}": v for field, v in against_multi(
                        params, (new_params, m), (ref_params, ref_m),
                        t.optimizer.learning_rate).items()})
                    del ref_params
                torch.backends.cudnn.deterministic = False
                if reps:
                    got.update({f"{k}_{field}": v for field, v in timed_multi(
                        dev, timed, fresh(), chained(), again, local, K, reps).items()})
                params, state = new_params, new_state
                continue
            kernels.reset_launches()
            (new_params, new_state, m), ms, host = timed(counted[name], gen)
            launches = {w.__name__: w.launches for w in kernels.KERNELS}
            rec = Recording(t.optimizer)
            sharded[name](rec)(params, state, *batch, again())
            times = [timed(counted[name], again())[1:] for _ in range(reps)]
            got.update({f"{k}_loss": float(m["loss"]), f"{k}_acc": float(m["accuracy"]),
                        f"{k}_ms": ms, f"{k}_host_ms": host,
                        f"{k}_reps_ms": np.asarray([w for w, _ in times]),
                        f"{k}_reps_host_ms": np.asarray([h for _, h in times]),
                        f"{k}_launches": json.dumps(launches),
                        f"{k}_digest": hashlib.sha256(flat(new_params).tobytes()).hexdigest()})
            if rank == 0:
                ref = Recording(t.optimizer)
                ref_params, _, ref_m = single[name](ref)(params, state, *whole, again())
                got.update({f"{k}_{key}": v for key, v in against(
                    (new_params, m, rec.grads), (ref_params, ref_m, ref.grads),
                    t.optimizer.learning_rate).items()})
                del ref, ref_params
            del rec
            params, state = new_params, new_state
        np.savez(out, **got)
    finally:
        release_step_graphs()
        dist.destroy_process_group()
    return 0


def timed_multi(dev, timed, multi, chained, dropout, stacks, K, reps) -> dict:
    """A new K-step call ``multi`` and the K chained sharded steps
    ``chained`` timed alike (``timed``: the ranks start together, the cards
    synchronized before and after) on the same stacks and dropout: after
    the call that captures (its capture timed alone) and a warm-up of the
    chain, ``reps`` of each in turn (ABBA). -> the reps' wall and host ms,
    ms a step, the host's share of a call and the peak GiB allocated in a
    call, each for both (the chained ones prefixed ``chained_``), and the
    capture's s."""
    spent = []
    graph = getattr(multi, "graph", None)
    if graph is not None:
        capture = graph._capture

        def timed_capture(*args):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            capture(*args)
            torch.cuda.synchronize(dev)
            spent.append(time.perf_counter() - t0)

        graph._capture = timed_capture
    timed(multi, dropout(), stacks)
    timed(chained, dropout(), stacks)
    runs = {"": (multi, [], []), "chained_": (chained, [], [])}
    for r in range(reps):
        for label in ("", "chained_") if r % 2 == 0 else ("chained_", ""):
            call, times, peaks = runs[label]
            torch.cuda.reset_peak_memory_stats(dev)
            times.append(timed(call, dropout(), stacks)[1:])
            peaks.append(torch.cuda.max_memory_allocated(dev) / 2**30)
    out = {"capture_s": spent[0] if spent else float("nan")}
    for label, (_, times, peaks) in runs.items():
        wall, host = np.asarray([w for w, _ in times]), np.asarray([h for _, h in times])
        out.update({f"{label}reps_ms": wall, f"{label}reps_host_ms": host,
                    f"{label}ms_per_step": float(np.median(wall)) / K,
                    f"{label}host_share": float(np.median(host / wall)),
                    f"{label}peak_gib": max(peaks)})
    if graph is not None:
        graph.release()
    return out


def load_rank(path) -> dict:
    """What ``rank_worker`` wrote: JSON fields parsed, scalars as float."""
    with np.load(path) as z:
        return {k: (json.loads(str(z[k])) if k in ("mesh", "steps") or k.endswith("_launches")
                    else str(z[k]) if k.endswith(("_digest", "error"))
                    else z[k] if z[k].ndim else z[k].item()) for k in z.files}


if __name__ == "__main__":
    if sys.argv[1] == "--claims":
        torch.set_num_threads(1)
        with open(f"{sys.argv[2]}{os.environ['RANK']}.json", "w") as f:
            json.dump(claim_errors(), f)
        torch.distributed.destroy_process_group()
        sys.exit(0)
    if sys.argv[1] == "--rank":
        ap = argparse.ArgumentParser()
        ap.add_argument("--rank", dest="out", required=True)
        ap.add_argument("--size", choices=SIZES, default="small")
        ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
        ap.add_argument("--steps", default="train")
        ap.add_argument("--reps", type=int, default=0)
        ap.add_argument("--guard", type=float, default=GUARD_S)
        a = ap.parse_args()
        faulthandler.dump_traceback_later(a.guard, exit=True)
        faulthandler.register(signal.SIGTERM, chain=True)
        sys.exit(rank_worker(a.out, a.size, a.backend, a.steps.split(","), a.reps))
    if sys.argv[1] == "--group":
        rank, world, port = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
        np.savez(sys.argv[6], **run_group(rank, world, port, sys.argv[5]))
        torch.distributed.destroy_process_group()
        sys.exit(0)
    if sys.argv[1] == "--stacked":
        rank, world, port, out = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
        np.savez(out, **run_stacked(rank, world, port))
        torch.distributed.destroy_process_group()
        sys.exit(0)
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    losses, flat_params = run(rank, world, port)
    np.savez(out, losses=losses, params=flat_params)
    torch.distributed.destroy_process_group()
