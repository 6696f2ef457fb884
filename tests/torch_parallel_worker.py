#!/usr/bin/env python3
"""One process of the port's several-process training check.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT.npz

Joins a gloo group of WORLD processes at localhost:PORT
(``parallel.initialize_distributed``), builds a one-slot CPU mesh inside it
(``make_multihost_mesh``), loads only its ``process_batch_slice`` rows of a
seeded global batch (``shard_global_batch``) and runs two sharded train
steps with dropout drawn for the global batch from one seeded generator.
Writes its losses and final params to OUT. ``run(None, ...)`` computes the
same in this process on the whole batch, without a group: the reference
``tests/test_torch_parallel.py`` holds the processes to.
"""

import sys

import numpy as np
import torch

from lrp_imagecaptioning_torch.config import FlickrConfig
from lrp_imagecaptioning_torch.models.captioner import build_captioner
from lrp_imagecaptioning_torch.parallel import (initialize_distributed, make_mesh,
                                                make_multihost_mesh, process_batch_slice,
                                                shard_global_batch)
from lrp_imagecaptioning_torch.train.optimizer import make_optimizer
from lrp_imagecaptioning_torch.train.step import make_sharded_train_step
from lrp_imagecaptioning_torch.weights import tree_leaves

GLOBAL_BATCH, VOCAB, STEPS = 8, 32, 2
CFG = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
           img_feature_dim=128, sentence_length=6, batch_size=GLOBAL_BATCH, drop_rate=0.5)


def global_batch():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(GLOBAL_BATCH, 8, 8, 3)).astype(np.float32)
    caps = rng.integers(0, VOCAB, size=(GLOBAL_BATCH, 7)).astype(np.int64)
    y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(GLOBAL_BATCH, 7))]
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
    params = cap.init_params(0, "cpu")
    params, state = place(params, opt.init(params))
    batch = shard_global_batch(mesh, *(a[rows] for a in global_batch()),
                               global_batch=GLOBAL_BATCH)
    gen = torch.Generator().manual_seed(5)
    losses = []
    for _ in range(STEPS):
        params, state, m = step(params, state, *batch, gen)
        losses.append(float(m["loss"]))
    return np.asarray(losses), torch.cat([p.reshape(-1) for p in tree_leaves(params)]).numpy()


if __name__ == "__main__":
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    losses, flat = run(rank, world, port)
    np.savez(out, losses=losses, params=flat)
    torch.distributed.destroy_process_group()
