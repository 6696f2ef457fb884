"""Several processes over ``torch.distributed``: the port of the JAX
package's ``parallel/distributed.py``.

Each process holds its own devices (``Mesh.devices``) and loads only its
rows of the global batch (``process_batch_slice``); the data axis spans the
processes and the model axis stays in one. The sharded steps sum the
gradients of a process's slots and then ``all_reduce`` them across the
processes (``train/step.py``), so every process applies the same update.

Nothing tells a program of a cluster: ``initialize_distributed`` takes the
coordinator's address, the process count and this process's rank, or reads
them from the environment ``torchrun`` sets (``auto=True``).

Each process owns its own cards, as ``jax.local_devices()`` gives a JAX
process its own (``local_devices``): under ``torchrun``'s ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` the visible cards split into equal contiguous blocks,
one a process of the host, unless each process of the host sees only its
own cards (``CUDA_VISIBLE_DEVICES`` set a rank), when each takes what it
sees. A card is known by its UUID, whatever index it has in a process.
The group is held to what the JAX package's ``make_multihost_mesh``
checks: every process owns as many devices; and in a NCCL group no two
processes hold one card (NCCL refuses two ranks on one card; a gloo group
may share one). The processes exchange what they hold through the
rendezvous store, with no collective: ``initialize_distributed`` under
NCCL before the communicator connects, ``make_multihost_mesh`` for the
mesh's devices before any step.
"""

from __future__ import annotations

import json
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (Mesh, NamedSharding, Sharded, batch_sharding, cuda_devices,
                   stacked_batch_sharding)


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# what every process of the group sees (``_view``), gathered when it joined
# through ``initialize_distributed``: ``local_devices`` reads whether the
# processes of a host share their cards
_joined_views: list | None = None


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           auto: bool = False, *, backend: str | None = None) -> int:
    """Join the process group, or skip joining; returns the process count.

    With no arguments in one process this joins nothing and returns 1 (a
    single-host run must not wait for peers). ``coordinator_address``
    ("host:port" or "tcp://host:port") with ``num_processes`` and
    ``process_id`` joins a group of that size; ``auto=True`` reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, which
    ``torchrun`` sets. ``backend`` defaults to NCCL where a card is visible,
    gloo otherwise; two processes on one card take gloo (NCCL refuses
    two ranks on one device). The store is torch's ``tcp://`` rendezvous
    (under ``torchrun`` its agent's), through which the processes first
    exchange the cards they see. Under NCCL with ``LOCAL_RANK`` set, each
    process's cards (``local_devices``) are checked before NCCL connects
    (``ValueError`` where two processes hold one card, in every process),
    and its first card is made current and binds the group."""
    global _joined_views
    if dist.is_initialized():
        return dist.get_world_size()
    if auto and coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        return 1
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed: a coordinator address needs num_processes "
                         "and process_id")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    store, _, _ = next(dist.rendezvous(f"tcp://{coordinator_address.removeprefix('tcp://')}",
                                       process_id, num_processes))
    views = _store_all_gather(store, process_id, num_processes, _view())
    device_id = None
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        # NCCL connects at once on the bound card and refuses a shared one:
        # every process's block, from every view, is checked first
        blocks = [_block(v, views) for v in views]
        _check_ownership([[v[0], len(b), {v[3][i]: i for i in b}]
                          for v, b in zip(views, blocks)])
        device_id = torch.device("cuda", blocks[process_id][0])
        torch.cuda.set_device(device_id)
    _joined_views = views
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id,
                            device_id=device_id)
    return dist.get_world_size()


def _card_id(index: int) -> str:
    """A card's UUID: one card has one id in every process, whatever index
    ``CUDA_VISIBLE_DEVICES`` gives it there."""
    return str(torch.cuda.get_device_properties(index).uuid)


def _view() -> list:
    """What this process sees: [host, LOCAL_RANK, LOCAL_WORLD_SIZE (None
    where unset), its visible cards' ids by index]."""
    return [socket.gethostname(), os.environ.get("LOCAL_RANK"),
            os.environ.get("LOCAL_WORLD_SIZE"), [_card_id(d.index) for d in cuda_devices()]]


def _block(view, views=()) -> list[int]:
    """The indices of the visible cards that the process of ``view`` owns,
    ``views`` being every process's (none where the group is not known).
    Without ``LOCAL_*``, every card it sees. Where the processes of its host
    see disjoint cards (each its own, ``CUDA_VISIBLE_DEVICES`` set a rank),
    every card it sees too. Else the split: block ``LOCAL_RANK`` of
    ``LOCAL_WORLD_SIZE`` equal contiguous blocks; a split that does not
    divide, or a block with no card, raises."""
    host, rank, world, ids = view
    every = list(range(len(ids)))
    if rank is None and world is None:
        return every
    if rank is None or world is None:
        raise ValueError("LOCAL_RANK and LOCAL_WORLD_SIZE go together (torchrun sets both)")
    peers = [v[3] for v in views if v[0] == host]
    if len(peers) > 1 and len({i for p in peers for i in p}) == sum(map(len, peers)):
        return every
    rank, world = int(rank), int(world)
    if world < 1 or len(ids) % world:
        raise ValueError(f"{len(ids)} visible cards do not split into "
                         f"LOCAL_WORLD_SIZE={world} equal blocks")
    per = len(ids) // world
    block = every[rank * per:(rank + 1) * per] if 0 <= rank < world else []
    if not block:
        raise ValueError(f"LOCAL_RANK={rank} takes no card: {len(ids)} visible cards in "
                         f"LOCAL_WORLD_SIZE={world} blocks")
    return block


def local_devices() -> list[torch.device]:
    """This process's cards, the counterpart of ``jax.local_devices()``
    (``_block``): every visible card without ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE``, or where the group showed that each process of
    the host sees only its own; else block ``LOCAL_RANK`` of the visible
    cards split into ``LOCAL_WORLD_SIZE``. A split that does not divide, or
    a block with no card, raises: a process never falls back to the CPU or
    to another's card."""
    views = _joined_views if dist.is_initialized() else None
    return [torch.device("cuda", i) for i in _block(_view(), views or ())]


def _claim(devices) -> list:
    """What this process holds: [host, device count, {card id: its index
    here}] (CPU slots hold no card)."""
    cards = {torch.cuda.current_device() if d.index is None else d.index
             for d in devices if d.type == "cuda"}
    return [socket.gethostname(), len(devices), {_card_id(i): i for i in sorted(cards)}]


def _check_ownership(claims, exclusive: bool = True) -> None:
    """``claims[r]``, process r's ``_claim``, against the JAX package's
    layout: every process owns as many devices (its message), and, where
    ``exclusive`` (a NCCL group: NCCL refuses two ranks on one card), no two
    processes hold one card, known by its id. A gloo group may share one
    (its collectives go through the host)."""
    local = sum(c[1] for c in claims) // len(claims)
    for pi, (_, n, _) in enumerate(claims):
        if n != local:
            raise ValueError(f"process {pi} owns {n} devices, expected {local}")
    holder = {}
    for pi, (host, _, cards) in enumerate(claims if exclusive else ()):
        for card, index in cards.items():
            other, other_index = holder.setdefault((host, card), (pi, index))
            if other != pi:
                raise ValueError(
                    f"processes {other} and {pi} both hold card {card} on host {host} "
                    f"(cuda:{other_index} in process {other}, cuda:{index} in process {pi}): "
                    f"each process of a NCCL group takes its own cards (LOCAL_RANK / "
                    f"LOCAL_WORLD_SIZE split the visible cards)")


def _store_all_gather(store, rank: int, world: int, value) -> list:
    """Every process's ``value`` through the rendezvous ``store``, with no
    collective (no NCCL call). Each process counts its own exchanges in the
    store, so that the processes' n-th exchanges meet."""
    n = store.add(f"lrpic/exchanges/{rank}", 1)
    store.set(f"lrpic/{n}/value/{rank}", json.dumps(value))
    out = [json.loads(store.get(f"lrpic/{n}/value/{r}")) for r in range(world)]
    store.set(f"lrpic/{n}/read/{rank}", "1")
    if rank == 0:
        # process 0 may serve the store: it returns (and may raise and exit)
        # only once every process has read, and the others ask it no more
        store.wait([f"lrpic/{n}/read/{r}" for r in range(world)])
    return out


def _check_group(claim, backend: str) -> None:
    """``claim`` (this process's ``_claim``) against every process's,
    through the group's store; the cards are exclusive under NCCL."""
    store = dist.distributed_c10d._get_default_store()
    claims = _store_all_gather(store, _process_index(), _process_count(), claim)
    _check_ownership(claims, exclusive="nccl" in backend)


def make_multihost_mesh(model_parallel: int = 1, devices=None) -> Mesh:
    """The (data, model) mesh of this process's ``devices`` (default: its
    own cards, ``local_devices()``) inside the process group: the data axis
    spans the processes, the model axis stays in one. With one process it is
    ``make_mesh``'s layout. In a group of several the processes' devices are
    exchanged and held to ``_check_ownership`` before any step (two
    processes on one card only where the group is not NCCL's)."""
    devices = local_devices() if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_multihost_mesh: no CUDA device is visible; pass "
                         "devices=['cpu'] * N to run on the CPU")
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if _process_count() > 1:
        _check_group(_claim(devices), dist.get_backend())
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // model_parallel, model_parallel), _process_count(),
                _process_index(), distributed=dist.is_initialized())


def process_batch_slice(global_batch: int, process_index: int | None = None,
                        process_count: int | None = None) -> slice:
    """The rows of the global batch this process loads: a contiguous equal
    split. ``global_batch`` must divide by the process count (the provider
    does not pad a ragged epoch tail; a mesh run drops it)."""
    pi = _process_index() if process_index is None else process_index
    pc = max(_process_count() if process_count is None else process_count, 1)
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} processes")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def global_batch_from_local(mesh: Mesh, local_array, global_batch: int | None = None,
                            sharding: NamedSharding | None = None) -> Sharded:
    """The global batch from this process's rows (``process_batch_slice``):
    a ``Sharded`` whose shards are those rows split over this process's
    slots. Nothing crosses processes."""
    sharded = (sharding or batch_sharding(mesh)).place(local_array)
    if global_batch is not None and global_batch != sharded.global_rows:
        raise ValueError(f"{np.shape(local_array)[sharded.axis]} local rows x "
                         f"{mesh.process_count} "
                         f"processes is not the global batch {global_batch}")
    return sharded


def global_stacked_batch_from_local(mesh: Mesh, local_array,
                                    global_batch: int | None = None) -> Sharded:
    """``global_batch_from_local`` for (K, B_local, ...) ``steps_per_call``
    stacks: each process stacks its own K local batches, and the stack's
    batch axis (axis 1) splits over this process's slots
    (``stacked_batch_sharding``), K whole. Nothing crosses processes."""
    return global_batch_from_local(mesh, local_array, global_batch,
                                   stacked_batch_sharding(mesh))


def shard_global_batch(mesh: Mesh, *local_arrays, global_batch: int | None = None):
    """The several-process counterpart of ``mesh.shard_batch``."""
    out = tuple(global_batch_from_local(mesh, a, global_batch) for a in local_arrays)
    return out if len(out) > 1 else out[0]


def all_reduce_sum(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``flat`` summed over the processes of the mesh's group (itself where
    the mesh spans no group)."""
    if mesh.distributed:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return flat
