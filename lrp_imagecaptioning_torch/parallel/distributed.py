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
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, NamedSharding, Sharded, batch_sharding, cuda_devices


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           auto: bool = False, backend: str | None = None) -> int:
    """Join the process group, or skip joining; returns the process count.

    With no arguments in one process this joins nothing and returns 1 (a
    single-host run must not wait for peers). ``coordinator_address``
    ("host:port" or "tcp://host:port") with ``num_processes`` and
    ``process_id`` joins a group of that size; ``auto=True`` reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, which
    ``torchrun`` sets. ``backend`` defaults to NCCL where a card is visible,
    gloo otherwise; two processes on one card take gloo (NCCL refuses
    two ranks on one device)."""
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
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def make_multihost_mesh(model_parallel: int = 1, devices=None) -> Mesh:
    """The (data, model) mesh of this process's ``devices`` (default: every
    visible CUDA device) inside the process group: the data axis
    spans the processes, the model axis stays in one. With one process it is
    ``make_mesh``'s layout."""
    devices = cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_multihost_mesh: no CUDA device is visible; pass "
                         "devices=['cpu'] * N to run on the CPU")
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
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
        raise ValueError(f"{np.shape(local_array)[0]} local rows x {mesh.process_count} "
                         f"processes is not the global batch {global_batch}")
    return sharded


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
