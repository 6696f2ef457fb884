"""Device mesh and placements for data-parallel work over several devices:
the port of the JAX package's ``parallel/mesh.py``.

A ``Mesh`` is a 2-D ``(data, model)`` array of ``torch.device``s. The
batch splits over ``data`` in contiguous row slices, one a data slot; every
slot holds a replica of the params and runs the single-device program on
its rows, and the sharded steps reduce the slots' gradients before the
optimizer (``train/step.py``). The JAX package gets the same program from
GSPMD: the single-device computation on the global batch, up to the order
of the reductions.

The model axis splits the vocabulary of the embedding and the output
projection (``shard_vocab``): a data row's model slots hold contiguous
slices of those two, as lists of tensors in the params tree, and the
sharded train step computes the logits and the softmax-CE slice by slice
(``train/step.py``). Everything else of a data row lives on its first
device; without ``shard_vocab`` the row's other slots would do the same
work again, so a data row runs on its first device.

An explicit ``devices=`` list may repeat a device (``["cpu"] * 4``,
``[cuda:0, cuda:0]``): the slots then share it, the port's counterpart of
XLA's virtual CPU devices. Unlike the JAX package, ``make_mesh`` never falls
back to the CPU when the card has too few devices: it raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..weights import tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """``devices`` (n_data, n_model) of ``torch.device`` held by this process.
    A mesh over a process group (``parallel/distributed.py``,
    ``distributed=True``) spans its ``process_count`` processes on the data
    axis, this process's block at ``process_index``; the sharded steps then
    ``all_reduce`` over the group."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices, process_count: int = 1, process_index: int = 0,
                 distributed: bool = False):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError(f"mesh devices must be 2-D (data, model), got {self.devices.shape}")
        self.process_count = process_count
        self.process_index = process_index
        self.distributed = distributed

    @property
    def shape(self) -> dict:
        """Axis sizes over every process, as ``jax.sharding.Mesh.shape``."""
        n_data, n_model = self.devices.shape
        return {DATA_AXIS: n_data * self.process_count, MODEL_AXIS: n_model}

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def slots(self) -> list[torch.device]:
        """This process's data slots, one device a data row."""
        return list(self.devices[:, 0])

    @property
    def primary(self) -> torch.device:
        """Where the sharded steps keep the params and apply the update."""
        return self.devices[0, 0]

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, slots={[str(d) for d in self.slots]}, "
                f"process {self.process_index} of {self.process_count})")


def _devices(devices) -> list[torch.device]:
    return [torch.device(d) for d in devices]


def cuda_devices() -> list[torch.device]:
    """Every visible card (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (default: every visible CUDA device; ``model_parallel`` of them a data
    row). Raises where fewer devices are there than asked for, or where their
    count does not divide by ``model_parallel``."""
    devices = cuda_devices() if devices is None else _devices(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            # a smaller mesh would run an N-way job on fewer slots, each with
            # a larger batch, and say nothing
            raise ValueError(f"requested a {n_devices}-device mesh but only {len(devices)} "
                             f"devices are available (pass devices=['cpu'] * N for CPU slots)")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no CUDA device is visible; pass devices=['cpu'] * N to "
                         "run a mesh on the CPU")
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // model_parallel, model_parallel))


class P(tuple):
    """A partition spec: one mesh axis name (or None) per dimension, as
    ``jax.sharding.PartitionSpec``; ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class VocabSlices(list):
    """A params leaf split on the vocabulary over the model axis: its
    contiguous slices, slice j on a data row's model slot j. A list, so
    that the tree functions (``weights.tree_map`` ...) and Adam's moments
    follow the slices."""


class Sharded(NamedTuple):
    """A global batch as this process's row slices, one a data slot (each on
    its slot's device). ``global_rows`` rows in all; this process's first
    row is ``offset``. The rows are the shards' axis ``axis``: 0 for a
    batch, 1 for a (K, B, ...) stack of K batches
    (``stacked_batch_sharding``)."""

    shards: list
    global_rows: int
    offset: int = 0
    axis: int = 0

    @property
    def rows(self) -> list[slice]:
        """Each shard's rows of the global batch."""
        out, start = [], self.offset
        for s in self.shards:
            out.append(slice(start, start + s.shape[self.axis]))
            start += s.shape[self.axis]
        return out


class NamedSharding(NamedTuple):
    """``spec`` on ``mesh``: ``P()`` puts a replica on every data slot,
    ``P(DATA_AXIS)`` splits the leading (batch) axis over them."""

    mesh: Mesh
    spec: tuple

    def place(self, x):
        """Replicated: a list of ``x`` on each slot (the same tensor where the
        slot's device holds it). Batch-split (``P(DATA_AXIS)``, or
        ``P(None, DATA_AXIS)`` for a stack of batches): a ``Sharded`` of
        ``x``'s rows on that axis. Split on the model axis: a list of
        ``x``'s contiguous slices along that dimension, slice j on the first
        data row's model slot j."""
        if MODEL_AXIS in self.spec:
            dim = self.spec.index(MODEL_AXIS)
            row = self.mesh.devices[0]
            return VocabSlices(s.to(d) for s, d in zip(
                torch.tensor_split(torch.as_tensor(x), len(row), dim), row))
        if not self.spec:
            return [torch.as_tensor(x).to(d) for d in self.mesh.slots]
        if self.spec not in ((DATA_AXIS,), (None, DATA_AXIS)):
            raise ValueError(f"unsupported partition spec {self.spec}")
        axis = len(self.spec) - 1
        x = torch.as_tensor(x)
        slots = self.mesh.slots
        n = len(slots) * self.mesh.process_count
        if x.shape[axis] % len(slots):
            raise ValueError(f"batch of {x.shape[axis]} rows not divisible by the mesh's "
                             f"{len(slots)} data slots")
        per = x.shape[axis] // len(slots)
        return Sharded([x.narrow(axis, i * per, per).to(d) for i, d in enumerate(slots)],
                       per * n, per * len(slots) * self.mesh.process_index, axis)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) axis split over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def stacked_batch_sharding(mesh: Mesh) -> NamedSharding:
    """(K, B, ...) stacks of K batches (``steps_per_call``): K whole, the
    batch axis split over the data axis."""
    return NamedSharding(mesh, P(None, DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def decoder_param_pspecs(decoder_params, shard_vocab: bool) -> dict:
    """Partition spec tree of a decoder params dict: with ``shard_vocab`` the
    embedding (V, E) splits on V and the output projection (H, V) on its V
    column, everything else replicates."""

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, VocabSlices):
            return type(node)(walk(v, keys) for v in node)
        if not shard_vocab:
            return P()
        if "embedding" in keys:
            return P(MODEL_AXIS, None)
        if "output" in keys:
            ndim = (node[0] if isinstance(node, VocabSlices) else node).dim()
            return P(None, MODEL_AXIS) if ndim == 2 else P(MODEL_AXIS)
        return P()

    return walk(decoder_params, ())


def param_shardings(mesh: Mesh, params, shard_vocab: bool = False):
    """``NamedSharding`` tree of a captioner's params ({'vgg', 'decoder'});
    the encoder always replicates."""
    specs = tree_map(lambda _: P(), params)
    if shard_vocab and "decoder" in params:
        specs = dict(specs, decoder=decoder_param_pspecs(params["decoder"], True))
    return _spec_map(lambda s: NamedSharding(mesh, s), specs)


def _spec_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
    if not isinstance(specs, P):
        return type(specs)(_spec_map(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(specs))
    return fn(specs, *trees)


def place_params(mesh: Mesh, params, shard_vocab: bool = False):
    """``params`` (or a tree of its shape: Adam's moments) where the sharded
    steps keep it: on the mesh's first slot, with ``shard_vocab`` the
    embedding and the output projection as lists of vocabulary slices on the
    first data row's model slots."""
    specs = tree_map(lambda _: P(), params)
    if shard_vocab:
        specs = dict(specs, decoder=decoder_param_pspecs(params["decoder"], True))
    return _spec_map(lambda s, x: NamedSharding(mesh, s).place(x) if s else x.to(mesh.primary),
                     specs, params)


def gather_params(params, device):
    """A params tree whose vocabulary leaves are lists of slices
    (``place_params``) as whole tensors on ``device``."""
    specs = decoder_param_pspecs(params["decoder"], True)

    def gather(spec, x):
        if isinstance(x, VocabSlices):
            return torch.cat([s.to(device) for s in x], dim=spec.index(MODEL_AXIS))
        return x.to(device)

    return dict(tree_map(lambda x: x.to(device), {k: v for k, v in params.items()
                                                   if k != "decoder"}),
                decoder=_spec_map(gather, specs, params["decoder"]))


def opt_state_shardings(mesh: Mesh, opt_state, params, shard_vocab: bool = False):
    """The Adam state's placements (``train/optimizer.py``: ``count``, ``mu``,
    ``nu``, ``learning_rate``): each moment mirrors its param's, the scalars
    replicate."""
    p = param_shardings(mesh, params, shard_vocab)
    rep = replicated(mesh)
    return {k: (p if k in ("mu", "nu") else rep) for k in opt_state}


def shard_batch(mesh: Mesh, *arrays):
    """Host arrays -> ``Sharded`` batches over the data axis."""
    s = batch_sharding(mesh)
    out = tuple(s.place(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def as_sharded(mesh: Mesh, x) -> Sharded:
    """``x`` as a ``Sharded`` batch: a ``Sharded`` as it is, an array or a
    tensor (the global batch of a one-process mesh) split over the slots."""
    return x if isinstance(x, Sharded) else batch_sharding(mesh).place(x)


def as_stacked(mesh: Mesh, x) -> Sharded:
    """A (K, B, ...) stack as a ``Sharded`` on axis 1: a ``Sharded`` as it is,
    an array or a tensor (a one-process mesh's global stack) split over the
    slots."""
    return x if isinstance(x, Sharded) else stacked_batch_sharding(mesh).place(x)
