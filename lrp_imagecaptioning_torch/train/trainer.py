"""Training orchestration, the port's counterpart of the JAX package's
``train/trainer.py`` and the reference ``Training`` classes
(train.py:12-400): config -> dataset provider -> model -> optimizer -> the
epoch loop with per-epoch caption-metric evaluation, the plateau learning
rate, the CSV log, checkpoints and the stop conditions.

On one device (``device="cuda"`` by default; it raises without a card), or
data-parallel over a ``parallel.make_mesh`` mesh (``mesh=``: the sharded
train and eval steps of ``train/step.py``; the ragged epoch tail dropped),
and with ``multihost=True`` over the processes of a ``torch.distributed``
group, each loading its own rows of the global batch
(``parallel.make_multihost_mesh``; process 0 writes the checkpoints and the
log). Checkpoints are the port's npz files (``train/checkpoint.py``).
``steps_per_call = K > 1`` runs K train steps a call
(``train/step.py::make_multi_train_step``, on the card each step replayed
from one captured CUDA graph; on a mesh of several slots or in a process
group its sharded form, replayed from one captured rank step in a NCCL
group of one card a process), the ragged epoch tail as single steps.
``cfg.pretrained_word_vector`` seeds the embedding from the file at
``cfg.word_vector_path`` (an attribute the caller sets, as in the JAX
package; ``models/word_vectors.py``).
"""

from __future__ import annotations

import os
import re
import time
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from ..data.prefetch import prefetch
from ..data.provider import DatasetProvider
from ..infer.api import BasicInference
from ..models.captioner import build_captioner
from ..runtime import resolve_device
from ..utils.profiling import memory_stats
from .callbacks import CSVLog, ReduceLROnPlateau, StopAfterTimedelta, StopWhenValLossExploding
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .optimizer import get_learning_rate, make_optimizer, set_learning_rate
from ..parallel.distributed import global_batch_from_local, global_stacked_batch_from_local
from .step import (make_eval_step, make_multi_train_step, make_sharded_eval_step,
                   make_sharded_multi_train_step, make_sharded_train_step, make_train_step,
                   metric_accumulator, one_device_mesh, run_stepped_steps)

_TIME_UNITS = ("seconds", "minutes", "hours", "days", "weeks")


def parse_timedelta(s: Optional[str]) -> Optional[timedelta]:
    """'12 hours' / '30 minutes' / '1 day' (the reference passes
    dateutil-style strings, train.py:29)."""
    if not s:
        return None
    parts = s.split()
    if len(parts) != 2:
        raise ValueError(f"time_limit must be '<number> <unit>' (e.g. '12 hours'), got {s!r}")
    unit = parts[1].rstrip("s") + "s"
    if unit not in _TIME_UNITS:
        raise ValueError(f"time_limit unit must be one of {_TIME_UNITS}, got {parts[1]!r}")
    return timedelta(**{unit: float(parts[0])})


def load_weights_file(path: str, captioner, device):
    """(params, opt_state or None) from a weights file: the port's npz
    checkpoint (params and Adam state), a flat params npz (the JAX package's
    ``save_params_npz``), or a reference Keras .h5/.hdf5."""
    if path.endswith(".npz"):
        from ..weights import load_params_npz

        with np.load(path) as f:    # the names only: the arrays load lazily
            is_checkpoint = any(k.startswith("params/") for k in f.files)
        if is_checkpoint:
            return restore_checkpoint(path, device=device)
        return load_params_npz(path, device=device), None
    if path.endswith((".h5", ".hdf5")):
        from ..models.weights_io import load_reference_checkpoint_h5

        return load_reference_checkpoint_h5(path, captioner.model_type,
                                            captioner.cfg.img_encoder, captioner.cfg.layer_name,
                                            device=device), None
    raise ValueError(f"{path!r}: the port reads .npz and .h5/.hdf5 weights; an orbax checkpoint "
                     "of the JAX package converts with its train/checkpoint.py::save_params_npz")


class Trainer:
    """main_attention() equivalent (train.py:676-682): pick the model by
    type and train with the reference's schedule semantics."""

    def __init__(self, model_type: str, config, dataset, label: str = "run", mesh=None,
                 seed: int = 0, eval_metrics: bool = True, multihost: bool = False,
                 steps_per_call: int = 1, *, device="cuda"):
        if multihost and mesh is None:
            # each process would train on its own rows with no gradient sum
            raise ValueError("multihost=True requires a mesh (make_multihost_mesh)")
        if mesh is not None and config.batch_size % mesh.shape["data"]:
            raise ValueError(f"batch_size {config.batch_size} not divisible by the mesh "
                             f"data-axis size {mesh.shape['data']}")
        self.model_type = model_type
        self.config = config
        self.dataset = dataset
        self.label = label
        self.mesh = mesh
        self._multihost = multihost
        # on a mesh the params, the state and the dropout live on its first slot
        self.device = mesh.primary if mesh is not None else resolve_device(device)

        self.provider = DatasetProvider(dataset, config)
        self.captioner = build_captioner(model_type, config, self.provider.vocab_size)
        self.optimizer = make_optimizer(model_type, config.learning_rate)
        # vocabs[i] is the word for model id i (1-based token i + 1)
        self.params = self.captioner.init_params(
            seed, vocab_words=self.provider.vocabs if config.pretrained_word_vector else None,
            word_vector_path=getattr(config, "word_vector_path", None), device=self.device)
        self.opt_state = self.optimizer.init(self.params)
        # every train step's dropout masks
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # steps_per_call > 1: K steps a call, the ragged epoch tail as singles;
        # below 1 it is 1, as in the JAX package
        self._steps_per_call = max(int(steps_per_call), 1)
        self._multi_step = None
        if mesh is None:
            self._train_step = make_train_step(self.captioner, self.optimizer)
            self._eval_step = make_eval_step(self.captioner)
            if self._steps_per_call > 1:
                self._multi_step = make_multi_train_step(self.captioner, self.optimizer)
        else:
            self._train_step, place = make_sharded_train_step(self.captioner, self.optimizer,
                                                              mesh)
            self._eval_step = make_sharded_eval_step(self.captioner, mesh)
            if self._steps_per_call > 1:
                self._multi_step = (
                    make_multi_train_step(self.captioner, self.optimizer)
                    if one_device_mesh(mesh) else
                    make_sharded_multi_train_step(self.captioner, self.optimizer, mesh)[0])
            self.params, self.opt_state = place(self.params, self.opt_state)
        # built once and handed the new params each epoch (LogMetrics,
        # callbacks.py:37-70); it decodes eagerly (infer/api.py)
        self.inference = BasicInference(
            self.captioner, self.params, self.provider,
            max_caption_length=config.sentence_length, device=self.device,
        ) if eval_metrics else None

        self.result_dir = os.path.join(
            "results", getattr(dataset, "dataset_name", config.dataset_name),
            "training-results", label)
        os.makedirs(self.result_dir, exist_ok=True)
        self._initial_epoch = 0  # advanced by resume_latest()

    def _typed(self, arr, stacked: bool = False) -> torch.Tensor:
        """A host batch array (``stacked``: a (K, B, ...) stack of them) as a
        tensor: images in the params' dtype, caption ids int64 (embedding
        indices), the one-hot targets as they come (int32, as the JAX
        package feeds them)."""
        t = torch.as_tensor(arr)
        if t.is_floating_point():
            return t.to(self.params["decoder"]["embedding"].dtype)
        return t.long() if t.dim() == 2 + stacked else t

    def _place(self, arr):
        """A training batch array on the device, or on a mesh its rows split
        over the data slots (a ``Sharded``; with ``multihost`` the array is
        this process's rows of the global batch)."""
        if self.mesh is not None:
            return global_batch_from_local(self.mesh, self._typed(arr))
        return self._typed(arr).to(self.device)

    def _place_stacked(self, arr):
        """A (K, B, ...) stack of training batches (with ``multihost``, this
        process's rows of K global batches): on the device, or on a mesh of
        several slots its batch axis (1) split over the data slots."""
        t = self._typed(arr, stacked=True)
        if self.mesh is not None and self.mesh.devices.size > 1:
            return global_stacked_batch_from_local(self.mesh, t)
        return t.to(self.device)

    def _place_eval(self, arr):
        """A validation batch array: on a mesh the eval step splits it (it
        may be the epoch's ragged tail)."""
        return self._typed(arr) if self.mesh is not None else self._place(arr)

    # -- weights -----------------------------------------------------------

    def load_weights(self, path: str):
        self.params, opt_state = load_weights_file(path, self.captioner, self.device)
        if opt_state is not None:
            self.opt_state = opt_state
        return self

    def resume_latest(self) -> bool:
        """Restore the newest checkpoint AND its epoch number, so a resumed
        ``run()`` continues the epoch numbering (its checkpoints then rank
        above the earlier ones in ``latest_checkpoint``) and appends to the
        metrics CSV instead of truncating it."""
        ckpt = latest_checkpoint(self.result_dir)
        if ckpt is None:
            return False
        self.load_weights(ckpt)
        m = re.match(r"ckpt_(\d+)", os.path.basename(ckpt))
        if m:
            self._initial_epoch = int(m.group(1)) + 1
        return True

    # -- loop --------------------------------------------------------------

    def _epoch(self, batches, steps: int, training: bool) -> dict:
        # the metrics stay on the device until the epoch ends: one host sync
        record, finalize = metric_accumulator()
        if training:
            self.params, self.opt_state = run_stepped_steps(
                batches, steps, self._steps_per_call, self._place, self.generator,
                self._multi_step, self._train_step, self.params, self.opt_state, record,
                self._place_stacked)
        else:
            for _ in range(steps):
                (cap_in, imgs), y = next(batches)
                record(self._eval_step(self.params, self._place_eval(imgs),
                                       self._place_eval(cap_in), self._place_eval(y)))
        return finalize(steps)

    @property
    def _writes(self) -> bool:
        """Whether this process writes the checkpoints and the log (one of a group does)."""
        return self.mesh is None or self.mesh.process_index == 0

    def _save(self, epoch: int, metric):
        if self._writes:
            save_checkpoint(self.result_dir, epoch, self.params, self.opt_state, metric=metric)

    def run(self, epochs: Optional[int] = None, time_limit: Optional[str] = None,
            steps_per_epoch: Optional[int] = None, log_prefix: str = "") -> list[dict]:
        """Train; returns the per-epoch logs. ``epochs`` is the total target
        (Keras' initial_epoch semantics: a run resumed at epoch e runs
        ``epochs - e``). Either ``epochs`` or a time limit must bound the run
        (train.py:46-48)."""
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.epochs
        tl = parse_timedelta(time_limit or cfg.time_limit)
        if epochs is None and tl is None:
            raise ValueError("need epochs or time_limit (reference enforces XOR, train.py:46-48)")

        T = cfg.sentence_length + 1  # the provider pads captions to T + 1 (SOS..EOS)
        # producer threads prepare the next batches during the steps
        # a mesh run drops the ragged epoch tail: it does not split over the slots
        train_gen = prefetch(self.provider.training_set(
            pad_to_length=T, drop_remainder=self.mesh is not None))
        val_gen = prefetch(self.provider.validation_set(pad_to_length=T))
        csv_log = CSVLog(os.path.join(self.result_dir, "metrics-log.csv"),
                         append=self._initial_epoch > 0)
        plateau = ReduceLROnPlateau(monitor="val_cider", factor=cfg.reduce_lr_factor,
                                    patience=cfg.reduce_lr_patience)
        time_stop = StopAfterTimedelta(tl)
        explode_stop = StopWhenValLossExploding()

        history = []
        epoch = self._initial_epoch
        try:
            while epochs is None or epoch < epochs:
                ts_start = time.time()
                steps = steps_per_epoch or self.provider.training_steps
                logs = self._epoch(train_gen, steps, training=True)
                val = self._epoch(val_gen, self.provider.validation_steps, training=False)
                logs.update({f"val_{k}": v for k, v in val.items()})
                if self.inference is not None:
                    # the caption metrics on the test split drive the learning
                    # rate and name the checkpoints (train.py:276-277)
                    self.inference.params = self.params
                    metrics = self.inference.evaluate_test_set()
                    logs.update({f"val_{k.lower()}": v for k, v in metrics.items()})

                lr = get_learning_rate(self.opt_state)
                new_lr = plateau.update(logs, lr)
                if new_lr != lr:
                    self.opt_state = set_learning_rate(self.opt_state, new_lr)
                logs["learning_rate"] = new_lr
                logs["ts_start"], logs["ts_end"] = ts_start, time.time()
                logs.update(memory_stats())

                self._save(epoch, logs.get("val_cider"))
                if self._writes:
                    csv_log.on_epoch_end(epoch, logs)
                history.append(logs)
                print(f"{log_prefix}epoch {epoch}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in logs.items() if isinstance(v, float)))
                epoch += 1
                if time_stop.should_stop() or explode_stop.should_stop(logs.get("val_loss")):
                    break
        finally:
            # the producer threads stop when an epoch raises too
            train_gen.stop()
            val_gen.stop()
            csv_log.close()
        if self._writes:
            cfg.save_yaml(os.path.join(self.result_dir, "config.yaml"))
        return history


MODELTYPE = ("adaptiveattention", "gridTD", "aoa")


def main_attention(config, dataset, label: str, model_type: str, weights: str | None = None,
                   *, device="cuda", **run_kw):
    """Reference entry point parity (train.py:679-682)."""
    if model_type not in MODELTYPE:
        raise ValueError(f"model_type must be one of {MODELTYPE}")
    t = Trainer(model_type, config, dataset, label, device=device)
    if weights:
        t.load_weights(weights)
    t.run(**run_kw)
    return t
