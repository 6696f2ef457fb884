"""Training orchestration, the port's counterpart of the JAX package's
``train/trainer.py`` and the reference ``Training`` classes
(train.py:12-400): config -> dataset provider -> model -> optimizer -> the
epoch loop with per-epoch caption-metric evaluation, the plateau learning
rate, the CSV log, checkpoints and the stop conditions.

On one device (``device="cuda"`` by default; it raises without a card).
Checkpoints are the port's npz files (``train/checkpoint.py``). Not ported,
and rejected with a message rather than ignored: a device mesh and
multi-host runs (ROADMAP A13b), several steps a call (the port has no
K-steps-a-call variants, ROADMAP §C). ``cfg.pretrained_word_vector`` seeds
the embedding from the file at ``cfg.word_vector_path`` (an attribute the
caller sets, as in the JAX package; ``models/word_vectors.py``).
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
from .step import make_eval_step, make_train_step, metric_accumulator, run_stepped_steps

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


def reject_unported(mesh=None, multihost: bool = False, steps_per_call: int = 1) -> None:
    """Raise for the options of the JAX package's trainer that the port
    lacks, naming where each stands."""
    if mesh is not None or multihost:
        raise NotImplementedError("a device mesh and multi-host training (torch.distributed "
                                  "over several cards) are not ported yet: ROADMAP A13b")
    if int(steps_per_call) != 1:
        raise NotImplementedError(f"steps_per_call={steps_per_call}: the port has no "
                                  "K-steps-a-call variants (ROADMAP §C, departures by design); "
                                  "each call runs one step")


def load_weights_file(path: str, captioner, device):
    """(params, opt_state or None) from a weights file: the port's npz
    checkpoint (params and Adam state), a flat params npz (the JAX package's
    ``save_params_npz``), or a reference Keras .h5/.hdf5."""
    if path.endswith(".npz"):
        from ..weights import load_params_npz

        with np.load(path) as f:    # the names only: the arrays load lazily
            is_checkpoint = any(k.startswith("params/") for k in f.files)
        if is_checkpoint:
            return restore_checkpoint(path, device)
        return load_params_npz(path, device), None
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
                 steps_per_call: int = 1, device="cuda"):
        reject_unported(mesh, multihost, steps_per_call)
        self.model_type = model_type
        self.config = config
        self.dataset = dataset
        self.label = label
        self.device = resolve_device(device)

        self.provider = DatasetProvider(dataset, config)
        self.captioner = build_captioner(model_type, config, self.provider.vocab_size)
        self.optimizer = make_optimizer(model_type, config.learning_rate)
        # vocabs[i] is the word for model id i (1-based token i + 1)
        self.params = self.captioner.init_params(
            seed, self.device,
            vocab_words=self.provider.vocabs if config.pretrained_word_vector else None,
            word_vector_path=getattr(config, "word_vector_path", None))
        self.opt_state = self.optimizer.init(self.params)
        # every train step's dropout masks
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._train_step = make_train_step(self.captioner, self.optimizer)
        self._eval_step = make_eval_step(self.captioner)
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

    def _place(self, arr) -> torch.Tensor:
        """A host batch array on the device: images in the params' dtype,
        caption ids int64 (embedding indices), the one-hot targets as they
        come (int32, as the JAX package feeds them)."""
        t = torch.as_tensor(arr, device=self.device)
        if t.is_floating_point():
            return t.to(self.params["decoder"]["embedding"].dtype)
        return t.long() if t.dim() == 2 else t

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
                batches, steps, self._place, self._train_step, self.generator,
                self.params, self.opt_state, record)
        else:
            for _ in range(steps):
                (cap_in, imgs), y = next(batches)
                record(self._eval_step(self.params, self._place(imgs), self._place(cap_in),
                                       self._place(y)))
        return finalize(steps)

    def _save(self, epoch: int, metric) -> str:
        return save_checkpoint(self.result_dir, epoch, self.params, self.opt_state, metric=metric)

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
        train_gen = prefetch(self.provider.training_set(pad_to_length=T))
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
        cfg.save_yaml(os.path.join(self.result_dir, "config.yaml"))
        return history


MODELTYPE = ("adaptiveattention", "gridTD", "aoa")


def main_attention(config, dataset, label: str, model_type: str, weights: str | None = None,
                   device="cuda", **run_kw):
    """Reference entry point parity (train.py:679-682)."""
    if model_type not in MODELTYPE:
        raise ValueError(f"model_type must be one of {MODELTYPE}")
    t = Trainer(model_type, config, dataset, label, device=device)
    if weights:
        t.load_weights(weights)
    t.run(**run_kw)
    return t
