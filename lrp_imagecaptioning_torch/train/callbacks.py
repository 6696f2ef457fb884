"""Training callbacks, the port's own copy of the JAX package's
``train/callbacks.py``: functional equivalents of models/callbacks.py and the
Keras callbacks the reference wires in (train.py:50-164):

* ``CSVLog``             — per-epoch metrics CSV incl. learning_rate and
                           ts_start/ts_end (LogLearningRate callbacks.py:12-14,
                           LogTimestamp callbacks.py:17-34, CSVLogger train.py:75).
* ``ReduceLROnPlateau``  — monitors val_cider (max mode), scales the learning
                           rate by ``factor`` after ``patience`` stagnant
                           epochs (train.py:107-117).
* ``StopAfterTimedelta`` — wall-clock limit (callbacks.py:75-95).
* ``StopWhenValLossExploding`` — divergence guard (callbacks.py:98-143).
"""

from __future__ import annotations

import csv
import os
import time
from datetime import timedelta


class CSVLog:
    def __init__(self, path: str, append: bool = False):
        """``append=True`` (resumed runs) keeps the existing rows and reuses
        the file's header columns instead of truncating the history."""
        self._path = path
        self._writer = None
        self._file = None
        self._append = append and os.path.isfile(path) and os.path.getsize(path) > 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def on_epoch_end(self, epoch: int, logs: dict):
        logs = {"epoch": epoch, **logs}
        if self._writer is None:
            if self._append:
                with open(self._path, newline="") as f:
                    fields = next(csv.reader(f), None) or list(logs)
                self._file = open(self._path, "a", newline="")
                self._writer = csv.DictWriter(self._file, fieldnames=fields)
            else:
                self._file = open(self._path, "w", newline="")
                self._writer = csv.DictWriter(self._file, fieldnames=list(logs))
                self._writer.writeheader()
        self._writer.writerow({k: logs.get(k, "") for k in self._writer.fieldnames})
        self._file.flush()

    def close(self):
        if self._file:
            self._file.close()


class ReduceLROnPlateau:
    """max-mode plateau scheduler on a monitored metric (default val_cider,
    the reference's monitor for both models, train.py:111/249)."""

    def __init__(self, monitor: str = "val_cider", factor: float = 0.5, patience: int = 2,
                 min_lr: float = 0.0, min_delta: float = 1e-4, mode: str = "max"):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.mode = mode
        self._best = float("-inf") if mode == "max" else float("inf")
        self._wait = 0

    def update(self, logs: dict, current_lr: float) -> float:
        """Returns the (possibly reduced) learning rate."""
        value = logs.get(self.monitor)
        if value is None:
            return current_lr
        improved = (value > self._best + self.min_delta) if self.mode == "max" else (
            value < self._best - self.min_delta
        )
        if improved:
            self._best = value
            self._wait = 0
            return current_lr
        self._wait += 1
        if self._wait >= self.patience:
            self._wait = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr


class StopAfterTimedelta:
    def __init__(self, limit: timedelta | None):
        self._deadline = None if limit is None else time.monotonic() + limit.total_seconds()

    def should_stop(self) -> bool:
        return self._deadline is not None and time.monotonic() > self._deadline


class StopWhenValLossExploding:
    """Stop when val_loss exceeds ``ratio`` x the best seen so far
    (callbacks.py:98-143 semantics, simplified to the ratio check)."""

    def __init__(self, ratio: float = 10.0):
        self._ratio = ratio
        self._best = None

    def should_stop(self, val_loss: float | None) -> bool:
        if val_loss is None:
            return False
        if self._best is None or val_loss < self._best:
            self._best = val_loss
            return False
        return val_loss > self._ratio * self._best
