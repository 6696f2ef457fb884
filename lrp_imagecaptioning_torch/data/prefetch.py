"""Background batch prefetching.

The port's own copy of the JAX package's ``data/prefetch.py``. Equivalent
of the reference's GeneratorEnqueuer usage (inference.py:63-92: one worker
thread, queue size 10, 0.01s poll) — but thread-safe by construction: ONE
producer thread owns the generator (the reference's generator is explicitly
not thread-safe, preparedataset.py:547) and the consumer pulls from a
bounded queue, overlapping host-side batch preparation with device compute.
"""

from __future__ import annotations

import queue
import threading


class PrefetchingGenerator:
    """Wrap any generator with a bounded background-producer queue."""

    _SENTINEL = object()

    def __init__(self, generator, max_queue_size: int = 10, daemon: bool = True):
        self._gen = generator
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue_size)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=daemon)
        self._thread.start()

    def _produce(self):
        try:
            for item in self._gen:
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surface producer errors to the consumer
            self._err = e
        finally:
            try:
                self._queue.put(self._SENTINEL, timeout=1.0)
            except queue.Full:
                pass

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def stop(self):
        self._stop.set()


def prefetch(generator, max_queue_size: int = 10):
    """Convenience wrapper: `for batch in prefetch(provider.training_set()):`"""
    return PrefetchingGenerator(generator, max_queue_size)
