"""Per-step camera batches for training (port of
gaustudio_tpu/pipelines/dataloader.py, single device).

Cameras are drawn with ``np.random.default_rng(seed).integers``, exactly as
the JAX loader draws them, so for one seed both trainers see the same
camera sequence. A capture that fits in ``CACHE_LIMIT_BYTES`` (1 GiB) is
cached on the device; a larger one is built on a background thread that
keeps a small queue ahead of the training loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List

import numpy as np

CACHE_LIMIT_BYTES = 1 << 30  # captures up to this size live on the device


class PrefetchLoader:
    """Infinite sampler of per-step batches with background prefetch."""

    def __init__(self, cameras: List, make_batch: Callable, prefetch: int = 2, seed: int = 0):
        self.cameras = cameras
        self.make_batch = make_batch
        self._rng = np.random.default_rng(seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _sample(self):
        return self.make_batch(self.cameras[int(self._rng.integers(len(self.cameras), size=1)[0])])

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._sample()
            except Exception as e:  # handed to the consumer, which raises it
                self._q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def make_batch_source(cameras: List, make_batch: Callable, seed: int = 0):
    """A zero-argument callable that returns the next batch; it has a
    ``close()`` that stops the loader thread.

    ``make_batch(camera)`` builds one batch on the device.
    """
    cam0 = cameras[0]
    total = len(cameras) * int(cam0.image_height) * int(cam0.image_width) * 12
    if total <= CACHE_LIMIT_BYTES:
        rng = np.random.default_rng(seed)
        cache = [make_batch(c) for c in cameras]
        fn = lambda: cache[int(rng.integers(len(cache), size=1)[0])]  # noqa: E731
        fn.close = lambda: None
        return fn
    loader = PrefetchLoader(cameras, make_batch, prefetch=2, seed=seed)
    fn = lambda: next(loader)  # noqa: E731
    fn.close = loader.close
    return fn
