"""Metric storage and writers of a training run.

A copy of `catre_tpu/utils/events.py` (`EventStorage` :20, `JSONWriter` :72,
`MetricPrinter` :89, `TensorboardWriter` :114), on the standard library and
numpy. Behavioural reference: detectron2's EventStorage and the reference's
writers (`core/utils/my_writer.py:17-290`: the metric printer with its ETA,
the JSON writer, the tensorboard writer). `TensorboardWriter` writes through
`torch.utils.tensorboard` where the `tensorboard` package is installed; where
it is not, it logs one line and drops what it is given.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque

import numpy as np

logger = logging.getLogger(__name__)


class EventStorage:
    """Scalars by name with a median over the last `window` values, and the
    images and histograms queued for the next tensorboard write."""

    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._window = window
        self._history: dict = defaultdict(lambda: deque(maxlen=window))
        self._latest: dict = {}
        self._images: list = []
        self._histograms: list = []

    def put_scalar(self, name: str, value) -> None:
        v = float(value)
        self._history[name].append(v)
        self._latest[name] = (v, self.iter)

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def put_image(self, name: str, img) -> None:
        """Queue an (H, W, 3) uint8 RGB image (the reference's
        `tbx_writer.add_image`, `engine.py:381`)."""
        self._images.append((name, img, self.iter))

    def pop_images(self) -> list:
        out, self._images = self._images, []
        return out

    def put_histogram(self, name: str, values, bins: int = 30) -> None:
        """Queue a histogram (flushed as the reference's writer does,
        `my_writer.py:102-105`)."""
        self._histograms.append((name, np.asarray(values).ravel(), bins, self.iter))

    def pop_histograms(self) -> list:
        out, self._histograms = self._histograms, []
        return out

    def latest(self) -> dict:
        """name -> (its last value, the iteration it was put at)."""
        return dict(self._latest)

    def median(self, name: str) -> float:
        h = sorted(self._history[name])
        return h[len(h) // 2] if h else float("nan")

    def smoothed(self) -> dict:
        return {k: self.median(k) for k in self._history}


class JSONWriter:
    """One JSON line of the latest scalars a write (metrics.json), appended."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage) -> None:
        rec = {"iteration": storage.iter}
        rec.update({k: v for k, (v, _) in storage.latest().items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MetricPrinter:
    """A log line a write: the iteration, the ETA, the smoothed lr and
    losses."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._t0 = time.perf_counter()
        self._start_iter = None

    def write(self, storage: EventStorage) -> None:
        if self._start_iter is None:
            self._start_iter = storage.iter
        done = max(storage.iter - self._start_iter, 1)
        per_iter = (time.perf_counter() - self._t0) / done
        eta = datetime.timedelta(seconds=int(per_iter * (self.max_iter - storage.iter)))
        s = storage.smoothed()
        losses = "  ".join(f"{k}: {v:.4g}" for k, v in sorted(s.items()) if "loss" in k)
        logger.info("iter %d/%d  eta: %s  lr: %.3g  %s", storage.iter, self.max_iter, eta,
                    s.get("lr", float("nan")), losses)

    def close(self) -> None:
        pass


class TensorboardWriter:
    """Scalars, images and histograms to tensorboard; without the
    `tensorboard` package, one log line and nothing written."""

    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except ImportError as e:
            logger.info("tensorboard unavailable (%s); skipping the tb writer", e)

    def write(self, storage: EventStorage) -> None:
        if self._writer is None:
            storage.pop_images()          # keep the queues bounded
            storage.pop_histograms()
            return
        for k, (v, it) in storage.latest().items():
            self._writer.add_scalar(k, v, it)
        for name, img, it in storage.pop_images():
            self._writer.add_image(name, img, it, dataformats="HWC")
        for name, values, bins, it in storage.pop_histograms():
            self._writer.add_histogram(name, values, it, bins=bins)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
