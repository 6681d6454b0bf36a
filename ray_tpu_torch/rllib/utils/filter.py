"""Observation filters.

The port's own copy of `ray_tpu/rllib/utils/filter.py` (numpy only).
Parity: `rllib/utils/filter.py` — `NoFilter`, `MeanStdFilter` (running
mean/std normalization with a shareable delta buffer so distributed workers
can merge statistics), and `rllib/utils/filter_manager.py`'s synchronize.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class RunningStat:
    """Numerically stable running mean/var (Welford), mergeable."""

    def __init__(self, shape=()):
        self.n = 0
        self.mean = np.zeros(shape, dtype=np.float64)
        self.m2 = np.zeros(shape, dtype=np.float64)

    def push(self, x):
        x = np.asarray(x, dtype=np.float64)
        self.n += 1
        delta = x - self.mean
        self.mean = self.mean + delta / self.n
        self.m2 = self.m2 + delta * (x - self.mean)

    def update(self, other: "RunningStat"):
        if other.n == 0:
            return
        n1, n2 = self.n, other.n
        n = n1 + n2
        delta = other.mean - self.mean
        self.mean = self.mean + delta * n2 / n
        self.m2 = self.m2 + other.m2 + delta * delta * n1 * n2 / n
        self.n = n

    @property
    def var(self):
        return self.m2 / (self.n - 1) if self.n > 1 else np.square(self.mean) * 0

    @property
    def std(self):
        return np.sqrt(np.maximum(self.var, 1e-8))

    def copy(self):
        out = RunningStat()
        out.n = self.n
        out.mean = self.mean.copy()
        out.m2 = self.m2.copy()
        return out


class Filter:
    def __call__(self, x, update: bool = True):
        raise NotImplementedError

    def as_serializable(self):
        return self

    def clear_buffer(self):
        pass

    def sync(self, other):
        pass

    def apply_changes(self, other, with_buffer=False):
        pass


class NoFilter(Filter):
    def __call__(self, x, update: bool = True):
        return x

    def copy(self):
        return self


class MeanStdFilter(Filter):
    """Normalize to zero-mean unit-std with running statistics.

    `buffer` accumulates deltas since the last flush so remote workers can
    ship only increments to the learner (reference: `filter.py` buffer +
    `FilterManager.synchronize`, `rllib/utils/filter_manager.py:14`).
    """

    def __init__(self, shape, demean=True, destd=True, clip=10.0):
        self.shape = shape
        self.demean = demean
        self.destd = destd
        self.clip = clip
        self.rs = RunningStat(shape)
        self.buffer = RunningStat(shape)
        self._lock = threading.Lock()

    def __call__(self, x, update: bool = True):
        x = np.asarray(x, dtype=np.float64)
        with self._lock:
            if update:
                self.rs.push(x)
                self.buffer.push(x)
            out = x
            if self.demean:
                out = out - self.rs.mean
            if self.destd:
                out = out / (self.rs.std + 1e-8)
            if self.clip is not None:
                out = np.clip(out, -self.clip, self.clip)
        return out.astype(np.float32)

    def as_serializable(self) -> "MeanStdFilter":
        with self._lock:
            out = MeanStdFilter(self.shape, self.demean, self.destd, self.clip)
            out.rs = self.rs.copy()
            out.buffer = self.buffer.copy()
            return out

    def clear_buffer(self):
        with self._lock:
            self.buffer = RunningStat(self.shape)

    def apply_changes(self, other: "MeanStdFilter", with_buffer=False):
        """Merge another filter's buffered deltas into our stats."""
        with self._lock:
            self.rs.update(other.buffer)
            if with_buffer:
                self.buffer = other.buffer.copy()

    def sync(self, other: "MeanStdFilter"):
        with self._lock:
            self.rs = other.rs.copy()
            self.buffer = other.buffer.copy()

    def copy(self):
        return self.as_serializable()

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_lock", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


def get_filter(name: str, shape) -> Filter:
    if name in (None, "NoFilter", "no_filter"):
        return NoFilter()
    if name == "MeanStdFilter":
        return MeanStdFilter(shape)
    raise ValueError(f"unknown filter {name!r}")


class FilterManager:
    """Parity: `rllib/utils/filter_manager.py:14` — pull remote workers'
    filter deltas, merge into the local filter, push merged state back."""

    @staticmethod
    def synchronize(local_filter, remote_workers, get_ref, sync_call):
        """Generic form: `get_ref(worker)` returns a ref to
        worker.get_filters(flush_after=True); `sync_call(worker, f)` pushes
        the merged filter."""
        import ray_tpu_torch
        remote_filters = ray_tpu_torch.get(
            [get_ref(w) for w in remote_workers])
        for f in remote_filters:
            local_filter.apply_changes(f, with_buffer=False)
        serialized = local_filter.as_serializable()
        serialized.clear_buffer()
        for w in remote_workers:
            sync_call(w, serialized)
