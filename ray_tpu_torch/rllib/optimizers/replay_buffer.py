"""Replay buffers: uniform and prioritized.

The port's own copy of `ray_tpu/rllib/optimizers/replay_buffer.py`
(parity: `rllib/optimizers/replay_buffer.py`, ReplayBuffer and
PrioritizedReplayBuffer — add, sample, update_priorities), columnar as
there: experiences are stored as preallocated numpy column arrays (a
ring per column), so sampling a train batch is one fancy-index per
column and yields contiguous arrays the learner copies to the device
in one transfer each.

One change: the buffer draws from the `np.random.Generator` it is
given (`rng`), where the JAX package draws from the global `np.random`,
so a run seeded from its config samples the same rows every time.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..sample_batch import SampleBatch
from .segment_tree import MinSegmentTree, SumSegmentTree


class ReplayBuffer:
    """Uniform-sampling ring buffer over columnar storage."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.capacity = size
        self.rng = rng
        self._columns: Optional[Dict[str, np.ndarray]] = None
        self._next_idx = 0
        self._num_added = 0
        self._num_sampled = 0
        self._est_size_bytes = 0

    def __len__(self) -> int:
        return min(self._num_added, self.capacity)

    def _ensure_storage(self, batch: SampleBatch):
        if self._columns is not None:
            return
        self._columns = {}
        for k, v in batch.items():
            v = np.asarray(v)
            self._columns[k] = np.zeros((self.capacity,) + v.shape[1:],
                                        dtype=v.dtype)
            self._est_size_bytes += self._columns[k].nbytes

    def add_batch(self, batch: SampleBatch) -> None:
        """Append all rows of `batch` (wraps at capacity)."""
        self._ensure_storage(batch)
        n = batch.count
        idxs = (self._next_idx + np.arange(n)) % self.capacity
        for k, col in self._columns.items():
            col[idxs] = np.asarray(batch[k])
        self._next_idx = int((self._next_idx + n) % self.capacity)
        self._num_added += n
        self._on_added(idxs)

    def _on_added(self, idxs: np.ndarray) -> None:
        pass

    def sample_idxes(self, batch_size: int) -> np.ndarray:
        return self.rng.integers(0, len(self), size=batch_size)

    def sample_with_idxes(self, idxs: np.ndarray) -> SampleBatch:
        self._num_sampled += len(idxs)
        return SampleBatch({k: col[idxs] for k, col in self._columns.items()})

    def sample(self, batch_size: int) -> SampleBatch:
        return self.sample_with_idxes(self.sample_idxes(batch_size))

    def stats(self) -> dict:
        return {
            "added_count": self._num_added,
            "sampled_count": self._num_sampled,
            "est_size_bytes": self._est_size_bytes,
            "num_entries": len(self),
        }


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (Schaul et al.) on segment trees,
    whole-minibatch vectorized (see segment_tree.py)."""

    def __init__(self, size: int, rng: np.random.Generator,
                 alpha: float = 0.6):
        super().__init__(size, rng)
        if alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {alpha}")
        self._alpha = alpha
        self._sum_tree = SumSegmentTree(size)
        self._min_tree = MinSegmentTree(size)
        self._max_priority = 1.0

    def _on_added(self, idxs: np.ndarray) -> None:
        # New experience enters at max priority so it is seen at least once.
        p = self._max_priority ** self._alpha
        self._sum_tree.set_items(idxs, np.full(len(idxs), p))
        self._min_tree.set_items(idxs, np.full(len(idxs), p))

    def sample_idxes(self, batch_size: int) -> np.ndarray:
        total = self._sum_tree.sum()
        # Stratified: one uniform draw per equal mass segment.
        bounds = np.linspace(0, total, batch_size + 1)
        mass = self.rng.uniform(bounds[:-1], bounds[1:])
        return self._sum_tree.find_prefixsum_idx(mass)

    def sample(self, batch_size: int, beta: float = 0.4):
        """Returns (batch, idxes); batch carries IS `weights` column."""
        idxs = self.sample_idxes(batch_size)
        batch = self.sample_with_idxes(idxs)
        total = self._sum_tree.sum()
        n = len(self)
        p_min = self._min_tree.min() / total
        max_weight = (p_min * n) ** (-beta)
        p_sample = self._sum_tree.get_items(idxs) / total
        weights = (p_sample * n) ** (-beta) / max_weight
        batch["weights"] = weights.astype(np.float32)
        batch["batch_indexes"] = idxs
        return batch, idxs

    def update_priorities(self, idxes, priorities) -> None:
        priorities = np.asarray(priorities, dtype=np.float64)
        if np.any(priorities <= 0):
            priorities = np.maximum(priorities, 1e-8)
        p = priorities ** self._alpha
        self._sum_tree.set_items(idxes, p)
        self._min_tree.set_items(idxes, p)
        self._max_priority = max(self._max_priority,
                                 float(priorities.max()))

    def stats(self) -> dict:
        out = super().stats()
        out["max_priority"] = self._max_priority
        return out
