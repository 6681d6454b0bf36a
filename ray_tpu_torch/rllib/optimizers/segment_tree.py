"""Array-backed segment trees for prioritized replay.

The port's own copy of `ray_tpu/rllib/optimizers/segment_tree.py`
(parity: `rllib/optimizers/segment_tree.py`, SumSegmentTree and
MinSegmentTree), numpy only: every update and prefix-sum query works on
a whole batch of indexes, one vectorized sweep per tree level. (The JAX
package can also run these loops in an optional C++ library; the port
keeps the numpy sweep, which descends the tree by the same comparisons
and so finds the same leaves.)
"""

from __future__ import annotations

import numpy as np


class SegmentTree:
    """Complete binary tree over `capacity` slots stored in one flat array.

    Leaves live at [size, 2*size); internal node i aggregates children
    2i and 2i+1 under `operation` (np ufunc with .reduce semantics).
    """

    def __init__(self, capacity: int, operation, neutral: float):
        size = 1
        while size < capacity:
            size *= 2
        self._size = size
        self.capacity = capacity
        self._op = operation
        self._neutral = neutral
        self._tree = np.full(2 * size, neutral, dtype=np.float64)

    # -- updates ---------------------------------------------------------
    def set_items(self, idxs, values) -> None:
        """Set leaves at `idxs` and repair ancestors."""
        idxs = np.ascontiguousarray(idxs, dtype=np.int64) + self._size
        self._tree[idxs] = np.asarray(values, dtype=np.float64)
        parents = np.unique(idxs // 2)
        while parents.size and parents[0] >= 1:
            self._tree[parents] = self._op(
                self._tree[2 * parents], self._tree[2 * parents + 1])
            parents = np.unique(parents // 2)
            if parents[0] == 0:
                break

    def get_items(self, idxs):
        return self._tree[self._size + np.asarray(idxs, dtype=np.int64)]

    def reduce_all(self) -> float:
        return float(self._tree[1])


class SumSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, np.add, 0.0)

    def sum(self) -> float:
        return self.reduce_all()

    def find_prefixsum_idx(self, prefixsums) -> np.ndarray:
        """For each p, the smallest leaf i with cumsum(leaves[0..i]) > p:
        all queries descend one level at a time (log n vectorized
        steps)."""
        p = np.asarray(prefixsums, dtype=np.float64).copy()
        idx = np.ones(len(p), dtype=np.int64)
        while idx[0] < self._size:  # all idx are at the same level
            left = 2 * idx
            left_sum = self._tree[left]
            go_right = p > left_sum
            p = np.where(go_right, p - left_sum, p)
            idx = np.where(go_right, left + 1, left)
        return np.minimum(idx - self._size, self.capacity - 1)


class MinSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, np.minimum, float("inf"))

    def min(self) -> float:
        return self.reduce_all()
