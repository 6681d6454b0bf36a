"""Observation/action space types.

The port's own copy of `ray_tpu/rllib/env/spaces.py` (numpy only),
trimmed to the spaces this slice's envs use, Box and Discrete, and
MultiDiscrete, which `get_action_dist` refuses as the reference does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class Space:
    def sample(self, rng: Optional[np.random.Generator] = None):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError

    @property
    def shape(self) -> Tuple[int, ...]:
        raise NotImplementedError


class Box(Space):
    """Bounded continuous space (parity: gym.spaces.Box)."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self._shape = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, dtype=dtype), self._shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype=dtype), self._shape).copy()
        self.dtype = np.dtype(dtype)

    @property
    def shape(self):
        return self._shape

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        low = np.where(np.isfinite(self.low), self.low, -1.0)
        high = np.where(np.isfinite(self.high), self.high, 1.0)
        return rng.uniform(low, high, size=self._shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self._shape and bool(
            np.all(x >= self.low - 1e-6) and np.all(x <= self.high + 1e-6))

    def __repr__(self):
        return f"Box{self._shape}"

    def __eq__(self, other):
        return (isinstance(other, Box) and other._shape == self._shape
                and np.allclose(other.low, self.low)
                and np.allclose(other.high, self.high))


class Discrete(Space):
    """{0, 1, ..., n-1} (parity: gym.spaces.Discrete)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.dtype = np.dtype(np.int64)

    @property
    def shape(self):
        return ()

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return int(rng.integers(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"

    def __eq__(self, other):
        return isinstance(other, Discrete) and other.n == self.n


class MultiDiscrete(Space):
    """A vector of Discrete spaces of sizes `nvec` (parity:
    gym.spaces.MultiDiscrete)."""

    def __init__(self, nvec):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.dtype = np.dtype(np.int64)

    @property
    def shape(self):
        return self.nvec.shape

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return (rng.random(self.nvec.shape) * self.nvec).astype(np.int64)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.nvec.shape and bool(
            np.all(x >= 0) and np.all(x < self.nvec))

    def __repr__(self):
        return f"MultiDiscrete({self.nvec.tolist()})"
