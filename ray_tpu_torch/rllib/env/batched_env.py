"""Batched environments: N env slots stepped as one vectorized call.

The port's own copy of `ray_tpu/rllib/env/batched_env.py` (numpy only).
The Sebulba inline actors step their envs as a batch with O(1) Python
per step: `vector_step` takes an action batch and returns (obs,
rewards, dones) arrays with auto-reset (a done slot's returned obs is
the first observation of its next episode).

`BatchedEnvFromSingle` adapts any registered single env; SyntheticAtari
and CartPole have natively vectorized implementations.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .env import Env
from .spaces import Box, Discrete


class BatchedEnv:
    """N env slots stepped as a batch.

    Contract:
      - `vector_reset() -> obs[N, ...]` resets every slot.
      - `vector_step(actions[N]) -> (obs[N,...], rewards[N], dones[N])`
        steps every slot; slots that finished an episode this step report
        done=True and their returned obs row is the NEXT episode's first
        observation (auto-reset). The terminal observation itself is never
        surfaced — V-trace/GAE cut the discount at dones, so only the
        post-reset obs is ever consumed (as the next step's input and as
        a bootstrap row whose value is masked by discount 0).
    """

    num_envs: int = 0
    observation_space = None
    action_space = None

    def vector_reset(self) -> np.ndarray:
        raise NotImplementedError

    def vector_step(self, actions):
        raise NotImplementedError

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)

    def close(self):
        pass


class BatchedEnvFromSingle(BatchedEnv):
    """Fallback adapter: N copies of a single `Env` stepped in a loop."""

    def __init__(self, make_env: Callable[[], Env], num_envs: int):
        self.envs = [make_env() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def seed(self, seed=None):
        for i, e in enumerate(self.envs):
            e.seed(None if seed is None else seed + i)

    def vector_reset(self):
        return np.stack([e.reset() for e in self.envs])

    def vector_step(self, actions):
        obs = [None] * self.num_envs
        rewards = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, bool)
        for i, (e, a) in enumerate(zip(self.envs, actions)):
            o, r, d, _ = e.step(a)
            if d:
                o = e.reset()
            obs[i] = o
            rewards[i] = r
            dones[i] = d
        return np.stack(obs), rewards, dones

    def close(self):
        for e in self.envs:
            e.close()


class BatchedSyntheticAtari(BatchedEnv):
    """Vectorized SyntheticAtari (see `env.py:SyntheticAtari`): Atari-shaped
    84x84x4 uint8 frames whose intensity band encodes the rewarded action.

    Frame generation is the dominant cost of the single-env version
    (~28 KiB of fresh RNG output per step). Here frames come from a
    precomputed noise pool with the action band already stamped per
    action: one gather-copy per step for the whole batch, so a single
    CPU core can feed tens of thousands of steps per second while the
    signal (band position -> best action) stays fully learnable.
    """

    def __init__(self, num_envs: int, episode_len: int = 1000,
                 num_actions: int = 6, pool_size: int = 32,
                 channels: int = 4, seed=None):
        self.num_envs = num_envs
        self.episode_len = episode_len
        self.num_actions = num_actions
        self.pool_size = pool_size
        self.channels = channels
        self.observation_space = Box(0, 255, shape=(84, 84, channels),
                                     dtype=np.uint8)
        self.action_space = Discrete(num_actions)
        self._rng = np.random.default_rng(seed)
        self._build_pool()
        self._t = np.zeros(num_envs, np.int64)
        self._target = self._rng.integers(0, num_actions, size=num_envs)

    def _build_pool(self):
        base = self._rng.integers(
            0, 64, size=(self.pool_size, 84, 84, self.channels),
            dtype=np.uint8)
        band = 84 // self.num_actions
        pool = np.broadcast_to(
            base, (self.num_actions,) + base.shape).copy()
        for a in range(self.num_actions):
            pool[a, :, a * band:(a + 1) * band, :, :] += 128
        self._pool = pool  # [A, P, 84, 84, C]

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)
        self._build_pool()

    def _frames(self):
        idx = self._rng.integers(0, self.pool_size, size=self.num_envs)
        return self._pool[self._target, idx]

    def vector_reset(self):
        self._t[:] = 0
        self._target = self._rng.integers(
            0, self.num_actions, size=self.num_envs)
        return self._frames()

    def vector_step(self, actions):
        rewards = (np.asarray(actions) == self._target).astype(np.float32)
        self._t += 1
        dones = self._t >= self.episode_len
        if dones.any():
            self._t[dones] = 0
        # Target re-randomizes every step (same as the single-env version),
        # so reset and non-reset slots draw from the same distribution.
        self._target = self._rng.integers(
            0, self.num_actions, size=self.num_envs)
        return self._frames(), rewards, dones


class BatchedCartPole(BatchedEnv):
    """Vectorized CartPole — dynamics shared with `env.py:CartPole` via
    `cartpole_step` (gym CartPole-v0 semantics)."""

    def __init__(self, num_envs: int, max_steps: int = 200, seed=None):
        from .env import init_cartpole_constants
        init_cartpole_constants(self, max_steps)
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4))
        self._t = np.zeros(num_envs, np.int64)

    def _reset_rows(self, mask):
        n = int(mask.sum())
        self._state[mask] = self._rng.uniform(-0.05, 0.05, size=(n, 4))
        self._t[mask] = 0

    def vector_reset(self):
        self._reset_rows(np.ones(self.num_envs, bool))
        return self._state.astype(np.float32)

    def vector_step(self, actions):
        from .env import cartpole_step
        self._state, violation = cartpole_step(self, self._state, actions)
        self._t += 1
        dones = violation | (self._t >= self.max_steps)
        rewards = np.ones(self.num_envs, np.float32)
        if dones.any():
            self._reset_rows(dones)
        return self._state.astype(np.float32), rewards, dones
