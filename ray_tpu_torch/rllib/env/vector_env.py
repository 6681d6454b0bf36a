"""Vectorized environment wrapper.

The port's own copy of `ray_tpu/rllib/env/vector_env.py` (numpy only).
Parity: `rllib/env/vector_env.py` — N copies of an env stepped as a batch,
with auto-reset on episode end. This is the sampler's unit of work: the
policy sees (num_envs, *obs_shape) batches, which is what keeps the
device-side `compute_actions` efficient.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np


class VectorEnv:
    """`num_envs` envs with global indices `first_index` onwards: env i
    is seeded by its global index, so a data-parallel learner's ranks,
    each holding its slice, together hold the one-rank env set."""

    def __init__(self, make_env: Callable[[], object], num_envs: int,
                 first_index: int = 0):
        self.envs = [make_env() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.first_index = first_index
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def seed(self, seed: int):
        for i, e in enumerate(self.envs):
            e.seed(seed + self.first_index + i)

    def reset(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs])

    def reset_at(self, i: int):
        return self.envs[i].reset()

    def step(self, actions):
        """Steps all envs; returns (obs, rewards, dones, infos). Done envs
        are NOT auto-reset — the caller decides (the sampler resets and
        records episode boundaries)."""
        obs_list, rewards, dones, infos = [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, d, i = e.step(a)
            obs_list.append(o)
            rewards.append(r)
            dones.append(d)
            infos.append(i)
        return (np.stack(obs_list), np.asarray(rewards, dtype=np.float32),
                np.asarray(dones), infos)

    def close(self):
        for e in self.envs:
            e.close()
