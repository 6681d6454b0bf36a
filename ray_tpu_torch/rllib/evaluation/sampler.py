"""The env-stepping hot loop.

Counterpart of `ray_tpu/rllib/evaluation/sampler.py` (parity:
`rllib/evaluation/sampler.py:60,226`, `SyncSampler` around
`_env_runner`), feedforward only: poll the vectorized env, batch
observations, one `compute_actions` per step (one network forward and
one sampling-tail launch, K2 or K7, covering all envs), build per-env
trajectories, postprocess on episode end or fragment truncation with value
bootstrapping; `explore=False` acts without exploring (evaluation).
Recurrent state threading, horizon truncation and ExternalEnv action
relabeling wait for later slices.
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional

import numpy as np

from .. import sample_batch as sb
from ..sample_batch import SampleBatch

RolloutMetrics = collections.namedtuple(
    "RolloutMetrics", ["episode_length", "episode_reward"])


class _EpisodeBuilder:
    """Accumulates one env slot's current episode fragment."""

    __slots__ = ("columns", "eps_id", "ep_reward", "ep_len", "_eps_ids")

    def __init__(self, eps_id: int):
        self.columns = collections.defaultdict(list)
        self.eps_id = eps_id
        self.ep_reward = 0.0
        self.ep_len = 0
        self._eps_ids = []

    def add(self, **row):
        for k, v in row.items():
            self.columns[k].append(v)
        self._eps_ids.append(self.eps_id)

    def count(self):
        return len(self.columns[sb.OBS])

    def build(self) -> SampleBatch:
        out = {}
        for k, v in self.columns.items():
            out[k] = np.stack(v) if isinstance(v[0], np.ndarray) \
                else np.asarray(v)
        out[sb.EPS_ID] = np.asarray(self._eps_ids, dtype=np.int64)
        return SampleBatch(out)


class SyncSampler:
    """Steps a VectorEnv for `rollout_fragment_length` steps per sample().

    `postprocess_fn(batch, last_obs or None) -> batch` is applied per
    trajectory chunk: at episode end with last_obs=None (terminal), or at
    fragment truncation with the bootstrap observation.
    """

    def __init__(self, vector_env, policy,
                 rollout_fragment_length: int,
                 postprocess_fn: Optional[Callable] = None,
                 obs_filter: Optional[Callable] = None,
                 preprocessor=None,
                 pack_fragments: bool = False,
                 explore: bool = True):
        self.env = vector_env
        self.explore = explore
        self.policy = policy
        self.T = rollout_fragment_length
        self.postprocess_fn = postprocess_fn
        self.obs_filter = obs_filter
        # pack_fragments=True: every env slot emits exactly T contiguous
        # steps per sample(), crossing episode boundaries (dones mark the
        # resets inside). This is the V-trace/IMPALA layout — sequences
        # reshape to [B, T] with no padding (reference: `_env_runner`
        # pack mode, `rllib/evaluation/sampler.py:226`).
        self.pack_fragments = pack_fragments
        # Space preprocessor (one-hot for Discrete obs etc.); identity
        # preprocessors are skipped entirely.
        self.preprocessor = preprocessor if (
            preprocessor is not None
            and not getattr(preprocessor, "is_identity", False)) else None
        self._eps_counter = 0
        self._obs = self._filter(self._preprocess(self.env.reset()))
        self._builders = [self._new_builder()
                          for _ in range(self.env.num_envs)]
        self.metrics: List[RolloutMetrics] = []

    def _preprocess(self, obs):
        if self.preprocessor is not None:
            return self.preprocessor.transform_batch(obs)
        return obs

    def _preprocess_one(self, obs):
        if self.preprocessor is not None:
            return self.preprocessor.transform(obs)
        return obs

    def _filter(self, obs):
        if self.obs_filter is not None:
            return np.stack([self.obs_filter(o) for o in obs])
        return obs

    def _new_builder(self):
        self._eps_counter += 1
        return _EpisodeBuilder(self._eps_counter)

    def sample(self) -> SampleBatch:
        chunks: List[SampleBatch] = []
        for _ in range(self.T):
            obs = self._obs
            actions, _, extra = self.policy.compute_actions(
                obs, explore=self.explore)
            next_obs, rewards, dones, _ = self.env.step(actions)
            next_obs = self._filter(self._preprocess(next_obs))
            for i in range(self.env.num_envs):
                b = self._builders[i]
                row = {
                    sb.OBS: obs[i],
                    sb.ACTIONS: actions[i],
                    sb.REWARDS: np.float32(rewards[i]),
                    sb.DONES: bool(dones[i]),
                    sb.NEW_OBS: next_obs[i],
                    sb.AGENT_INDEX: i,
                    sb.T: b.ep_len,
                }
                for k, v in extra.items():
                    row[k] = v[i]
                b.add(**row)
                b.ep_reward += float(rewards[i])
                b.ep_len += 1
                if dones[i]:
                    self.metrics.append(
                        RolloutMetrics(b.ep_len, b.ep_reward))
                    if self.pack_fragments:
                        # Keep filling the same fragment across the reset.
                        self._eps_counter += 1
                        b.eps_id = self._eps_counter
                        b.ep_reward, b.ep_len = 0.0, 0
                    else:
                        chunk = b.build()
                        if self.postprocess_fn is not None:
                            chunk = self.postprocess_fn(chunk, None)
                        chunks.append(chunk)
                        self._builders[i] = self._new_builder()
                    fresh = self._preprocess_one(self.env.reset_at(i))
                    next_obs[i] = fresh if self.obs_filter is None \
                        else self.obs_filter(fresh)
            self._obs = next_obs
        # Fragment boundary: flush partial trajectories with bootstrap obs.
        for i in range(self.env.num_envs):
            b = self._builders[i]
            if b.count() > 0:
                chunk = b.build()
                if self.postprocess_fn is not None:
                    chunk = self.postprocess_fn(chunk, self._obs[i])
                chunks.append(chunk)
                # Continue the same episode in a fresh _EpisodeBuilder.
                nb = _EpisodeBuilder(b.eps_id)
                nb.ep_reward, nb.ep_len = b.ep_reward, b.ep_len
                self._builders[i] = nb
        return SampleBatch.concat_samples(chunks)

    def get_metrics(self) -> List[RolloutMetrics]:
        out = self.metrics
        self.metrics = []
        return out
