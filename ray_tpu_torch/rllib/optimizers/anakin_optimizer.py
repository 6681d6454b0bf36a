"""Anakin optimizer: device-resident envs, rollout inference and the
V-trace update on one card, with no host sync inside a call.

Counterpart of `ray_tpu/rllib/optimizers/anakin_optimizer.py`. The JAX
package compiled a whole call (M updates, each a `lax.scan` of T env
steps with policy inference, then the V-trace update) into one donated
XLA program. PyTorch runs eagerly, so here a call enqueues the same work
launch by launch on the device's current stream, and the host reads
nothing back until the call's one stats read (the reference's
`float(v)` at `:184`). Per env step: the policy forward under
`no_grad`, the action draw (kernel K2, uniforms from the policy's
generator) and the env step (kernel K5a or K5b,
`rllib/env/device_env.py`, through the step `DeviceEnv.bind` returns
once for the optimizer's buffers), which writes the next observation
straight into its slot of the trajectory buffer and books finished
episodes.
Per update: `TorchPolicy.apply_update` (kernel K1 inside the loss).

Semantics follow the reference's `_build_fn` (`:85-177`): on-policy
IMPALA (the behaviour logits are the rollout forward's `dist_inputs`,
so V-trace's importance ratios are 1); batch columns in env-major order
(row n*T + t, the reference's `em()`); completed-episode reward and
length sums and counts per call, whose means override the sampler
summary (a call with no completed episode keeps the previous means);
stats are the mean over the M updates of the loss stats; the step
counters advance by M*N*T per call.

Buffers are allocated once and reused on one stream: the env-major
observations [N, T, *obs] plus the bootstrap observations [N, *obs].
The learner's OBS column is a view of the former (no transpose) and
BOOTSTRAP_OBS is the latter, which becomes the next rollout's step-0
observation by one copy. Stream order makes the reuse safe: the next
rollout's env kernels write only after the previous backward has read.

The reference's `metrics_mod.inc` counters wait for the runtime copy
(ROADMAP A6); the data-parallel mesh and a CUDA graph over the call wait
for later slices.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import sample_batch as sb
from ..env.device_env import EpisodeAccumulator
from .policy_optimizer import PolicyOptimizer


class AnakinOptimizer(PolicyOptimizer):
    """Fused device-resident IMPALA (see module docstring)."""

    def __init__(self, workers, device_env, num_envs: int,
                 rollout_fragment_length: int,
                 updates_per_call: int = 10,
                 seed: int = 0):
        super().__init__(workers)
        self.policy = workers.local_worker.policy
        self.env = device_env
        self.num_envs = num_envs
        self.T = rollout_fragment_length
        self.updates_per_call = updates_per_call
        self.learner_stats: Dict = {}
        self._ep_reward_mean = float("nan")
        self._ep_len_mean = float("nan")
        self._episodes_total = 0
        self._call_time_total = 0.0
        self._calls = 0
        self._call_start = None
        self._stat_keys: List[str] = []

        device = self.policy.device
        N, T = num_envs, self.T
        self._seed = seed
        obs = device_env.empty_obs(N * T, device)
        self._obs = obs.view((N, T) + tuple(obs.shape[1:]))
        self._boot = device_env.empty_obs(N, device)
        self._rewards = torch.empty(N, T, dtype=torch.float32,
                                    device=device)
        self._dones = torch.empty(N, T, dtype=torch.bool, device=device)
        self._episodes = EpisodeAccumulator(N, device)
        # Philox counter of the env launches: 0 is the reset, each env
        # step takes the next one.
        self._env_state, _ = device_env.reset(
            N, seed, device=device, counter=0, obs_out=self._boot)
        self._counter = 1
        # Env step t writes obs slot t + 1 (the bootstrap buffer after the
        # last) and reward/done column t: bound once, checked once.
        self._env_step = device_env.bind(
            self._env_state,
            [self._obs[:, t] for t in range(1, T)] + [self._boot],
            self._rewards.unbind(1), self._dones.unbind(1), seed=seed,
            episodes=self._episodes)

    # ------------------------------------------------------------------
    def _rollout(self) -> Dict[str, torch.Tensor]:
        """T env steps of N envs under the current weights; returns the
        fragment batch (views of the reused buffers, enqueued and not
        waited for)."""
        policy, env_step = self.policy, self._env_step
        N, T = self.num_envs, self.T
        self._obs[:, 0].copy_(self._boot)
        actions, logits = [], []
        for t in range(T):
            with torch.no_grad():
                dist_inputs, _ = policy.model(self._obs[:, t])
                action, _ = policy.dist_class(dist_inputs).sample_with_logp(
                    policy.generator)
            env_step(action, t, self._counter)
            self._counter += 1
            actions.append(action)
            logits.append(dist_inputs)
        return {
            sb.OBS: self._obs.view((N * T,) + tuple(self._obs.shape[2:])),
            sb.ACTIONS: torch.stack(actions, 1).view(N * T),
            sb.REWARDS: self._rewards.view(N * T),
            sb.DONES: self._dones.view(N * T).float(),
            sb.ACTION_DIST_INPUTS: torch.stack(logits, 1).view(N * T, -1),
            sb.BOOTSTRAP_OBS: self._boot,
        }

    def enqueue(self) -> torch.Tensor:
        """Enqueue one call (updates_per_call x (rollout + update)) with
        no host sync. Returns the call's results as one float64 device
        tensor: the mean loss stats, then the completed-episode reward
        sum, length sum and count; `finish` reads it."""
        policy = self.policy
        self._call_start = time.perf_counter()
        with policy._update_lock:
            self._episodes.zero_sums()
            per_update = []
            for _ in range(self.updates_per_call):
                stats = policy.apply_update(self._rollout())
                # The reference reports the loss's stats (its update
                # computes no grad_gnorm stat).
                stats.pop("grad_gnorm", None)
                self._stat_keys = list(stats)
                per_update.append(torch.stack(
                    [v.detach().double().reshape(()) for v in
                     stats.values()]))
            means = torch.stack(per_update).mean(0)
            return torch.cat([means, self._episodes.totals()])

    def finish(self, pending: torch.Tensor) -> dict:
        """The call's one device->host read and the host bookkeeping."""
        values = pending.tolist()
        self._call_time_total += time.perf_counter() - self._call_start
        self._calls += 1
        n = self.updates_per_call * self.num_envs * self.T
        self.num_steps_sampled += n
        self.num_steps_trained += n
        self.policy.global_timestep += n
        rew_sum, len_sum, cnt = values[-3:]
        if cnt > 0:
            self._ep_reward_mean = rew_sum / cnt
            self._ep_len_mean = len_sum / cnt
            self._episodes_total += int(cnt)
        self.learner_stats = dict(zip(self._stat_keys, values[:-3]))
        return self.learner_stats

    def step(self) -> dict:
        return self.finish(self.enqueue())

    def stats(self) -> dict:
        out = super().stats()
        out.update({
            "anakin": True,
            "updates_per_call": self.updates_per_call,
            # Episode metrics are device-aggregated (sum/count), not
            # per-episode records — the mean overrides the (empty)
            # sampler summary in Trainer results.
            "episode_reward_mean": self._ep_reward_mean,
            "episode_len_mean": self._ep_len_mean,
            "episodes_total": self._episodes_total,
            "timing": {
                "anakin_call_time_ms": round(
                    1000 * self._call_time_total / max(1, self._calls), 3),
            },
        })
        return out
