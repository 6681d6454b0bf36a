"""Synchronous replay optimizer (DQN-style).

Counterpart of `ray_tpu/rllib/optimizers/sync_replay_optimizer.py`
(parity: `rllib/optimizers/sync_replay_optimizer.py`) on the local
worker: each `step()` samples one fragment into the (optionally
prioritized) replay buffer and, once the buffer is warm, runs one
minibatch update sampled from it, writing |TD error| + eps back as the
new priorities. The buffer draws from a generator seeded with `seed`
(the trainer passes `config["seed"]`). Remote workers and the
`before_learn_on_batch` hook wait for the runtime port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.schedules import LinearSchedule
from .policy_optimizer import PolicyOptimizer
from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer


class SyncReplayOptimizer(PolicyOptimizer):
    def __init__(self, workers,
                 learning_starts: int = 1000,
                 buffer_size: int = 10000,
                 prioritized_replay: bool = True,
                 prioritized_replay_alpha: float = 0.6,
                 prioritized_replay_beta: float = 0.4,
                 final_prioritized_replay_beta: float = 0.4,
                 prioritized_replay_beta_annealing_timesteps: int = 100000,
                 prioritized_replay_eps: float = 1e-6,
                 train_batch_size: int = 32,
                 seed: Optional[int] = None):
        super().__init__(workers)
        if workers.remote_workers:
            raise NotImplementedError(
                "remote rollout workers in the synchronous optimizers "
                "are not ported yet (ROADMAP Queue A item A6, after "
                "A6b); IMPALA's async optimizer runs them")
        self.learning_starts = learning_starts
        self.prioritized_replay_eps = prioritized_replay_eps
        self.train_batch_size = train_batch_size
        self.prioritized = prioritized_replay
        rng = np.random.default_rng(seed)
        if prioritized_replay:
            self.replay_buffer = PrioritizedReplayBuffer(
                buffer_size, rng, alpha=prioritized_replay_alpha)
            self.beta_schedule = LinearSchedule(
                prioritized_replay_beta_annealing_timesteps,
                initial_p=prioritized_replay_beta,
                final_p=final_prioritized_replay_beta)
        else:
            self.replay_buffer = ReplayBuffer(buffer_size, rng)
            self.beta_schedule = None
        self.learner_stats = {}

    # ------------------------------------------------------------------
    def step(self) -> dict:
        # 1. Sample new experience from the local worker.
        with self.timers["sample"]:
            batch = self.workers.local_worker.sample()
            self.num_steps_sampled += batch.count
            self.replay_buffer.add_batch(batch)

        # 2. Learn from replay once warm.
        if self.num_steps_sampled >= self.learning_starts and \
                len(self.replay_buffer) >= self.train_batch_size:
            with self.timers["learn"]:
                self.learner_stats = self._optimize()
        return self.learner_stats

    def _optimize(self) -> dict:
        policy = self.workers.local_worker.policy
        if self.prioritized:
            beta = self.beta_schedule.value(self.num_steps_sampled)
            replay, idxes = self.replay_buffer.sample(
                self.train_batch_size, beta=beta)
            stats, td_abs = policy.learn_with_td(replay)
            self.replay_buffer.update_priorities(
                idxes, td_abs + self.prioritized_replay_eps)
        else:
            replay = self.replay_buffer.sample(self.train_batch_size)
            stats = policy.learn_on_batch(replay)
        self.num_steps_trained += replay.count
        return stats

    def stats(self) -> dict:
        out = super().stats()
        out["replay_buffer"] = self.replay_buffer.stats()
        return out
