"""Synchronous sample-then-train optimizers.

Counterpart of `ray_tpu/rllib/optimizers/sync_samples_optimizer.py`
(parity: `rllib/optimizers/sync_samples_optimizer.py` and
`multi_gpu_optimizer.py:24`), on the local worker:
- `SyncSamplesOptimizer`: gather a train batch, one `learn_on_batch`
  update (A2C/PG-style);
- `MultiDeviceOptimizer`: gather a train batch, standardize its
  advantages on the host, and run the whole minibatch-SGD phase as one
  `TorchPolicy.sgd_learn` (PPO).

Remote workers, the weight broadcast and the filter sync wait for the
runtime port; `MultiAgentBatch` waits for policy maps.
"""

from __future__ import annotations

from ..sample_batch import SampleBatch
from .policy_optimizer import PolicyOptimizer


def collect_train_batch(workers, train_batch_size: int) -> SampleBatch:
    """Sample the local worker until `train_batch_size` env steps are
    gathered."""
    batches = []
    count = 0
    while count < train_batch_size:
        b = workers.local_worker.sample()
        batches.append(b)
        count += b.count
    return SampleBatch.concat_samples(batches)


class _SyncOptimizer(PolicyOptimizer):
    def __init__(self, workers, train_batch_size: int):
        super().__init__(workers)
        if workers.remote_workers:
            raise NotImplementedError(
                "remote rollout workers are not ported yet")
        self.train_batch_size = train_batch_size
        self.learner_stats = {}

    def step(self) -> dict:
        with self.timers["sample"]:
            batch = collect_train_batch(self.workers, self.train_batch_size)
        with self.timers["learn"]:
            self.learner_stats = self._learn(batch)
        n = batch.count
        self.num_steps_sampled += n
        self.num_steps_trained += n
        return self.learner_stats

    def _learn(self, batch) -> dict:
        raise NotImplementedError


class SyncSamplesOptimizer(_SyncOptimizer):
    """One `learn_on_batch` update per train batch."""

    def __init__(self, workers, train_batch_size: int = 200):
        super().__init__(workers, train_batch_size)

    def _learn(self, batch) -> dict:
        return self.workers.local_worker.policy.learn_on_batch(batch)


class MultiDeviceOptimizer(_SyncOptimizer):
    """PPO-style minibatch SGD on the learner device."""

    def __init__(self, workers, train_batch_size: int = 4000,
                 num_sgd_iter: int = 10, sgd_minibatch_size: int = 128,
                 standardize_fields=("advantages",)):
        super().__init__(workers, train_batch_size)
        self.num_sgd_iter = num_sgd_iter
        self.sgd_minibatch_size = sgd_minibatch_size
        self.standardize_fields = standardize_fields

    def _standardize(self, batch):
        """Each field to zero mean and unit (population) std, the std
        floored at 1e-4, on the host. (The JAX package also leaves
        recurrent padding rows out; the port's batches have none.)"""
        for field in self.standardize_fields:
            if field in batch:
                v = batch[field]
                batch[field] = (v - v.mean()) / max(1e-4, v.std())
        return batch

    def _learn(self, batch) -> dict:
        self._standardize(batch)
        return self.workers.local_worker.policy.sgd_learn(
            batch, self.num_sgd_iter, self.sgd_minibatch_size)
