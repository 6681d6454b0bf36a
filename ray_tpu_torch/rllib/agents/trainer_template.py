"""Declarative trainer factory.

Counterpart of `ray_tpu/rllib/agents/trainer_template.py` (parity:
`rllib/agents/trainer_template.py:9` `build_trainer`): an algorithm is a
policy class + an optimizer choice (`SyncSamplesOptimizer` by default)
+ a config check + three hooks: `after_init` (DQN's exploration
schedule), `after_optimizer_step` (PPO's adaptive KL; DQN's epsilon and
target-network sync) and `after_train_result` (DQN's exploration
metrics). The JAX package's `before_init`, `before_train_step` and
`get_policy_class` come with the algorithms that use them.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..optimizers.sync_samples_optimizer import SyncSamplesOptimizer
from .trainer import Trainer


def build_trainer(name: str,
                  default_policy,
                  make_policy_optimizer: Optional[Callable] = None,
                  default_config: Optional[dict] = None,
                  validate_config: Optional[Callable] = None,
                  after_init: Optional[Callable] = None,
                  after_optimizer_step: Optional[Callable] = None,
                  after_train_result: Optional[Callable] = None):
    """Returns a Trainer subclass named `name`. The hooks
    (`trainer_template.py:21-24` in the JAX package):
    - `after_init(trainer)` runs once the workers and the optimizer are
      built;
    - `after_optimizer_step(trainer, fetches)` runs after every
      optimizer step, inside the iteration's pacing loop
      (`trainer_template.py:63-68`);
    - `after_train_result(trainer, result)` runs on each iteration's
      result dict before `train()` returns it."""

    class _Trainer(Trainer):
        _default_config = default_config or Trainer._default_config

        def _init(self, config):
            if validate_config:
                validate_config(config)
            self.workers = self._make_workers(default_policy)
            if make_policy_optimizer:
                self.optimizer = make_policy_optimizer(self.workers, config)
            else:
                self.optimizer = SyncSamplesOptimizer(
                    self.workers,
                    train_batch_size=config["train_batch_size"])
            if after_init:
                after_init(self)

        def _train_inner(self):
            # Iteration pacing (parity: trainer_template.py:117-135): keep
            # stepping the optimizer until both min_iter_time_s and
            # timesteps_per_iteration are satisfied. Every rank of a
            # data-parallel learner samples the same number of steps, and
            # rank 0's clock decides for all, so every rank runs the same
            # updates (each one a collective).
            start = time.monotonic()
            steps0 = self.optimizer.num_steps_sampled
            min_time = self.config.get("min_iter_time_s") or 0
            min_steps = self.config.get("timesteps_per_iteration") or 0
            world = 1 if self.group is None else self.group.world_size
            while True:
                fetches = self.optimizer.step()
                if after_optimizer_step:
                    after_optimizer_step(self, fetches)
                done = (time.monotonic() - start >= min_time
                        and (self.optimizer.num_steps_sampled - steps0)
                        * world >= min_steps)
                if self.group is not None:
                    done = self.group.broadcast_object(done)
                if done:
                    break
            result = self._result_from_optimizer(self.optimizer)
            if after_train_result:
                after_train_result(self, result)
            return result

    _Trainer.__name__ = name
    _Trainer.__qualname__ = name
    return _Trainer
