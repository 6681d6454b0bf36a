"""WorkerSet: the local RolloutWorker.

Counterpart of `ray_tpu/rllib/evaluation/worker_set.py` (parity:
`rllib/evaluation/worker_set.py`) with the local worker only: its
policy is the learner's, on the trainer's device. On a rank of a
data-parallel learner (`config["_learner_group"]`) the local worker
holds that rank's slice of `num_envs_per_worker`, by global env index.
Remote rollout-worker actors wait for the runtime port.
"""

from __future__ import annotations

from typing import Callable, List

from .rollout_worker import RolloutWorker


class WorkerSet:
    def __init__(self,
                 env_creator: Callable,
                 policy_cls,
                 config: dict,
                 num_workers: int = 0):
        if num_workers:
            raise NotImplementedError(
                "remote rollout workers (num_workers > 0) are not ported "
                "yet; use num_workers=0")
        num_envs = config.get("num_envs_per_worker", 1)
        group = config.get("_learner_group")
        rank, world = (0, 1) if group is None else (group.rank,
                                                    group.world_size)
        if num_envs % world:
            raise ValueError(
                f"num_envs_per_worker={num_envs} does not split over the "
                f"{world} ranks of the data-parallel learner")
        self.local_worker = RolloutWorker(
            env_creator, policy_cls, dict(config),
            num_envs=num_envs // world,
            first_env_index=rank * (num_envs // world),
            rollout_fragment_length=config.get("rollout_fragment_length", 100),
            worker_index=0,
            seed=config.get("seed"),
            observation_filter=config.get("observation_filter", "NoFilter"),
            env_config=config.get("env_config"),
            pack_fragments=config.get("pack_fragments", False))
        self.remote_workers: List = []

    def stop(self):
        self.local_worker.stop()
