"""WorkerSet: one local RolloutWorker + N remote RolloutWorker actors.

Counterpart of `ray_tpu/rllib/evaluation/worker_set.py` (parity:
`rllib/evaluation/worker_set.py`). The local worker holds the learner's
policy, on the trainer's device. On a rank of a data-parallel learner
(`config["_learner_group"]`) it holds that rank's slice of
`num_envs_per_worker`, by global env index. Remote workers are actors
of `ray_tpu_torch.remote(RolloutWorker)` on the runtime that
`ray_tpu_torch.init(local_mode=True)` started: they run in this
process and build their policies on the config's ``"device"`` (the
reference pins them to the CPU through `env_vars`, which its local mode
ignores too). `sync_weights` broadcasts through the weight plane
(`utils/weight_broadcast.py`), `sync_filters` merges observation
filters. Remote workers beside a data-parallel learner wait for ROADMAP
Queue A item 8.
"""

from __future__ import annotations

from typing import Callable, List

import ray_tpu_torch

from ..._private import worker_state
from .rollout_worker import RolloutWorker


class WorkerSet:
    def __init__(self,
                 env_creator: Callable,
                 policy_cls,
                 config: dict,
                 num_workers: int = 0):
        self._env_creator = env_creator
        self._policy_cls = policy_cls
        self._config = config
        num_envs = config.get("num_envs_per_worker", 1)
        group = config.get("_learner_group")
        if num_workers and group is not None:
            raise NotImplementedError(
                f"num_workers={num_workers} with a data-parallel learner "
                f"(num_gpus_for_learner={group.world_size}): remote "
                "workers feeding a world are not ported yet (ROADMAP "
                "Queue A item 8)")
        if num_workers:
            # Fail before any env or policy is built.
            worker_state.get_runtime()
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
        self._broadcaster = None  # weight-sync delta plane (lazy)
        if num_workers > 0:
            remote_cls = ray_tpu_torch.remote(RolloutWorker)
            for i in range(num_workers):
                self.remote_workers.append(
                    self._make_remote_worker(remote_cls, i + 1))
            # Block until all workers are constructed.
            ray_tpu_torch.get([w.ping.remote() for w in self.remote_workers])

    def _make_remote_worker(self, remote_cls, index: int):
        cfg = self._config
        return remote_cls.options(
            num_cpus=cfg.get("num_cpus_per_worker", 1)).remote(
                self._env_creator, self._policy_cls, dict(cfg),
                num_envs=cfg.get("num_envs_per_worker", 1),
                rollout_fragment_length=cfg.get(
                    "rollout_fragment_length", 100),
                worker_index=index,
                seed=cfg.get("seed"),
                observation_filter=cfg.get("observation_filter", "NoFilter"),
                env_config=cfg.get("env_config"),
                pack_fragments=cfg.get("pack_fragments", False))

    # ------------------------------------------------------------------
    def sync_weights(self):
        """Broadcast the local policy's weights to all remote workers
        through the weight-sync delta plane (one encode + put per call;
        each worker gets the q8 delta against the version it holds, or
        the full blob when its base is stale or missing)."""
        if not self.remote_workers:
            return
        if self._broadcaster is None:
            from ..utils.weight_broadcast import WeightBroadcaster
            self._broadcaster = WeightBroadcaster(
                self.local_worker.get_weights,
                codec=self._config.get("weight_sync_codec", "auto"))
        self._broadcaster.sync_all_blocking(self.remote_workers)

    def sync_filters(self):
        """Merge remote MeanStdFilter deltas into the local filter and
        push the result back (parity: `FilterManager.synchronize`,
        `rllib/utils/filter_manager.py:14`)."""
        from ..utils.filter import FilterManager, NoFilter
        if not self.remote_workers or isinstance(
                self.local_worker.obs_filter, NoFilter):
            return
        FilterManager.synchronize(
            self.local_worker.obs_filter, self.remote_workers,
            get_ref=lambda w: w.get_filters.remote(flush_after=True),
            sync_call=lambda w, f: w.sync_filters.remote(f))

    def stop(self):
        for w in self.remote_workers:
            try:
                w.stop.remote()  # closes its envs
                ray_tpu_torch.kill(w)
            except (ray_tpu_torch.ActorDiedError, RuntimeError):
                pass  # already dead, or the runtime was shut down first
        self.local_worker.stop()
