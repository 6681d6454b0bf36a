"""Trainer: the user-facing algorithm runner.

Counterpart of `ray_tpu/rllib/agents/trainer.py` (parity:
`rllib/agents/trainer.py:335`): extends the Tune `Trainable`, builds a
WorkerSet in `_setup`, runs the policy optimizer per `train()`, runs
evaluation episodes every `evaluation_interval` iterations
(`_maybe_evaluate`) and exposes `compute_action`/`get_policy`/`workers`.

The JAX trainer built a learner mesh from `jax.devices()`
(`Trainer._make_mesh`); this one resolves the config's ``"device"``
instead ("cuda" by default, "cpu" on request, no fallback), and with
`num_gpus_for_learner` = D >= 2 it is one rank of a data-parallel
learner: every rank of a `torch.distributed` world of D ranks
(`parallel/distributed.py`) builds the same trainer with the same
global config, samples its share of the envs, learns on its share of
each train batch and exchanges gradients (`_make_learner_group`). With
`device_frame_stack` the probe env advertises the stacked observation
space, and episodes of inline (Sebulba) actors join the result. The
evaluation worker is one local `RolloutWorker` that acts with
`explore=False`, synced to the learner's weights and filters before
each evaluation. Remote workers run on either runtime
(`ray_tpu_torch.init()`, each worker a process of its own, or
`init(local_mode=True)`); worker-failure recovery, checkpoints and the
cluster-metrics push are not ported.
"""

from __future__ import annotations

from typing import Optional

from ...device import resolve_device
from ...parallel.mesh import LearnerGroup
from ...tune.trainable import Trainable
from ..env.registry import EnvCreator
from ..evaluation.metrics import (collect_episodes, summarize_episodes,
                                  world_totals)
from ..evaluation.rollout_worker import RolloutWorker
from ..evaluation.worker_set import WorkerSet
from ..utils.config import deep_merge

COMMON_CONFIG = {
    # === Rollouts ===
    "num_workers": 0,
    "num_envs_per_worker": 1,
    "rollout_fragment_length": 200,
    "observation_filter": "NoFilter",
    # === Training ===
    "gamma": 0.99,
    "lr": 5e-5,
    "train_batch_size": 200,
    "model": {},
    "grad_clip": None,
    "seed": None,
    # Policy-level compute dtype: "auto" defers to RAY_TPU_COMPUTE_DTYPE
    # ("f32"); bf16 casting of the whole parameter tree is not ported.
    "compute_dtype": "auto",
    # Weight broadcast codec to remote workers (_private/weight_sync.py):
    # "full" ships the whole float32 tree every sync; "q8_delta" ships
    # int8 block-quantized deltas with sender-side error feedback and a
    # version handshake that full-syncs stale receivers. "auto" is
    # "full": local mode passes payloads by reference, so a delta saves
    # no bytes.
    "weight_sync_codec": "auto",
    # === Device ===
    # "cuda" (default) or "cpu"; "cuda" without a card raises.
    "device": "cuda",
    # === Data-parallel learner ===
    # 0 or 1: one learner device. D >= 2: this process is one rank of an
    # initialized torch.distributed world of exactly D ranks (start one
    # with `parallel.distributed.launch`), each with a full replica of
    # the parameters and 1/D of the envs and of every train batch.
    "num_gpus_for_learner": 0,
    # The gradient exchange: "fp32" (all-reduce), "q8" (block-quantized
    # all-reduce with error feedback), or "auto" (RAY_TPU_ALLREDUCE_CODEC,
    # default fp32).
    "allreduce_codec": "auto",
    # The world's backend: "nccl" (one rank per card) or "gloo" (CPU
    # worlds, and ranks sharing one card). Must be the world's own.
    "collective_backend": "nccl",
    # === Evaluation (parity: trainer.py:96-100 in the JAX package) ===
    # Every this many iterations, run `evaluation_num_episodes` episodes
    # with `explore=False` on a separate evaluation worker (None: never).
    "evaluation_interval": None,
    "evaluation_num_episodes": 10,
    # Config overrides applied to the evaluation worker's policy/env.
    "evaluation_config": {},
    # === Environment ===
    "env": None,
    "env_config": {},
    # === Reporting ===
    "min_iter_time_s": 0,
    "timesteps_per_iteration": 0,
}


def with_common_config(extra: dict) -> dict:
    cfg = deep_merge({}, COMMON_CONFIG)
    return deep_merge(cfg, extra)


class Trainer(Trainable):
    _default_config = COMMON_CONFIG

    def __init__(self, config: Optional[dict] = None,
                 env: Optional[str] = None):
        config = dict(config or {})
        if env is not None:
            config["env"] = env
        super().__init__(config)

    # ------------------------------------------------------------------
    def _setup(self, config: dict):
        merged = deep_merge(deep_merge({}, self._default_config), config)
        self.config = merged
        env_name = merged.get("env")
        if callable(env_name):
            self.env_creator = env_name
        elif env_name is not None:
            # Picklable: remote rollout workers get it by reference.
            self.env_creator = EnvCreator(env_name)
        else:
            raise ValueError("config['env'] is required")
        k = merged.get("device_frame_stack") or 0
        if k:
            # On-device frame stacking (device_frame_stack.py): the env
            # emits single frames, the device sampler stacks them on the
            # card. The probe env must advertise the STACKED space so the
            # policy builds the right network.
            from ..env.device_frame_stack import stacked_space
            inner_creator = self.env_creator

            def stacked_creator(cfg, _mk=inner_creator, _k=k):
                env = _mk(cfg)
                env.observation_space = stacked_space(
                    env.observation_space, _k)
                return env

            self.env_creator = stacked_creator
        # Fail before any env or policy is built: a CUDA device that is
        # not there is an error, never a silent CPU run.
        self.group = self._make_learner_group(merged)
        merged["_learner_group"] = self.group
        self.device = self.group.device if self.group is not None \
            else resolve_device(merged.get("device"))
        self._init(merged)

    @staticmethod
    def _make_learner_group(config) -> Optional[LearnerGroup]:
        """The counterpart of `_make_mesh`: None for one learner device,
        else this rank's `LearnerGroup` of the initialized world, which
        must have exactly `num_gpus_for_learner` ranks and the
        configured backend (a short world is an error, as a short mesh
        is in JAX)."""
        if (config.get("num_tpus_for_learner") or 0) > 1:
            raise ValueError(
                "num_tpus_for_learner is the JAX package's mesh size; the "
                "port's data-parallel learner is num_gpus_for_learner (one "
                "rank of a torch.distributed world per device)")
        world = config.get("num_gpus_for_learner") or 0
        if world <= 1:
            return None
        return LearnerGroup.from_world(
            world, config.get("collective_backend"), config.get("device"))

    def _init(self, config):
        """Subclasses/templates build workers + optimizer here."""
        raise NotImplementedError

    def _train(self) -> dict:
        """One iteration, then evaluation when it is due (parity:
        `trainer.py:195`)."""
        result = self._train_inner()
        self._maybe_evaluate(result)
        return result

    def _train_inner(self) -> dict:
        """Subclasses/templates run one training iteration here."""
        raise NotImplementedError

    def _make_workers(self, policy_cls) -> WorkerSet:
        return WorkerSet(
            self.env_creator, policy_cls, self.config,
            num_workers=self.config["num_workers"])

    # ------------------------------------------------------------------
    def _result_from_optimizer(self, optimizer) -> dict:
        episodes = collect_episodes(self.workers)
        inline = getattr(optimizer, "inline_episodes", None)
        if inline is not None:
            episodes.extend(inline())
        sampled, trained = (optimizer.num_steps_sampled,
                            optimizer.num_steps_trained)
        if self.group is not None:
            # The whole world's steps and episodes, one collective.
            episodes, sampled, trained = world_totals(
                self.group, episodes, sampled, trained)
        self._episode_history = getattr(self, "_episode_history", [])
        result = summarize_episodes(
            episodes, smoothed=self._episode_history)
        self._episode_history = (self._episode_history + episodes)[-100:]
        result.update(optimizer.stats())
        result["num_steps_sampled"] = sampled
        result["num_steps_trained"] = trained
        result["timesteps_this_iter"] = (
            sampled - getattr(self, "_last_steps_sampled", 0))
        self._last_steps_sampled = sampled
        result["info"] = {"learner": getattr(optimizer, "learner_stats", {})}
        return result

    # ------------------------------------------------------------------
    def _maybe_evaluate(self, result: dict) -> None:
        interval = self.config.get("evaluation_interval")
        if not interval:
            return
        self._iters_since_eval = getattr(self, "_iters_since_eval", 0) + 1
        if self._iters_since_eval < interval:
            return
        self._iters_since_eval = 0
        result["evaluation"] = self._evaluate()

    def _evaluate(self) -> dict:
        """Run `evaluation_num_episodes` episodes, not exploring, on a
        dedicated evaluation worker (parity: `trainer.py:285-330` in the
        JAX package): built once, with `evaluation_config` applied, on
        this trainer's device and outside any data-parallel world; synced
        to the learner's weights and observation filter first."""
        if getattr(self, "_eval_worker", None) is None:
            cfg = deep_merge(deep_merge({}, self.config),
                             self.config.get("evaluation_config") or {})
            cfg.pop("_learner_group", None)
            cfg.update(num_gpus_for_learner=0, device=str(self.device))
            self._eval_worker = RolloutWorker(
                self.env_creator, type(self.get_policy()), cfg,
                num_envs=cfg.get("num_envs_per_worker", 1),
                rollout_fragment_length=cfg.get(
                    "rollout_fragment_length", 100),
                worker_index=0,
                seed=cfg.get("seed"),
                observation_filter=cfg.get(
                    "observation_filter", "NoFilter"),
                explore=False,
                env_config=cfg.get("env_config"))
        local = self.workers.local_worker
        self._eval_worker.set_weights(local.get_weights())
        self._eval_worker.sync_filters(local.get_filters())
        n = self.config.get("evaluation_num_episodes", 10)
        self._eval_worker.get_metrics()  # drain stale episodes
        episodes = []
        while len(episodes) < n:
            self._eval_worker.sample()
            episodes.extend(self._eval_worker.get_metrics())
        return summarize_episodes(episodes)

    # ------------------------------------------------------------------
    def get_policy(self):
        return self.workers.local_worker.policy

    def compute_action(self, obs, state=None, explore=False):
        action, _, _ = self.get_policy().compute_single_action(
            obs, state, explore=explore)
        return action

    def _stop(self):
        if hasattr(self, "workers"):
            self.workers.stop()
        if getattr(self, "_eval_worker", None) is not None:
            self._eval_worker.stop()
        opt = getattr(self, "optimizer", None)
        if opt is not None:
            opt.stop()
