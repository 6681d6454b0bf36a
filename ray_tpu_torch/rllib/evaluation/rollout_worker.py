"""RolloutWorker: the sampling unit.

Counterpart of `ray_tpu/rllib/evaluation/rollout_worker.py` (parity:
`rllib/evaluation/rollout_worker.py:55`), local and single-agent: builds
env + policy + sampler; `sample`, `get/set_weights`, `get/sync_filters`;
`explore=False` makes a non-exploring (evaluation) worker.
Offline I/O, remote envs, observation compression, policy maps and the
versioned weight-sync receiver wait for later slices.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from .. import sample_batch as sb
from ..env.vector_env import VectorEnv
from ..sample_batch import SampleBatch
from ..utils.filter import get_filter
from .postprocessing import compute_advantages
from .sampler import SyncSampler


class RolloutWorker:
    def __init__(self,
                 env_creator: Callable,
                 policy_cls,
                 policy_config: dict,
                 num_envs: int = 1,
                 rollout_fragment_length: int = 100,
                 worker_index: int = 0,
                 seed: Optional[int] = None,
                 observation_filter: str = "NoFilter",
                 env_config: Optional[dict] = None,
                 pack_fragments: bool = False,
                 first_env_index: int = 0,
                 explore: bool = True):
        self.worker_index = worker_index
        env_config = dict(env_config or {})
        env_config["worker_index"] = worker_index
        # `first_env_index`: this rank's slice of a data-parallel
        # learner's envs starts there (seeds follow global indices).
        self.env = VectorEnv(lambda: env_creator(env_config), num_envs,
                             first_index=first_env_index)
        if seed is not None:
            self.env.seed(seed + worker_index * 1000)
            np.random.seed(seed + worker_index * 1000)
        cfg = dict(policy_config)
        if seed is not None:
            # Parameter init and the rollout generator; the policy adds
            # a data-parallel rank to the generator's seed only.
            cfg["seed"] = seed + worker_index
        self.policy = policy_cls(
            self.env.observation_space, self.env.action_space, cfg)
        # Filter shapes follow the preprocessed obs (Discrete -> one-hot).
        self.preprocessor = getattr(self.policy, "preprocessor", None)
        self.obs_filter = get_filter(
            observation_filter,
            self.preprocessor.shape if self.preprocessor is not None
            else self.env.observation_space.shape)

        gamma = cfg.get("gamma", 0.99)
        lambda_ = cfg.get("lambda", 1.0)
        use_gae = cfg.get("use_gae", True)
        use_critic = cfg.get("use_critic", True)

        def postprocess(chunk: SampleBatch, bootstrap_obs):
            if bootstrap_obs is None or not use_gae:
                last_r = 0.0
            else:
                last_r = float(self.policy.value_function(
                    bootstrap_obs[None])[0])
            if sb.VF_PREDS in chunk or use_gae:
                chunk = compute_advantages(
                    chunk, last_r, gamma=gamma, lambda_=lambda_,
                    use_gae=use_gae and sb.VF_PREDS in chunk,
                    use_critic=use_critic)
            return self.policy.postprocess_trajectory(chunk)

        self.sampler = SyncSampler(
            self.env, self.policy, rollout_fragment_length,
            # Packed fragments (IMPALA/V-trace) compute targets on the
            # learner; GAE postprocessing only applies to episode chunks.
            postprocess_fn=None if pack_fragments else postprocess,
            obs_filter=self.obs_filter if observation_filter != "NoFilter"
            else None,
            preprocessor=self.preprocessor,
            pack_fragments=pack_fragments,
            explore=explore)

    # -- sampling --------------------------------------------------------
    def sample(self) -> SampleBatch:
        return self.sampler.sample()

    # -- weights ---------------------------------------------------------
    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights):
        self.policy.set_weights(weights)

    def get_policy(self, policy_id: str = "default_policy"):
        return self.policy

    # -- filters (parity: FilterManager.synchronize) ---------------------
    def get_filters(self):
        return self.obs_filter.as_serializable()

    def sync_filters(self, new_filter):
        self.obs_filter.sync(new_filter)

    # -- metrics / introspection -----------------------------------------
    def get_metrics(self) -> List:
        return self.sampler.get_metrics()

    def stop(self):
        self.env.close()
