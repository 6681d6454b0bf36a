"""RolloutWorker: the sampling unit.

Counterpart of `ray_tpu/rllib/evaluation/rollout_worker.py` (parity:
`rllib/evaluation/rollout_worker.py:55`), single-agent: builds env +
policy + sampler; `sample`, `get/set_weights`, `get/sync_filters`,
`apply`, `ping`; `explore=False` makes a non-exploring (evaluation)
worker. Built in the trainer's process as the local worker and, through
`ray_tpu_torch.remote(RolloutWorker)`, as a remote worker
(`WorkerSet`), whose `set_weights` receives the weight plane's
versioned payloads. A worker builds its policy on the config's
``"device"`` like any other entry point: in local mode the remote
workers share the learner's process and card; on the multi-process
runtime each is a process of its own with its own CUDA context, which
loads the kernels its driver built. `sample` returns numpy columns
only, so no torch tensor enters the object store. Offline I/O, remote
envs, observation compression and policy maps wait for later slices.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

from ..._private import metrics
from ..._private.weight_sync import WeightSyncDecoder, WeightSyncPayload
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
        # Receiver side of the weight-sync delta plane (built on the
        # first versioned payload).
        self._weight_decoder = None
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
        """Apply a weight sync: either a raw weights dict or a versioned
        `WeightSyncPayload` from the delta plane. Returns a status dict
        the sender's handshake reads: a "stale" status (a delta against
        a base this worker does not hold) leaves the weights untouched
        and makes the sender fall back to a full payload."""
        if isinstance(weights, WeightSyncPayload):
            if self._weight_decoder is None:
                self._weight_decoder = WeightSyncDecoder()
            t0 = time.perf_counter()
            decoded, status = self._weight_decoder.apply(weights)
            apply_ms = 1e3 * (time.perf_counter() - t0)
            metrics.set_gauge("weight_apply_ms", apply_ms)
            # Sum and count: a worker process's mean decode time.
            metrics.inc("weight_apply_ms_sum", apply_ms)
            metrics.inc("weight_sync_applied")
            if status == "stale":
                metrics.inc("weight_sync_stale_received")
            if decoded is None:
                return {"status": status,
                        "version": self._weight_decoder.version}
            weights = decoded
        elif self._weight_decoder is not None:
            # A raw-dict sync outside the versioned stream invalidates
            # the delta base.
            self._weight_decoder.reset()
        self.policy.set_weights(weights)
        return {"status": "ok", "version": self.weight_sync_version()}

    def weight_sync_version(self) -> int:
        """The sync version this worker's decoder holds (0: no base)."""
        return (self._weight_decoder.version
                if self._weight_decoder is not None else 0)

    def get_policy(self, policy_id: str = "default_policy"):
        return self.policy

    def apply(self, fn, *args):
        """`fn(self, *args)` in the worker's process (parity:
        `RolloutWorker.apply`); on the multi-process runtime `fn` must be
        importable (a module-level function)."""
        return fn(self, *args)

    # -- filters (parity: FilterManager.synchronize) ---------------------
    def get_filters(self, flush_after: bool = False):
        f = self.obs_filter.as_serializable()
        if flush_after:
            self.obs_filter.clear_buffer()
        return f

    def sync_filters(self, new_filter):
        self.obs_filter.sync(new_filter)

    # -- metrics / introspection -----------------------------------------
    def get_metrics(self) -> List:
        return self.sampler.get_metrics()

    def ping(self):
        return "ok"

    def stop(self):
        self.env.close()
