"""IMPALA: Importance-Weighted Actor-Learner Architecture.

Counterpart of `ray_tpu/rllib/agents/impala/impala.py` (parity:
`rllib/agents/impala/impala.py:109`): V-trace policy +
`AsyncSamplesOptimizer`, in local mode (`num_workers=0`: the local
worker samples through the learner's policy on the device), with remote
rollout workers (`num_workers >= 1`, under
`ray_tpu_torch.init(local_mode=True)`: each worker's own policy on the
trainer's device, fed versioned weight syncs, `weight_sync_codec`) or
on the Sebulba inline-actor path (`num_inline_actors >= 1`: actor
threads step batched host envs with device-resident observations); a
LearnerThread runs the updates in all three. In Anakin mode (`anakin:
True`) the `AnakinOptimizer` steps device-resident envs, infers and
updates on the card.
With `num_gpus_for_learner` = D >= 2 each rank of a `torch.distributed`
world runs local mode on 1/D of the envs and of each train batch and
exchanges gradients (fp32 or q8); the data-parallel Anakin and Sebulba
paths are not ported yet. With `sgd_minibatch_size` set, the learner
runs `num_sgd_iter` epochs of whole-fragment minibatches through
`TorchPolicy.sgd_learn` (`async_samples_optimizer.py:93-97` in the JAX
package); without it, each train batch is one `learn_on_batch`.
"""

from __future__ import annotations

import logging

from ...optimizers.async_samples_optimizer import AsyncSamplesOptimizer
from ..trainer_template import build_trainer
from .vtrace_policy import DEFAULT_CONFIG, VTraceTorchPolicy

logger = logging.getLogger(__name__)

def make_async_optimizer(workers, config):
    if config.get("anakin"):
        from ...env.device_env import make_device_env
        from ...optimizers.anakin_optimizer import AnakinOptimizer
        return AnakinOptimizer(
            workers,
            device_env=make_device_env(config["env"],
                                       config.get("env_config")),
            num_envs=config["_anakin_num_envs"],
            rollout_fragment_length=config["rollout_fragment_length"],
            updates_per_call=config.get("anakin_updates_per_call", 10),
            seed=config.get("seed") or 0)
    return AsyncSamplesOptimizer(
        workers,
        # A data-parallel rank learns on its share of the global batch.
        train_batch_size=config["train_batch_size"] // _world(config),
        rollout_fragment_length=config["rollout_fragment_length"],
        max_sample_requests_in_flight_per_worker=config[
            "max_sample_requests_in_flight_per_worker"],
        broadcast_interval=config["broadcast_interval"],
        learner_queue_size=config["learner_queue_size"],
        num_sgd_iter=config["num_sgd_iter"],
        sgd_minibatch_size=config.get("sgd_minibatch_size", 0),
        # Minibatches shuffle and slice whole fragments, so V-trace's
        # [B, T] reshape stays valid.
        sgd_sequence_length=config["rollout_fragment_length"],
        # Sebulba inline actors: batched device inference on the learner
        # process (see `InlineActorThread`).
        num_inline_actors=config.get("num_inline_actors", 0),
        inline_env=config.get("env"),
        inline_num_envs=config.get("_inline_num_envs", 1),
        inline_env_config=config.get("env_config"),
        inline_seed=config.get("seed"),
        device_rollouts=config.get("device_rollouts", "auto"),
        device_frame_stack=config.get("device_frame_stack", 0),
        obs_delta=config.get("obs_delta", "auto"),
        obs_delta_budget=config.get("obs_delta_budget", 256),
        # Sebulba pipeline gears (see evaluation/device_sampler.py):
        # double-buffered env groups + k-step on-device selection.
        sebulba_env_groups=config.get("sebulba_env_groups", 2),
        sebulba_onchip_steps=config.get("sebulba_onchip_steps", 1),
        weight_sync_codec=config.get("weight_sync_codec", "auto"))


def _train_on_whole_fragments(config, slots_key: str, message: str):
    """Move num_envs_per_worker to the optimizer's env slots (`slots_key`)
    and set train_batch_size to one fragment per slot, so downstream
    consumers (and users reading results) see the effective value instead
    of a silently-ignored one."""
    config[slots_key] = config.get("num_envs_per_worker", 1)
    config["num_envs_per_worker"] = 1
    effective = config[slots_key] * config["rollout_fragment_length"]
    if config.get("train_batch_size") not in (None, effective):
        logger.info(message, effective, config.get("train_batch_size"))
    config["train_batch_size"] = effective


def _world(config) -> int:
    return max(1, config.get("num_gpus_for_learner") or 0)


def _validate_world(config):
    """A data-parallel learner of D >= 2 ranks: local mode only, with
    whole fragments on every rank (the envs split in `WorkerSet`)."""
    world = _world(config)
    if world < 2:
        return
    for key, what in (("anakin", "the Anakin path's exchange over NCCL"),
                      ("num_inline_actors", "Sebulba inline actors"),
                      ("sgd_minibatch_size", "minibatch SGD over the "
                                             "world's batch")):
        if config.get(key):
            raise NotImplementedError(
                f"num_gpus_for_learner={world} with {key}: the "
                f"data-parallel learner for {what} is not ported yet "
                "(ROADMAP Queue A item 8); local mode is")
    T = config["rollout_fragment_length"]
    if config["train_batch_size"] % (world * T):
        raise ValueError(
            f"train_batch_size={config['train_batch_size']} must split "
            f"into whole {T}-step fragments on each of the {world} ranks")


def validate_config(config):
    """The reference's checks and errors (`impala.py:61-125`) first, then
    NotImplementedError for what the port does not run yet."""
    _validate_world(config)
    if config.get("device_frame_stack") and \
            not config.get("num_inline_actors"):
        raise ValueError(
            "device_frame_stack only applies to the inline-actor "
            "(Sebulba) path; set num_inline_actors >= 1")
    if config.get("num_inline_actors"):
        if config.get("num_workers"):
            raise ValueError(
                "num_inline_actors and num_workers are alternative "
                "sampling architectures; set num_workers=0 for the "
                "inline (Sebulba) path or num_inline_actors=0 for "
                "remote rollout workers")
        if config.get("anakin"):
            raise ValueError(
                "num_inline_actors is ignored in anakin mode — the "
                "fused program does its own device-resident rollouts")
        onchip = config.get("sebulba_onchip_steps", 1)
        if onchip < 1:
            raise ValueError("sebulba_onchip_steps must be >= 1")
        if config["rollout_fragment_length"] % onchip:
            raise ValueError(
                "rollout_fragment_length must be a multiple of "
                "sebulba_onchip_steps (fragments tile whole k-step "
                "selection windows)")
        if config.get("sebulba_env_groups", 1) < 1:
            raise ValueError("sebulba_env_groups must be >= 1")
        # Inline actors own the real env batch; the local RolloutWorker
        # keeps a single probe env (spaces only). One actor fragment IS
        # the train batch in this mode.
        _train_on_whole_fragments(
            config, "_inline_num_envs",
            "inline-actor mode trains on whole %d-step fragments "
            "(num_envs_per_worker * rollout_fragment_length); "
            "overriding train_batch_size=%s")
    if config.get("anakin"):
        if config.get("num_workers"):
            raise ValueError(
                "anakin mode is fully device-resident; num_workers must "
                "be 0 (env slots come from num_envs_per_worker)")
        if (config.get("model") or {}).get("use_lstm"):
            raise ValueError(
                "anakin mode currently supports feedforward policies "
                "only; use the inline-actor (Sebulba) path for LSTM")
        # The device-resident env slots are the optimizer's; the local
        # RolloutWorker keeps a single probe env (spaces only). Each
        # update trains on one num_envs x T fragment batch.
        _train_on_whole_fragments(
            config, "_anakin_num_envs",
            "anakin mode trains on whole %d-step fragment batches; "
            "overriding train_batch_size=%s")
    if (config.get("model") or {}).get("use_lstm"):
        raise NotImplementedError(
            "use_lstm: recurrent IMPALA is not ported yet")
    if config["train_batch_size"] % config["rollout_fragment_length"] != 0:
        raise ValueError(
            "train_batch_size must be a multiple of "
            "rollout_fragment_length (V-trace sequences reshape to "
            "[B, T] with no padding)")
    mb = config.get("sgd_minibatch_size", 0)
    if mb and mb % config["rollout_fragment_length"] != 0:
        raise ValueError(
            "sgd_minibatch_size must be a multiple of "
            "rollout_fragment_length")
    if not config.get("pack_fragments", True):
        raise ValueError("IMPALA requires pack_fragments=True")


IMPALATrainer = build_trainer(
    name="IMPALA",
    default_policy=VTraceTorchPolicy,
    default_config=DEFAULT_CONFIG,
    make_policy_optimizer=make_async_optimizer,
    validate_config=validate_config)
