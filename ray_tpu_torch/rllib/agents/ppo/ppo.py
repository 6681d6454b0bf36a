"""Proximal Policy Optimization.

Counterpart of `ray_tpu/rllib/agents/ppo/ppo.py` (parity:
`rllib/agents/ppo/ppo.py` + `ppo_policy.py`): clipped surrogate +
clipped value loss + entropy bonus + adaptive KL penalty (`update_kl`),
GAE postprocessing on the rollout worker, minibatch SGD.

The minibatch-SGD phase is `MultiDeviceOptimizer` ->
`TorchPolicy.sgd_learn`: all `num_sgd_iter` x minibatch updates
enqueued on the card with one read at the end. Rollouts sample through
kernel K2 (Discrete actions) or K7 (Box actions, DiagGaussian).
Local mode on one learner device; a data-parallel PPO learner waits
for ROADMAP A8 (it needs the advantages standardized over the world).
"""

from __future__ import annotations

import torch

from ... import sample_batch as sb
from ...optimizers.sync_samples_optimizer import MultiDeviceOptimizer
from ...policy.torch_policy_template import build_torch_policy
from ..trainer import with_common_config
from ..trainer_template import build_trainer

DEFAULT_CONFIG = with_common_config({
    "lr": 5e-5,
    "gamma": 0.99,
    "use_gae": True,
    "lambda": 1.0,
    "kl_coeff": 0.2,
    "kl_target": 0.01,
    "rollout_fragment_length": 200,
    "train_batch_size": 4000,
    "sgd_minibatch_size": 128,
    "num_sgd_iter": 30,
    "clip_param": 0.3,
    "vf_clip_param": 10.0,
    "vf_loss_coeff": 1.0,
    "entropy_coeff": 0.0,
    "grad_clip": None,
    "loss_state": {"kl_coeff": 0.2},
})


def ppo_loss(policy, model, batch):
    cfg = policy.config
    dist_inputs, value = model(batch[sb.OBS])
    dist = policy.dist_class(dist_inputs)
    old_dist = policy.dist_class(batch[sb.ACTION_DIST_INPUTS])

    logp = dist.logp(batch[sb.ACTIONS])
    ratio = torch.exp(logp - batch[sb.ACTION_LOGP])
    adv = batch[sb.ADVANTAGES]
    clip_param = cfg["clip_param"]
    surrogate = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * adv)

    kl = old_dist.kl(dist)
    entropy = dist.entropy()

    # Clipped value loss: the value's change is clipped, not the value.
    v_target = batch[sb.VALUE_TARGETS]
    v_old = batch[sb.VF_PREDS]
    vf_err1 = (value - v_target) ** 2
    v_clipped = v_old + torch.clamp(value - v_old, -cfg["vf_clip_param"],
                                    cfg["vf_clip_param"])
    vf_err2 = (v_clipped - v_target) ** 2
    vf_loss = torch.maximum(vf_err1, vf_err2)

    kl_coeff = policy.loss_state.get("kl_coeff", 0.0)
    total = torch.mean(
        -surrogate
        + kl_coeff * kl
        + cfg["vf_loss_coeff"] * vf_loss
        - cfg["entropy_coeff"] * entropy)
    stats = {
        "total_loss": total,
        "policy_loss": -torch.mean(surrogate),
        "vf_loss": torch.mean(vf_loss),
        "kl": torch.mean(kl),
        "entropy": torch.mean(entropy),
        "vf_explained_var": explained_variance(v_target, value),
    }
    return total, stats


def explained_variance(y, pred):
    """1 - Var[y - pred] / Var[y], floored at -1, with population
    variances (jnp.var's; torch.var's default is unbiased)."""
    y_var = torch.var(y, correction=0)
    diff_var = torch.var(y - pred, correction=0)
    return torch.clamp_min(1.0 - diff_var / (y_var + 1e-8), -1.0)


# The loss is a mean over rows: a data-parallel exchange would divide
# the summed gradient by the world size.
PPOTorchPolicy = build_torch_policy(
    "PPOTorchPolicy", ppo_loss, loss_reduction="mean",
    get_default_config=lambda: DEFAULT_CONFIG, module=__name__)


def make_ppo_optimizer(workers, config):
    return MultiDeviceOptimizer(
        workers,
        train_batch_size=config["train_batch_size"],
        num_sgd_iter=config["num_sgd_iter"],
        sgd_minibatch_size=config["sgd_minibatch_size"])


def update_kl(trainer, fetches):
    """Adaptive KL coefficient (reference: `ppo.py` update_kl /
    `ppo_policy.py` KLCoeffMixin): x1.5 above twice the target, x0.5
    below half of it. Reads the step's stats (already host floats) and
    the coefficient's host value: no device read."""
    policy = trainer.get_policy()
    if "kl" not in fetches or not policy.loss_state:
        return
    kl = fetches["kl"]
    target = policy.config.get("kl_target", trainer.config["kl_target"])
    coeff = policy.loss_state_host["kl_coeff"]
    if kl > 2.0 * target:
        coeff *= 1.5
    elif kl < 0.5 * target:
        coeff *= 0.5
    policy.update_loss_state(kl_coeff=coeff)


def validate_config(config):
    if config["sgd_minibatch_size"] > config["train_batch_size"]:
        raise ValueError("sgd_minibatch_size must be <= train_batch_size")
    if config["entropy_coeff"] < 0:
        raise ValueError("entropy_coeff must be >= 0")
    world = config.get("num_gpus_for_learner") or 0
    if world > 1:
        raise NotImplementedError(
            f"num_gpus_for_learner={world} with PPO: the data-parallel "
            "PPO learner (advantages standardized over the world) is not "
            "ported yet (ROADMAP Queue A item A8); one learner device is")


PPOTrainer = build_trainer(
    name="PPO",
    default_policy=PPOTorchPolicy,
    default_config=DEFAULT_CONFIG,
    make_policy_optimizer=make_ppo_optimizer,
    validate_config=validate_config,
    after_optimizer_step=update_kl)
