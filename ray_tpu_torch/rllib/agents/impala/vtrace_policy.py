"""V-trace actor-critic policy (IMPALA's learner loss).

Counterpart of `ray_tpu/rllib/agents/impala/vtrace_policy.py` (parity:
`rllib/agents/impala/vtrace_policy.py`, VTraceTFPolicy): policy gradient
with V-trace-corrected advantages + value loss + entropy bonus, with the
same stats keys.

Layout: the learner receives packed fragments — a flat [B*T] batch
where each consecutive run of T rows is one contiguous env fragment. The
loss reshapes to [B, T] and transposes to time-major [T, B]. Bootstrap
values come from the last row's NEW_OBS per fragment. The V-trace
targets run through the K1 kernel on the card (`vtrace.py`).
"""

from __future__ import annotations

import torch

from ... import sample_batch as sb
from ...policy.torch_policy_template import build_torch_policy
from ..trainer import with_common_config
from . import vtrace

DEFAULT_CONFIG = with_common_config({
    "lr": 0.0005,
    "gamma": 0.99,
    "grad_clip": 40.0,
    "vf_loss_coeff": 0.5,
    "entropy_coeff": 0.01,
    "vtrace_clip_rho_threshold": 1.0,
    "vtrace_clip_pg_rho_threshold": 1.0,
    "lambda": 1.0,
    "rollout_fragment_length": 50,
    "train_batch_size": 500,
    "min_iter_time_s": 10,
    # The JAX package defaults to 2 remote workers; here 0 (local mode),
    # since remote workers need `ray_tpu_torch.init(local_mode=True)`.
    "num_workers": 0,
    "num_envs_per_worker": 1,
    # IMPALA sequences cross episode boundaries (V-trace cuts at dones).
    "pack_fragments": True,
    "use_gae": False,
    # Learner queue/broadcast knobs (reference: impala.py:14-17).
    "max_sample_requests_in_flight_per_worker": 2,
    "broadcast_interval": 1,
    "learner_queue_size": 16,
    "num_sgd_iter": 1,
    # 0 = one full-batch update per train batch; else num_sgd_iter
    # epochs of minibatches of this many rows (whole fragments) through
    # `TorchPolicy.sgd_learn`.
    "sgd_minibatch_size": 0,
    # Sebulba inline actors (`optimizers/async_samples_optimizer.py`
    # InlineActorThread): actor threads on the trainer's process step
    # batched host envs and select actions through the learner's policy
    # on the device. 0 = local mode.
    "num_inline_actors": 0,
    # Device-resident inline rollouts (`evaluation/device_sampler.py`):
    # obs ship to the card once and train in place. "auto" uses them for
    # feedforward policies; False (the host-side VectorSampler) is not
    # ported yet.
    "device_rollouts": "auto",
    # Stack depth for on-device frame stacking (0 = off). Requires an
    # env that emits single-channel frames (see device_frame_stack.py).
    "device_frame_stack": 0,
    # Delta-encoded observation uploads (`env/delta_obs.py`): the device
    # retains the frame batch; the host ships only changed pixels.
    # "auto" = envs with native delta support; True also wraps other
    # frame envs in the generic host-side `DeltaEncoder`; False = off.
    "obs_delta": "auto",
    # Max changed pixels per env-row before falling back to a full-frame
    # row (generic DeltaEncoder only; native envs set their own budget).
    "obs_delta_budget": 256,
    # Double-buffered env groups per inline actor: while one group's
    # selection and action fetch are in flight, the other groups' envs
    # step on the host. Falls back to the largest count that tiles the
    # env slots.
    "sebulba_env_groups": 2,
    # k-step on-device action selection: one action fetch per k env
    # steps, at up to k-1 steps of behaviour-policy lag (the POLICY_LAG
    # column; V-trace corrects it, since the stored behaviour logits are
    # the ones that selected each action). Requires
    # rollout_fragment_length % k == 0.
    "sebulba_onchip_steps": 1,
    # Anakin mode (`optimizers/anakin_optimizer.py`): device-resident envs
    # (`env/device_env.py`), rollout inference and the V-trace update on
    # the card, updates_per_call updates per optimizer step with one
    # host read. num_envs_per_worker sets the env slots.
    "anakin": False,
    "anakin_updates_per_call": 10,
})


def _time_major(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """[B*T, ...] -> [T, B, ...]."""
    b = x.shape[0] // seq_len
    return x.reshape((b, seq_len) + tuple(x.shape[1:])).transpose(0, 1)


def forward_with_bootstrap(policy, model, batch, T: int):
    """Model forward over a packed [B*T] fragment batch plus the
    per-fragment bootstrap value (feedforward policies).

    The bootstrap observation is a BOOTSTRAP_OBS column of shape [B, ...]
    when the batch has one, else the last NEW_OBS row of each fragment.
    Returns (dist_inputs[B*T, O], values[B*T], bootstrap_value[B]); the
    bootstrap value only feeds the V-trace targets, which carry no
    gradient, so it is computed without one.
    """
    dist_inputs, values_flat = model(batch[sb.OBS])
    if sb.BOOTSTRAP_OBS in batch:
        boot_obs = batch[sb.BOOTSTRAP_OBS]
    else:
        boot_obs = _time_major(batch[sb.NEW_OBS], T)[-1]
    with torch.no_grad():
        _, bootstrap_value = model(boot_obs)
    return dist_inputs, values_flat, bootstrap_value


def vtrace_loss(policy, model, batch):
    cfg = policy.config
    T = cfg["rollout_fragment_length"]
    gamma = cfg["gamma"]

    dist_inputs, values_flat, bootstrap_value = forward_with_bootstrap(
        policy, model, batch, T)

    behaviour_logits = _time_major(batch[sb.ACTION_DIST_INPUTS], T)
    target_logits = _time_major(dist_inputs, T)
    actions = _time_major(batch[sb.ACTIONS], T)
    rewards = _time_major(batch[sb.REWARDS], T)
    dones = _time_major(batch[sb.DONES], T)
    values = _time_major(values_flat, T)
    discounts = gamma * (1.0 - dones)

    returns, log_rhos, target_logp = vtrace.from_logits(
        behaviour_policy_logits=behaviour_logits,
        target_policy_logits=target_logits,
        actions=actions,
        discounts=discounts,
        rewards=rewards,
        values=values,
        bootstrap_value=bootstrap_value,
        dist_class=policy.dist_class,
        clip_rho_threshold=cfg["vtrace_clip_rho_threshold"],
        clip_pg_rho_threshold=cfg["vtrace_clip_pg_rho_threshold"],
        lambda_=cfg["lambda"])
    vs = returns.vs  # targets: computed without gradient
    pg_advantages = returns.pg_advantages

    pi_loss = -torch.sum(target_logp * pg_advantages)
    delta = values - vs
    vf_loss = 0.5 * torch.sum(delta ** 2)
    entropy = torch.sum(policy.dist_class(target_logits).entropy())

    total = (pi_loss
             + cfg["vf_loss_coeff"] * vf_loss
             - cfg["entropy_coeff"] * entropy)
    n = values_flat.shape[0]
    stats = {
        "total_loss": total,
        "policy_loss": pi_loss / n,
        "vf_loss": vf_loss / n,
        "entropy": entropy / n,
        "mean_kl_behaviour": torch.mean(-log_rhos),
        "vtrace_mean_vs": torch.mean(vs),
    }
    return total, stats


# The loss sums over rows (`pi_loss`, `vf_loss` and `entropy` above), so
# the data-parallel exchange is a psum: the gradient of the global-batch
# loss, as the implicit fp32 psum gives it on one device or a mesh.
VTraceTorchPolicy = build_torch_policy(
    "VTraceTorchPolicy", vtrace_loss, loss_reduction="sum",
    get_default_config=lambda: DEFAULT_CONFIG)
