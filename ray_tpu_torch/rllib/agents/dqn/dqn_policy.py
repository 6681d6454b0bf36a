"""DQN-family policy: Q-network, target network, epsilon-greedy.

Counterpart of `ray_tpu/rllib/agents/dqn/dqn_policy.py` (parity:
`rllib/agents/dqn/dqn_policy.py` QLoss, build_q_models, epsilon-greedy
exploration, `postprocess_nstep_and_prio`, and `simple_q_policy.py`):

- The Q-network is the port's `QNetwork`, built from the policy's
  config by `make_q_model` as the JAX package's `make_model` builds it
  (`config["model"]` read raw, not through the catalog's defaults).
- The target network is a second `QNetwork` on the same device, with
  `requires_grad=False`; `update_target` copies the online parameters
  into it in place.
- `compute_actions` runs the forward and then the epsilon-greedy tail,
  kernel K8 on the card (`models/eps_greedy.py`), with two uniforms per
  row from the policy's own generator. K8 writes the actions, and
  nothing else, into a pinned int64 host output of the calling thread
  (`ActionRecord`), and the host waits once for it.
- `learn_with_td` is one update (`TorchPolicy.apply_update`: loss,
  backward, clip, Adam) and returns the scalar stats and |TD error|
  with one device->host read.

Worker-side prioritization (APEX) waits for the runtime port (ROADMAP
A6), a data-parallel DQN learner for A8.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ....models.catalog import observation_shape, resolve_compute_dtype
from ....models.distributions import ActionRecord, ThreadRecords
from ....models.eps_greedy import EPS_GREEDY_KERNEL, eps_greedy
from ....models.networks import QNetwork
from ... import sample_batch as sb
from ...policy.torch_policy import (TorchPolicy, host_state_dict,
                                    load_host_state_dict, read_stats)
from ...sample_batch import SampleBatch
from ...utils.config import deep_merge

PRIO_WEIGHTS = "weights"


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Reference: `rllib/utils/error.py` huber_loss."""
    return torch.where(x.abs() < delta, 0.5 * x ** 2,
                       delta * (x.abs() - 0.5 * delta))


def dqn_loss(policy, model, batch):
    """The mean Huber TD loss, with double Q and an n-step bootstrap;
    the target is computed with no gradient. Stats: `loss`, `mean_q`,
    `min_q`, `max_q`, `mean_td_error` and the `td_error` vector."""
    cfg = policy.config
    q_t, _ = model(batch[sb.OBS])
    q_t_selected = q_t.gather(-1, batch[sb.ACTIONS].long()[:, None])[:, 0]
    with torch.no_grad():
        q_tp1_target, _ = policy.target_model(batch[sb.NEW_OBS])
        if cfg["double_q"]:
            best = torch.argmax(model(batch[sb.NEW_OBS])[0], dim=-1)
        else:
            best = torch.argmax(q_tp1_target, dim=-1)
        q_tp1_best = q_tp1_target.gather(-1, best[:, None])[:, 0]
        not_done = 1.0 - batch[sb.DONES]
        # n-step postprocessing already folded gamma^k into rewards, so
        # the bootstrap term is discounted by gamma^n_step.
        gamma_n = cfg["gamma"] ** cfg["n_step"]
        target = batch[sb.REWARDS] + gamma_n * q_tp1_best * not_done
    td_error = q_t_selected - target
    is_weights = batch.get(PRIO_WEIGHTS)
    if is_weights is None:
        is_weights = torch.ones_like(td_error)
    loss = torch.mean(is_weights * huber_loss(td_error))
    stats = {
        "loss": loss,
        "mean_q": torch.mean(q_t_selected),
        "min_q": torch.min(q_t),
        "max_q": torch.max(q_t),
        "mean_td_error": torch.mean(td_error),
        "td_error": td_error,  # vector; popped before scalar reporting
    }
    return loss, stats


def adjust_nstep(n_step: int, gamma: float, batch: SampleBatch) -> None:
    """Fold the next n-1 rewards into each row (in place, vectorized).

    Parity: `dqn_policy.py` `_adjust_nstep` — rewards[i] +=
    sum_j gamma^j * rewards[i+j]; new_obs/dones shift to row i+n-1
    (truncated at the fragment end, matching the reference).
    """
    if n_step == 1:
        return
    dones = np.asarray(batch[sb.DONES])
    if dones[:-1].any():
        raise ValueError("unexpected done in the middle of a trajectory "
                         "fragment passed to n-step adjustment")
    L = batch.count
    idx = np.minimum(np.arange(L) + n_step - 1, L - 1)
    batch[sb.NEW_OBS] = np.asarray(batch[sb.NEW_OBS])[idx]
    batch[sb.DONES] = dones[idx]
    rewards = np.asarray(batch[sb.REWARDS], dtype=np.float32)
    padded = np.concatenate([rewards, np.zeros(n_step - 1, np.float32)])
    windows = np.lib.stride_tricks.sliding_window_view(padded, n_step)
    disc = (gamma ** np.arange(n_step)).astype(np.float32)
    batch[sb.REWARDS] = windows @ disc


def postprocess_nstep_and_prio(policy, batch, other_agent_batches=None,
                               episode=None):
    """n-step reward folding (`dqn_policy.py`
    `postprocess_nstep_and_prio`; the worker-side TD errors of APEX are
    not ported)."""
    adjust_nstep(policy.config["n_step"], policy.config["gamma"], batch)
    return batch


DQN_POLICY_DEFAULTS = {
    "double_q": True,
    "dueling": True,
    "hiddens": [256],
    "n_step": 1,
    "gamma": 0.99,
    "lr": 5e-4,
    "adam_epsilon": 1e-8,
    "grad_clip": 40.0,
    "use_gae": False,  # no advantage postprocessing for Q-learning
    "worker_side_prioritization": False,
}


def validate_config(config: dict) -> None:
    """Refuse what this slice does not port."""
    if config.get("worker_side_prioritization"):
        raise NotImplementedError(
            "worker_side_prioritization (APEX's replay actors) waits for "
            "the runtime port (ROADMAP Queue A item A6)")
    world = config.get("num_gpus_for_learner") or 0
    if world > 1:
        raise NotImplementedError(
            f"num_gpus_for_learner={world} with DQN: the data-parallel DQN "
            "learner is not ported yet (ROADMAP Queue A item A8); one "
            "learner device is")


def make_q_model(obs_space, action_space, config) -> QNetwork:
    """The Q-network of `dqn_policy.py:133-159`: `config["model"]` read
    raw (activation "relu" by default), a trunk of
    `model.fcnet_hiddens` ++ `hiddens` dense layers on flat
    observations and of `hiddens` after the conv stack on frames, the
    dueling head with `dueling`. Initial weights from `config["seed"]`.
    `model.compute_dtype` "f32" or "bf16" sets the conv trunk's compute
    type (bf16 otherwise, as in the JAX package)."""
    mcfg = config.get("model") or {}
    shape = observation_shape(obs_space)
    trunk = tuple(mcfg.get("fcnet_hiddens") or ()) if len(shape) < 3 \
        else ()
    kwargs = {}
    if mcfg.get("compute_dtype", "auto") not in (None, "auto"):
        kwargs["compute_dtype"] = resolve_compute_dtype(
            mcfg["compute_dtype"])
    return QNetwork(
        shape, action_space.n,
        hiddens=trunk + tuple(config["hiddens"]),
        activation=mcfg.get("fcnet_activation", "relu"),
        dueling=config["dueling"],
        conv_filters=tuple(tuple(f) for f in (
            mcfg.get("conv_filters")
            or ((32, 8, 4), (64, 4, 2), (64, 3, 1)))),
        generator=torch.Generator().manual_seed(config.get("seed") or 0),
        **kwargs)


class DQNPolicy(TorchPolicy):
    """Q-learning policy. dist_inputs are the Q-values; exploration is
    epsilon-greedy with a host-controlled epsilon scalar."""

    def __init__(self, observation_space, action_space, config):
        cfg = deep_merge(deep_merge({}, DQN_POLICY_DEFAULTS), config)
        if not hasattr(action_space, "n"):
            raise ValueError("DQN requires a Discrete action space")
        validate_config(cfg)
        self.num_actions = action_space.n
        # A mean over rows (a data-parallel exchange would divide by D).
        super().__init__(observation_space, action_space, cfg,
                         loss_fn=dqn_loss, loss_reduction="mean",
                         make_model=make_q_model,
                         postprocess_fn=postprocess_nstep_and_prio)
        self.cur_epsilon = 1.0
        # Per-thread host outputs of `compute_actions`.
        pin = self.device.type == "cuda"
        self._action_records = ThreadRecords(
            lambda rows: ActionRecord(rows, pin=pin, dtype=torch.int64))
        self.target_model = copy.deepcopy(self.model)
        for p in self.target_model.parameters():
            p.requires_grad_(False)

    # -- exploration -----------------------------------------------------
    def set_epsilon(self, epsilon: float) -> None:
        self.cur_epsilon = float(epsilon)

    def action_kernels(self) -> list:
        return [EPS_GREEDY_KERNEL]

    def compute_actions(self, obs_batch, state_batches=None, explore=True,
                        prev_action_batch=None, prev_reward_batch=None):
        obs = self._to_device(obs_batch)
        eps = self.cur_epsilon if explore else 0.0
        record = self._action_records.get(obs.shape[0])
        # The forward, the uniforms (drawn at eps 0 too) and K8 writing
        # this thread's host output; one wait after the lock, a copy.
        with self._update_lock, torch.no_grad():
            q, _ = self.model(obs)
            u = torch.rand((q.shape[0], 2), generator=self.generator,
                           dtype=torch.float32, device=self.device)
            eps_greedy(q, u, eps, host_actions=record)
            record.record_done(self.device)
        return record.columns(), [], {}

    # -- learning --------------------------------------------------------
    def learn_with_td(self, batch):
        """One update; returns (scalar stats, |td_error| per row as
        numpy) so the caller can refresh replay priorities. The stats
        and the TD errors come back in one device->host copy."""
        dev_batch = self._device_batch(batch)
        with self._update_lock:
            stats = self.apply_update(dev_batch)
        self.global_timestep += batch.count
        td = stats.pop("td_error")
        return read_stats(stats, td.abs())

    def learn_on_batch(self, batch):
        stats, _ = self.learn_with_td(batch)
        return stats

    # -- target network --------------------------------------------------
    def update_target(self) -> None:
        """Copy the online parameters into the target network, in place
        (reference: `dqn_policy.py update_target`)."""
        with self._update_lock, torch.no_grad():
            for target, online in zip(self.target_model.parameters(),
                                      self.model.parameters()):
                target.copy_(online)

    # -- weights ---------------------------------------------------------
    # Both networks, as the JAX policy returns them (`dqn_policy.py:250`).
    def get_weights(self):
        with self._update_lock:
            return {"online": host_state_dict(self.model),
                    "target": host_state_dict(self.target_model)}

    def set_weights(self, weights):
        with self._update_lock:
            if "online" in weights:
                load_host_state_dict(self.model, weights["online"])
                load_host_state_dict(self.target_model, weights["target"])
            else:  # a bare online state dict
                load_host_state_dict(self.model, weights)

    # -- state -----------------------------------------------------------
    def get_state(self):
        state = super().get_state()
        state["cur_epsilon"] = self.cur_epsilon
        return state

    def set_state(self, state):
        state = dict(state)
        self.cur_epsilon = state.pop("cur_epsilon", self.cur_epsilon)
        super().set_state(state)
