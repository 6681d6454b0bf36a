"""SAC policy: squashed-Gaussian actor, twin-Q critics, learned alpha.

Counterpart of `ray_tpu/rllib/agents/sac/sac_policy.py` (parity:
`rllib/agents/sac/sac_policy.py`): soft actor-critic with clipped
double-Q targets, a reparameterized tanh-Gaussian actor and automatic
entropy-temperature tuning against a target entropy.

- Three parameter sets on one device: the actor (`StochasticActor`),
  the critic (`ContinuousQNetwork`, twin towers with `twin_q`) and
  `log_alpha`, each with its own `torch.optim.Adam` at optax's
  defaults; a target copy of the critic only, Polyak-averaged after
  every update (`tau`).
- The squashed-Gaussian tail (the clipped log_std, the reparameterized
  sample, its logp) is `models.distributions.squashed_gaussian_sample_
  logp`: kernel K9f on the card, and K9b for the actor loss's gradient.
  It runs twice per update (the critic's target with no gradient, the
  actor loss with one), once per `compute_td_error` and once per acted
  env step after `pure_exploration_steps`. Its constants (`SquashedTail`)
  are made once. An acted step's K9f also writes the actions into a
  pinned host output of the calling thread (`ActionRecord`), and the
  host waits once for it.
- One update (`learn_with_td`) in the JAX order (`sac_policy.py:202-
  235`): the critic step against the target critic and the pre-update
  actor and alpha, then the actor step against the updated critic with
  alpha held fixed, the alpha step on the actor's mean logp, and the
  Polyak average. Its normals come from the policy's device generator,
  two draws per update (critic, then actor). The stats and |TD error|
  come back in one device->host read.
- Pure exploration draws from `np.random.RandomState(seed)` exactly as
  the JAX policy does, so those actions are the JAX package's, bit for
  bit.

Worker-side prioritization (APEX-style remote workers) waits for the
runtime port (ROADMAP A6), a data-parallel SAC learner for A8.
"""

from __future__ import annotations

import copy
import math
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ....device import resolve_device
from ....models import catalog
from ....models.distributions import (SQUASHED_GAUSSIAN_KERNEL,
                                      ActionRecord, SquashedTail,
                                      ThreadRecords,
                                      squashed_gaussian_sample_logp)
from ....models.networks import ContinuousQNetwork, StochasticActor
from ... import sample_batch as sb
from ...policy.policy import Policy
from ...policy.torch_policy import (_to_host, host_state_dict,
                                    load_host_state_dict, read_stats,
                                    to_device)
from ...utils.config import deep_merge
from ..dqn.dqn_policy import adjust_nstep, huber_loss

SAC_POLICY_DEFAULTS = {
    "twin_q": True,
    "actor_hiddens": [256, 256],
    "actor_hidden_activation": "relu",
    "critic_hiddens": [256, 256],
    "critic_hidden_activation": "relu",
    "n_step": 1,
    "gamma": 0.99,
    "actor_lr": 3e-4,
    "critic_lr": 3e-4,
    "alpha_lr": 3e-4,
    "initial_alpha": 1.0,
    # "auto" => -|A| (the SAC paper's heuristic), else a float.
    "target_entropy": "auto",
    "tau": 5e-3,
    "use_huber": False,
    "huber_threshold": 1.0,
    "grad_clip": None,
    "pure_exploration_steps": 1000,
    # Treat episode-end dones as non-terminal for the TD target (right
    # for time-limit-truncated envs like Pendulum).
    "no_done_at_end": False,
    "use_gae": False,
    "worker_side_prioritization": False,
}

_COLUMNS = (sb.OBS, sb.NEW_OBS, sb.ACTIONS, sb.REWARDS, sb.DONES, "weights")


def validate_config(config: dict) -> None:
    """Refuse what this slice does not port."""
    if config.get("worker_side_prioritization"):
        raise NotImplementedError(
            "worker_side_prioritization (APEX-style replay actors) waits "
            "for the runtime port (ROADMAP Queue A item A6)")
    world = config.get("num_gpus_for_learner") or 0
    if world > 1:
        raise NotImplementedError(
            f"num_gpus_for_learner={world} with SAC: the data-parallel SAC "
            "learner is not ported yet (ROADMAP Queue A item A8); one "
            "learner device is")


def _adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) at its defaults: b1 0.9, b2 0.999, eps 1e-8; the
    multi-tensor implementation (PyTorch's default on the card) on the
    CPU too."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            foreach=True)


class SACPolicy(Policy):
    def __init__(self, observation_space, action_space, config):
        cfg = deep_merge(deep_merge({}, SAC_POLICY_DEFAULTS), config)
        super().__init__(observation_space, action_space, cfg)
        if not hasattr(action_space, "low"):
            raise ValueError("SAC requires a Box action space")
        validate_config(cfg)
        self.device = resolve_device(cfg.get("device", "cuda"))
        self.preprocessor = catalog.get_preprocessor(observation_space)
        self.action_dim = int(np.prod(action_space.shape))
        self.low = float(np.min(action_space.low))
        self.high = float(np.max(action_space.high))
        if cfg["target_entropy"] == "auto":
            self.target_entropy = -float(self.action_dim)
        else:
            self.target_entropy = float(cfg["target_entropy"])

        seed = cfg.get("seed") or 0
        init = torch.Generator().manual_seed(seed)
        obs_dim = int(np.prod(self.preprocessor.shape))
        self.actor = StochasticActor(
            obs_dim, self.action_dim, hiddens=tuple(cfg["actor_hiddens"]),
            activation=cfg["actor_hidden_activation"],
            generator=init).to(self.device)
        self.critic = ContinuousQNetwork(
            obs_dim, self.action_dim, hiddens=tuple(cfg["critic_hiddens"]),
            activation=cfg["critic_hidden_activation"], twin=cfg["twin_q"],
            generator=init).to(self.device)
        self.log_alpha = torch.nn.Parameter(torch.tensor(
            math.log(cfg["initial_alpha"]), dtype=torch.float32,
            device=self.device))
        # Only the critic has a target copy (SAC keeps the online actor).
        self.target_critic = copy.deepcopy(self.critic)
        for p in self.target_critic.parameters():
            p.requires_grad_(False)
        self.actor_optimizer = _adam(self.actor.parameters(),
                                     cfg["actor_lr"])
        self.critic_optimizer = _adam(self.critic.parameters(),
                                      cfg["critic_lr"])
        self.alpha_optimizer = _adam([self.log_alpha], cfg["alpha_lr"])
        # The tail's normals (two draws per update, one per acted step).
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._np_rng = np.random.RandomState(seed)
        self._tail_constants = SquashedTail(self.low, self.high,
                                            self.action_dim)
        self._update_lock = threading.Lock()
        # Per-thread host outputs of the acted steps.
        pin = self.device.type == "cuda"
        self._act_records = ThreadRecords(
            lambda rows: ActionRecord(rows, self.action_dim, pin=pin))
        self._update_count = 0
        self.global_timestep = 0

    # ------------------------------------------------------------------
    def num_params(self) -> int:
        """Trainable parameters (actor, critic, log_alpha); the target
        critic holds as many as the critic on top."""
        return (sum(p.numel() for p in self.actor.parameters())
                + sum(p.numel() for p in self.critic.parameters()) + 1)

    def _tail(self, obs: torch.Tensor, z: Optional[torch.Tensor],
              explore: bool = True,
              host_actions: Optional[ActionRecord] = None):
        """(actions, logp) of the actor at `obs`: K9f on the card (and
        K9b for a gradient); `host_actions` also gets the actions."""
        return squashed_gaussian_sample_logp(
            self.actor(obs), z, explore=explore, tail=self._tail_constants,
            host_actions=host_actions)

    def _normals(self, rows: int) -> torch.Tensor:
        return torch.randn((rows, self.action_dim), generator=self.generator,
                           dtype=torch.float32, device=self.device)

    def _soft_target(self, dev: Dict[str, torch.Tensor],
                     z: torch.Tensor) -> torch.Tensor:
        """r + gamma^n (min target Q - alpha logp') (1 - done), with no
        gradient (`sac_policy.py:161-170`)."""
        cfg = self.config
        gamma_n = cfg["gamma"] ** cfg["n_step"]
        with torch.no_grad():
            a_next, logp_next = self._tail(dev[sb.NEW_OBS], z)
            q1t, q2t = self.target_critic(dev[sb.NEW_OBS], a_next)
            q_next = torch.minimum(q1t, q2t) if cfg["twin_q"] else q1t
            alpha = torch.exp(self.log_alpha)
            soft_next = q_next - alpha * logp_next
            return dev[sb.REWARDS] + gamma_n * soft_next \
                * (1.0 - dev[sb.DONES])

    # ------------------------------------------------------------------
    def action_kernels(self) -> list:
        return [SQUASHED_GAUSSIAN_KERNEL]

    def compute_actions(self, obs_batch, state_batches=None, explore=True,
                        prev_action_batch=None, prev_reward_batch=None):
        if explore and self.global_timestep \
                < self.config["pure_exploration_steps"]:
            actions = self._np_rng.uniform(
                self.low, self.high,
                (len(obs_batch), self.action_dim)).astype(np.float32)
        else:
            # The normals, the actor and K9f, which also writes the
            # actions into this thread's pinned host output; one wait.
            obs = to_device(obs_batch, self.device)
            record = self._act_records.get(obs.shape[0])
            with self._update_lock, torch.no_grad():
                z = self._normals(obs.shape[0]) if explore else None
                self._tail(obs, z, explore, host_actions=record)
                record.record_done(self.device)
            actions = record.columns()
        self.global_timestep += len(actions)
        return actions, [], {}

    def postprocess_trajectory(self, batch, other_agent_batches=None,
                               episode=None):
        adjust_nstep(self.config["n_step"], self.config["gamma"], batch)
        if self.config.get("no_done_at_end"):
            batch[sb.DONES] = np.zeros_like(np.asarray(batch[sb.DONES]))
        return batch

    # ------------------------------------------------------------------
    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        dev = {k: to_device(batch[k], self.device)
               for k in _COLUMNS if k in batch}
        if dev[sb.ACTIONS].dim() == 1:
            dev[sb.ACTIONS] = dev[sb.ACTIONS][:, None]
        return dev

    def update_normals(self, rows: int, normals: Optional[Sequence] = None):
        """The update's two [rows, d] normal draws (critic, then actor):
        from the policy's generator, or the given ones."""
        if normals is None:
            return self._normals(rows), self._normals(rows)
        return tuple(to_device(np.array(z, np.float32), self.device)
                     for z in normals)

    def critic_step(self, dev: Dict[str, torch.Tensor],
                    z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Step 1 of an update: the critic's loss against the target
        critic and the pre-update actor and alpha, and its Adam step."""
        cfg = self.config
        weights = dev.get("weights")

        def loss(td):
            err = huber_loss(td, cfg["huber_threshold"]) \
                if cfg["use_huber"] else td ** 2
            return torch.mean(err if weights is None else weights * err)

        target = self._soft_target(dev, z)
        q1, q2 = self.critic(dev[sb.OBS], dev[sb.ACTIONS])
        td = q1 - target
        critic_loss = loss(td)
        if cfg["twin_q"]:
            critic_loss = critic_loss + loss(q2 - target)
        self.critic_optimizer.zero_grad(set_to_none=True)
        critic_loss.backward()
        self.critic_optimizer.step()
        return {"critic_loss": critic_loss.detach(),
                "mean_q": torch.mean(q1.detach()), "td_error": td.detach()}

    def actor_step(self, dev: Dict[str, torch.Tensor],
                   z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Step 2: the actor's loss against the updated critic with alpha
        held fixed, and its Adam step. The gradient goes to the actor's
        parameters only, through the tail's backward (K9b on the card)."""
        actions, logp = self._tail(dev[sb.OBS], z)
        q1, q2 = self.critic(dev[sb.OBS], actions)
        q = torch.minimum(q1, q2) if self.config["twin_q"] else q1
        alpha = torch.exp(self.log_alpha).detach()
        actor_loss = torch.mean(alpha * logp - q)
        params = list(self.actor.parameters())
        for p, g in zip(params, torch.autograd.grad(actor_loss, params)):
            p.grad = g
        self.actor_optimizer.step()
        return {"actor_loss": actor_loss.detach(),
                "entropy": -torch.mean(logp.detach())}

    def alpha_step(self, entropy: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Step 3: alpha's loss on the actor loss's mean logp (= -entropy)
        and its Adam step, then the Polyak average over the critic."""
        alpha_loss = -self.log_alpha * (self.target_entropy - entropy)
        self.alpha_optimizer.zero_grad(set_to_none=True)
        alpha_loss.backward()
        self.alpha_optimizer.step()
        tau = self.config["tau"]
        with torch.no_grad():
            for t, o in zip(self.target_critic.parameters(),
                            self.critic.parameters()):
                t.copy_((1.0 - tau) * t + tau * o)
        return {"alpha_loss": alpha_loss.detach(),
                "alpha": torch.exp(self.log_alpha.detach())}

    def _update(self, dev: Dict[str, torch.Tensor],
                normals: Optional[Sequence] = None
                ) -> Dict[str, torch.Tensor]:
        """One SAC update on device tensors, in the JAX order
        (`sac_policy.py:202-235`); the stats stay on the device. The
        caller holds `_update_lock`."""
        z_critic, z_actor = self.update_normals(dev[sb.OBS].shape[0],
                                                normals)
        stats = self.critic_step(dev, z_critic)
        stats.update(self.actor_step(dev, z_actor))
        stats.update(self.alpha_step(stats["entropy"]))
        return stats

    def learn_with_td(self, batch, _normals: Optional[Sequence] = None):
        """One update; returns (scalar stats, |td_error| per row as
        numpy), read in one device->host copy. `_normals`, for tests
        only: the update's two [rows, d] normal draws (critic, actor)."""
        dev = self._device_batch(batch)
        with self._update_lock:
            stats = self._update(dev, _normals)
        self._update_count += 1
        td = stats.pop("td_error")
        return read_stats(stats, td.abs())

    def learn_on_batch(self, batch) -> Dict[str, float]:
        stats, _ = self.learn_with_td(batch)
        return stats

    def compute_td_error(self, batch, _normals=None) -> np.ndarray:
        """q1 - the soft target per row, with one normal draw for the
        target's tail (`td_fn`, `sac_policy.py:253-267`). `_normals`, for
        tests only: that draw, [rows, d]."""
        dev = self._device_batch(batch)
        with self._update_lock, torch.no_grad():
            z = self._normals(dev[sb.OBS].shape[0]) if _normals is None \
                else to_device(np.array(_normals, np.float32), self.device)
            target = self._soft_target(dev, z)
            q1, _ = self.critic(dev[sb.OBS], dev[sb.ACTIONS])
            return (q1 - target).cpu().numpy()

    def update_target(self) -> None:
        """Copy the critic into the target critic, in place."""
        with self._update_lock, torch.no_grad():
            for t, o in zip(self.target_critic.parameters(),
                            self.critic.parameters()):
                t.copy_(o)

    # ------------------------------------------------------------------
    # weights: {"online": {"actor", "critic", "log_alpha"},
    #           "target": {"critic"}}, as the JAX policy returns them.
    def _online_weights(self):
        return {"actor": host_state_dict(self.actor),
                "critic": host_state_dict(self.critic),
                "log_alpha": self.log_alpha.detach().to(
                    "cpu", copy=True).numpy()}

    def get_weights(self):
        with self._update_lock:
            return {"online": self._online_weights(),
                    "target": {"critic": host_state_dict(
                        self.target_critic)}}

    def _set_online(self, online) -> None:
        load_host_state_dict(self.actor, online["actor"])
        load_host_state_dict(self.critic, online["critic"])
        with torch.no_grad():
            self.log_alpha.copy_(torch.from_numpy(
                np.array(online["log_alpha"], np.float32)))

    def set_weights(self, weights) -> None:
        with self._update_lock:
            if "online" in weights:
                self._set_online(weights["online"])
                load_host_state_dict(self.target_critic,
                                     weights["target"]["critic"])
            else:  # the online parameters alone
                self._set_online(weights)

    def get_state(self):
        with self._update_lock:
            opt_state = {
                name: _to_host(opt.state_dict()) for name, opt in (
                    ("actor", self.actor_optimizer),
                    ("critic", self.critic_optimizer),
                    ("alpha", self.alpha_optimizer))}
        return {"weights": self.get_weights(), "opt_state": opt_state,
                "update_count": self._update_count,
                "global_timestep": self.global_timestep}

    def set_state(self, state):
        self.set_weights(state["weights"])
        with self._update_lock:
            for name, opt in (("actor", self.actor_optimizer),
                              ("critic", self.critic_optimizer),
                              ("alpha", self.alpha_optimizer)):
                opt.load_state_dict(state["opt_state"][name])
        self._update_count = state.get("update_count", 0)
        self.global_timestep = state.get("global_timestep", 0)
