"""SAC trainer.

Counterpart of `ray_tpu/rllib/agents/sac/sac.py` (parity:
`rllib/agents/sac/sac.py`): off-policy soft actor-critic on DQN's sync
replay optimizer, in local mode (one env stepping on the local worker,
one learner device). APEX-style remote workers wait for the runtime
port (ROADMAP A6), checkpoints for A12.
"""

from __future__ import annotations

from ..dqn.dqn import make_sync_replay_optimizer
from ..trainer import with_common_config
from ..trainer_template import build_trainer
from .sac_policy import SACPolicy, validate_config

DEFAULT_CONFIG = with_common_config({
    "twin_q": True,
    "actor_hiddens": [256, 256],
    "actor_hidden_activation": "relu",
    "critic_hiddens": [256, 256],
    "critic_hidden_activation": "relu",
    "n_step": 1,
    "actor_lr": 3e-4,
    "critic_lr": 3e-4,
    "alpha_lr": 3e-4,
    "initial_alpha": 1.0,
    "target_entropy": "auto",
    "tau": 5e-3,
    "use_huber": False,
    "huber_threshold": 1.0,
    "pure_exploration_steps": 1000,
    "no_done_at_end": False,
    "buffer_size": 100000,
    "prioritized_replay": False,
    "prioritized_replay_alpha": 0.6,
    "prioritized_replay_beta": 0.4,
    "final_prioritized_replay_beta": 0.4,
    "prioritized_replay_beta_annealing_timesteps": 20000,
    "prioritized_replay_eps": 1e-6,
    "learning_starts": 1500,
    "rollout_fragment_length": 1,
    "train_batch_size": 256,
    "timesteps_per_iteration": 1000,
    "use_gae": False,
    "worker_side_prioritization": False,
})


SACTrainer = build_trainer(
    name="SAC",
    default_policy=SACPolicy,
    default_config=DEFAULT_CONFIG,
    make_policy_optimizer=make_sync_replay_optimizer,
    validate_config=validate_config)
