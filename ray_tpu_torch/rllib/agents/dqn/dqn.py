"""DQN and SimpleQ trainers.

Counterpart of `ray_tpu/rllib/agents/dqn/dqn.py` (parity:
`rllib/agents/dqn/dqn.py` DQNTrainer — prioritized replay, double,
dueling and n-step Q-learning, the epsilon schedule, the target-network
sync of `update_target_if_needed` — and `simple_q.py`), in local mode:
`SyncReplayOptimizer` on the local worker, one learner device. Epsilon
anneals on sampled steps; the target network syncs on trained steps.
APEX waits for the runtime port (ROADMAP A6).
"""

from __future__ import annotations

from ...optimizers.sync_replay_optimizer import SyncReplayOptimizer
from ...utils.schedules import LinearSchedule
from ..trainer import with_common_config
from ..trainer_template import build_trainer
from .dqn_policy import DQNPolicy, validate_config

DEFAULT_CONFIG = with_common_config({
    # === Model ===
    "double_q": True,
    "dueling": True,
    "hiddens": [256],
    "n_step": 1,
    # === Exploration ===
    "exploration_initial_eps": 1.0,
    "exploration_final_eps": 0.02,
    "exploration_timesteps": 10000,
    # === Replay ===
    "buffer_size": 50000,
    "prioritized_replay": True,
    "prioritized_replay_alpha": 0.6,
    "prioritized_replay_beta": 0.4,
    "final_prioritized_replay_beta": 0.4,
    "prioritized_replay_beta_annealing_timesteps": 20000,
    "prioritized_replay_eps": 1e-6,
    "learning_starts": 1000,
    # === Optimization ===
    "lr": 5e-4,
    "adam_epsilon": 1e-8,
    "grad_clip": 40.0,
    "rollout_fragment_length": 4,
    "train_batch_size": 32,
    "target_network_update_freq": 500,
    # === Parity plumbing ===
    "use_gae": False,
    "worker_side_prioritization": False,
    "timesteps_per_iteration": 1000,
})

# SimpleQ is DQN without double Q, dueling or prioritized replay
# (`simple_q.py`); the prioritized-replay keys it keeps are unread.
SIMPLE_Q_CONFIG = with_common_config(dict(
    DEFAULT_CONFIG, double_q=False, dueling=False, prioritized_replay=False))


def make_sync_replay_optimizer(workers, config):
    return SyncReplayOptimizer(
        workers,
        learning_starts=config["learning_starts"],
        buffer_size=config["buffer_size"],
        prioritized_replay=config["prioritized_replay"],
        prioritized_replay_alpha=config["prioritized_replay_alpha"],
        prioritized_replay_beta=config["prioritized_replay_beta"],
        final_prioritized_replay_beta=config[
            "final_prioritized_replay_beta"],
        prioritized_replay_beta_annealing_timesteps=config[
            "prioritized_replay_beta_annealing_timesteps"],
        prioritized_replay_eps=config["prioritized_replay_eps"],
        train_batch_size=config["train_batch_size"],
        seed=config["seed"])


def setup_exploration(trainer):
    trainer._eps_schedule = LinearSchedule(
        trainer.config["exploration_timesteps"],
        initial_p=trainer.config["exploration_initial_eps"],
        final_p=trainer.config["exploration_final_eps"])
    trainer._last_target_update_ts = 0
    trainer._num_target_updates = 0
    trainer.get_policy().set_epsilon(
        trainer.config["exploration_initial_eps"])


def update_target_and_epsilon(trainer, fetches):
    """Per-step hooks: anneal epsilon from the SAMPLED steps, sync the
    target network on TRAINED steps (parity: dqn.py
    `update_target_if_needed` keys the target schedule on
    optimizer.num_steps_trained)."""
    trainer.get_policy().set_epsilon(trainer._eps_schedule.value(
        trainer.optimizer.num_steps_sampled))
    ts = trainer.optimizer.num_steps_trained
    if ts - trainer._last_target_update_ts >= \
            trainer.config["target_network_update_freq"]:
        trainer.get_policy().update_target()
        trainer._last_target_update_ts = ts
        trainer._num_target_updates += 1


def add_exploration_metrics(trainer, result):
    result["info"]["exploration_epsilon"] = \
        trainer.get_policy().cur_epsilon
    result["info"]["num_target_updates"] = trainer._num_target_updates


DQNTrainer = build_trainer(
    name="DQN",
    default_policy=DQNPolicy,
    default_config=DEFAULT_CONFIG,
    make_policy_optimizer=make_sync_replay_optimizer,
    validate_config=validate_config,
    after_init=setup_exploration,
    after_optimizer_step=update_target_and_epsilon,
    after_train_result=add_exploration_metrics)

SimpleQTrainer = build_trainer(
    name="SimpleQ",
    default_policy=DQNPolicy,
    default_config=SIMPLE_Q_CONFIG,
    make_policy_optimizer=make_sync_replay_optimizer,
    validate_config=validate_config,
    after_init=setup_exploration,
    after_optimizer_step=update_target_and_epsilon,
    after_train_result=add_exploration_metrics)
