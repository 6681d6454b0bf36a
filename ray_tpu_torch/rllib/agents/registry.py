"""Algorithm registry: trainer classes by name.

Counterpart of `ray_tpu/rllib/agents/registry.py` (parity:
`rllib/agents/registry.py:98`) for the algorithms the port has: IMPALA,
PPO, DQN, SimpleQ and SAC. Every other name the JAX package registers
raises NotImplementedError naming the ROADMAP item that ports it; a
name neither package knows raises ValueError.
"""

from __future__ import annotations


def _impala():
    from .impala import IMPALATrainer
    return IMPALATrainer


def _ppo():
    from .ppo import PPOTrainer
    return PPOTrainer


def _dqn():
    from .dqn import DQNTrainer
    return DQNTrainer


def _simple_q():
    from .dqn import SimpleQTrainer
    return SimpleQTrainer


def _sac():
    from .sac import SACTrainer
    return SACTrainer


ALGORITHMS = {
    "IMPALA": _impala,
    "PPO": _ppo,
    "DQN": _dqn,
    "SimpleQ": _simple_q,
    "SAC": _sac,
}

# The JAX package's other names -> the ROADMAP item that ports them.
NOT_PORTED = {
    "PG": "A11", "A2C": "A11", "A3C": "A11", "APPO": "A11",
    "MARWIL": "A11", "DDPG": "A11", "TD3": "A11", "ES": "A11",
    "ARS": "A11", "QMIX": "A11", "contrib/MADDPG": "A11", "MADDPG": "A11",
    "contrib/AlphaZero": "A11", "AlphaZero": "A11",
    # Their replay and rollout actors are remote.
    "APEX": "A6", "APEX_DDPG": "A6", "APEX_QMIX": "A6",
}


def get_trainer_class(name: str):
    if name in ALGORITHMS:
        return ALGORITHMS[name]()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ROADMAP Queue A item "
            f"{NOT_PORTED[name]}); ported: {sorted(ALGORITHMS)}")
    raise ValueError(f"unknown algorithm {name!r}; available: "
                     f"{sorted(ALGORITHMS)}")
