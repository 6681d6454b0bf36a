"""Framework-neutral policy interface.

The port's own copy of `ray_tpu/rllib/policy/policy.py`, trimmed to the
methods this slice's path calls. Parity: `rllib/policy/policy.py:27` —
compute_actions (:64), postprocess_trajectory (:158), learn_on_batch
(:183), get/set_weights (:222/:231).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class Policy:
    def __init__(self, observation_space, action_space, config: dict):
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config

    def compute_actions(self, obs_batch, state_batches=None,
                        explore: bool = True,
                        prev_action_batch=None, prev_reward_batch=None
                        ) -> Tuple[object, List, Dict]:
        """Returns (actions, state_out, extra_fetches)."""
        raise NotImplementedError

    def action_kernels(self) -> list:
        """The hand kernels (`CudaKernel`s) that `compute_actions`
        launches on the card: a rollout worker's process only loads
        them, so its driver builds these first."""
        return []

    def compute_single_action(self, obs, state=None, explore=True):
        pre = getattr(self, "preprocessor", None)
        if pre is not None and not getattr(pre, "is_identity", True):
            obs = pre.transform(obs)
        actions, state_out, extra = self.compute_actions(
            np.asarray(obs)[None], [s[None] for s in (state or [])],
            explore=explore)
        return actions[0], [s[0] for s in state_out], \
            {k: v[0] for k, v in extra.items()}

    def postprocess_trajectory(self, batch, other_agent_batches=None,
                               episode=None):
        return batch

    def learn_on_batch(self, batch) -> Dict:
        raise NotImplementedError

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, weights) -> None:
        raise NotImplementedError

    def get_state(self) -> dict:
        return {"weights": self.get_weights()}

    def set_state(self, state: dict) -> None:
        self.set_weights(state["weights"])
