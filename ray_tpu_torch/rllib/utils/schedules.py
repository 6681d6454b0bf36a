"""Parameter schedules (exploration epsilon, prioritized-replay beta).

The port's own copy of `ray_tpu/rllib/utils/schedules.py`, trimmed to
the two schedules DQN uses. Parity: `rllib/utils/schedules.py` —
host-side scalar schedules driven by a global timestep counter.
"""

from __future__ import annotations


class Schedule:
    def value(self, t: float) -> float:
        raise NotImplementedError


class ConstantSchedule(Schedule):
    def __init__(self, value: float):
        self._v = value

    def value(self, t: float) -> float:
        return self._v


class LinearSchedule(Schedule):
    """Linear interpolation from `initial_p` to `final_p` over
    `schedule_timesteps`, then constant at `final_p`."""

    def __init__(self, schedule_timesteps: int, final_p: float,
                 initial_p: float = 1.0):
        self.schedule_timesteps = schedule_timesteps
        self.final_p = final_p
        self.initial_p = initial_p

    def value(self, t: float) -> float:
        frac = min(float(t) / max(1, self.schedule_timesteps), 1.0)
        return self.initial_p + frac * (self.final_p - self.initial_p)
