"""Single-agent environment API + built-in environments.

The port's own copy of `ray_tpu/rllib/env/env.py` (numpy only), trimmed
to the envs the port runs: CartPole (the learning tests), Pendulum (the
continuous-action PPO path) and SyntheticAtari (84x84x4 uint8 frames, 6
actions; the stand-in for ALE).

API: `reset() -> obs`, `step(action) -> (obs, reward, done, info)` —
the same contract RLlib's samplers expect.
"""

from __future__ import annotations

import numpy as np

from .spaces import Box, Discrete


class Env:
    observation_space = None
    action_space = None

    def reset(self):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)

    def close(self):
        pass


def init_cartpole_constants(obj, max_steps: int):
    """Shared CartPole parameters + spaces (Barto-Sutton-Anderson '83,
    gym CartPole-v0 values)."""
    obj.gravity = 9.8
    obj.masscart, obj.masspole = 1.0, 0.1
    obj.total_mass = obj.masscart + obj.masspole
    obj.length = 0.5  # half pole length
    obj.polemass_length = obj.masspole * obj.length
    obj.force_mag = 10.0
    obj.tau = 0.02
    obj.theta_threshold = 12 * 2 * np.pi / 360
    obj.x_threshold = 2.4
    obj.max_steps = max_steps
    high = np.array([obj.x_threshold * 2, np.finfo(np.float32).max,
                     obj.theta_threshold * 2, np.finfo(np.float32).max],
                    dtype=np.float32)
    obj.observation_space = Box(-high, high)
    obj.action_space = Discrete(2)


def cartpole_step(p, state: np.ndarray, actions) -> tuple:
    """Euler-integrate one step for a [N, 4] state batch. Returns
    (new_state [N, 4], threshold_violation [N] bool). `p` carries the
    constants from `init_cartpole_constants`."""
    x, x_dot, theta, theta_dot = state.T
    force = np.where(np.asarray(actions) == 1, p.force_mag, -p.force_mag)
    costheta, sintheta = np.cos(theta), np.sin(theta)
    temp = (force + p.polemass_length * theta_dot ** 2 * sintheta) \
        / p.total_mass
    thetaacc = (p.gravity * sintheta - costheta * temp) / (
        p.length * (4.0 / 3.0
                    - p.masspole * costheta ** 2 / p.total_mass))
    xacc = temp - p.polemass_length * thetaacc * costheta / p.total_mass
    x = x + p.tau * x_dot
    x_dot = x_dot + p.tau * xacc
    theta = theta + p.tau * theta_dot
    theta_dot = theta_dot + p.tau * thetaacc
    new_state = np.stack([x, x_dot, theta, theta_dot], axis=1)
    violation = (np.abs(x) > p.x_threshold) \
        | (np.abs(theta) > p.theta_threshold)
    return new_state, violation


class CartPole(Env):
    """Cart-pole balancing (200-step limit, +1 reward per step, terminate
    at |x|>2.4 or |theta|>12deg)."""

    def __init__(self, max_steps: int = 200):
        init_cartpole_constants(self, max_steps)
        self._rng = np.random.default_rng()
        self._state = None
        self._t = 0

    def reset(self):
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32)

    def step(self, action):
        new_state, violation = cartpole_step(
            self, self._state[None, :], np.array([action]))
        self._state = new_state[0]
        self._t += 1
        done = bool(violation[0]) or self._t >= self.max_steps
        return self._state.astype(np.float32), 1.0, done, {}


class Pendulum(Env):
    """Torque-controlled pendulum swing-up (matching gym Pendulum-v0:
    200-step episodes, continuous action in [-2, 2]). The env clips the
    torque itself, so a policy's unclipped Gaussian draw is a valid
    action."""

    def __init__(self, max_steps: int = 200):
        self.max_speed = 8.0
        self.max_torque = 2.0
        self.dt = 0.05
        self.g, self.m, self.l = 10.0, 1.0, 1.0
        self.max_steps = max_steps
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Box(-self.max_torque, self.max_torque, shape=(1,))
        self._rng = np.random.default_rng()

    def reset(self):
        self._theta = self._rng.uniform(-np.pi, np.pi)
        self._thetadot = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs()

    def _obs(self):
        return np.array([np.cos(self._theta), np.sin(self._theta),
                         self._thetadot], dtype=np.float32)

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.max_torque, self.max_torque))
        th, thdot = self._theta, self._thetadot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.g / (2 * self.l) * np.sin(th)
                         + 3.0 / (self.m * self.l ** 2) * u) * self.dt
        thdot = np.clip(thdot, -self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        self._theta, self._thetadot = th, thdot
        self._t += 1
        return self._obs(), -float(cost), self._t >= self.max_steps, {}


class SyntheticAtari(Env):
    """Atari-shaped throughput environment: 84x84x4 uint8 frames, 6 actions.

    Stands in for ALE (not available in this image) when measuring
    sampler/learner throughput at the reference's Atari configuration
    (reference preprocessing: `rllib/env/atari_wrappers.py` produces
    84x84x4 stacked frames). Observations carry a learnable signal (frame
    intensity encodes the best action) so policies must do real work.
    """

    def __init__(self, episode_len: int = 1000, num_actions: int = 6,
                 channels: int = 4):
        self.observation_space = Box(0, 255, shape=(84, 84, channels),
                                     dtype=np.uint8)
        self.action_space = Discrete(num_actions)
        self.episode_len = episode_len
        self.num_actions = num_actions
        self.channels = channels
        self._rng = np.random.default_rng()

    def reset(self):
        self._t = 0
        self._target = int(self._rng.integers(self.num_actions))
        return self._frame()

    def _frame(self):
        frame = self._rng.integers(
            0, 64, size=(84, 84, self.channels), dtype=np.uint8)
        # Embed the target action as a bright band.
        band = 84 // self.num_actions
        frame[self._target * band:(self._target + 1) * band, :, :] += 128
        return frame

    def step(self, action):
        reward = 1.0 if int(action) == self._target else 0.0
        self._t += 1
        self._target = int(self._rng.integers(self.num_actions))
        return self._frame(), reward, self._t >= self.episode_len, {}
