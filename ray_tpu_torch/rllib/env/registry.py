"""Environment registry.

The port's own copy of `ray_tpu/rllib/env/registry.py`, trimmed to the
built-in ids the port runs: the single-env registry (`make_env`) and
the batched-env registry of the Sebulba inline actors
(`make_batched_env`). Unknown ids raise; the gymnasium fall-through
waits for a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict

from .env import CartPole, Pendulum, SyntheticAtari

_REGISTRY: Dict[str, Callable] = {}


def register_env(name: str, creator: Callable) -> None:
    """Register `creator(env_config) -> Env` under `name`."""
    _REGISTRY[name] = creator


def make_env(name: str, env_config: dict = None):
    env_config = env_config or {}
    if name in _REGISTRY:
        return _REGISTRY[name](env_config)
    raise ValueError(
        f"unknown env {name!r}; registered: {sorted(_REGISTRY)}")


class EnvCreator:
    """`creator(env_config) -> Env` for a registered env id. It carries
    the id only and looks the env up in the registry of the process that
    calls it, so it pickles by reference (plain pickle) to a remote
    rollout worker, where the registry's own creators (lambdas) could
    not go."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, env_config: dict = None):
        return make_env(self.name, env_config)

    def __repr__(self):
        return f"EnvCreator({self.name!r})"


# -- batched (vectorized) envs ------------------------------------------
# The Sebulba inline-actor path steps envs as a batch (see
# `batched_env.py`). Envs with a natively-vectorized implementation
# register it here; everything else falls back to a per-env loop adapter.
_BATCHED_REGISTRY: Dict[str, Callable] = {}


def register_batched_env(name: str, creator: Callable) -> None:
    """Register `creator(num_envs, env_config) -> BatchedEnv`."""
    _BATCHED_REGISTRY[name] = creator


def make_batched_env(name, num_envs: int, env_config: dict = None,
                     seed=None, device_frame_stack: int = 0,
                     obs_delta=False, obs_delta_budget: int = 256):
    """Build a BatchedEnv for `name` (string id or env creator callable).

    Uses the natively-vectorized implementation when one is registered;
    otherwise wraps N single-env instances (`BatchedEnvFromSingle`).
    With `device_frame_stack=k` the env must emit single-channel frames;
    they are wrapped for on-device stacking (`device_frame_stack.py`).
    With `obs_delta=True`, envs without native delta support gain the
    generic host-side `DeltaEncoder` (`delta_obs.py`); "auto" keeps
    native support only.
    """
    from .batched_env import BatchedEnvFromSingle
    env_config = env_config or {}
    if isinstance(name, str) and name in _BATCHED_REGISTRY:
        env = _BATCHED_REGISTRY[name](num_envs, env_config)
    elif isinstance(name, str):
        env = BatchedEnvFromSingle(
            lambda: make_env(name, env_config), num_envs)
    else:  # creator callable
        env = BatchedEnvFromSingle(lambda: name(env_config), num_envs)
    if obs_delta is True and not hasattr(env, "delta_budget"):
        from .delta_obs import DeltaEncoder
        env = DeltaEncoder(env, budget=obs_delta_budget)
    if device_frame_stack:
        from .device_frame_stack import DeviceFrameStack
        env = DeviceFrameStack(env, device_frame_stack)
    if seed is not None:
        env.seed(seed)
    return env


def _batched_synthetic_atari(channels=4):
    def creator(n, cfg):
        from .batched_env import BatchedSyntheticAtari
        return BatchedSyntheticAtari(
            n, episode_len=cfg.get("episode_len", 1000),
            num_actions=cfg.get("num_actions", 6),
            pool_size=cfg.get("pool_size", 32),
            channels=cfg.get("channels", channels))
    return creator


def _batched_cartpole(max_steps):
    def creator(n, cfg):
        from .batched_env import BatchedCartPole
        return BatchedCartPole(n, max_steps=max_steps)
    return creator


def _batched_sprite_atari(n, cfg):
    from .delta_obs import BatchedSpriteAtari
    return BatchedSpriteAtari(
        n, episode_len=cfg.get("episode_len", 1000),
        num_actions=cfg.get("num_actions", 6),
        pool_size=cfg.get("pool_size", 16),
        speed=cfg.get("speed", 3))


def _sprite_atari(cfg):
    from .delta_obs import SpriteAtari
    return SpriteAtari(
        episode_len=cfg.get("episode_len", 1000),
        num_actions=cfg.get("num_actions", 6),
        pool_size=cfg.get("pool_size", 16),
        speed=cfg.get("speed", 3))


register_batched_env("SyntheticAtari-v0", _batched_synthetic_atari(4))
# Single-frame emission variant for on-device frame stacking (pair with
# config device_frame_stack=4; see env/device_frame_stack.py).
register_batched_env("SyntheticAtariFrames-v0", _batched_synthetic_atari(1))
# Temporally-coherent Atari-shaped frames with native delta emission
# (env/delta_obs.py): single-channel, pair with device_frame_stack=4 and
# obs_delta="auto" on the inline-actor path.
register_batched_env("SpriteAtari-v0", _batched_sprite_atari)
register_batched_env("CartPole-v0", _batched_cartpole(200))
register_batched_env("CartPole-v1", _batched_cartpole(500))

# Built-ins (same ids the JAX package registers).
register_env("CartPole-v0", lambda cfg: CartPole(max_steps=200))
register_env("CartPole-v1", lambda cfg: CartPole(max_steps=500))
register_env("Pendulum-v0", lambda cfg: Pendulum())
register_env("SyntheticAtari-v0",
             lambda cfg: SyntheticAtari(
                 episode_len=cfg.get("episode_len", 1000),
                 num_actions=cfg.get("num_actions", 6)))
register_env("SyntheticAtariFrames-v0",
             lambda cfg: SyntheticAtari(
                 episode_len=cfg.get("episode_len", 1000),
                 num_actions=cfg.get("num_actions", 6),
                 channels=1))
register_env("SpriteAtari-v0", _sprite_atari)
