"""On-device frame stacking: ship one frame per step, stack on the card.

The port's own copy of `ray_tpu/rllib/env/device_frame_stack.py` (numpy
only). A host `FrameStack` ships k frames' worth of bytes per env step
although k-1 of them are already on the device; this wrapper moves the
stack into the device pipeline:

- the wrapped env emits only the newest frame ([H, W, 1] per slot);
- `DeviceSebulbaSampler` keeps the [N, H, W, k] stack on the card (roll
  + insert, refilled at episode boundaries; kernel K3), cutting per-step
  host->device traffic by k x;
- the advertised `observation_space` is the STACKED space, so policies
  build exactly the network they would for host-side stacking.

Only the device sampler understands the single-frame emission contract
(the `device_frame_stack` attribute).
"""

from __future__ import annotations

import numpy as np

from .batched_env import BatchedEnv
from .spaces import Box


def stacked_space(base: Box, k: int) -> Box:
    """The [H, W, 1] frame space stacked to [H, W, k]."""
    if base.shape[-1] != 1:
        raise ValueError(
            f"device frame stacking needs single-channel frames; env "
            f"emits {base.shape}")
    shape = base.shape[:-1] + (k,)
    return Box(low=np.min(base.low), high=np.max(base.high),
               shape=shape, dtype=base.dtype)


class DeviceFrameStack(BatchedEnv):
    """Wrap a single-frame BatchedEnv; advertise the stacked obs space.

    `vector_reset`/`vector_step` still return raw [N, H, W, 1] frames —
    the device sampler does the stacking. The `device_frame_stack`
    attribute is the marker (and stack depth) samplers key on.
    """

    def __init__(self, inner: BatchedEnv, k: int):
        self.inner = inner
        self.device_frame_stack = int(k)
        self.num_envs = inner.num_envs
        self.observation_space = stacked_space(inner.observation_space, k)
        self.action_space = inner.action_space
        # Delta protocol passthrough (env/delta_obs.py): the sampler
        # keys on `delta_budget` to enable delta-encoded uploads.
        if hasattr(inner, "delta_budget"):
            self.delta_budget = inner.delta_budget
            self.vector_reset_delta = inner.vector_reset_delta
            self.vector_step_delta = inner.vector_step_delta

    def vector_reset(self):
        return self.inner.vector_reset()

    def vector_step(self, actions):
        return self.inner.vector_step(actions)

    def seed(self, seed=None):
        self.inner.seed(seed)

    def close(self):
        self.inner.close()
