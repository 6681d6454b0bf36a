"""ModelCatalog: spaces → preprocessors, networks, action distributions.

Counterpart of `ray_tpu/models/catalog.py`, with the same
MODEL_DEFAULTS vocabulary (fcnet_hiddens, conv_filters, ...). The
recurrent (`use_lstm`) path waits for a later slice.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..rllib.env.spaces import Box, Discrete
from .distributions import get_action_dist  # re-export  # noqa: F401
from .networks import FullyConnectedNetwork, VisionNetwork

MODEL_DEFAULTS = {
    "fcnet_hiddens": [256, 256],
    "fcnet_activation": "tanh",
    "conv_filters": None,  # None -> nature CNN for image obs
    "vf_share_layers": False,
    "free_log_std": False,
    "use_lstm": False,
    "lstm_cell_size": 256,
    "max_seq_len": 20,
    "framework": "torch",
    # Trunk compute dtype: "auto" defers to RAY_TPU_COMPUTE_DTYPE (the
    # JAX package's knob, read from the environment). At the default
    # f32 each network keeps its own default (the Vision trunk stays
    # bf16); "bf16"/"f32" force it everywhere.
    "compute_dtype": "auto",
}

COMPUTE_DTYPES = {
    "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


def resolve_compute_dtype(value="auto") -> torch.dtype:
    """A `compute_dtype` config value -> torch dtype ("auto" reads
    RAY_TPU_COMPUTE_DTYPE, default f32)."""
    if value in (None, "auto"):
        value = os.environ.get("RAY_TPU_COMPUTE_DTYPE", "f32")
    if isinstance(value, torch.dtype):
        return value
    key = str(value).lower()
    if key not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute dtype {value!r}; known: "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[key]


def _resolve_model_dtype(cfg) -> Optional[torch.dtype]:
    """MODEL_DEFAULTS["compute_dtype"] -> dtype, or None (= keep each
    network's own default)."""
    value = cfg.get("compute_dtype", "auto")
    explicit = value not in (None, "auto")
    dtype = resolve_compute_dtype(value)
    if not explicit and dtype == torch.float32:
        return None
    return dtype


class Preprocessor:
    """obs → flat/typed numpy (parity: `rllib/models/preprocessors.py`).

    Images pass through as uint8 (normalized on the device in the
    network), Discrete becomes one-hot, Box passes through.
    """

    def __init__(self, obs_space):
        self.obs_space = obs_space
        if isinstance(obs_space, Discrete):
            self.shape = (obs_space.n,)
            self.dtype = np.float32
        else:
            self.shape = obs_space.shape
            self.dtype = obs_space.dtype if hasattr(obs_space, "dtype") \
                else np.float32

    def transform(self, obs):
        if isinstance(self.obs_space, Discrete):
            out = np.zeros(self.obs_space.n, dtype=np.float32)
            out[int(obs)] = 1.0
            return out
        return np.asarray(obs, dtype=self.dtype)

    @property
    def is_identity(self) -> bool:
        return not isinstance(self.obs_space, Discrete)

    def transform_batch(self, obs):
        """Vectorized transform for a [num_envs, ...] stack of raw obs."""
        if isinstance(self.obs_space, Discrete):
            idx = np.asarray(obs, dtype=np.int64)
            return np.eye(self.obs_space.n, dtype=np.float32)[idx]
        return np.asarray(obs, dtype=self.dtype)


def get_preprocessor(obs_space) -> Preprocessor:
    return Preprocessor(obs_space)


def is_image_space(obs_space) -> bool:
    return isinstance(obs_space, Box) and len(obs_space.shape) == 3


def get_model(obs_space, num_outputs: int, model_config: dict = None,
              generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Build the network for this observation space (on the CPU; the
    policy moves it). Returns a module whose forward(obs) ->
    (dist_inputs, value). `generator` seeds the initial weights."""
    cfg = dict(MODEL_DEFAULTS)
    cfg.update(model_config or {})
    if cfg["use_lstm"]:
        raise NotImplementedError(
            "use_lstm: the recurrent path is not ported yet")
    dtype = _resolve_model_dtype(cfg)
    kwargs = {} if dtype is None else {"compute_dtype": dtype}
    if is_image_space(obs_space):
        filters = cfg["conv_filters"] or ((32, 8, 4), (64, 4, 2), (64, 3, 1))
        return VisionNetwork(
            obs_space.shape, num_outputs,
            conv_filters=tuple(tuple(f) for f in filters),
            generator=generator, **kwargs)
    return FullyConnectedNetwork(
        int(np.prod(observation_shape(obs_space))), num_outputs,
        hiddens=tuple(cfg["fcnet_hiddens"]),
        activation=cfg["fcnet_activation"],
        vf_share_layers=cfg["vf_share_layers"],
        free_log_std=cfg["free_log_std"],
        generator=generator, **kwargs)


def observation_shape(obs_space) -> Tuple[int, ...]:
    if isinstance(obs_space, Discrete):
        return (obs_space.n,)
    return tuple(obs_space.shape)
