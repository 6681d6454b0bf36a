"""Declarative policy factory.

Counterpart of `ray_tpu/rllib/policy/jax_policy_template.py`
(`build_jax_policy`; parity: `rllib/policy/tf_policy_template.py:13`):
a policy class from a loss function and its default config (whose
`loss_state` entry seeds `TorchPolicy.loss_state`). The other
hooks of `build_jax_policy` (postprocess, extra action outputs, custom
models/optimizers, mixins) come with the algorithms that use them.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..utils.config import deep_merge
from .torch_policy import TorchPolicy


def build_torch_policy(name: str,
                       loss_fn: Callable,
                       loss_reduction: str,
                       get_default_config: Optional[Callable] = None,
                       *,
                       module: str):
    """Returns a TorchPolicy subclass named `name`. `loss_reduction`
    ("sum" or "mean") declares how `loss_fn` reduces over rows: the
    data-parallel gradient exchange divides by the world size only for
    "mean" (`TorchPolicy._exchange_gradients`). The class belongs to
    `module` (the caller's `__name__`) under `name`: the caller binds it
    to `name` at module level, so that plain pickle ships it by
    reference (a remote rollout worker gets it so)."""

    def __init__(self, observation_space, action_space, config):
        cfg = deep_merge(
            {}, get_default_config() if get_default_config else {})
        deep_merge(cfg, config)
        TorchPolicy.__init__(self, observation_space, action_space, cfg,
                             loss_fn=loss_fn, loss_reduction=loss_reduction)

    return type(name, (TorchPolicy,), {
        "__init__": __init__, "__module__": module, "__qualname__": name})
