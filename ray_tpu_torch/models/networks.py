"""Policy/value networks as `nn.Module`s.

Counterpart of `ray_tpu/models/networks.py` (`FullyConnectedNetwork`,
`VisionNetwork`, `QNetwork`, and SAC's `StochasticActor` and
`ContinuousQNetwork`); the LSTM network and DDPG's `DeterministicActor`
wait for later slices. As there:

- every policy network returns `(dist_inputs, value)` from one forward
  pass (the actor and critic networks return what their flax modules
  return);
- parameters are float32 masters; the trunk computes in
  `compute_dtype` (bf16 by default for the Vision trunk), casting each
  layer's inputs and parameters at the layer, as flax's
  `Dense(dtype=...)`/`Conv(dtype=...)` do; the logits and value heads
  compute in float32;
- uint8 frames are normalized on the device, so host->device transfers
  stay at 1 byte per pixel. The public input layout stays NHWC uint8.

Layer names match the flax modules' (`conv_0`, `fc`, `logits`, ...), so
`models/convert.py` maps a flax params tree onto `state_dict()` keys
one to one. The conv trunk (shared by `VisionNetwork` and `QNetwork`)
computes NCHW; the first dense layer after it (`fc`, or `QNetwork`'s
`fc_0`) reads the conv output flattened in (C, H, W) order, and the
converter permutes that flax kernel's rows from flax's (H, W, C) order
to match.
Initialization follows flax's defaults: LeCun-normal (truncated)
kernels, zero biases, N(0, 0.01) logits kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

_ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu, "swish": F.silu,
                "elu": F.elu}

# Std of a unit normal truncated to [-2, 2] (flax's lecun_normal).
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def _init_layer(layer: nn.Module, generator: Optional[torch.Generator],
                std: Optional[float] = None) -> None:
    """flax defaults: lecun_normal kernel (or N(0, std)), zero bias."""
    with torch.no_grad():
        if std is None:
            fan_in = layer.weight[0].numel()
            _lecun_normal_(layer.weight, fan_in, generator)
        else:
            layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.zero_()


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class FullyConnectedNetwork(nn.Module):
    """MLP with separate (or shared) policy and value towers.

    `free_log_std` (Box policies): the logits layer emits the d =
    num_outputs / 2 means only, and a state-independent `log_std`
    parameter (zeros at init) is broadcast after them, as in flax."""

    def __init__(self, obs_dim: int, num_outputs: int,
                 hiddens: Sequence[int] = (256, 256),
                 activation: str = "tanh",
                 vf_share_layers: bool = False,
                 free_log_std: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = _ACTIVATIONS[activation]
        self.vf_share_layers = vf_share_layers
        self.compute_dtype = compute_dtype
        self.hidden_names = []
        self.value_names = []
        last = obs_dim
        for i, size in enumerate(hiddens):
            self.add_module(f"fc_{i}", nn.Linear(last, size))
            self.hidden_names.append(f"fc_{i}")
            last = size
        if free_log_std and num_outputs % 2:
            raise ValueError(f"free_log_std needs an even num_outputs, "
                             f"got {num_outputs}")
        num_out = num_outputs // 2 if free_log_std else num_outputs
        self.logits = nn.Linear(last, num_out)
        self.log_std = nn.Parameter(torch.zeros(num_out)) \
            if free_log_std else None
        if vf_share_layers:
            self.value = nn.Linear(last, 1)
        else:
            last_v = obs_dim
            for i, size in enumerate(hiddens):
                self.add_module(f"vf_{i}", nn.Linear(last_v, size))
                self.value_names.append(f"vf_{i}")
                last_v = size
            self.value = nn.Linear(last_v, 1)
        for name in self.hidden_names + self.value_names + ["value"]:
            _init_layer(getattr(self, name), generator)
        _init_layer(self.logits, generator, std=0.01)

    def _tower(self, x, names):
        for name in names:
            x = self.activation(_linear(x, getattr(self, name),
                                        self.compute_dtype))
        return x.float()

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = obs.reshape(obs.shape[0], -1).to(self.compute_dtype)
        h = self._tower(x, self.hidden_names)
        logits = _linear(h, self.logits, torch.float32)
        if self.log_std is not None:
            logits = torch.cat(
                [logits, self.log_std.expand_as(logits)], dim=-1)
        v = h if self.vf_share_layers else self._tower(x, self.value_names)
        value = _linear(v, self.value, torch.float32)
        return logits, value[..., 0]


def _add_convs(module: nn.Module, obs_shape: Sequence[int],
               conv_filters: Sequence[Tuple[int, int, int]]) -> int:
    """Add `conv_0`, `conv_1`, ... (VALID padding) for NHWC frames of
    `obs_shape` to `module`, with `conv_names`, `strides` and
    `conv_out_hw`; returns the flattened output's width."""
    height, width, channels = obs_shape
    module.conv_names = []
    module.strides = []
    for i, (out_ch, k, s) in enumerate(conv_filters):
        module.add_module(f"conv_{i}", nn.Conv2d(channels, out_ch, k, s))
        module.conv_names.append(f"conv_{i}")
        module.strides.append(s)
        channels = out_ch
        height = (height - k) // s + 1  # padding="VALID"
        width = (width - k) // s + 1
    module.conv_out_hw = (height, width)
    return channels * height * width


def _conv_trunk(module: nn.Module, obs: torch.Tensor, cdt: torch.dtype,
                activation) -> torch.Tensor:
    """NHWC uint8 frames -> the conv stack's output in `cdt`, flattened
    in (C, H, W) order."""
    # NHWC uint8 -> NCHW compute dtype, normalized on the device. The
    # divisor is a Python number: a 0-d tensor made on the card here
    # would be a blocking host->device copy, a stream sync per forward.
    x = obs.permute(0, 3, 1, 2).to(cdt) / 255.0
    for name, stride in zip(module.conv_names, module.strides):
        conv = getattr(module, name)
        x = activation(F.conv2d(x, conv.weight.to(cdt), conv.bias.to(cdt),
                                stride=stride))
    return x.reshape(x.shape[0], -1)


class VisionNetwork(nn.Module):
    """Nature-CNN for 84x84xC uint8 frames (NHWC at the input)."""

    def __init__(self, obs_shape: Sequence[int], num_outputs: int,
                 conv_filters: Sequence[Tuple[int, int, int]] = (
                     (32, 8, 4), (64, 4, 2), (64, 3, 1)),
                 hidden: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        flat = _add_convs(self, obs_shape, conv_filters)
        self.fc = nn.Linear(flat, hidden)
        self.logits = nn.Linear(hidden, num_outputs)
        self.value = nn.Linear(hidden, 1)
        for name in self.conv_names + ["fc", "value"]:
            _init_layer(getattr(self, name), generator)
        _init_layer(self.logits, generator, std=0.01)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cdt = self.compute_dtype
        x = _conv_trunk(self, obs, cdt, F.relu)
        h32 = F.relu(_linear(x, self.fc, cdt)).float()
        logits = _linear(h32, self.logits, torch.float32)
        value = _linear(h32, self.value, torch.float32)
        return logits, value[..., 0]


class QNetwork(nn.Module):
    """Q-value network of the DQN family (`networks.py:104-146` in the
    JAX package). Returns `(q, max_a q)`, the policy interface's
    `(dist_inputs, value)`.

    NHWC image observations (a 3-d `obs_shape`) go through the conv
    trunk alone, in `compute_dtype` (bf16 by default), and its
    flattened output is cast to float32; flat observations are
    flattened in float32. Then `hiddens` dense layers with `activation`
    (which the conv layers use too) and the head, in float32: with
    `dueling`, `state_value + advantage - mean(advantage)`, else one
    dense `q` layer. Every layer starts from flax's Dense/Conv defaults
    (LeCun-normal kernels, zero biases)."""

    def __init__(self, obs_shape: Sequence[int], num_actions: int,
                 hiddens: Sequence[int] = (256,),
                 activation: str = "relu",
                 dueling: bool = True,
                 conv_filters: Sequence[Tuple[int, int, int]] = (
                     (32, 8, 4), (64, 4, 2), (64, 3, 1)),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = _ACTIVATIONS[activation]
        self.compute_dtype = compute_dtype
        self.image = len(obs_shape) == 3
        if self.image:
            last = _add_convs(self, obs_shape, conv_filters)
        else:
            self.conv_names = []
            last = int(math.prod(obs_shape))
        self.hidden_names = []
        for i, size in enumerate(hiddens):
            self.add_module(f"fc_{i}", nn.Linear(last, size))
            self.hidden_names.append(f"fc_{i}")
            last = size
        self.dueling = dueling
        heads = ["advantage", "state_value"] if dueling else ["q"]
        if dueling:
            self.advantage = nn.Linear(last, num_actions)
            self.state_value = nn.Linear(last, 1)
        else:
            self.q = nn.Linear(last, num_actions)
        for name in self.conv_names + self.hidden_names + heads:
            _init_layer(getattr(self, name), generator)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.image:
            h = _conv_trunk(self, obs, self.compute_dtype,
                            self.activation).float()
        else:
            h = obs.reshape(obs.shape[0], -1).float()
        for name in self.hidden_names:
            h = self.activation(_linear(h, getattr(self, name),
                                        torch.float32))
        if self.dueling:
            adv = _linear(h, self.advantage, torch.float32)
            value = _linear(h, self.state_value, torch.float32)
            q = value + adv - adv.mean(dim=-1, keepdim=True)
        else:
            q = _linear(h, self.q, torch.float32)
        return q, q.max(dim=-1).values


def _dense_tower(module: nn.Module, prefix: str, in_dim: int,
                 hiddens: Sequence[int], out_dim: int,
                 out_name: str) -> list:
    """Add `{prefix}fc_0`, ... and the `out_name` head to `module`;
    returns the layer names in order."""
    names = []
    last = in_dim
    for i, size in enumerate(hiddens):
        names.append(f"{prefix}fc_{i}")
        module.add_module(names[-1], nn.Linear(last, size))
        last = size
    names.append(out_name)
    module.add_module(out_name, nn.Linear(last, out_dim))
    return names


def _run_tower(module: nn.Module, names: Sequence[str], x: torch.Tensor,
               activation) -> torch.Tensor:
    for name in names[:-1]:
        x = activation(_linear(x, getattr(module, name), torch.float32))
    return _linear(x, getattr(module, names[-1]), torch.float32)


class StochasticActor(nn.Module):
    """pi(s) -> [mean, raw log_std] inputs [B, 2d] of the squashed
    Gaussian (SAC; `networks.py:174-187` in the JAX package): `hiddens`
    dense layers with `activation` on the flattened observation, then
    the `out` layer, all in float32 from flax's Dense defaults."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hiddens: Sequence[int] = (256, 256),
                 activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = _ACTIVATIONS[activation]
        self.layer_names = _dense_tower(self, "", obs_dim, hiddens,
                                        2 * action_dim, "out")
        for name in self.layer_names:
            _init_layer(getattr(self, name), generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.reshape(obs.shape[0], -1).float()
        return _run_tower(self, self.layer_names, x, self.activation)


class ContinuousQNetwork(nn.Module):
    """Q(s, a) (SAC's critic; `networks.py:190-214` in the JAX package):
    one tower (`q1_fc_*`, `q1_out`) over concat(flattened obs, action),
    and with `twin` a second, independent one (`q2_*`). Returns (q1, q2)
    [B] each, or (q1, q1) without `twin`."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hiddens: Sequence[int] = (256, 256),
                 activation: str = "relu", twin: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = _ACTIVATIONS[activation]
        self.twin = twin
        self.towers = [_dense_tower(self, f"{q}_", obs_dim + action_dim,
                                    hiddens, 1, f"{q}_out")
                       for q in (("q1", "q2") if twin else ("q1",))]
        for names in self.towers:
            for name in names:
                _init_layer(getattr(self, name), generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs.reshape(obs.shape[0], -1).float(),
                       action.float()], dim=-1)
        qs = [_run_tower(self, names, x, self.activation)[..., 0]
              for names in self.towers]
        return qs[0], qs[-1]
