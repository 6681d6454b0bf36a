"""Carry weights from the JAX package's flax params to the port.

`flax_to_state_dict(params)` turns a flax params tree (a nested dict of
numpy arrays, as `JaxPolicy.get_weights()` returns it) into a
`state_dict` for the port's network of the same architecture:

- Conv kernels HWIO -> `Conv2d.weight` OIHW;
- Dense kernels [in, out] -> `Linear.weight` [out, in];
- biases, and bare parameter leaves (the FC network's `log_std` with
  `free_log_std`), unchanged.

The one trap: a flax conv trunk flattens its NHWC output in (H, W, C)
order into the dense layer that reads it (the Vision network's `fc`,
the Q network's `fc_0`, or a Q network's heads when it has no hidden
layer), while the port computes NCHW and flattens in (C, H, W) order.
The port keeps its own NCHW flatten and the conversion permutes that
kernel's input rows from (H, W, C) to (C, H, W) instead
(`tests/test_torch_models.py` and `tests/test_torch_dqn.py` prove it).

The way back, for gradients: `flax_leaves` puts each port tensor's
elements in its flax leaf's shape and element order, in flax's
tree-flatten order of the leaves (layers by sorted name, then `bias`
before `kernel`), and `flax_pack_plan` turns that into the packing of
the data-parallel gradient exchange (`parallel/collectives.py`): every
leaf in a block-aligned slot of one buffer, so that the q8 codes,
scales and residuals are the JAX package's, leaf by leaf.
`state_dict_to_flax` builds the flax params tree itself from those
leaves. `flax_leaf_table` describes the same packing per leaf (flat
offset, packed offset, sizes, packed strides) for the exchange's
unpacking kernel, in place of the plan's index per element.

SAC keeps three parameter sets and a target (`sac_policy.py:96-119`):
`sac_weights_from_flax` turns the JAX SAC policy's weights
`{"online": {"actor", "critic", "log_alpha"}, "target": {"critic"}}`
into the port's (a state dict per network, `log_alpha` as a 0-d array)
and `sac_weights_to_flax` goes back; its networks are dense only, so
each layer is the `Linear` transpose.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch


def _layers(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _conv_readers(layer_names) -> set:
    """The dense layers that read the conv trunk's flattened output:
    `fc` (VisionNetwork), else `fc_0` (QNetwork), else, for a QNetwork
    with no hidden layer, its heads; none without convs."""
    names = set(layer_names)
    if not any(n.startswith("conv_") for n in names):
        return set()
    for first in ("fc", "fc_0"):
        if first in names:
            return {first}
    return {n for n in names if not n.startswith("conv_")}


def _conv_out_shape(channels: int, fc_in: int,
                    conv_out_hw: Optional[Tuple[int, int]]):
    """(H, W, C) of a conv output of `channels` channels that a dense
    layer reads as `fc_in` features (square by default)."""
    if conv_out_hw is None:
        side = math.isqrt(fc_in // channels)
        if side * side * channels != fc_in:
            raise ValueError(
                f"fc reads {fc_in} features, not a square map of "
                f"{channels} channels: pass conv_out_hw")
        conv_out_hw = (side, side)
    height, width = conv_out_hw
    if height * width * channels != fc_in:
        raise ValueError(f"conv_out_hw {conv_out_hw} x {channels} channels "
                         f"!= fc input {fc_in}")
    return height, width, channels


def flax_to_state_dict(params: Mapping,
                       conv_out_hw: Optional[Tuple[int, int]] = None
                       ) -> Dict[str, torch.Tensor]:
    """flax params -> port `state_dict` (float32 CPU tensors).

    `conv_out_hw` is the Vision trunk's final (H, W); by default it is
    taken as square from the `fc` kernel's input size."""
    layers = _layers(params)
    readers = _conv_readers(layers)
    if readers:
        last_conv = max((k for k in layers if k.startswith("conv_")),
                        key=lambda k: int(k.split("_")[1]))
        channels = np.asarray(layers[last_conv]["kernel"]).shape[-1]
    out = {}
    for name, leaf in layers.items():
        if not isinstance(leaf, Mapping):  # a bare parameter (log_std)
            out[name] = torch.from_numpy(np.array(leaf, dtype=np.float32))
            continue
        kernel = np.asarray(leaf["kernel"], dtype=np.float32)
        if kernel.ndim == 4:  # HWIO -> OIHW
            weight = kernel.transpose(3, 2, 0, 1)
        elif kernel.ndim == 2:
            if name in readers:
                h, w, c = _conv_out_shape(channels, kernel.shape[0],
                                          conv_out_hw)
                kernel = kernel.reshape(h, w, c, -1).transpose(
                    2, 0, 1, 3).reshape(h * w * c, -1)
            weight = kernel.T
        else:
            raise ValueError(f"{name}: unexpected kernel rank {kernel.ndim}")
        out[f"{name}.weight"] = torch.from_numpy(np.array(weight))
        out[f"{name}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], dtype=np.float32))
    return out


# ---------------------------------------------------------------------
# port -> flax element order (gradients, the exchange's packing)
# ---------------------------------------------------------------------
def _conv_channels(state_dict: Mapping[str, torch.Tensor]) -> int:
    """Output channels of the last conv layer of a port state_dict."""
    convs = [k for k in state_dict
             if k.startswith("conv_") and k.endswith(".weight")]
    last = max(convs, key=lambda k: int(k.split(".")[0].split("_")[1]))
    return state_dict[last].shape[0]


def flax_leaves(state_dict: Mapping[str, torch.Tensor],
                conv_out_hw: Optional[Tuple[int, int]] = None
                ) -> List[Tuple[str, str, torch.Tensor]]:
    """Port tensors (parameters, gradients, or index tensors of their
    shapes) -> [(layer, "bias" | "kernel" | None, tensor in the flax
    leaf's shape and element order)], in flax's tree-flatten order
    (None for a bare parameter such as `log_std`). The inverse of
    `flax_to_state_dict`'s layout map."""
    layers = sorted({k.split(".")[0] for k in state_dict})
    readers = _conv_readers(layers)
    out = []
    for layer in layers:
        if layer in state_dict:  # a bare parameter, no sub-leaves
            out.append((layer, None, state_dict[layer]))
            continue
        weight = state_dict[f"{layer}.weight"]
        if weight.dim() == 4:  # OIHW -> HWIO
            kernel = weight.permute(2, 3, 1, 0)
        elif weight.dim() == 2 and layer in readers:
            # [out, (C, H, W)] -> [(H, W, C), out]
            h, w, c = _conv_out_shape(_conv_channels(state_dict),
                                      weight.shape[1], conv_out_hw)
            kernel = weight.reshape(weight.shape[0], c, h, w).permute(
                2, 3, 1, 0).reshape(h * w * c, -1)
        elif weight.dim() == 2:
            kernel = weight.t()
        else:
            raise ValueError(f"{layer}: unexpected weight rank "
                             f"{weight.dim()}")
        out.append((layer, "bias", state_dict[f"{layer}.bias"]))
        out.append((layer, "kernel", kernel))
    return out


class PackPlan(NamedTuple):
    """Where each gradient element goes in the exchange's packed buffer.

    `pack_index` [nb * block]: for each packed position, the index into
    the concatenation of the flattened gradients (in `parameters()`
    order) followed by one zero, which the padding positions read.
    `unpack_index` [n]: for each element of that concatenation, its
    packed position. `leaf_sizes`: element counts in flax leaf order.
    """
    pack_index: torch.Tensor
    unpack_index: torch.Tensor
    leaf_sizes: List[int]
    nb: int


def flax_pack_plan(model: torch.nn.Module, block: int) -> PackPlan:
    """The packing of `model`'s gradients: each flax leaf, in flax order
    and its own element order, in a slot of whole `block`-element
    blocks, zero-padded to its end."""
    named = dict(model.named_parameters())
    index, offset = {}, 0
    for name, p in named.items():
        index[name] = torch.arange(offset, offset + p.numel()).reshape(
            p.shape)
        offset += p.numel()
    pad = offset  # the zero after the concatenated gradients
    slots, sizes = [], []
    for _, _, idx in flax_leaves(index, getattr(model, "conv_out_hw",
                                                None)):
        flat = idx.reshape(-1)
        n = flat.numel()
        slot = torch.full((-(-n // block) * block,), pad, dtype=torch.long)
        slot[:n] = flat
        slots.append(slot)
        sizes.append(n)
    pack_index = torch.cat(slots)
    unpack_index = torch.empty(offset, dtype=torch.long)
    real = pack_index < pad
    unpack_index[pack_index[real]] = torch.nonzero(real)[:, 0]
    return PackPlan(pack_index, unpack_index, sizes,
                    pack_index.numel() // block)


class LeafLayout(NamedTuple):
    """Where one parameter's elements sit in the exchange's packed buffer,
    as a permutation of a view of at most 4 dimensions (the K6b leaf
    table, `parallel/collectives.py` `Q8Decode`).

    The parameter is seen as [rows, *sizes] in its own (row-major)
    element order, starting at `offset` in the concatenation of the
    flattened parameters (`parameters()` order). Its element (o, i1, i2,
    i3) sits at packed position `packed_offset + (i1 * strides[0] + i2 *
    strides[1] + i3 * strides[2]) * rows + o`: `rows` is the packed
    slot's fastest dimension, `strides` count in packed rows of `rows`
    elements.
    """
    offset: int
    packed_offset: int
    rows: int
    sizes: Tuple[int, int, int]
    strides: Tuple[int, int, int]

    @property
    def numel(self) -> int:
        return self.rows * math.prod(self.sizes)


def _leaf_layouts(named: Mapping[str, torch.Tensor],
                  conv_out_hw: Optional[Tuple[int, int]]):
    """(parameter name, rows, sizes, strides) of each flax leaf in flax's
    tree-flatten order: the index form of `flax_leaves`' layout map."""
    layers = sorted({k.split(".")[0] for k in named})
    readers = _conv_readers(layers)
    for layer in layers:
        if layer in named:  # a bare parameter: the identity
            yield layer, 1, (1, 1, named[layer].numel()), (0, 0, 1)
            continue
        yield (f"{layer}.bias", 1, (1, 1, named[f"{layer}.bias"].numel()),
               (0, 0, 1))
        shape = tuple(named[f"{layer}.weight"].shape)
        if len(shape) == 4:  # OIHW -> HWIO: (i, h, w) -> (h * W + w) * I + i
            out, cin, h, w = shape
            yield f"{layer}.weight", out, (cin, h, w), (1, w * cin, cin)
        elif len(shape) == 2 and layer in readers:
            # [out, (C, H, W)] -> [(H, W, C), out]
            h, w, c = _conv_out_shape(_conv_channels(named), shape[1],
                                      conv_out_hw)
            yield f"{layer}.weight", shape[0], (c, h, w), (1, w * c, c)
        elif len(shape) == 2:  # [out, in] -> [in, out]
            yield f"{layer}.weight", shape[0], (1, 1, shape[1]), (0, 0, 1)
        else:
            raise ValueError(f"{layer}: unexpected weight rank {len(shape)}")


def flax_leaf_table(model: torch.nn.Module, block: int) -> List[LeafLayout]:
    """The layout of each of `model`'s parameters (in `parameters()`
    order) in `flax_pack_plan(model, block)`'s packed buffer: per leaf a
    flat offset, a packed offset, sizes and packed strides, in place of
    an index per element. `unpack_leaves(arange, table)` reproduces the
    plan's `unpack_index`."""
    named = dict(model.named_parameters())
    offsets, offset = {}, 0
    for name, p in named.items():
        offsets[name] = offset
        offset += p.numel()
    table, packed = {}, 0
    for name, rows, sizes, strides in _leaf_layouts(
            named, getattr(model, "conv_out_hw", None)):
        leaf = LeafLayout(offsets[name], packed, rows, sizes, strides)
        if leaf.numel != named[name].numel():
            raise ValueError(f"{name}: layout of {leaf.numel} elements for "
                             f"{named[name].numel()}")
        table[name] = leaf
        packed += -(-leaf.numel // block) * block
    return [table[name] for name in named]


def unpack_leaves(packed: torch.Tensor, table: List[LeafLayout]
                  ) -> torch.Tensor:
    """The packed buffer's leaves back in `parameters()` element order
    (one strided view per leaf, concatenated): the plain form of K6b's
    unpacking. `packed` is a contiguous 1-D tensor."""
    base = packed.storage_offset()
    parts = []
    for leaf in table:
        r = leaf.rows
        parts.append(torch.as_strided(
            packed, (r,) + tuple(leaf.sizes),
            (1,) + tuple(s * r for s in leaf.strides),
            base + leaf.packed_offset).reshape(-1))
    return torch.cat(parts)


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor],
                       conv_out_hw: Optional[Tuple[int, int]] = None
                       ) -> Dict[str, Dict]:
    """Port `state_dict` -> flax params tree `{"params": {layer:
    {"kernel", "bias"}}}` of float32 numpy arrays: the inverse of
    `flax_to_state_dict`."""
    layers = {}
    for layer, kind, tensor in flax_leaves(state_dict, conv_out_hw):
        value = np.array(tensor.detach().cpu().numpy(), dtype=np.float32)
        if kind is None:
            layers[layer] = value
        else:
            layers.setdefault(layer, {})[kind] = value
    return {"params": layers}


def sac_weights_from_flax(weights: Mapping) -> Dict[str, Dict]:
    """The JAX SAC policy's `get_weights()` (flax trees, numpy leaves) ->
    the port's `SACPolicy.set_weights` input."""
    def sd(tree):
        return {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}

    online, target = weights["online"], weights["target"]
    return {"online": {"actor": sd(online["actor"]),
                       "critic": sd(online["critic"]),
                       "log_alpha": np.asarray(online["log_alpha"],
                                               np.float32)},
            "target": {"critic": sd(target["critic"])}}


def sac_weights_to_flax(weights: Mapping) -> Dict[str, Dict]:
    """The port's `SACPolicy.get_weights()` -> the JAX SAC policy's
    weights layout."""
    def tree(state):
        return state_dict_to_flax({k: torch.as_tensor(np.asarray(v))
                                   for k, v in state.items()})

    online, target = weights["online"], weights["target"]
    return {"online": {"actor": tree(online["actor"]),
                       "critic": tree(online["critic"]),
                       "log_alpha": np.asarray(online["log_alpha"],
                                               np.float32)},
            "target": {"critic": tree(target["critic"])}}
