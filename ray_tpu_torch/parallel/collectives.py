"""The learner's gradient exchange: fp32 all-reduce or the q8
block-quantized all-reduce with error feedback.

Counterpart of `ray_tpu/parallel/collectives.py`. There each replica of
a `shard_map` quantized its local gradient (plus its carried residual)
to int8 with one f32 scale per `Q8_BLOCK` elements, `all_gather`ed
codes and scales over the mesh axis and summed every sender's
dequantized contribution in f32. Here each rank of a `torch.distributed`
world does the same over a `LearnerGroup` (`parallel/mesh.py`), on one
packed buffer:

- the gradient is packed in the JAX package's element order, each
  parameter leaf in a block-aligned slot zero-padded to its block
  boundary (`models/convert.py` `flax_pack_plan`), so one launch
  encodes every leaf with the codes of per-leaf encoding;
- K6a `q8_encode_ef` (`csrc/q8.cu`) adds the residual, quantizes, and
  writes the codes and scales into one byte buffer, the wire image, and
  the new residual in place;
- the transport all-gathers the wire images;
- K6b `q8_gather_sum` dequantizes every sender's image and sums them in
  rank order in f32 (divided by the world size for a mean); with a
  model's leaf table (`Q8Decode`, built once per model) it writes the
  sum straight in `parameters()` order, the unpacking gather fused in.

Each kernel's wrapper launches it on CUDA tensors and runs its plain
PyTorch version, the same arithmetic, on CPU tensors only.

The exchange is a psum: the gradient of the global-batch loss when the
loss sums over rows, as XLA's implicit psum gave the fp32 program. (The
JAX q8 path divides by the device count whatever the loss; the port
divides only for a loss that is a mean over rows.)
"""

from __future__ import annotations

import ctypes
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from .._private.cuda_build import (CudaKernel, device_stream_handle,
                                   stream_handle)
from .._private.serialization import Q8_BLOCK, Q8_SCALE_EPS
from ..models.convert import LeafLayout, unpack_leaves


CODECS = ("fp32", "q8")
# `allreduce_codec: "auto"` reads this environment variable (the
# registry knob of `ray_tpu/_private/config.py:97`), default fp32.
CODEC_ENV = "RAY_TPU_ALLREDUCE_CODEC"

# K6a and K6b: see the source note in csrc/q8.cu.
Q8_ENCODE_KERNEL = CudaKernel(
    "q8_encode_ef", "q8.cu", "q8_encode_ef",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p])
Q8_GATHER_SUM_KERNEL = CudaKernel(
    "q8_gather_sum", "q8.cu", "q8_gather_sum",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p])
# K6b's form with the leaf table (the exchange's path, `Q8Decode`).
Q8_GATHER_UNPACK_KERNEL = CudaKernel(
    "q8_gather_sum_unpack", "q8.cu", "q8_gather_sum_unpack",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def resolve_codec(value=None) -> str:
    """An `allreduce_codec` config value -> "fp32" | "q8"; "auto" (or
    None) reads `RAY_TPU_ALLREDUCE_CODEC`, default "fp32"."""
    if value in (None, "auto"):
        import os
        value = os.environ.get(CODEC_ENV, "fp32")
    value = str(value).lower()
    if value not in CODECS:
        raise ValueError(
            f"unknown allreduce codec {value!r}; known: {CODECS}")
    return value


# ---------------------------------------------------------------------
# the wire image: int8 codes [nb * Q8_BLOCK], then f32 scales [nb]
# ---------------------------------------------------------------------
def wire_size(nb: int) -> int:
    """Bytes of one sender's wire image for `nb` blocks."""
    return nb * Q8_BLOCK + 4 * nb


def wire_views(wire: torch.Tensor, nb: int):
    """(codes int8 [..., nb*Q8_BLOCK], scales f32 [..., nb]) views of a
    uint8 wire image [..., wire_size(nb)] (one row per sender)."""
    n = nb * Q8_BLOCK
    return wire[..., :n].view(torch.int8), wire[..., n:].view(torch.float32)


def num_blocks(packed: torch.Tensor) -> int:
    if packed.dim() != 1 or packed.numel() % Q8_BLOCK or not packed.numel():
        raise ValueError(
            f"the packed gradient is a non-empty 1-D buffer of whole "
            f"{Q8_BLOCK}-element blocks, got {tuple(packed.shape)}")
    return packed.numel() // Q8_BLOCK


def _check(name: str, x: torch.Tensor, dtype, device,
           align: int = 4) -> None:
    """Dtype, device, contiguity, and the address alignment of the
    kernels' vector loads (float4: 16 bytes; char4 and f32: 4)."""
    if x.dtype != dtype:
        raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")


# ---------------------------------------------------------------------
# K6a: encode with error feedback
# ---------------------------------------------------------------------
def _q8_encode_ef_plain(packed: torch.Tensor, ef: torch.Tensor,
                        wire: torch.Tensor) -> None:
    """Plain version of K6a: the numpy `q8_quantize` arithmetic in f32
    tensor ops (every division by a tensor: a CUDA division by a Python
    scalar multiplies by its reciprocal; `torch.round` rounds half to
    even like `np.rint`), with the residual add and write."""
    nb = packed.numel() // Q8_BLOCK
    v = (packed + ef).view(nb, Q8_BLOCK)
    amax = v.abs().amax(dim=1)
    scales = torch.maximum(amax / torch.full_like(amax, 127.0),
                           torch.full_like(amax, Q8_SCALE_EPS))
    q = torch.clamp(torch.round(v / scales[:, None]), -127.0, 127.0)
    ef.copy_((v - q * scales[:, None]).view(-1))
    codes, out_scales = wire_views(wire, nb)
    codes.copy_(q.view(-1).to(torch.int8))
    out_scales.copy_(scales)


def q8_encode_ef(packed: torch.Tensor, ef: torch.Tensor,
                 wire: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v = packed + ef per element; per block of Q8_BLOCK: scale =
    max(amax|v| / 127, Q8_SCALE_EPS), q = clip(rint(v / scale), ±127);
    ef <- v - q * scale (in place). Returns the uint8 wire image
    [wire_size(nb)]: the codes, then the scales."""
    nb = num_blocks(packed)
    _check("packed gradient", packed, torch.float32, packed.device, 16)
    _check("residual", ef, torch.float32, packed.device, 16)
    if ef.shape != packed.shape:
        raise ValueError(f"residual is {tuple(ef.shape)}, gradient "
                         f"{tuple(packed.shape)}")
    if wire is None:
        wire = torch.empty(wire_size(nb), dtype=torch.uint8,
                           device=packed.device)
    _check("wire", wire, torch.uint8, packed.device)
    if wire.shape != (wire_size(nb),):
        raise ValueError(f"wire is {tuple(wire.shape)}, expected "
                         f"{(wire_size(nb),)}")
    if packed.device.type == "cpu":
        _q8_encode_ef_plain(packed, ef, wire)
    elif packed.device.type == "cuda":
        Q8_ENCODE_KERNEL.launch(packed.data_ptr(), ef.data_ptr(),
                                wire.data_ptr(), nb, stream_handle(packed))
    else:
        raise ValueError(f"no q8 encode kernel for {packed.device}")
    return wire


def q8_decode(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """One sender's reconstruction: f32(q) * scale of its block (the
    numpy `q8_dequantize` arithmetic)."""
    nb = scales.numel()
    return (codes.view(nb, Q8_BLOCK).float() * scales[:, None]).view(-1)


# ---------------------------------------------------------------------
# K6b: dequantize and sum every sender's image
# ---------------------------------------------------------------------
def _q8_gather_sum_plain(gathered: torch.Tensor, nb: int,
                         mean: bool) -> torch.Tensor:
    """Plain version of K6b: f32 sum over senders in rank order of
    q * scale (each product rounded, then added), divided by D (by a
    tensor) for a mean."""
    codes, scales = wire_views(gathered, nb)
    acc = torch.zeros(nb * Q8_BLOCK, dtype=torch.float32,
                      device=gathered.device)
    for s in range(gathered.shape[0]):
        acc = acc + q8_decode(codes[s], scales[s])
    if mean:
        acc = acc / torch.full_like(acc, float(gathered.shape[0]))
    return acc


def q8_gather_sum(gathered: torch.Tensor, nb: int,
                  mean: bool = False) -> torch.Tensor:
    """Σ over senders s = 0..D-1 (in order) of q_s * scale_s, in f32,
    from the gathered uint8 wire images [D, wire_size(nb)]; divided by
    D when `mean`. Returns f32 [nb * Q8_BLOCK]."""
    if gathered.dim() != 2 or gathered.shape[1] != wire_size(nb) \
            or not gathered.shape[0]:
        raise ValueError(f"gathered wire images are "
                         f"{tuple(gathered.shape)}, expected "
                         f"[D, {wire_size(nb)}]")
    _check("gathered wire images", gathered, torch.uint8, gathered.device)
    if gathered.device.type == "cpu":
        return _q8_gather_sum_plain(gathered, nb, mean)
    if gathered.device.type != "cuda":
        raise ValueError(f"no q8 gather-sum kernel for {gathered.device}")
    out = torch.empty(nb * Q8_BLOCK, dtype=torch.float32,
                      device=gathered.device)
    Q8_GATHER_SUM_KERNEL.launch(gathered.data_ptr(), out.data_ptr(), nb,
                                gathered.shape[0], int(mean),
                                stream_handle(gathered))
    return out


# ---------------------------------------------------------------------
# K6b with the leaf table: the sum in parameters() order
# ---------------------------------------------------------------------
# A tile of the unpacking kernel: 4,096 elements of one leaf, at most 64
# rows (csrc/q8.cu kTileElems, kMaxTileRows); 16 ints per tile. Flags:
# char4 code loads (the leaf's rows a multiple of 4), float4 output rows
# (every row of the tile on a 16-byte boundary).
UNPACK_TILE = 4096
UNPACK_TILE_ROWS = 64
UNPACK_TILE_FIELDS = 16
UNPACK_VEC_IN, UNPACK_VEC_OUT = 1, 2


def q8_unpack_tiles(table: List[LeafLayout]) -> np.ndarray:
    """The unpacking kernel's grid: int32 [num_tiles, 16], one block per
    tile (the record's fields are listed in csrc/q8.cu). A leaf of `rows`
    rows and `row_len` columns is cut into tiles of tp rows (the largest
    power of two up to min(rows, 64)) by 4096 / tp columns."""
    records = []
    for leaf in table:
        rows, (_, d2, d3) = leaf.rows, leaf.sizes
        row_len = leaf.numel // rows
        tp = 1 << min(rows.bit_length(), UNPACK_TILE_ROWS.bit_length()) - 1
        tr = UNPACK_TILE // tp
        for o0 in range(0, rows, tp):
            for r0 in range(0, row_len, tr):
                out0, cols = leaf.offset + o0 * row_len + r0, min(
                    tr, row_len - r0)
                flags = (UNPACK_VEC_IN if rows % 4 == 0 else 0) | (
                    UNPACK_VEC_OUT if out0 % 4 == 0 and row_len % 4 == 0
                    and cols % 4 == 0 else 0)
                records.append([
                    out0, row_len, leaf.packed_offset + o0, rows,
                    tp.bit_length() - 1, tr.bit_length() - 1,
                    min(tp, rows - o0), cols, r0, d2 * d3, d3,
                    *leaf.strides, flags, 0])
    return np.asarray(records, dtype=np.int32).reshape(
        -1, UNPACK_TILE_FIELDS)


def _q8_gather_sum_unpack_plain(gathered: torch.Tensor, nb: int,
                                mean: bool, table: List[LeafLayout]
                                ) -> torch.Tensor:
    """Plain version of K6b with the leaf table: the packed sum, then each
    leaf's strided view of it in `parameters()` order."""
    return unpack_leaves(_q8_gather_sum_plain(gathered, nb, mean), table)


class Q8Decode:
    """The decode of one model's q8 exchange: K6b with the model's leaf
    table (`models/convert.py` `flax_leaf_table`), the world's gradient
    written straight in `parameters()` order.

    Built once, where the policy builds its packing plan: the table's
    tiles on the device, the output buffer, `nb` and the element count.
    A call checks only the gathered wire images and returns the output
    buffer, which the next call overwrites (the policy's `p.grad` views
    of it live until its next `zero_grad`). On the CPU a call runs the
    plain version and returns a fresh tensor."""

    def __init__(self, table: List[LeafLayout], nb: int, device):
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"no q8 gather-sum kernel for {device}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.table, self.nb, self.device = list(table), nb, device
        self.numel = sum(leaf.numel for leaf in self.table)
        packed_end = max(leaf.packed_offset + leaf.numel
                         for leaf in self.table)
        if packed_end > nb * Q8_BLOCK or self.numel >= 1 << 31:
            raise ValueError(f"the leaf table ({self.numel} elements up to "
                             f"packed {packed_end}) does not fit {nb} "
                             "blocks in int32 positions")
        self.wire = wire_size(nb)
        tiles = q8_unpack_tiles(self.table)
        self.num_tiles = len(tiles)
        self.cuda = device.type == "cuda"
        if not self.cuda:
            return
        self.index = device.index
        self.tiles = torch.from_numpy(tiles.reshape(-1)).to(device)
        self.out = torch.empty(self.numel, dtype=torch.float32,
                               device=device)

    def __call__(self, gathered: torch.Tensor, mean: bool) -> torch.Tensor:
        """Σ over senders (in order) of q_s * scale_s, divided by D when
        `mean`, in `parameters()` order: f32 [numel]."""
        if gathered.dtype is not torch.uint8 or gathered.dim() != 2 \
                or gathered.shape[1] != self.wire \
                or not gathered.shape[0] \
                or gathered.device != self.device \
                or not gathered.is_contiguous():
            raise ValueError(
                f"gathered wire images must be contiguous uint8 [D, "
                f"{self.wire}] on {self.device}, got {gathered.dtype} "
                f"{tuple(gathered.shape)} on {gathered.device}")
        if not self.cuda:
            return _q8_gather_sum_unpack_plain(gathered, self.nb, mean,
                                               self.table)
        Q8_GATHER_UNPACK_KERNEL.launch(
            gathered.data_ptr(), self.out.data_ptr(), self.nb,
            gathered.shape[0], int(mean), self.tiles.data_ptr(),
            self.num_tiles, device_stream_handle(self.index))
        return self.out


# ---------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------
def psum_quantized(packed: torch.Tensor, ef: torch.Tensor, group,
                   mean: bool = False,
                   decode: Optional[Q8Decode] = None) -> torch.Tensor:
    """The q8 all-reduce of one packed gradient over `group`: encode
    (updating this rank's residual `ef` in place), all-gather the wire
    images, dequantize and sum (divided by the world size when `mean`).
    Every rank gets the same result: the packed sum, or with `decode`
    the sum in its model's `parameters()` order."""
    gathered = group.all_gather(q8_encode_ef(packed, ef))
    if decode is not None:
        return decode(gathered, mean)
    return q8_gather_sum(gathered, num_blocks(packed), mean)


def pmean_quantized(packed: torch.Tensor, ef: torch.Tensor,
                    group) -> torch.Tensor:
    """psum_quantized / world size (the division fused into K6b)."""
    return psum_quantized(packed, ef, group, mean=True)


def ef_zeros(nb: int, device) -> torch.Tensor:
    """The initial error-feedback residual of a packed gradient of `nb`
    blocks: f32 zeros, this rank's own."""
    return torch.zeros(nb * Q8_BLOCK, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------
def payload_bytes(leaf_sizes: Iterable[int], codec: str) -> int:
    """Per-sender payload bytes of one all-reduce, JAX's analytic count:
    fp32 4 bytes per element; q8 1 byte per element plus one f32 scale
    per Q8_BLOCK elements of each leaf (no padding counted)."""
    total = 0
    for n in leaf_sizes:
        if codec == "q8":
            total += n + 4 * max(1, -(-n // Q8_BLOCK))
        else:
            total += 4 * n
    return total


def wire_bytes(leaf_sizes: Iterable[int], codec: str) -> int:
    """Bytes one sender actually puts on the wire per all-reduce: q8
    sends every leaf's block-aligned slot, padding included; fp32 the
    unpadded f32 gradient."""
    sizes = list(leaf_sizes)
    if codec == "q8":
        return wire_size(sum(max(1, -(-n // Q8_BLOCK)) for n in sizes))
    return 4 * sum(sizes)


def allreduce_probe_s(group, leaf_sizes: Iterable[int], codec: str,
                      iters: int = 3) -> float:
    """Median wall seconds of one standalone exchange of gradient-shaped
    zeros over `group` (every rank must call it): the q8 exchange
    (encode, all-gather, gather-sum, with a residual of its own) or the
    fp32 all-reduce, synchronized at both ends."""
    sizes = list(leaf_sizes)
    device = group.device
    if codec == "q8":
        nb = sum(max(1, -(-n // Q8_BLOCK)) for n in sizes)
        zeros = torch.zeros(nb * Q8_BLOCK, dtype=torch.float32,
                            device=device)
        ef = ef_zeros(nb, device)

        def step():
            psum_quantized(zeros, ef, group)
    else:
        zeros = torch.zeros(sum(sizes), dtype=torch.float32, device=device)

        def step():
            group.all_reduce_(zeros)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step()  # first use: kernel load, communicator setup
    times = []
    for _ in range(max(1, iters)):
        sync()
        t0 = time.perf_counter()
        step()
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
