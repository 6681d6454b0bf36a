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
  rank order in f32 (divided by the world size for a mean).

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
from typing import Iterable, Optional

import torch

from .._private.cuda_build import CudaKernel, stream_handle
from .._private.serialization import Q8_BLOCK, Q8_SCALE_EPS


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
# the exchange
# ---------------------------------------------------------------------
def psum_quantized(packed: torch.Tensor, ef: torch.Tensor, group,
                   mean: bool = False) -> torch.Tensor:
    """The q8 all-reduce of one packed gradient over `group`: encode
    (updating this rank's residual `ef` in place), all-gather the wire
    images, dequantize and sum (divided by the world size when `mean`).
    Every rank gets the same result."""
    gathered = group.all_gather(q8_encode_ef(packed, ef))
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
