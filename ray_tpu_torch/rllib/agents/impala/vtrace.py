"""V-trace off-policy actor-critic targets (IMPALA).

Counterpart of `ray_tpu/rllib/agents/impala/vtrace.py`
(`from_importance_weights`, `from_logits`), itself the DeepMind
reference implementation. All inputs are time-major [T, B].

`from_importance_weights` runs the hand-written CUDA kernel
`csrc/vtrace.cu` (K1: a block per tile of batch columns stages the
inputs through shared memory, computes each step's terms with all its
threads, and one thread per column walks the reverse recursion) on CUDA
tensors, and its plain PyTorch version `_from_importance_weights_plain`
on CPU tensors. The kernel reads strided [T, B] views in place: the
learner's batch-major columns, which `vtrace_policy._time_major` hands
over transposed, reach it with no copy. Its outputs are targets: the
JAX loss `stop_gradient`s them, so here they are computed from detached
inputs and carry no gradient.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from ...._private.cuda_build import CudaKernel, device_stream_handle

VTraceReturns = collections.namedtuple("VTraceReturns", ["vs", "pg_advantages"])

# K1: see the source note in csrc/vtrace.cu. Each [T, B] input goes with
# its (stride_t, stride_b) in elements, the bootstrap with its stride.
VTRACE_KERNEL = CudaKernel(
    "vtrace", "vtrace.cu", "vtrace_forward",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 4
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_void_p])

# K1's launch plan. A block stages a tile of at most one warp's 32 columns
# (one walker thread each), a power of two from 8, enough tiles for about
# two blocks on each of an H100's 132 SMs (on the card, 16 x 4096 ran
# fastest in tiles of 16 and 50 x 32 in tiles of 8). Its shared memory (the
# kernel's `shared_bytes`: the staged inputs, two stages when T takes more
# than one chunk, and the work arrays) stays within the default 48 KB a
# block gets without opting in (the kernel's kMaxSharedBytes).
VTRACE_TARGET_BLOCKS = 2 * 132
VTRACE_MIN_TILE, VTRACE_MAX_TILE = 8, 32
VTRACE_SHARED_BYTES = 48 * 1024
VTRACE_INPUTS = 4

VTracePlan = collections.namedtuple(
    "VTracePlan", ["tile", "chunk", "tiles", "chunks", "stages",
                   "shared_bytes"])


def _line_pitch(length: int) -> int:
    """Floats between two staged lines of `length` elements (the kernel's
    `line_pitch`): the line from the 16-byte boundary before it in whole
    16-byte vectors, an odd number of them."""
    vectors = (length + 6) // 4
    return 4 * (vectors + 1 - vectors % 2)


def vtrace_shared_bytes(T: int, tile: int, chunk: int) -> int:
    """The kernel's `shared_bytes`: each input's staged chunk (columns of
    `chunk` steps or rows of `tile` columns, whichever is larger), in two
    stages when T takes more than one chunk; four [chunk][tile + 1] work
    arrays, vs in [chunk + 1][tile + 1], and V at a chunk's end per
    column."""
    stages = 2 if T > chunk else 1
    slot = max(tile * _line_pitch(chunk), chunk * _line_pitch(tile))
    ld = tile + 1
    return 4 * (stages * VTRACE_INPUTS * slot + 4 * chunk * ld
                + (chunk + 1) * ld + tile)


@functools.lru_cache(maxsize=256)
def vtrace_plan(T: int, B: int) -> VTracePlan:
    """K1's grid for [T, B] inputs: `tiles` blocks of `tile` columns
    (block j takes columns [j * tile, min((j + 1) * tile, B)); the last
    may be ragged), each walking `chunks` chunks of `chunk` steps from the
    end (chunk c takes steps [max(0, T - (c + 1) * chunk), T - c * chunk);
    the earliest may be short), staged in `stages` buffers; the launch
    takes `shared_bytes`. T is one chunk when that fits the shared memory;
    otherwise chunks as equal as the limit allows, double-buffered."""
    want = -(-B // VTRACE_TARGET_BLOCKS)
    tile = VTRACE_MIN_TILE
    while tile < min(want, VTRACE_MAX_TILE):
        tile *= 2
    T = max(T, 1)
    chunk = T
    if vtrace_shared_bytes(T, tile, T) > VTRACE_SHARED_BYTES:
        longest = T - 1
        while vtrace_shared_bytes(T, tile, longest) > VTRACE_SHARED_BYTES:
            longest -= 1
        chunk = -(-T // -(-T // longest))
    chunks = -(-T // chunk)
    return VTracePlan(tile, chunk, -(-B // tile), chunks,
                      2 if chunks > 1 else 1,
                      vtrace_shared_bytes(T, tile, chunk))


def _input_arg(name: str, x: torch.Tensor, shape, index: int, device):
    """(address, *strides) of one K1 input; raises on what the kernel
    cannot take. The stride of a dimension of size 1 is never read, and
    goes as 1; a [T, B] input needs a unit stride along one dimension (the
    [B] bootstrap is read with any)."""
    if x.shape != shape:
        raise ValueError(f"vtrace kernel: {name} is {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"vtrace kernel: {name} is {x.dtype}, expected "
                         "float32")
    if x.get_device() != index:
        raise ValueError(f"vtrace kernel: {name} is on {x.device}, "
                         f"log_rhos on {device}")
    strides = tuple(1 if n == 1 else st for n, st in zip(shape, x.stride()))
    if len(shape) == 2 and 1 not in strides:
        raise ValueError(f"vtrace kernel: {name} has strides "
                         f"{x.stride()}; it reads [T, B] inputs with a "
                         "unit stride along T or B")
    return (x.data_ptr(), *strides)


def vtrace_kernel_args(log_rhos, discounts, rewards, values,
                       bootstrap_value):
    """K1's input arguments as the C entry takes them: (address, stride_t,
    stride_b) for each [T, B] input in the order log_rhos, discounts,
    rewards, values, then (address, stride) of the [B] bootstrap. The
    tensors are read where they lie, strided as they are (nothing is
    copied): time-major (stride_b = 1) and batch-major (stride_t = 1)
    float32 inputs on one device are taken; an input of another layout,
    shape, type or device raises a ValueError that names it."""
    if log_rhos.dim() != 2:
        raise ValueError(f"vtrace kernel takes [T, B] inputs, got "
                         f"{tuple(log_rhos.shape)}")
    shape = log_rhos.shape
    index, device = log_rhos.get_device(), log_rhos.device
    return (_input_arg("log_rhos", log_rhos, shape, index, device)
            + _input_arg("discounts", discounts, shape, index, device)
            + _input_arg("rewards", rewards, shape, index, device)
            + _input_arg("values", values, shape, index, device)
            + _input_arg("bootstrap_value", bootstrap_value, shape[1:],
                         index, device))


def _from_importance_weights_plain(log_rhos, discounts, rewards, values,
                                   bootstrap_value, clip_rho_threshold,
                                   clip_pg_rho_threshold, lambda_):
    """Plain PyTorch version of K1: the JAX function's arithmetic, with
    the reverse `lax.scan` as a Python loop over T."""
    rhos = torch.exp(log_rhos)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold) \
        if clip_rho_threshold is not None else rhos
    cs = lambda_ * torch.clamp(rhos, max=1.0)
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)

    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = []
    for t in range(log_rhos.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v.append(acc)
    vs = torch.stack(vs_minus_v[::-1], dim=0) + values

    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = torch.clamp(rhos, max=clip_pg_rho_threshold) \
        if clip_pg_rho_threshold is not None else rhos
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * vs_t_plus_1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)


def _from_importance_weights_cuda(log_rhos, discounts, rewards, values,
                                  bootstrap_value, clip_rho_threshold,
                                  clip_pg_rho_threshold, lambda_):
    """Launch K1 on float32 time-major or batch-major [T, B] inputs and a
    [B] bootstrap, all on one CUDA device; allocates the contiguous [T, B]
    outputs (one allocation for both)."""
    args = vtrace_kernel_args(log_rhos, discounts, rewards, values,
                              bootstrap_value)
    T, B = log_rhos.shape
    plan = vtrace_plan(T, B)
    vs, pg_advantages = torch.empty(
        (2, T, B), dtype=torch.float32, device=log_rhos.device).unbind(0)
    VTRACE_KERNEL.launch(
        *args, vs.data_ptr(), pg_advantages.data_ptr(), T, B, plan.tile,
        plan.chunk,
        math.inf if clip_rho_threshold is None else clip_rho_threshold,
        math.inf if clip_pg_rho_threshold is None
        else clip_pg_rho_threshold, lambda_,
        device_stream_handle(log_rhos.get_device()))
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)


def from_importance_weights(log_rhos,
                            discounts,
                            rewards,
                            values,
                            bootstrap_value,
                            clip_rho_threshold: Optional[float] = 1.0,
                            clip_pg_rho_threshold: Optional[float] = 1.0,
                            lambda_: float = 1.0) -> VTraceReturns:
    """V-trace targets from log importance weights.

    Args (all time-major):
      log_rhos: [T, B] log(pi_target(a|x) / pi_behaviour(a|x)).
      discounts: [T, B] discount at each step (0 at terminal steps).
      rewards, values: [T, B].
      bootstrap_value: [B] value estimate for the state after step T-1.
      clip_*_threshold: None means no clip.

    Returns VTraceReturns(vs=[T, B], pg_advantages=[T, B]), detached:
    they are fixed-point targets. CUDA inputs launch K1 (or raise), which
    reads time-major and batch-major views in place; CPU inputs take the
    plain version.
    """
    if log_rhos.is_cuda:
        return _from_importance_weights_cuda(
            log_rhos, discounts, rewards, values, bootstrap_value,
            clip_rho_threshold, clip_pg_rho_threshold, lambda_)
    if log_rhos.device.type != "cpu":
        raise ValueError(f"no vtrace kernel for {log_rhos.device}")
    args = [x.detach().contiguous() for x in
            (log_rhos, discounts, rewards, values, bootstrap_value)]
    with torch.no_grad():
        return _from_importance_weights_plain(
            *args, clip_rho_threshold, clip_pg_rho_threshold, lambda_)


def from_logits(behaviour_policy_logits,
                target_policy_logits,
                actions,
                discounts,
                rewards,
                values,
                bootstrap_value,
                dist_class,
                clip_rho_threshold: Optional[float] = 1.0,
                clip_pg_rho_threshold: Optional[float] = 1.0,
                lambda_: float = 1.0):
    """V-trace from behaviour/target distribution parameters.

    Returns (VTraceReturns, log_rhos, target_logp). The two logps stay
    plain PyTorch: `target_logp` carries the policy gradient.
    """
    behaviour_logp = dist_class(behaviour_policy_logits).logp(actions)
    target_logp = dist_class(target_policy_logits).logp(actions)
    log_rhos = target_logp - behaviour_logp
    returns = from_importance_weights(
        log_rhos=log_rhos, discounts=discounts, rewards=rewards,
        values=values, bootstrap_value=bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
        lambda_=lambda_)
    return returns, log_rhos, target_logp
