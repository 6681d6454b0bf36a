"""Action distributions as functions of `dist_inputs` tensors.

Counterpart of `ray_tpu/models/distributions.py`, trimmed to
`Categorical` (the Atari north star's discrete actions) and
`DiagGaussian` (Box actions, PPO's continuous path). Each method is a
plain tensor function, so the same code serves rollout inference and
the learner loss.

The sampling tail (`sample`, `deterministic_sample` and the logp of the
chosen action) goes through the hand-written CUDA kernel
`csrc/categorical.cu` on CUDA tensors and through its plain PyTorch
version, `_sample_logp_plain`, on CPU tensors. Its k-step form
(`sample_logp_k`: k draws from one distribution per row, the Sebulba
selection window) is the same file's second kernel, with its plain
version `_sample_logp_k_plain`. `DiagGaussian`'s sampling tail (mean +
std * z or the mean, and the logp of that action) is the kernel
`csrc/diag_gaussian.cu` (K7), with its plain version
`_gaussian_sample_logp_plain`. `logp`, `entropy` and `kl` stay plain
PyTorch: the learner differentiates them.

SAC's tanh-squashed Gaussian tail (`squashed_gaussian_sample_logp`: the
clipped log_std, the reparameterized sample squashed to [low, high] and
its logp with the stable log-det) carries a gradient, since the actor
loss differentiates it: `SquashedGaussianTail` is an autograd function
whose forward is the kernel K9f and whose backward is K9b, both in
`csrc/squashed_gaussian.cu`, with the plain versions
`_squashed_gaussian_plain` and `_squashed_gaussian_backward_plain`.
Where no gradient is needed the tail goes to K9f directly.
`SquashedGaussian.logp` and `entropy` stay plain PyTorch (no path calls
them).

Per-step host outputs: K2 and K7 fill a `StepRecord` (the step's
actions, logp, value and dist inputs) and K9f an `ActionRecord` (its
actions; K8 in `eps_greedy.py` fills an int64 one) in pinned host
memory, through the buffer's device-mapped address: K2 and K9f beside
their device outputs, K7 (and K8) beside them or instead of them. On the
CPU the plain versions fill the same records by copy. `ThreadRecords`
keeps a policy's records per calling thread.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._private.cuda_build import (CudaKernel, device_stream_handle,
                                   stream_handle)
from ..rllib.env.spaces import Box, Discrete, MultiDiscrete

# K2: one warp per row, with the optional step record in pinned host
# memory; see the source note in csrc/categorical.cu.
CATEGORICAL_KERNEL = CudaKernel(
    "categorical", "categorical.cu", "categorical_sample",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p])

# K2k: the k-step form, one warp per (draw, row), with the optional
# int32 wire actions in pinned host memory; same source note.
CATEGORICAL_K_KERNEL = CudaKernel(
    "categorical_k", "categorical.cu", "categorical_sample_k",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p])

# K7: one warp per row, with the optional step record in pinned host
# memory; see the source note in csrc/diag_gaussian.cu.
DIAG_GAUSSIAN_KERNEL = CudaKernel(
    "diag_gaussian", "diag_gaussian.cu", "diag_gaussian_sample",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

# K9f and K9b: the squashed-Gaussian tail and its backward; see the
# source note in csrc/squashed_gaussian.cu.
SQUASHED_GAUSSIAN_KERNEL = CudaKernel(
    "squashed_gaussian", "squashed_gaussian.cu", "squashed_gaussian_sample",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# K9b reads the upstream gradients strided as autograd hands them over:
# g_a with its (row, column) strides, g_logp with its stride.
SQUASHED_GAUSSIAN_BACKWARD_KERNEL = CudaKernel(
    "squashed_gaussian_backward", "squashed_gaussian.cu",
    "squashed_gaussian_backward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_void_p])

_TINY = torch.finfo(torch.float32).tiny


def _sampling_inputs(x: torch.Tensor) -> torch.Tensor:
    """`x` as a sampling kernel takes it: f32, contiguous, no gradient
    (no copy where it already is)."""
    if x.requires_grad:
        x = x.detach()
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.float().contiguous()
    return x


class HostRecord:
    """A host buffer that a kernel fills beside its device outputs (or
    instead of them), through the buffer's device-mapped address: pinned
    when `pin` (for a CUDA device), pageable otherwise (for the CPU,
    where the plain versions fill it by copy; a kernel refuses it). The mapped address is
    resolved once, at the first launch that writes the buffer. The
    kernel's writes are complete once `record_done`'s event, recorded
    after the launch, has completed: `wait` waits for it.

    One record serves one caller at a time: a launch that writes it
    while an earlier one's values are still being read overwrites them.
    """

    def __init__(self, nbytes: int, pin: bool):
        self.buffer = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        self._address = None
        self._event = torch.cuda.Event() if pin else None
        self._offset = 0

    def _column(self, dtype: torch.dtype, shape: Tuple[int, ...]
                ) -> torch.Tensor:
        """The next `shape` column of `dtype`, after the earlier ones."""
        nbytes = int(np.prod(shape)) * torch.empty(
            0, dtype=dtype).element_size()
        start, self._offset = self._offset, self._offset + nbytes
        return self.buffer[start:self._offset].view(dtype).view(shape)

    def address(self, kernel: CudaKernel) -> int:
        """The buffer's device-mapped address (raises for pageable
        memory, before any launch)."""
        if self._address is None:
            self._address = kernel.mapped_address(self.buffer.data_ptr())
        return self._address

    def record_done(self, device: torch.device) -> None:
        """Mark the end of the work queued so far on `device`'s current
        stream (the launch that writes the record); nothing on the CPU."""
        if self._event is not None:
            self._event.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        """Wait until `record_done`'s mark has completed."""
        if self._event is not None:
            self._event.synchronize()


class StepRecord(HostRecord):
    """A sampling tail's step record for B rows of `width` dist inputs,
    back to back in the order the kernels write them
    (`csrc/categorical.cu`, `csrc/diag_gaussian.cu`): `actions`, `logp`
    f32 [B], `value` f32 [B] and `inputs` f32 [B, width] (torch views of
    the buffer; `numpy` holds numpy views of the four, in that order).
    The actions are Categorical's int64 [B] (K2) when `action_dim` is
    None, else DiagGaussian's f32 [B, action_dim] (K7)."""

    def __init__(self, B: int, width: int, pin: bool,
                 action_dim: Optional[int] = None):
        action_dtype = torch.int64 if action_dim is None else torch.float32
        action_shape = (B,) if action_dim is None else (B, action_dim)
        action_bytes = 8 * B if action_dim is None else 4 * B * action_dim
        super().__init__(action_bytes + 4 * B * (2 + width), pin)
        self.shape = (B, width)
        self.action_dim = action_dim
        self.actions = self._column(action_dtype, action_shape)
        self.logp = self._column(torch.float32, (B,))
        self.value = self._column(torch.float32, (B,))
        self.inputs = self._column(torch.float32, (B, width))
        self.numpy = tuple(t.numpy() for t in (
            self.actions, self.logp, self.value, self.inputs))

    def columns(self) -> Tuple[np.ndarray, ...]:
        """Wait for the kernel's writes, then copies of (actions, logp,
        value, inputs): the record is reused by the next step."""
        self.wait()
        return tuple(a.copy() for a in self.numpy)


class ActionRecord(HostRecord):
    """A host output of actions alone: `actions` of `shape` and `dtype`
    (a torch view; `numpy` its numpy view). K9f's is f32 [B, d], K8's
    int64 [B]."""

    def __init__(self, *shape: int, pin: bool,
                 dtype: torch.dtype = torch.float32):
        itemsize = torch.empty(0, dtype=dtype).element_size()
        super().__init__(itemsize * int(np.prod(shape)), pin)
        self.shape = shape
        self.dtype = dtype
        self.actions = self._column(dtype, shape)
        self.numpy = self.actions.numpy()

    def columns(self) -> np.ndarray:
        """Wait for the kernel's writes, then a copy of the actions."""
        self.wait()
        return self.numpy.copy()


class ThreadRecords:
    """A policy's host records per calling thread and row count, each
    made by `make(rows)` at its first use: no two callers in flight
    share one (each reads copies of its columns, so no view outlives the
    thread's next step)."""

    def __init__(self, make: Callable[[int], HostRecord]):
        self._make = make
        self._local = threading.local()

    def get(self, rows: int) -> HostRecord:
        records = getattr(self._local, "by_rows", None)
        if records is None:
            records = self._local.by_rows = {}
        record = records.get(rows)
        if record is None:
            record = records[rows] = self._make(rows)
        return record


def _check_record(record, cls, shape, **attrs) -> None:
    if not isinstance(record, cls) or record.shape != shape or any(
            getattr(record, k) != v for k, v in attrs.items()):
        raise ValueError(f"record must be a {cls.__name__} of shape "
                         f"{shape} {attrs}, got {record!r}")


def _check_value(value: Optional[torch.Tensor], record, B: int,
                 index: int) -> None:
    if value is not None and (
            record is None or value.shape != (B,)
            or value.dtype != torch.float32 or value.get_device() != index
            or not value.is_contiguous()):
        raise ValueError("value goes into a record: a contiguous float32 "
                         "[B] tensor on the inputs' device")


def _sample_logp_plain(logits: torch.Tensor, u: Optional[torch.Tensor],
                       explore: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K2 kernel: same inputs, same
    arithmetic. Gumbel-max with the given uniforms when exploring,
    argmax otherwise; logp of the chosen action under log_softmax."""
    if explore:
        score = logits + -torch.log(-torch.log(u.clamp_min(_TINY)))
    else:
        score = logits
    actions = torch.argmax(score, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, actions[..., None])[..., 0]
    return actions, logp


def _sample_logp_cuda(logits: torch.Tensor, u: Optional[torch.Tensor],
                      explore: bool, value: Optional[torch.Tensor] = None,
                      record: Optional[StepRecord] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on [B, A] f32 logits (and [B, A] f32 uniforms when
    exploring). Allocates the int64 actions and f32 logp outputs. With
    `record` (a pinned StepRecord of [B, A] and int64 actions), the kernel
    also writes the actions, logp and logits there, and `value` (f32 [B]
    on the logits' device) into its value column."""
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError(f"categorical kernel takes [B, A] float32 logits, "
                         f"got {tuple(logits.shape)} {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("categorical kernel takes contiguous logits")
    B, A = logits.shape
    index = logits.get_device()
    if explore:
        if u is None or u.shape != logits.shape \
                or u.dtype != torch.float32 or u.get_device() != index:
            raise ValueError(
                "exploring needs float32 uniforms shaped like the logits "
                "on the same device")
        if not u.is_contiguous():
            raise ValueError("categorical kernel takes contiguous uniforms")
    address = None
    if record is not None:
        _check_record(record, StepRecord, (B, A), action_dim=None)
        address = record.address(CATEGORICAL_KERNEL)
    _check_value(value, record, B, index)
    actions = torch.empty(B, dtype=torch.int64, device=logits.device)
    logp = torch.empty(B, dtype=torch.float32, device=logits.device)
    CATEGORICAL_KERNEL.launch(
        logits.data_ptr(), u.data_ptr() if explore else None,
        actions.data_ptr(), logp.data_ptr(),
        value.data_ptr() if value is not None else None, address, B, A,
        1 if explore else 0, device_stream_handle(index))
    return actions, logp


def sample_logp(logits: torch.Tensor, u: Optional[torch.Tensor] = None,
                explore: bool = True, *,
                value: Optional[torch.Tensor] = None,
                record: Optional[StepRecord] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(actions int64[...], logp f32[...]) for logits [..., A].

    With `record`, a StepRecord of the [B, A] logits' shape (pinned for
    CUDA logits), the record also gets the actions, the logp and the
    logits, and `value` (f32 [B], optional) its value column: written by
    K2 on the card (complete after `record.record_done` and
    `record.wait`), copied in on the CPU.

    CUDA tensors launch the K2 kernel (or raise); CPU tensors take the
    plain version. No gradient flows: sampling has none."""
    if logits.is_cuda:
        if logits.dim() == 2 or record is not None:
            return _sample_logp_cuda(logits, u, explore, value, record)
        lead, A = logits.shape[:-1], logits.shape[-1]
        actions, logp = _sample_logp_cuda(
            logits.reshape(-1, A), None if u is None else u.reshape(-1, A),
            explore)
        return actions.reshape(lead), logp.reshape(lead)
    if not logits.is_cpu:
        raise ValueError(f"no categorical kernel for {logits.device}")
    with torch.no_grad():
        actions, logp = _sample_logp_plain(logits, u, explore)
        if record is not None:
            _check_record(record, StepRecord, tuple(logits.shape),
                          action_dim=None)
            _fill_record(record, actions, logp, value, logits)
    return actions, logp


def _fill_record(record: StepRecord, actions: torch.Tensor,
                 logp: torch.Tensor, value: Optional[torch.Tensor],
                 inputs: torch.Tensor) -> None:
    """The CPU's step record: the plain version's columns, by copy."""
    record.actions.copy_(actions)
    record.logp.copy_(logp)
    record.inputs.copy_(inputs)
    if value is not None:
        record.value.copy_(value)


def _sample_logp_k_plain(logits: torch.Tensor, u: Optional[torch.Tensor],
                         k: int, explore: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K2k kernel: k draws per row of [N, A]
    logits, draw j with the uniforms u[j] ([k, N, A]) when exploring,
    the argmax k times otherwise. Returns (actions int64 [k, N], logp
    f32 [k, N])."""
    lead = logits.expand((k,) + tuple(logits.shape))
    return _sample_logp_plain(lead, u, explore)


def _check_host_actions(host_actions: torch.Tensor, k: int, N: int) -> None:
    if host_actions.dtype != torch.int32 or host_actions.is_cuda \
            or host_actions.shape != (k, N) \
            or not host_actions.is_contiguous():
        raise ValueError(
            f"host_actions must be a contiguous int32 [{k}, {N}] host "
            f"tensor, got {tuple(host_actions.shape)} {host_actions.dtype} "
            f"on {host_actions.device}")


def _sample_logp_k_cuda(logits: torch.Tensor, u: Optional[torch.Tensor],
                        k: int, explore: bool,
                        host_actions: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2k on [N, A] f32 logits (and [k, N, A] f32 uniforms when
    exploring). Allocates the int64 [k, N] actions and f32 [k, N] logp;
    `host_actions`, a pinned int32 [k, N] host tensor, also receives the
    actions (the launch raises if the card cannot write it)."""
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError(f"categorical_k kernel takes [N, A] float32 "
                         f"logits, got {tuple(logits.shape)} {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("categorical_k kernel takes contiguous logits")
    if k < 1:
        raise ValueError(f"categorical_k kernel: k={k} < 1")
    N, A = logits.shape
    index = logits.get_device()
    if explore:
        if u is None or u.shape != (k, N, A) \
                or u.dtype != torch.float32 or u.get_device() != index:
            raise ValueError(
                f"exploring needs float32 uniforms of shape {(k, N, A)} "
                "on the logits' device")
        if not u.is_contiguous():
            raise ValueError("categorical_k kernel takes contiguous "
                             "uniforms")
    if host_actions is not None:
        _check_host_actions(host_actions, k, N)
    actions = torch.empty((k, N), dtype=torch.int64, device=logits.device)
    logp = torch.empty((k, N), dtype=torch.float32, device=logits.device)
    CATEGORICAL_K_KERNEL.launch(
        logits.data_ptr(), u.data_ptr() if explore else None,
        actions.data_ptr(), logp.data_ptr(),
        host_actions.data_ptr() if host_actions is not None else None, k, N,
        A, 1 if explore else 0, device_stream_handle(index))
    return actions, logp


def sample_logp_k(logits: torch.Tensor, u: Optional[torch.Tensor] = None,
                  explore: bool = True, k: Optional[int] = None,
                  host_actions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(actions int64 [k, N], logp f32 [k, N]): k draws from each row of
    the [N, A] logits, draw j with the uniforms u[j] of u [k, N, A].
    Without uniforms (`explore=False`) every draw is the argmax and `k`
    must be given. `host_actions`, an int32 [k, N] host tensor (pinned
    for CUDA logits), receives the same actions: written by the kernel
    on the card (complete once an event recorded after this call has
    completed), copied in on the CPU.

    CUDA tensors launch the K2k kernel (or raise); CPU tensors take the
    plain version. No gradient flows: sampling has none."""
    if k is None:
        if u is None:
            raise ValueError("sample_logp_k needs k or the [k, N, A] "
                             "uniforms")
        k = u.shape[0]
    if logits.is_cuda:
        return _sample_logp_k_cuda(logits, u, k, explore, host_actions)
    if not logits.is_cpu:
        raise ValueError(f"no categorical_k kernel for {logits.device}")
    with torch.no_grad():
        actions, logp = _sample_logp_k_plain(logits, u, k, explore)
    if host_actions is not None:
        _check_host_actions(host_actions, k, logits.shape[0])
        host_actions.copy_(actions)
    return actions, logp


def gaussian_log_norm(d: int) -> float:
    """0.5 * d * log(2 pi), the normalizer of a d-dim unit Gaussian."""
    return 0.5 * d * math.log(2.0 * math.pi)


def _gaussian_sample_logp_plain(inputs: torch.Tensor,
                                z: Optional[torch.Tensor], explore: bool
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K7 kernel: same inputs, same steps.
    inputs [B, 2d] = [mean, log_std], z [B, d] normals (used only when
    exploring). Returns (actions [B, d] = mean + exp(log_std) * z, or
    the mean; logp [B] of those actions), both sums over d taken in
    column order as the kernel takes them."""
    d = inputs.shape[-1] // 2
    mean, log_std = inputs[:, :d], inputs[:, d:]
    std = torch.exp(log_std)
    actions = mean + std * z if explore else mean.clone()
    y = (actions - mean) / std
    y2 = y * y
    sq = torch.zeros_like(inputs[:, 0])
    sls = torch.zeros_like(inputs[:, 0])
    for j in range(d):
        sq = sq + y2[:, j]
        sls = sls + log_std[:, j]
    logp = (-0.5 * sq - gaussian_log_norm(d)) - sls
    return actions, logp


def _gaussian_sample_logp_cuda(inputs: torch.Tensor,
                               z: Optional[torch.Tensor], explore: bool,
                               value: Optional[torch.Tensor] = None,
                               record: Optional[StepRecord] = None
                               ) -> Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Launch K7 on [B, 2d] f32 inputs (and [B, d] f32 normals when
    exploring). With `record` (a pinned StepRecord of [B, 2d] and f32
    [B, d] actions), the kernel writes the actions, logp and inputs
    there alone, and `value` (f32 [B] on the inputs' device) into its
    value column, and None is returned; without one it writes f32
    [B, d] actions and [B] logp on the device (returned)."""
    if inputs.dtype != torch.float32 or inputs.dim() != 2 \
            or inputs.shape[1] % 2:
        raise ValueError(f"diag_gaussian kernel takes [B, 2d] float32 "
                         f"inputs, got {tuple(inputs.shape)} {inputs.dtype}")
    if not inputs.is_contiguous():
        raise ValueError("diag_gaussian kernel takes contiguous inputs")
    B, width = inputs.shape
    d = width // 2
    index = inputs.get_device()
    if explore:
        if z is None or z.shape != (B, d) or z.dtype != torch.float32 \
                or z.get_device() != index:
            raise ValueError(
                f"exploring needs float32 normals of shape {(B, d)} on "
                "the inputs' device")
        if not z.is_contiguous():
            raise ValueError("diag_gaussian kernel takes contiguous "
                             "normals")
    _check_value(value, record, B, index)
    actions = logp = address = None
    if record is None:
        actions = torch.empty(B, d, dtype=torch.float32,
                              device=inputs.device)
        logp = torch.empty(B, dtype=torch.float32, device=inputs.device)
    else:
        _check_record(record, StepRecord, (B, width), action_dim=d)
        address = record.address(DIAG_GAUSSIAN_KERNEL)
    DIAG_GAUSSIAN_KERNEL.launch(
        inputs.data_ptr(), z.data_ptr() if explore else None,
        None if actions is None else actions.data_ptr(),
        None if logp is None else logp.data_ptr(),
        None if value is None else value.data_ptr(), address, B, d,
        1 if explore else 0, gaussian_log_norm(d),
        device_stream_handle(index))
    return None if record is not None else (actions, logp)


def gaussian_sample_logp(inputs: torch.Tensor,
                         z: Optional[torch.Tensor] = None,
                         explore: bool = True, *,
                         value: Optional[torch.Tensor] = None,
                         record: Optional[StepRecord] = None
                         ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(actions f32 [B, d], logp f32 [B]) for DiagGaussian inputs
    [B, 2d]: mean + exp(log_std) * z when exploring, the mean otherwise.

    With `record`, a StepRecord of [B, 2d] with f32 [B, d] actions
    (pinned for CUDA inputs), the actions, the logp and the inputs go
    there alone, `value` (f32 [B], optional) into its value column, and
    None is returned: written by K7 on the card (complete after
    `record.record_done` and `record.wait`), with no device output
    allocated; copied in on the CPU.

    CUDA tensors launch the K7 kernel (or raise); CPU tensors take the
    plain version. No gradient flows: sampling has none."""
    if inputs.is_cuda:
        return _gaussian_sample_logp_cuda(inputs, z, explore, value, record)
    if not inputs.is_cpu:
        raise ValueError(f"no diag_gaussian kernel for {inputs.device}")
    with torch.no_grad():
        actions, logp = _gaussian_sample_logp_plain(inputs, z, explore)
        if record is None:
            return actions, logp
        B, width = inputs.shape
        _check_record(record, StepRecord, (B, width), action_dim=width // 2)
        _fill_record(record, actions, logp, value, inputs)
    return None


LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def _squashed_gaussian_plain(x: torch.Tensor, z: Optional[torch.Tensor],
                             low: float, high: float, explore: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K9f: same inputs, same steps. x [B, 2d] =
    [mean, raw log_std], z [B, d] normals (used only when exploring; the
    deterministic action takes z = 0). Returns (actions [B, d] in [low,
    high], logp [B]), the sum over d taken in column order as the kernel
    takes it (`sac_policy.py:137-150` term for term)."""
    d = x.shape[-1] // 2
    mean, raw = x[:, :d], x[:, d:]
    s = (high - low) / 2.0
    log_std = raw.clamp(LOG_STD_MIN, LOG_STD_MAX)
    if explore:
        pre = mean + torch.exp(log_std) * z
    else:
        z = torch.zeros_like(mean)
        pre = mean
    t = torch.tanh(pre)
    actions = low + (t + 1.0) * s
    m = -2.0 * pre
    softplus = torch.relu(m) + torch.log1p(torch.exp(-m.abs()))
    terms = (-0.5 * (z * z + 2.0 * log_std + _LOG_2PI)
             - 2.0 * (_LOG_2 - pre - softplus))
    logp = torch.zeros_like(x[:, 0])
    for j in range(d):
        logp = logp + terms[:, j]
    return actions, logp - d * math.log(s)


def _squashed_gaussian_backward_plain(
        x: torch.Tensor, z: Optional[torch.Tensor],
        g_a: Optional[torch.Tensor], g_logp: Optional[torch.Tensor],
        low: float, high: float, explore: bool) -> torch.Tensor:
    """Plain PyTorch version of K9b: the gradient [B, 2d] of
    sum(g_a * actions) + sum(g_logp * logp) with respect to x, from the
    upstream gradients g_a [B, d] and g_logp [B] (None reads as zeros).
    pre and tanh(pre) are recomputed from x and z."""
    d = x.shape[-1] // 2
    mean, raw = x[:, :d], x[:, d:]
    s = (high - low) / 2.0
    std = torch.exp(raw.clamp(LOG_STD_MIN, LOG_STD_MAX))
    if explore:
        pre = mean + std * z
    else:
        z = torch.zeros_like(mean)
        pre = mean
    t = torch.tanh(pre)
    ga = g_a if g_a is not None else torch.zeros_like(mean)
    gl = (g_logp if g_logp is not None
          else torch.zeros_like(x[:, 0]))[:, None]
    g_pre = ga * s * (1.0 - t * t) + gl * 2.0 * t
    inside = (raw >= LOG_STD_MIN) & (raw <= LOG_STD_MAX)
    g_raw = torch.where(inside, g_pre * std * z - gl, torch.zeros_like(raw))
    return torch.cat([g_pre, g_raw], dim=-1)


class SquashedTail:
    """The constants of one squashed-Gaussian tail over a d-dim box
    [low, high]: the half-range s = (high - low) / 2 and d log s (the
    logp's log-det of the rescale), computed once (a SAC policy holds
    one) instead of at every launch."""

    def __init__(self, low: float, high: float, d: int):
        self.low, self.high, self.d = float(low), float(high), int(d)
        self.s = (self.high - self.low) / 2.0
        self.d_log_s = self.d * math.log(self.s)


def _check_squashed_inputs(x: torch.Tensor, z: Optional[torch.Tensor],
                           explore: bool) -> Tuple[int, int]:
    """(B, d) of K9's [B, 2d] f32 inputs; raises on what it cannot take."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"squashed_gaussian kernel takes [B, 2d] float32 "
                         f"inputs, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("squashed_gaussian kernel takes contiguous inputs")
    B, d = x.shape[0], x.shape[1] // 2
    if explore:
        if z is None or z.shape != (B, d) or z.dtype != torch.float32 \
                or z.get_device() != x.get_device() or not z.is_contiguous():
            raise ValueError(
                f"exploring needs contiguous float32 normals of shape "
                f"{(B, d)} on the inputs' device")
    return B, d


def _squashed_cuda(x: torch.Tensor, z: Optional[torch.Tensor],
                   tail: SquashedTail, explore: bool,
                   host: Optional[ActionRecord] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K9f on [B, 2d] f32 inputs (and [B, d] f32 normals when
    exploring). Allocates the f32 [B, d] actions and [B] logp; `host`, a
    pinned ActionRecord of [B, d], also receives the actions."""
    B, d = _check_squashed_inputs(x, z, explore)
    if d != tail.d:
        raise ValueError(f"squashed_gaussian: inputs of d={d} for a tail "
                         f"of d={tail.d}")
    address = None
    if host is not None:
        _check_record(host, ActionRecord, (B, d), dtype=torch.float32)
        address = host.address(SQUASHED_GAUSSIAN_KERNEL)
    actions = torch.empty((B, d), dtype=torch.float32, device=x.device)
    logp = torch.empty(B, dtype=torch.float32, device=x.device)
    SQUASHED_GAUSSIAN_KERNEL.launch(
        x.data_ptr(), z.data_ptr() if explore else None, actions.data_ptr(),
        logp.data_ptr(), address, B, d, 1 if explore else 0, tail.low,
        tail.s, tail.d_log_s, device_stream_handle(x.get_device()))
    return actions, logp


def _squashed_gaussian_cuda(x: torch.Tensor, z: Optional[torch.Tensor],
                            low: float, high: float, explore: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K9f on [B, 2d] f32 inputs (and [B, d] f32 normals when
    exploring). Allocates the f32 [B, d] actions and [B] logp."""
    return _squashed_cuda(x, z, SquashedTail(low, high, x.shape[-1] // 2),
                          explore)


def _squashed_forward(x: torch.Tensor, z: Optional[torch.Tensor],
                      tail: SquashedTail, explore: bool,
                      host: Optional[ActionRecord] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9f on CUDA tensors (or raise), the plain version on CPU ones
    (`host` then filled by copy)."""
    if x.is_cuda:
        return _squashed_cuda(x, z, tail, explore, host)
    if not x.is_cpu:
        raise ValueError(f"no squashed_gaussian kernel for {x.device}")
    actions, logp = _squashed_gaussian_plain(x, z, tail.low, tail.high,
                                             explore)
    if host is not None:
        _check_record(host, ActionRecord, tuple(actions.shape),
                      dtype=torch.float32)
        with torch.no_grad():
            host.actions.copy_(actions)
    return actions, logp


def _squashed_backward_launch(x: torch.Tensor, z: Optional[torch.Tensor],
                              g_a: Optional[torch.Tensor],
                              g_logp: Optional[torch.Tensor], B: int, d: int,
                              index: int, s: float, explore: bool
                              ) -> torch.Tensor:
    """Launch K9b on x [B, 2d] and z [B, d] already checked (by K9f's
    launch, or by `_squashed_gaussian_backward_cuda`) on CUDA device
    `index`, and the upstream gradients g_a [B, d] and g_logp [B], each
    f32 on that device or None, read in place with their strides (a
    column slice, an expand). Allocates g_x."""
    if g_a is not None and (g_a.shape != (B, d) or g_a.dtype != torch.float32
                            or g_a.get_device() != index):
        raise ValueError(f"squashed_gaussian backward takes float32 "
                         f"gradients of shape {(B, d)} on the inputs' "
                         f"device, got g_a {tuple(g_a.shape)} {g_a.dtype} "
                         f"on {g_a.device}")
    if g_logp is not None and (g_logp.shape != (B,)
                               or g_logp.dtype != torch.float32
                               or g_logp.get_device() != index):
        raise ValueError(f"squashed_gaussian backward takes float32 "
                         f"gradients of shape {(B,)} on the inputs' device, "
                         f"got g_logp {tuple(g_logp.shape)} {g_logp.dtype} "
                         f"on {g_logp.device}")
    g_x = torch.empty((B, 2 * d), dtype=torch.float32, device=x.device)
    ga_row, ga_col = g_a.stride() if g_a is not None else (0, 0)
    SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launch(
        x.data_ptr(), z.data_ptr() if explore else None,
        g_a.data_ptr() if g_a is not None else None, ga_row, ga_col,
        g_logp.data_ptr() if g_logp is not None else None,
        g_logp.stride(0) if g_logp is not None else 0, g_x.data_ptr(), B,
        d, 1 if explore else 0, s, device_stream_handle(index))
    return g_x


def _squashed_gaussian_backward_cuda(
        x: torch.Tensor, z: Optional[torch.Tensor],
        g_a: Optional[torch.Tensor], g_logp: Optional[torch.Tensor],
        low: float, high: float, explore: bool) -> torch.Tensor:
    """Launch K9b: x [B, 2d], z [B, d] (when exploring), g_a [B, d] and
    g_logp [B] (each f32 of any strides, or None). Allocates g_x."""
    B, d = _check_squashed_inputs(x, z, explore)
    return _squashed_backward_launch(x, z, g_a, g_logp, B, d,
                                     x.get_device(), (high - low) / 2.0,
                                     explore)


class SquashedGaussianTail(torch.autograd.Function):
    """(actions, logp) = the squashed-Gaussian tail of x [B, 2d], with a
    gradient to x. On CUDA tensors the forward launches K9f and the
    backward K9b (or raises); on CPU tensors they are the two plain
    functions. z, the tail's constants, explore and the host output get
    no gradient.

    The forward keeps what the backward needs (B, d, the device, the
    tail's s), so the backward checks only the upstream gradients, which
    autograd hands over as views (a column slice of the critic's concat
    gradient, the expand of a sum) and K9b reads in place."""

    @staticmethod
    def forward(ctx, x, z, tail, explore, host):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, z)
        out = _squashed_forward(x, z, tail, explore, host)
        ctx.tail, ctx.explore = tail, explore
        ctx.dims = (x.shape[0], x.shape[1] // 2, x.get_device())
        return out

    @staticmethod
    def backward(ctx, g_a, g_logp):
        if g_a is None and g_logp is None:
            return None, None, None, None, None
        x, z = ctx.saved_tensors
        B, d, index = ctx.dims
        tail = ctx.tail
        if index >= 0:
            g_x = _squashed_backward_launch(x, z, g_a, g_logp, B, d, index,
                                            tail.s, ctx.explore)
        else:
            g_x = _squashed_gaussian_backward_plain(
                x, z, g_a, g_logp, tail.low, tail.high, ctx.explore)
        return g_x, None, None, None, None


def squashed_gaussian_sample_logp(x: torch.Tensor,
                                  z: Optional[torch.Tensor] = None,
                                  low: float = -1.0, high: float = 1.0,
                                  explore: bool = True, *,
                                  tail: Optional[SquashedTail] = None,
                                  host_actions: Optional[ActionRecord] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(actions f32 [B, d] in [low, high], logp f32 [B]) for the actor's
    output x [B, 2d] = [mean, raw log_std]: tanh(mean + std * z) rescaled
    when exploring, tanh(mean) rescaled otherwise (z is not read).

    `tail`, the SquashedTail of (low, high, d) made once by the caller,
    takes the place of `low` and `high`. `host_actions`, an ActionRecord
    of [B, d] (pinned for CUDA inputs), also receives the actions:
    written by K9f on the card (complete after `record_done` and
    `wait`), copied in on the CPU.

    Where x needs a gradient this goes through `SquashedGaussianTail`
    (K9f forward, K9b backward); otherwise straight to K9f. CUDA tensors
    launch the kernels or raise; CPU tensors take the plain versions."""
    if not explore:
        z = None
    elif z is None:
        raise ValueError("exploring needs the [B, d] normals z")
    if tail is None:
        tail = SquashedTail(low, high, x.shape[-1] // 2)
    explore = bool(explore)
    if x.requires_grad and torch.is_grad_enabled():
        return SquashedGaussianTail.apply(x, z, tail, explore, host_actions)
    return _squashed_forward(x, z, tail, explore, host_actions)


class Categorical:
    """inputs: logits (..., n)."""

    STEP_KERNEL = CATEGORICAL_KERNEL  # what `record_step` launches

    def __init__(self, inputs: torch.Tensor):
        self.inputs = inputs

    def _logits_and_noise(self, generator, explore):
        logits = _sampling_inputs(self.inputs)
        u = None
        if explore:
            u = torch.rand(logits.shape, generator=generator,
                           dtype=torch.float32, device=logits.device)
        return logits, u

    def sample_with_logp(self, generator: Optional[torch.Generator] = None,
                         explore: bool = True):
        """Draw actions and their logp in one pass (K2 on the card).
        The uniforms come from `generator` on the logits' device."""
        logits, u = self._logits_and_noise(generator, explore)
        return sample_logp(logits, u, explore)

    def record_step(self, generator: Optional[torch.Generator],
                    explore: bool, value: torch.Tensor,
                    record: StepRecord) -> None:
        """Draw as `sample_with_logp` does, into `record` (from
        `step_record`): the actions, logp, logits and `value` (K2 on the
        card; see `sample_logp`)."""
        logits, u = self._logits_and_noise(generator, explore)
        sample_logp(logits, u, explore, value=value, record=record)

    @staticmethod
    def step_record(rows: int, width: int, pin: bool) -> StepRecord:
        """The step record of `rows` rows of `width` logits."""
        return StepRecord(rows, width, pin)

    def sample_k_with_logp(self, generator: Optional[torch.Generator],
                           k: int, explore: bool = True,
                           host_actions: Optional[torch.Tensor] = None):
        """k draws per row of [N, A] logits and their logp, each [k, N]
        (K2k on the card): the Sebulba selection window. Draw j uses its
        own uniforms from `generator`, so the k draws are independent.
        `host_actions` (int32 [k, N], pinned for CUDA logits) also gets
        the actions; see `sample_logp_k`."""
        logits = self.inputs
        if logits.dtype != torch.float32 or not logits.is_contiguous():
            logits = logits.float().contiguous()
        u = None
        if explore:
            u = torch.rand((k,) + tuple(logits.shape), generator=generator,
                           dtype=torch.float32, device=logits.device)
        return sample_logp_k(logits, u, explore, k=k,
                             host_actions=host_actions)

    def sample(self, generator: Optional[torch.Generator] = None):
        return self.sample_with_logp(generator, explore=True)[0]

    def deterministic_sample(self):
        return self.sample_with_logp(explore=False)[0]

    def logp(self, x):
        logits = torch.log_softmax(self.inputs, dim=-1)
        return logits.gather(-1, x[..., None].long())[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self.inputs, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def kl(self, other: "Categorical"):
        logp = torch.log_softmax(self.inputs, dim=-1)
        logq = torch.log_softmax(other.inputs, dim=-1)
        return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)

    @staticmethod
    def required_input_dim(space) -> int:
        return space.n


class DiagGaussian:
    """inputs: concat([mean, log_std], -1) over a Box of dim d. `mean`,
    `log_std` and `std` are computed at their first read (`logp`,
    `entropy`, `kl`): sampling reads none of them."""

    STEP_KERNEL = DIAG_GAUSSIAN_KERNEL  # what `record_step` launches

    def __init__(self, inputs: torch.Tensor):
        self.inputs = inputs

    @functools.cached_property
    def mean(self) -> torch.Tensor:
        return self.inputs[..., :self.inputs.shape[-1] // 2]

    @functools.cached_property
    def log_std(self) -> torch.Tensor:
        return self.inputs[..., self.inputs.shape[-1] // 2:]

    @functools.cached_property
    def std(self) -> torch.Tensor:
        return torch.exp(self.log_std)

    def _inputs_and_noise(self, generator, explore):
        inputs = _sampling_inputs(self.inputs)
        z = None
        if explore:
            z = torch.randn(inputs.shape[:-1] + (inputs.shape[-1] // 2,),
                            generator=generator, dtype=torch.float32,
                            device=inputs.device)
        return inputs, z

    def sample_with_logp(self, generator: Optional[torch.Generator] = None,
                         explore: bool = True):
        """Draw actions and their logp in one pass (K7 on the card).
        The normals come from `generator` on the inputs' device."""
        inputs, z = self._inputs_and_noise(generator, explore)
        return gaussian_sample_logp(inputs, z, explore)

    def record_step(self, generator: Optional[torch.Generator],
                    explore: bool, value: torch.Tensor,
                    record: StepRecord) -> None:
        """Draw as `sample_with_logp` does, into `record` (from
        `step_record`) alone: the actions, logp, inputs and `value` (K7
        on the card, with no device outputs; see
        `gaussian_sample_logp`)."""
        inputs, z = self._inputs_and_noise(generator, explore)
        gaussian_sample_logp(inputs, z, explore, value=value, record=record)

    @staticmethod
    def step_record(rows: int, width: int, pin: bool) -> StepRecord:
        """The step record of `rows` rows of `width` = 2d inputs."""
        return StepRecord(rows, width, pin, action_dim=width // 2)

    def sample(self, generator: Optional[torch.Generator] = None):
        return self.sample_with_logp(generator, explore=True)[0]

    def deterministic_sample(self):
        return self.mean

    def logp(self, x):
        d = self.mean.shape[-1]
        return (-0.5 * torch.sum(((x - self.mean) / self.std) ** 2, dim=-1)
                - gaussian_log_norm(d)
                - torch.sum(self.log_std, dim=-1))

    def entropy(self):
        d = self.mean.shape[-1]
        return torch.sum(self.log_std, dim=-1) + \
            0.5 * d * (1.0 + math.log(2.0 * math.pi))

    def kl(self, other: "DiagGaussian"):
        return torch.sum(
            other.log_std - self.log_std
            + (self.std ** 2 + (self.mean - other.mean) ** 2)
            / (2.0 * other.std ** 2) - 0.5, dim=-1)

    @staticmethod
    def required_input_dim(space) -> int:
        return 2 * int(np.prod(space.shape))


class SquashedGaussian:
    """inputs: concat([mean, raw log_std], -1), a tanh-squashed Gaussian
    bounded to [low, high] (SAC policies; `distributions.py:130-176` in
    the JAX package). `sample` and `deterministic_sample` go through the
    squashed-Gaussian tail (K9f on the card); `logp` of a given action
    (arctanh unsquash) and `entropy` stay plain PyTorch."""

    def __init__(self, inputs: torch.Tensor, low: float = -1.0,
                 high: float = 1.0):
        self.inputs = inputs
        self.mean, log_std = torch.chunk(inputs, 2, dim=-1)
        self.log_std = log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)
        self.std = torch.exp(self.log_std)
        self.low, self.high = low, high

    def sample_with_logp(self, generator: Optional[torch.Generator] = None,
                         explore: bool = True):
        """Draw actions and their logp in one pass (K9f on the card), the
        normals from `generator` on the inputs' device."""
        lead, width = self.inputs.shape[:-1], self.inputs.shape[-1]
        x = self.inputs.float().reshape(-1, width).contiguous()
        z = None
        if explore:
            z = torch.randn((x.shape[0], width // 2), generator=generator,
                            dtype=torch.float32, device=x.device)
        actions, logp = squashed_gaussian_sample_logp(
            x, z, self.low, self.high, explore)
        return actions.reshape(self.mean.shape), logp.reshape(lead)

    def sample(self, generator: Optional[torch.Generator] = None):
        return self.sample_with_logp(generator, explore=True)[0]

    def deterministic_sample(self):
        return self.sample_with_logp(explore=False)[0]

    def _unsquash(self, x):
        y = 2.0 * (x - self.low) / (self.high - self.low) - 1.0
        return torch.atanh(y.clamp(-1.0 + 1e-6, 1.0 - 1e-6))

    def logp(self, x):
        raw = self._unsquash(x)
        d = self.mean.shape[-1]
        base = (-0.5 * torch.sum(((raw - self.mean) / self.std) ** 2, dim=-1)
                - gaussian_log_norm(d) - torch.sum(self.log_std, dim=-1))
        # log |d squash / d raw|
        correction = torch.sum(torch.log(
            (1 - torch.tanh(raw) ** 2) * (self.high - self.low) / 2.0
            + 1e-8), dim=-1)
        return base - correction

    def entropy(self):
        # The unsquashed Gaussian's entropy, as in the JAX package.
        d = self.mean.shape[-1]
        return torch.sum(self.log_std, dim=-1) + \
            0.5 * d * (1.0 + math.log(2.0 * math.pi))

    @staticmethod
    def required_input_dim(space) -> int:
        return 2 * int(np.prod(space.shape))


def get_action_dist(action_space):
    """Map a space to (dist_class, required_input_dim) — parity:
    `ModelCatalog.get_action_dist` (`rllib/models/catalog.py:109`), with
    the reference's errors: NotImplementedError for MultiDiscrete,
    ValueError for any other space."""
    if isinstance(action_space, Discrete):
        return Categorical, action_space.n
    if isinstance(action_space, Box):
        return DiagGaussian, DiagGaussian.required_input_dim(action_space)
    if isinstance(action_space, MultiDiscrete):
        raise NotImplementedError("MultiDiscrete dist: use a Tuple policy")
    raise ValueError(f"unsupported action space {action_space}")
