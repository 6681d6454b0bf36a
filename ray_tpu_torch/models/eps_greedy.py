"""The epsilon-greedy action tail of the Q-policies (kernel K8).

Counterpart of `eps_action_fn`'s sampling part
(`ray_tpu/rllib/agents/dqn/dqn_policy.py:161-170`): per row of Q-values,
the greedy action (the first maximum, NaN counted as maximal, as
`torch.argmax` counts it), a uniform random action, and a uniform draw
that picks the random action where it is below epsilon.

`eps_greedy` launches the hand-written CUDA kernel `csrc/eps_greedy.cu`
on CUDA tensors and takes its plain PyTorch version,
`_eps_greedy_plain`, on CPU tensors. The two take the same two
uniforms per row and agree exactly on them at any epsilon. No single
PyTorch call computes this function.

The DQN policy's env step takes its actions into an int64
`ActionRecord` in pinned host memory (`host_actions=`), which K8 writes
through the buffer's device-mapped address, with no device output; on
the CPU the plain version fills the same record by copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._private.cuda_build import CudaKernel, device_stream_handle
from .distributions import ActionRecord, _check_record

# K8: one warp per row, with the optional int64 host actions in pinned
# host memory; see the source note in csrc/eps_greedy.cu.
EPS_GREEDY_KERNEL = CudaKernel(
    "eps_greedy", "eps_greedy.cu", "eps_greedy",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _eps_greedy_plain(q: torch.Tensor, u: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Plain PyTorch version of K8: q [B, A] f32, u [B, 2] f32 ->
    int64 [B]. Row i takes min(floor(u[i, 1] * A), A - 1) where
    u[i, 0] < eps, else argmax q[i]."""
    A = q.shape[-1]
    greedy = torch.argmax(q, dim=-1)
    rand = torch.floor(u[:, 1] * A).clamp_max(A - 1).long()
    return torch.where(u[:, 0] < eps, rand, greedy)


def _eps_greedy_cuda(q: torch.Tensor, u: torch.Tensor, eps: float,
                     host_actions: Optional[ActionRecord] = None
                     ) -> Optional[torch.Tensor]:
    """Launch K8 on [B, A] f32 Q-values and [B, 2] f32 uniforms into
    `host_actions`, a pinned int64 ActionRecord of [B] (returns None),
    or without one into int64 [B] device actions (returned)."""
    if q.dtype != torch.float32 or q.dim() != 2:
        raise ValueError(f"eps_greedy kernel takes [B, A] float32 "
                         f"Q-values, got {tuple(q.shape)} {q.dtype}")
    B, A = q.shape
    index = q.get_device()
    if u.shape != (B, 2) or u.dtype != torch.float32 \
            or u.get_device() != index:
        raise ValueError(f"eps_greedy kernel takes float32 uniforms of "
                         f"shape {(B, 2)} on the Q-values' device")
    if not (q.is_contiguous() and u.is_contiguous()):
        raise ValueError("eps_greedy kernel takes contiguous Q-values and "
                         "uniforms")
    actions = address = None
    if host_actions is None:
        actions = torch.empty(B, dtype=torch.int64, device=q.device)
    else:
        _check_record(host_actions, ActionRecord, (B,), dtype=torch.int64)
        address = host_actions.address(EPS_GREEDY_KERNEL)
    EPS_GREEDY_KERNEL.launch(
        q.data_ptr(), u.data_ptr(),
        None if actions is None else actions.data_ptr(), address, B, A,
        float(eps), device_stream_handle(index))
    return actions


def eps_greedy(q: torch.Tensor, u: torch.Tensor, eps: float, *,
               host_actions: Optional[ActionRecord] = None
               ) -> Optional[torch.Tensor]:
    """Epsilon-greedy actions (int64 [B]) for Q-values [B, A] with two
    uniforms per row, u [B, 2]: u[:, 0] decides the swap, u[:, 1] draws
    the random action.

    With `host_actions`, an int64 ActionRecord of [B] (pinned for CUDA
    Q-values), the actions go there alone and None is returned: written
    by K8 on the card (complete after `record_done` and `wait`), with no
    device output allocated; copied in on the CPU.

    CUDA tensors launch the K8 kernel (or raise); CPU tensors take the
    plain version."""
    if q.is_cuda:
        return _eps_greedy_cuda(q, u, eps, host_actions)
    if not q.is_cpu:
        raise ValueError(f"no eps_greedy kernel for {q.device}")
    with torch.no_grad():
        actions = _eps_greedy_plain(q, u, eps)
    if host_actions is None:
        return actions
    _check_record(host_actions, ActionRecord, (q.shape[0],),
                  dtype=torch.int64)
    host_actions.actions.copy_(actions)
    return None
