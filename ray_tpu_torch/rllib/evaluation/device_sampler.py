"""Device-resident Sebulba sampler: observations ship to the card once.

Counterpart of `ray_tpu/rllib/evaluation/device_sampler.py`
(`_EnvGroup`, `DeviceSebulbaSampler`). An inline actor steps batched
host envs; observations are uploaded once per env step, kept on the
card for the train batch, and actions come back in one [k, N] fetch per
selection window:

- One "apply" per env step and env group: upload the newest delta (or
  frame) and build the step's observation on the card. This is kernel
  K3 (`csrc/obs_apply.cu`, wrapper `apply_obs` below, and
  `GroupObsApply`, the group's lean launch path): full-row
  replacement, delta scatter into the retained frame buffer, and the
  rolling frame stack, in one launch.
- One "select" per window of k steps: the policy's forward at the
  newest observation and k sampled action arrays (kernel K2k,
  `TorchPolicy.select`). K2k writes the [k, n] int32 wire actions
  straight into the group's pinned host buffer; the fetch waits on the
  window's CUDA event when the window is consumed.
- Every step's observation is RETAINED on the card; at fragment end the
  OBS / BOOTSTRAP_OBS / ACTION_DIST_INPUTS / ACTION_LOGP / VF_PREDS
  columns are assembled on the card and handed to the learner as
  tensors, which `TorchPolicy._device_batch` passes through.

Pipeline gears, as in the JAX sampler:

- env groups (`sebulba_env_groups`): the actor's N env slots split into
  G groups with their own frame stack, delta state and pending window,
  so one group's fetch waits behind the other groups' host work;
- k-step selection (`sebulba_onchip_steps=k`): one fetch per k steps at
  a selection lag of j steps for sub-step j, recorded in the POLICY_LAG
  column; the stored behaviour logits/logp are the ones that selected
  each action, so V-trace's ratios are exact.

Streams and buffers: every launch of the sampler and of the learner
goes to the device's default stream. The policy's `_update_lock` is held
while a select is enqueued, so stream order makes each window read
either the whole old or the whole new parameters. Host->device uploads
are non-blocking copies from a pinned staging buffer taken fresh for
each upload (PyTorch's pinned-memory cache hands a block out again only
after the copy that read it has completed). The action buffer is one
pinned [k, n] int32 tensor per group, written by K2k through its
device-mapped address and read only after the window's event, then
copied out (the fragment's ACTIONS column keeps every window's
actions, and the next window overwrites the buffer). The retained
frame buffer is updated in place (the JAX sampler donated it); the
stack never is: each step's observation is a fresh tensor, and the
previous one stays in the train batch.

Byte/time accounting (`bytes_h2d`, `bytes_d2h`, `t_fetch`, `t_env`,
`policy_lag_sum`, `fetch_waits`) is kept on the instance and counts what
the JAX sampler counts. Its wire-codec probe needs the runtime's stream
encoder, which is not ported: `wire_probe_raw`/`wire_probe_wire` stay 0.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..._private.cuda_build import CudaKernel, device_stream_handle
from .. import sample_batch as sb
from ..env.delta_obs import all_pad_delta
from ..sample_batch import SampleBatch
from .sampler import RolloutMetrics

# K3: a (row, pixel-chunk) grid; see the source note in csrc/obs_apply.cu.
OBS_APPLY_KERNEL = CudaKernel(
    "obs_apply", "obs_apply.cu", "obs_apply",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p])

# K3's launch plan: about two blocks per SM of an H100 (132 SMs), chunk
# edges on 16-pixel lines (one uint4 of frame bytes), chunks of 256 to
# 1024 pixels (a block's 256 threads hold one 4-pixel word each; the
# kernel's kMaxChunk).
OBS_APPLY_TARGET_BLOCKS = 2 * 132
OBS_APPLY_ALIGN_PX = 16
OBS_APPLY_MIN_CHUNK_PX = 256
OBS_APPLY_MAX_CHUNK_PX = 1024

_UINT8 = (torch.uint8,)
_INT32 = (torch.int32,)
_DONE = (torch.uint8, torch.bool)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def obs_apply_plan(n: int, hw: int) -> Tuple[int, int]:
    """(chunks per row, pixels per chunk) of K3's grid of n * chunks
    blocks: enough chunks that n rows give OBS_APPLY_TARGET_BLOCKS
    blocks, each a multiple of OBS_APPLY_ALIGN_PX pixels, at least
    OBS_APPLY_MIN_CHUNK_PX and at most OBS_APPLY_MAX_CHUNK_PX; one chunk
    of the whole row where the row fits in one. Chunk c covers
    [c * chunk_px, min((c + 1) * chunk_px, hw)); the last one may be
    ragged."""
    want = max(-(-OBS_APPLY_TARGET_BLOCKS // max(n, 1)),
               -(-hw // OBS_APPLY_MAX_CHUNK_PX))
    chunk = -(-hw // want)
    chunk = -(-chunk // OBS_APPLY_ALIGN_PX) * OBS_APPLY_ALIGN_PX
    chunk = min(max(chunk, OBS_APPLY_MIN_CHUNK_PX), OBS_APPLY_MAX_CHUNK_PX)
    if chunk >= hw:
        return 1, hw
    return -(-hw // chunk), chunk


def _apply_obs_plain(frames: torch.Tensor, frame_shape: Tuple[int, ...],
                     packed: Optional[torch.Tensor] = None,
                     done: Optional[torch.Tensor] = None,
                     rows: Optional[torch.Tensor] = None,
                     fulls: Optional[torch.Tensor] = None,
                     stack: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the K3 kernel: the same three phases,
    with `frames` updated in place and a fresh observation returned."""
    n = frames.shape[0]
    flat = frames.view(n, -1)
    hw = flat.shape[1]
    if rows is not None and len(rows):
        keep = (rows >= 0) & (rows < n)
        flat[rows[keep].long()] = fulls[keep]
    if packed is not None:
        K = (packed.shape[1] - 1) // 3
        if K:
            idx = packed[:, 0:2 * K:2].long() | (
                packed[:, 1:2 * K:2].long() << 8)
            val = packed[:, 2 * K:3 * K]
            keep = idx < hw
            row_ids = torch.arange(n, device=frames.device)[:, None].expand(
                n, K)
            flat[row_ids[keep], idx[keep]] = val[keep]
        d = packed[:, -1] != 0
    else:
        if done is None or done.shape != (n,):
            raise ValueError(f"frame mode needs a [{n}] done upload")
        d = done != 0
    frame = flat.view((n,) + tuple(frame_shape))
    if stack is None:
        return frame.clone()
    rolled = torch.cat([stack[..., 1:], frame.to(stack.dtype)], dim=-1)
    filled = frame.to(stack.dtype).expand_as(stack)
    return torch.where(d.view((n,) + (1,) * (stack.dim() - 1)), filled,
                       rolled)


def _check_obs_tensor(name: str, x: torch.Tensor, index: int,
                      dtypes=_UINT8) -> None:
    """One K3 operand: an allowed dtype, on CUDA device `index`, dense."""
    if x.dtype not in dtypes:
        raise ValueError(f"obs_apply kernel: {name} is {x.dtype}")
    if x.get_device() != index:
        raise ValueError(f"obs_apply kernel: {name} is on {x.device}, "
                         f"not cuda:{index}")
    if not x.is_contiguous():
        raise ValueError(f"obs_apply kernel: {name} is not contiguous")


def _check_obs_frames(frames: torch.Tensor, n: int, hw: int, index: int,
                      frame_shape: Tuple[int, ...]) -> None:
    _check_obs_tensor("frames", frames, index)
    if frames.numel() != n * hw:
        raise ValueError(f"obs_apply kernel: frames {tuple(frames.shape)} "
                         f"do not hold {n} frames of {tuple(frame_shape)}")


def _check_obs_stack(stack: Optional[torch.Tensor], n: int, index: int,
                     frame_shape: Tuple[int, ...]) -> int:
    """The stack's depth S (0 without one), after checking it."""
    if stack is None:
        return 0
    _check_obs_tensor("stack", stack, index)
    S = stack.shape[-1]
    if stack.shape != (n,) + tuple(frame_shape[:-1]) + (S,):
        raise ValueError(f"obs_apply kernel: stack is "
                         f"{tuple(stack.shape)} for frames "
                         f"{tuple(frame_shape)}")
    return S


def _check_obs_uploads(n: int, hw: int, index: int, packed, done, rows,
                       fulls) -> Tuple[int, int]:
    """What one call brings: the packed delta rows (or, in frame mode,
    the done upload) and the full rows. Returns (K, b)."""
    K = 0
    if packed is not None:
        _check_obs_tensor("packed", packed, index)
        K = (packed.shape[1] - 1) // 3
        if packed.shape != (n, 3 * K + 1):
            raise ValueError(f"obs_apply kernel: packed is "
                             f"{tuple(packed.shape)}, not [{n}, 3K+1]")
    else:
        if done is None or done.shape != (n,):
            raise ValueError(f"obs_apply kernel: frame mode needs a [{n}] "
                             "done upload")
        _check_obs_tensor("done", done, index, _DONE)
    b = 0
    if rows is not None and len(rows):
        _check_obs_tensor("rows", rows, index, _INT32)
        b = rows.shape[0]
        if fulls is None or fulls.shape != (b, hw):
            raise ValueError(f"obs_apply kernel: fulls must be [{b}, {hw}]")
        _check_obs_tensor("fulls", fulls, index)
    return K, b


def _launch_obs_apply(frames, packed, K, done, rows, fulls, b, stack, out,
                      n, hw, S, chunk_px, index) -> torch.Tensor:
    OBS_APPLY_KERNEL.launch(
        frames.data_ptr(), packed.data_ptr() if packed is not None else None,
        K, done.data_ptr() if packed is None else None,
        rows.data_ptr() if b else None, fulls.data_ptr() if b else None, b,
        stack.data_ptr() if S else None, out.data_ptr(), n, hw, S, chunk_px,
        device_stream_handle(index))
    return out


def _apply_obs_cuda(frames, frame_shape, packed=None, done=None, rows=None,
                    fulls=None, stack=None) -> torch.Tensor:
    """Launch K3. All byte tensors uint8 (rows int32), contiguous, on
    one CUDA device; allocates the output. Checks every operand: the
    sampler's groups use `GroupObsApply`, which checks the buffers that
    stay the same from call to call once."""
    n = frames.shape[0]
    hw = math.prod(frame_shape)
    index = frames.get_device()
    _check_obs_frames(frames, n, hw, index, frame_shape)
    S = _check_obs_stack(stack, n, index, frame_shape)
    K, b = _check_obs_uploads(n, hw, index, packed, done, rows, fulls)
    out = torch.empty_like(stack) if S else torch.empty(
        (n,) + tuple(frame_shape), dtype=torch.uint8, device=frames.device)
    return _launch_obs_apply(frames, packed, K, done, rows, fulls, b, stack,
                             out, n, hw, S, obs_apply_plan(n, hw)[1], index)


def apply_obs(frames: torch.Tensor, frame_shape: Tuple[int, ...], *,
              packed: Optional[torch.Tensor] = None,
              done: Optional[torch.Tensor] = None,
              rows: Optional[torch.Tensor] = None,
              fulls: Optional[torch.Tensor] = None,
              stack: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One env step's observation, built on the frames' device.

    Delta mode: `frames` is the retained [n, HW] uint8 buffer, updated in
    place: first whole rows `fulls[j]` where `rows[j]` < n (`rows` pads
    with n), then the packed [n, 3K+1] step (K little-endian uint16
    indices, K values, the done byte; indices >= HW are dropped). Frame
    mode (`packed` None): `frames` is the uploaded [n, *frame_shape]
    batch, read only, with `done` [n].

    Returns a fresh tensor: the stack [n, H, W, S] rolled by one channel
    with the new frame last, or the frame in every channel where done is
    set; without a stack, a copy of the frames as [n, *frame_shape].
    CUDA tensors launch the K3 kernel (or raise); CPU tensors take the
    plain version. No gradient is involved: the operands are bytes.
    """
    if frames.is_cuda:
        return _apply_obs_cuda(frames, frame_shape, packed, done, rows,
                               fulls, stack)
    if frames.is_cpu:
        return _apply_obs_plain(frames, frame_shape, packed, done, rows,
                                fulls, stack)
    raise ValueError(f"no obs_apply kernel for {frames.device}")


class GroupObsApply:
    """`apply_obs` for one env group of the sampler, on its hot path.

    Built once per group: it checks the buffers that stay the same from
    call to call (the retained frames in delta mode, and the stack's
    shape, dtype, device and contiguity, which every output of K3 keeps,
    since each is `torch.empty_like` of the stack it rolled) and fixes
    the launch plan. A call then checks only what it brings: the packed
    delta rows and full rows, or in frame mode the frame and done
    uploads. On the CPU every call takes the plain version.
    """

    def __init__(self, device: torch.device, n: int,
                 frame_shape: Tuple[int, ...],
                 stack: Optional[torch.Tensor],
                 frames: Optional[torch.Tensor] = None):
        self.n = n
        self.frame_shape = tuple(frame_shape)
        self.hw = math.prod(self.frame_shape)
        self.cuda = device.type == "cuda"
        if not self.cuda:
            return
        self.index = device.index if device.index is not None \
            else torch.cuda.current_device()
        if frames is not None:
            _check_obs_frames(frames, n, self.hw, self.index,
                              self.frame_shape)
        self.S = _check_obs_stack(stack, n, self.index, self.frame_shape)
        self.chunk_px = obs_apply_plan(n, self.hw)[1]

    def __call__(self, frames: torch.Tensor, stack: Optional[torch.Tensor],
                 packed: Optional[torch.Tensor] = None,
                 done: Optional[torch.Tensor] = None,
                 rows: Optional[torch.Tensor] = None,
                 fulls: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`apply_obs(frames, frame_shape, ...)` with the group's stack
        (None: no stack); in delta mode `frames` is the group's retained
        buffer that the constructor checked."""
        if not self.cuda:
            return _apply_obs_plain(frames, self.frame_shape, packed, done,
                                    rows, fulls, stack)
        n, hw, index = self.n, self.hw, self.index
        if packed is None:  # frame mode: the frames are this call's upload
            _check_obs_frames(frames, n, hw, index, self.frame_shape)
        K, b = _check_obs_uploads(n, hw, index, packed, done, rows, fulls)
        out = torch.empty_like(stack) if self.S else torch.empty(
            (n,) + self.frame_shape, dtype=torch.uint8, device=frames.device)
        return _launch_obs_apply(frames, packed, K, done, rows, fulls, b,
                                 stack, out, n, hw, self.S, self.chunk_px,
                                 index)


class _EnvGroup:
    """One double-buffered slice of an inline actor's env slots.

    Owns everything that must be independent for the group's device
    pipeline to run while its siblings' fetches are in flight: the env,
    frame stack, retained delta frames, episode bookkeeping, and the
    pending (dispatched, unfetched) selection window.
    """

    def __init__(self, sampler: "DeviceSebulbaSampler", env, eps_base: int):
        self.env = env
        n = env.num_envs
        self.n = n
        self.ep_rew = np.zeros(n, np.float64)
        self.ep_len = np.zeros(n, np.int64)
        self.cur_eps = eps_base + np.arange(n, dtype=np.int64)
        self.host_done = np.ones(n, bool)
        # The window's int32 [k, n] wire actions: K2k writes them straight
        # into this buffer (pinned, so the card can write it; on the CPU
        # the plain path copies them in). One buffer per group, reused by
        # every window: `_consume_window` copies a window's actions out
        # before the next window is dispatched into it.
        self.host_actions = sampler._staging((sampler.k, n), torch.int32)[0]
        # Dispatched window: (event, logp [k, n], dist_inputs [n, A],
        # value [n]); its actions land in `host_actions`.
        self.pending = None
        # Fetched window consumed sub-step by sub-step.
        self.win_actions = None  # host [k, n]
        self.win_logp = None     # device [k, n]
        self.win_di = None       # device [n, A]
        self.win_val = None      # device [n]
        # Device obs for the NEXT transition (output of the last apply).
        self.obs_next = None
        if sampler.frame_stack:
            space = env.observation_space
            self.stack = torch.zeros(
                (n,) + tuple(space.shape),
                dtype=_torch_dtype(space.dtype),
                device=sampler.device)
        else:
            self.stack = None
        if sampler.delta:
            ds = env.vector_reset_delta()
            self.frames_d = sampler._upload(
                np.ascontiguousarray(ds.full_frames))
            sampler.bytes_h2d += ds.full_frames.nbytes
            self.host_delta = None
        else:
            self.host_obs = np.asarray(env.vector_reset())
        # K3 for this group: the buffers that stay fixed are checked here.
        self.apply = None
        if sampler.delta or sampler.frame_stack:
            self.apply = GroupObsApply(
                sampler.device, n, sampler._frame_shape
                if sampler.delta else tuple(self.host_obs.shape[1:]),
                self.stack, self.frames_d if sampler.delta else None)


class DeviceSebulbaSampler:
    """Steps BatchedEnv groups for T steps per sample(); obs live on the
    policy's device.

    Feedforward policies only. Output layout: flat [N*T] rows,
    fragment-major (group 0's envs first), plus per-fragment
    BOOTSTRAP_OBS; the big columns are tensors on the policy's device.

    `batched_env` may be a single BatchedEnv (one group — the serial
    pipeline) or a list of same-sized BatchedEnvs (one per group).
    `seed` seeds the sampler's own `torch.Generator` (the uniforms of
    the action draws); None draws a fresh seed.
    """

    def __init__(self, batched_env, policy,
                 rollout_fragment_length: int,
                 explore: bool = True,
                 eps_id_offset: int = 0,
                 use_delta: bool = True,
                 onchip_steps: int = 1,
                 seed: Optional[int] = None):
        if getattr(policy, "recurrent", False):
            raise ValueError(
                "DeviceSebulbaSampler supports feedforward policies only")
        envs: List = (list(batched_env)
                      if isinstance(batched_env, (list, tuple))
                      else [batched_env])
        if len({e.num_envs for e in envs}) != 1:
            raise ValueError(
                "all env groups must have the same number of env slots; "
                f"got {[e.num_envs for e in envs]}")
        self.policy = policy
        self.device = policy.device
        self.T = rollout_fragment_length
        self.k = max(1, int(onchip_steps))
        if self.T % self.k:
            raise ValueError(
                f"rollout_fragment_length ({self.T}) must be a multiple "
                f"of sebulba_onchip_steps ({self.k}) — fragments tile "
                "whole selection windows")
        self.explore = explore
        self.generator = torch.Generator(device=self.device)
        if seed is None:
            self.generator.seed()
        else:
            self.generator.manual_seed(seed)
        self.frame_stack = int(getattr(envs[0], "device_frame_stack", 0))
        self.delta = bool(use_delta
                          and all(hasattr(e, "delta_budget") for e in envs))
        self._n = sum(e.num_envs for e in envs)
        self._eps_counter = eps_id_offset
        self.metrics: List[RolloutMetrics] = []
        # ---- transfer accounting --------------------------------------
        self.bytes_h2d = 0       # delta entries / frames + flags shipped
        self.bytes_d2h = 0       # action arrays fetched down
        self.t_fetch = 0.0       # host blocked waiting for actions
        self.t_env = 0.0         # host inside env.vector_step
        self.steps_total = 0
        self.policy_lag_sum = 0  # sum over transitions of selection lag
        self.fetch_waits = 0     # blocking D2H action fetches (windows)

        inner = getattr(envs[0], "inner", envs[0])
        self._frame_shape = tuple(inner.observation_space.shape)
        if self.delta:
            self._hw = math.prod(self._frame_shape)

        self.groups: List[_EnvGroup] = []
        for env in envs:
            self.groups.append(_EnvGroup(self, env, self._eps_counter))
            self._eps_counter += env.num_envs
        # Prime every group's pipeline: obs_0 onto the device, first
        # selection window dispatched.
        for g in self.groups:
            self._dispatch_apply(g)
            self._dispatch_select(g)

    # ------------------------------------------------------------------
    def _staging(self, shape, dtype) -> Tuple[torch.Tensor, np.ndarray]:
        """A fresh host buffer to fill for one upload (pinned on a CUDA
        device) and its numpy view."""
        host = torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")
        return host, host.numpy()

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A staging buffer onto the device without blocking the host
        (on the CPU the fresh buffer itself is the device tensor)."""
        if self.device.type == "cpu":
            return host
        return host.to(self.device, non_blocking=True)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        array = np.ascontiguousarray(array)
        host, view = self._staging(array.shape, _torch_dtype(array.dtype))
        view[...] = array
        return self._to_device(host)

    @staticmethod
    def _pack_step(idx: np.ndarray, val: np.ndarray, done: np.ndarray,
                   out: np.ndarray) -> np.ndarray:
        """One contiguous uint8 buffer per step (layout read back by
        `apply_obs`): [idx as LE uint16 bytes | val | done]."""
        assert idx.dtype == np.uint16
        K = idx.shape[1]
        out[:, :2 * K] = np.ascontiguousarray(idx).view(np.uint8)
        out[:, 2 * K:3 * K] = val
        out[:, 3 * K] = done
        return out

    # ------------------------------------------------------------------
    def _dispatch_apply(self, g: _EnvGroup):
        """Upload the group's newest env output and launch the obs apply
        (full rows, delta scatter, frame-stack update). Returns without
        waiting for the device; `g.obs_next` is the device tensor of the
        next transition's observation."""
        done = g.host_done
        S = self.frame_stack
        if self.delta:
            ds = g.host_delta
            rows_d = fulls_d = None
            if ds is not None and len(ds.full_rows):
                # Resets / over-budget rows: bucketed full-row replacement
                # ahead of the sparse delta (delta entries for these rows
                # are pad, per the DeltaStep contract).
                m = len(ds.full_rows)
                b = 1 << (m - 1).bit_length() if m > 1 else 1
                b = min(b, g.n)
                rows_h, rows = self._staging((b,), torch.int32)
                rows[:] = g.n
                rows[:m] = ds.full_rows
                fulls_h, fulls = self._staging((b, self._hw), torch.uint8)
                fulls[:m] = ds.full_frames
                fulls[m:] = 0
                rows_d, fulls_d = self._to_device(rows_h), \
                    self._to_device(fulls_h)
                self.bytes_h2d += rows.nbytes + fulls.nbytes
            if ds is None:
                # First step after reset: frames already uploaded whole;
                # an all-pad delta leaves them untouched.
                pad = all_pad_delta(g.n, int(g.env.delta_budget), self._hw)
                idx, val = pad.idx, pad.val
            else:
                idx, val = ds.idx, ds.val
            packed_h, packed = self._staging(
                (g.n, 3 * idx.shape[1] + 1), torch.uint8)
            self._pack_step(idx, val, done, packed)
            self.bytes_h2d += packed.nbytes
            g.obs_next = g.apply(
                g.frames_d, g.stack, packed=self._to_device(packed_h),
                rows=rows_d, fulls=fulls_d)
        else:
            frame = g.host_obs
            frame_d = self._upload(frame)
            done_d = self._upload(done)
            self.bytes_h2d += frame.nbytes + done.nbytes
            if S:
                g.obs_next = g.apply(frame_d, g.stack, done=done_d)
            else:
                g.obs_next = frame_d
        if S:
            g.stack = g.obs_next

    def _dispatch_select(self, g: _EnvGroup):
        """Enqueue the selection window for the group's newest obs: the
        forward and K2k, which writes the [k, n] int32 wire actions
        straight into the group's pinned `host_actions`, so that the
        fetch finds them there once the window's event has completed.
        Reads live parameters under the policy's update lock
        (`TorchPolicy.select`)."""
        _, logp, di, val = self.policy.select(
            g.obs_next, self.k, self.generator, self.explore,
            host_actions=g.host_actions)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        g.pending = (event, logp, di, val)

    def _consume_window(self, g: _EnvGroup):
        """Wait for the group's dispatched selection window — the ONLY
        device wait on the hot path, one [k, n] array per k steps — and
        copy its actions out of the group's host buffer, which the next
        window is written into."""
        event, logp, di, val = g.pending
        g.pending = None
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        g.win_actions = g.host_actions.numpy().copy()
        self.t_fetch += time.perf_counter() - t0
        self.fetch_waits += 1
        self.bytes_d2h += g.win_actions.nbytes
        g.win_logp, g.win_di, g.win_val = logp, di, val

    # ------------------------------------------------------------------
    def sample(self) -> SampleBatch:
        T, k = self.T, self.k
        G = len(self.groups)
        obs_buf = [[] for _ in range(G)]
        logp_buf = [[] for _ in range(G)]
        di_buf = [[] for _ in range(G)]
        vf_buf = [[] for _ in range(G)]
        act_host = [[] for _ in range(G)]
        rew_buf = [[] for _ in range(G)]
        done_buf = [[] for _ in range(G)]
        eps_ids = [np.empty((T, g.n), np.int64) for g in self.groups]
        ts = [np.empty((T, g.n), np.int64) for g in self.groups]

        for t in range(T):
            jw = t % k
            for gi, g in enumerate(self.groups):
                if jw == 0:
                    # While this fetch waits, the other groups' applies
                    # and selects are already queued on the device.
                    self._consume_window(g)
                obs_buf[gi].append(g.obs_next)
                logp_buf[gi].append(g.win_logp[jw])
                di_buf[gi].append(g.win_di)
                vf_buf[gi].append(g.win_val)
                actions = g.win_actions[jw]
                t0 = time.perf_counter()
                if self.delta:
                    g.host_delta, rewards, dones = \
                        g.env.vector_step_delta(actions)
                else:
                    next_obs, rewards, dones = g.env.vector_step(actions)
                    g.host_obs = np.asarray(next_obs)
                self.t_env += time.perf_counter() - t0
                eps_ids[gi][t] = g.cur_eps
                ts[gi][t] = g.ep_len
                act_host[gi].append(actions)
                rew_buf[gi].append(np.asarray(rewards, np.float32))
                done_buf[gi].append(np.asarray(dones))
                g.ep_rew += rewards
                g.ep_len += 1
                if dones.any():
                    done_idx = np.nonzero(dones)[0]
                    for i in done_idx:
                        self.metrics.append(RolloutMetrics(
                            int(g.ep_len[i]), float(g.ep_rew[i])))
                    g.ep_rew[dones] = 0.0
                    g.ep_len[dones] = 0
                    g.cur_eps[dones] = self._eps_counter + np.arange(
                        len(done_idx), dtype=np.int64)
                    self._eps_counter += len(done_idx)
                g.host_done = np.asarray(dones)
                self.steps_total += g.n
                # The obs apply for the NEXT step is enqueued now; at
                # window end the next selection is too.
                self._dispatch_apply(g)
                if jw == k - 1:
                    self._dispatch_select(g)

        # Selection lag per transition: sub-step j of a window executed
        # an action chosen from the window-head obs, j steps stale.
        lags = (np.arange(T, dtype=np.int64) % k).astype(np.int32)
        self.policy_lag_sum += int(lags.sum()) * self._n

        # Each group's obs_next is the post-fragment bootstrap
        # observation AND step 0 of the next fragment — computed once.
        boot_obs = (self.groups[0].obs_next if G == 1 else
                    torch.cat([g.obs_next for g in self.groups], dim=0))

        def dpack(gbufs):
            parts = []
            for g, bufs in zip(self.groups, gbufs):
                a = torch.stack(bufs)  # [T, n, ...]
                parts.append(a.transpose(0, 1).reshape(
                    (g.n * T,) + tuple(a.shape[2:])))
            return parts[0] if G == 1 else torch.cat(parts, dim=0)

        def hpack(gbufs):
            parts = []
            for g, bufs in zip(self.groups, gbufs):
                a = np.stack(bufs)
                parts.append(np.swapaxes(a, 0, 1).reshape(
                    (g.n * T,) + a.shape[2:]))
            return parts[0] if G == 1 else np.concatenate(parts, axis=0)

        def hpack_tn(arrs):
            return np.concatenate(
                [np.swapaxes(a, 0, 1).reshape(-1) for a in arrs])

        return SampleBatch({
            sb.OBS: dpack(obs_buf),
            sb.ACTION_LOGP: dpack(logp_buf),
            sb.ACTION_DIST_INPUTS: dpack(di_buf),
            sb.VF_PREDS: dpack(vf_buf),
            sb.BOOTSTRAP_OBS: boot_obs,
            sb.ACTIONS: hpack(act_host),
            sb.REWARDS: hpack(rew_buf),
            sb.DONES: hpack(done_buf),
            sb.EPS_ID: hpack_tn(eps_ids),
            sb.T: hpack_tn(ts),
            sb.POLICY_LAG: np.tile(lags, self._n),
        })

    def get_metrics(self) -> List[RolloutMetrics]:
        out = self.metrics
        self.metrics = []
        return out

    def transfer_stats(self) -> dict:
        return {
            "bytes_h2d": self.bytes_h2d,
            "bytes_d2h": self.bytes_d2h,
            "t_fetch_s": round(self.t_fetch, 3),
            "t_env_s": round(self.t_env, 3),
            "steps": self.steps_total,
            "policy_lag_sum": self.policy_lag_sum,
            "fetch_waits": self.fetch_waits,
            # The runtime's wire-codec probe is not ported (needs the
            # runtime's stream encoder): kept at 0.
            "wire_probe_raw": 0,
            "wire_probe_wire": 0,
        }
