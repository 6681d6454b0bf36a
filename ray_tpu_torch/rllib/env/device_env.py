"""Device-resident environments: the Anakin-side env API.

Counterpart of `ray_tpu/rllib/env/jax_env.py`. The JAX package wrote its
device envs as pure functions of one env that XLA vmapped and fused into
the Anakin program (`optimizers/anakin_optimizer.py`); here each env's
batched step is one hand-written CUDA kernel (`csrc/device_env.cu`),
launched once per env step for all N envs, with a plain PyTorch version
of the same function beside it for CPU tensors. Observations never leave
the device.

API (batched: torch has no `vmap`):
  - `reset(n, seed, device=..., counter=0, obs_out=None) -> (state, obs)`
  - `step(state, actions, seed, counter, obs_out=None, reward_out=None,
    done_out=None, episodes=None) -> (state, obs, reward, done)`,
    auto-resetting as `jax_env.py:13-19` specifies: where an episode
    ends, the returned state and obs are the next episode's initial ones
    and done is True.

State is a small dict of tensors on one device (SyntheticAtari: `t`,
`target` int32 [N]; CartPole: `s` f32 [N, 4], `t` int32 [N]). Unlike the
JAX envs' immutable arrays, `step` updates the state tensors in place
and returns the same dict, and writes the observation into `obs_out`
(any [N, *obs_shape] view whose rows are contiguous, such as one time
slot of an env-major trajectory buffer) without a copy; `reward_out`
and `done_out` may likewise be strided [N] views. `episodes`
(`EpisodeAccumulator`) takes the Anakin step's episode bookkeeping into
the same launch.

`bind(state, obs_slots, reward_slots, done_slots, seed=..., episodes=...)`
fixes a rollout's buffers once (one obs, reward and done view per
trajectory slot) and returns a step `(actions, slot, counter)`. For
CartPole (`BoundCartPoleStep`) the buffers are checked at bind time and
a step checks only the action tensor and launches K5b with its fixed
arguments in one prebuilt struct; other envs' bound step calls `step`.

Randomness is Philox4x32-10 keyed by `seed` at the host's launch
counter `counter` (see the source note in `csrc/device_env.cu`); the
plain versions compute the same stream with torch integer ops, so on the
card kernel and plain agree byte for byte. jax.random's streams differ:
the tests hold the deterministic parts against `jax_env.py` exactly and
the random ones by distribution.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._private.cuda_build import (CudaKernel, device_stream_handle,
                                   stream_handle)
from .env import init_cartpole_constants
from .spaces import Box, Discrete

# ---------------------------------------------------------------------
# Philox4x32-10 in torch integer ops
# ---------------------------------------------------------------------
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
# Counter word of an env's draws (target, reset state); frame chunks use
# words 0..1763.
DRAW_WORD = 0x80000000
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * b for a 32-bit constant m and int64
    tensors b holding 32-bit values. The 64-bit product overflows int64,
    so it is assembled from 16-bit limbs (each partial product < 2^32)."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    ll = b_lo * m_lo
    mid = b_hi * m_lo + b_lo * m_hi + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = b_hi * m_hi + (mid >> 16)
    return hi, lo


def philox4x32(counter: Sequence[torch.Tensor], key: Tuple[int, int]
               ) -> List[torch.Tensor]:
    """Philox4x32-10 of the four 32-bit counter words (int64 tensors,
    broadcast together) under the 2-word key; returns the four output
    words as int64 tensors holding 32-bit values."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & _MASK32, (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def _stream(word, n: int, seed: int, counter: int, device
            ) -> List[torch.Tensor]:
    """Philox words for counter (word, env, counter lo, counter hi), env
    in 0..n-1 along the first axis and `word` (an int or an int64 tensor
    of shape [1, W]) along the second."""
    def full(v):
        return torch.full((), v, dtype=torch.int64, device=device)

    env = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    if isinstance(word, int):
        word = full(word)
    return philox4x32((word, env, full(counter & _MASK32),
                       full(counter >> 32)),
                      (seed & _MASK32, seed >> 32))


def _draws(n: int, seed: int, counter: int, device) -> List[torch.Tensor]:
    """Each env's four draw words, [n] int64 each."""
    return [w[:, 0] for w in _stream(DRAW_WORD, n, seed, counter, device)]


_U64 = 1 << 64


def _check_rng(seed: int, counter: int) -> None:
    for name, v in (("seed", seed), ("counter", counter)):
        if not 0 <= int(v) < _U64:
            raise ValueError(f"{name} {v} is not a 64-bit unsigned value")


# ---------------------------------------------------------------------
# Episode bookkeeping
# ---------------------------------------------------------------------
class EpisodeAccumulator:
    """Per-env running episode reward/length and the per-env sums over
    completed episodes (reference: the `ep_rew`, `ep_len` and `ep_acc`
    carry of `anakin_optimizer.py:106-114`). The env kernels update it in
    place; `totals()` reduces the completed sums over envs on the device.
    """

    FIELDS = ("ep_rew", "ep_len", "done_rew", "done_len", "done_cnt")

    def __init__(self, n: int, device):
        f32, i32 = torch.float32, torch.int32
        self.ep_rew = torch.zeros(n, dtype=f32, device=device)
        self.ep_len = torch.zeros(n, dtype=i32, device=device)
        self.done_rew = torch.zeros(n, dtype=f32, device=device)
        self.done_len = torch.zeros(n, dtype=i32, device=device)
        self.done_cnt = torch.zeros(n, dtype=i32, device=device)

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f) for f in self.FIELDS]

    def zero_sums(self) -> None:
        """Start a new accounting window (the running episodes go on)."""
        for x in (self.done_rew, self.done_len, self.done_cnt):
            x.zero_()

    def totals(self) -> torch.Tensor:
        """float64 [3] on the device: completed-episode reward sum,
        length sum and count since `zero_sums`."""
        return torch.stack([self.done_rew.double().sum(),
                            self.done_len.double().sum(),
                            self.done_cnt.double().sum()])

    def record(self, reward: torch.Tensor, done: torch.Tensor) -> None:
        """The kernels' bookkeeping in plain PyTorch (same arithmetic)."""
        r = self.ep_rew + reward
        length = self.ep_len + 1
        self.done_rew += torch.where(done, r, 0.0)
        self.done_len += torch.where(done, length, 0)
        self.done_cnt += done.int()
        self.ep_rew.copy_(torch.where(done, 0.0, r))
        self.ep_len.copy_(torch.where(done, 0, length))


def _episode_pointers(episodes: Optional[EpisodeAccumulator], n: int,
                      device) -> List[Optional[int]]:
    if episodes is None:
        return [None] * 5
    out = []
    for name, x in zip(EpisodeAccumulator.FIELDS, episodes.tensors()):
        want = torch.float32 if name.endswith("rew") else torch.int32
        if x.dtype != want or x.shape != (n,) or x.device != device \
                or not x.is_contiguous():
            raise ValueError(f"episodes.{name} must be a contiguous [{n}] "
                             f"{want} tensor on {device}")
        out.append(x.data_ptr())
    return out


def _check_state(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the state on {device}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _row_stride(name: str, x: torch.Tensor, n: int, row_shape, dtype,
                device, align: int = 1) -> int:
    """Stride (elements) between the rows of an [n, *row_shape] output
    view whose rows are each contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the state on {device}")
    if x.dtype != dtype or tuple(x.shape) != (n,) + tuple(row_shape):
        raise ValueError(f"{name} must be {dtype} {(n,) + tuple(row_shape)}"
                         f", got {x.dtype} {tuple(x.shape)}")
    inner = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size > 1 and stride != inner:
            raise ValueError(f"{name}: each row must be contiguous")
        inner *= size
    stride = x.stride(0) if n > 1 else inner
    if stride * x.element_size() % align or x.data_ptr() % align:
        raise ValueError(f"{name}: rows must start on {align}-byte "
                         "boundaries")
    return stride


def _step_arguments(actions, reward, done, episodes, n: int, device,
                    reset: bool):
    """Checked kernel arguments of a step's inputs and outputs: pointers
    to (actions, reward, done), the reward/done row stride and the five
    episode-field pointers (all None, and stride 0, on a reset)."""
    if reset:
        return [None, None, None], 0, [None] * 5
    _check_state("actions", actions, (n,), torch.int64, device)
    out_stride = _row_stride("reward", reward, n, (), torch.float32, device)
    if _row_stride("done", done, n, (), torch.bool, device) != out_stride:
        raise ValueError("reward and done must share one row stride")
    return ([actions.data_ptr(), reward.data_ptr(), done.data_ptr()],
            out_stride, _episode_pointers(episodes, n, device))


def _dispatch(x: torch.Tensor, plain, cuda, name: str):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"no {name} kernel for {x.device}")


# ---------------------------------------------------------------------
# K5a: SyntheticAtari
# ---------------------------------------------------------------------
FRAME_SHAPE = (84, 84, 4)
_ROW_CHUNKS = 84 * 4 // 16           # 16-byte chunks per frame row
_CHUNKS = 84 * _ROW_CHUNKS           # per frame

# One block per env; see the source note in csrc/device_env.cu.
SYNTHETIC_ATARI_KERNEL = CudaKernel(
    "synthetic_atari_step", "device_env.cu", "synthetic_atari_step",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
    + [ctypes.c_longlong] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_uint64] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _targets_plain(n: int, num_actions: int, seed: int, counter: int,
                   device) -> torch.Tensor:
    """Uniform targets on [0, A): floor(x * A / 2^32) of draw word x."""
    x = _draws(n, seed, counter, device)[0]
    return ((x * num_actions) >> 32).to(torch.int32)


def _render_plain(target: torch.Tensor, num_actions: int, seed: int,
                  counter: int) -> torch.Tensor:
    """[n, 84, 84, 4] uint8 frames: Philox noise bytes & 63, +128 on the
    rows of each env's target band (reference: `JaxSyntheticAtari._obs`).
    Chunk i of env n is the 16 little-endian bytes of its Philox words."""
    n, device = target.shape[0], target.device
    chunk = torch.arange(_CHUNKS, dtype=torch.int64, device=device)[None]
    words = torch.stack(_stream(chunk, n, seed, counter, device), -1)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    noise = (words[..., None] >> shifts) & 0x3F          # [n, C, 4, 4]
    band = 84 // num_actions
    row = chunk // _ROW_CHUNKS
    tgt = target.long()[:, None]
    in_band = (row >= tgt * band) & (row < (tgt + 1) * band)
    frame = noise | (in_band.long() << 7)[..., None, None]
    return frame.to(torch.uint8).reshape((n,) + FRAME_SHAPE)


def _synthetic_atari_step_plain(t, target, actions, obs, reward, done,
                                episodes, num_actions, episode_len, seed,
                                counter, reset):
    """Plain PyTorch version of K5a, with the kernel's in-place effects:
    the state, `obs` and (on a step) `reward`, `done` and `episodes`."""
    new_target = _targets_plain(t.shape[0], num_actions, seed, counter,
                                t.device)
    if reset:
        t.zero_()
    else:
        r = (actions == target).to(torch.float32)
        tn = t + 1
        d = tn >= episode_len
        t.copy_(torch.where(d, 0, tn))
        reward.copy_(r)
        done.copy_(d)
        if episodes is not None:
            episodes.record(r, d)
    target.copy_(new_target)
    obs.copy_(_render_plain(new_target, num_actions, seed, counter))


def _synthetic_atari_step_cuda(t, target, actions, obs, reward, done,
                               episodes, num_actions, episode_len, seed,
                               counter, reset):
    """Launch K5a on the state's device after checking every argument."""
    device = t.device
    if device.type != "cuda":
        raise ValueError(f"synthetic_atari_step kernel: t is on {device}")
    if t.dim() != 1:
        raise ValueError(f"t must be [N], got {tuple(t.shape)}")
    n = t.shape[0]
    _check_state("t", t, (n,), torch.int32, device)
    _check_state("target", target, (n,), torch.int32, device)
    if not 1 <= num_actions < 1 << 16:
        raise ValueError(f"num_actions {num_actions} not in [1, 65536)")
    _check_rng(seed, counter)
    obs_stride = _row_stride("obs", obs, n, FRAME_SHAPE, torch.uint8,
                             device, align=16)
    ptrs, out_stride, eps = _step_arguments(actions, reward, done,
                                            episodes, n, device, reset)
    SYNTHETIC_ATARI_KERNEL.launch(
        t.data_ptr(), target.data_ptr(), ptrs[0], obs.data_ptr(),
        obs_stride, ptrs[1], ptrs[2], out_stride, *eps, n, num_actions,
        episode_len, seed, counter, int(bool(reset)), stream_handle(t))


# ---------------------------------------------------------------------
# K5b: CartPole
# ---------------------------------------------------------------------
# One thread per env; see the source note in csrc/device_env.cu. Two
# entry points launch the one kernel: `cartpole_step` takes every
# argument (`DeviceEnv.step`), `cartpole_step_bound` a `_CartPoleArgs`
# built once by `BoundCartPoleStep` (the Anakin rollout's path); each
# counts its own launches.
CARTPOLE_KERNEL = CudaKernel(
    "cartpole_step", "device_env.cu", "cartpole_step",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
    + [ctypes.c_longlong] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
    + [ctypes.c_uint64] * 2 + [ctypes.c_int, ctypes.c_void_p])
CARTPOLE_BOUND_KERNEL = CudaKernel(
    "cartpole_step_bound", "device_env.cu", "cartpole_step_bound",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p])


class _CartPoleArgs(ctypes.Structure):
    """`CartPoleArgs` of csrc/device_env.cu, field for field (native
    alignment on both sides)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "s", "t", "obs", "reward", "done", "ep_rew", "ep_len", "done_rew",
        "done_len", "done_cnt")] + [
        ("obs_stride", ctypes.c_longlong), ("out_stride", ctypes.c_longlong),
        ("seed", ctypes.c_uint64), ("n", ctypes.c_int),
        ("max_steps", ctypes.c_int), ("reset", ctypes.c_int),
        ("obs_vec", ctypes.c_int)]


def _f32(x: float) -> float:
    """The float32 value a weak-typed Python float becomes in JAX's f32
    arithmetic. Python scalars holding exact f32 values give the same
    results whether PyTorch applies them in f32 or in f64."""
    return float(np.float32(x))


class _CartPoleConstants:
    def __init__(self):
        init_cartpole_constants(self, 0)
        self.gravity, self.masspole, self.total_mass, self.length = (
            _f32(v) for v in (self.gravity, self.masspole,
                              self.total_mass, self.length))
        self.polemass_length = _f32(self.polemass_length)
        self.force_mag, self.tau = _f32(self.force_mag), _f32(self.tau)
        self.four_thirds = _f32(4.0 / 3.0)
        self.theta_threshold = _f32(self.theta_threshold)
        self.x_threshold = _f32(self.x_threshold)


_CP = _CartPoleConstants()
_RESET_SPAN, _RESET_LOW = _f32(0.1), _f32(-0.05)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b, correctly rounded. A Python divisor is made a tensor:
    PyTorch divides by a scalar as a multiply by its reciprocal on CUDA,
    which moves the last bit."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def _cartpole_reset_plain(n: int, seed: int, counter: int, device
                          ) -> torch.Tensor:
    """[n, 4] f32 initial states uniform on [-0.05, 0.05): each draw word
    w gives (w >> 8) * 2^-24 * 0.1 - 0.05, each step rounded to f32."""
    words = torch.stack(_draws(n, seed, counter, device), 1)
    u = (words >> 8).to(torch.float32) * _f32(2.0 ** -24)
    return u * _RESET_SPAN + _RESET_LOW


def _cartpole_dynamics_plain(s: torch.Tensor, actions: torch.Tensor
                             ) -> torch.Tensor:
    """One Euler step of [n, 4] f32 states in `JaxCartPole.step`'s order
    of operations, every operation rounded on its own."""
    c = _CP
    x, x_dot, theta, theta_dot = s.unbind(1)
    force = torch.where(actions == 1, c.force_mag, -c.force_mag).to(
        torch.float32)
    costheta, sintheta = torch.cos(theta), torch.sin(theta)
    temp = _div(force + c.polemass_length * (theta_dot * theta_dot)
                * sintheta, c.total_mass)
    thetaacc = _div(
        c.gravity * sintheta - costheta * temp,
        c.length * (c.four_thirds - _div(
            c.masspole * (costheta * costheta), c.total_mass)))
    xacc = temp - _div(c.polemass_length * thetaacc * costheta,
                       c.total_mass)
    return torch.stack([x + c.tau * x_dot, x_dot + c.tau * xacc,
                        theta + c.tau * theta_dot,
                        theta_dot + c.tau * thetaacc], 1)


def _cartpole_step_plain(s, t, actions, obs, reward, done, episodes,
                         max_steps, seed, counter, reset):
    """Plain PyTorch version of K5b, with the kernel's in-place effects."""
    s0 = _cartpole_reset_plain(s.shape[0], seed, counter, s.device)
    if reset:
        new_s = s0
        t.zero_()
    else:
        new_s = _cartpole_dynamics_plain(s, actions)
        tn = t + 1
        d = ((new_s[:, 0].abs() > _CP.x_threshold)
             | (new_s[:, 2].abs() > _CP.theta_threshold)
             | (tn >= max_steps))
        new_s = torch.where(d[:, None], s0, new_s)
        t.copy_(torch.where(d, 0, tn))
        reward.fill_(1.0)
        done.copy_(d)
        if episodes is not None:
            episodes.record(torch.ones_like(reward), d)
    s.copy_(new_s)
    obs.copy_(new_s)


def _check_cartpole_state(s, t, n: int, device) -> None:
    """The state K5b reads a row of as one float4: f32 [n, 4] contiguous
    from a 16-byte boundary, t int32 [n]."""
    _check_state("s", s, (n, 4), torch.float32, device)
    if s.data_ptr() % 16:
        raise ValueError("s must start on a 16-byte boundary")
    _check_state("t", t, (n,), torch.int32, device)


def _cartpole_step_cuda(s, t, actions, obs, reward, done, episodes,
                        max_steps, seed, counter, reset):
    """Launch K5b on the state's device after checking every argument."""
    device = s.device
    if device.type != "cuda":
        raise ValueError(f"cartpole_step kernel: s is on {device}")
    if s.dim() != 2:
        raise ValueError(f"s must be [N, 4], got {tuple(s.shape)}")
    n = s.shape[0]
    _check_cartpole_state(s, t, n, device)
    _check_rng(seed, counter)
    obs_stride = _row_stride("obs", obs, n, (4,), torch.float32, device,
                             align=4)
    ptrs, out_stride, eps = _step_arguments(actions, reward, done,
                                            episodes, n, device, reset)
    CARTPOLE_KERNEL.launch(
        s.data_ptr(), t.data_ptr(), ptrs[0], obs.data_ptr(), obs_stride,
        ptrs[1], ptrs[2], out_stride, *eps, n, max_steps, seed, counter,
        int(bool(reset)), stream_handle(s))


# ---------------------------------------------------------------------
# Bound steps: a rollout's buffers fixed once
# ---------------------------------------------------------------------
class BoundStep:
    """`env.step` of one rollout's state into fixed buffers: trajectory
    slot `slot` writes its observation into `obs_slots[slot]` and its
    reward and done into `reward_slots[slot]` and `done_slots[slot]`.
    This generic form passes them to `step`, which checks every argument
    on every call."""

    def __init__(self, env: "DeviceEnv", state: Dict[str, torch.Tensor],
                 obs_slots: Sequence[torch.Tensor],
                 reward_slots: Sequence[torch.Tensor],
                 done_slots: Sequence[torch.Tensor], seed: int,
                 episodes: Optional[EpisodeAccumulator] = None):
        self.env, self.state, self.seed = env, state, seed
        self.obs_slots = list(obs_slots)
        self.reward_slots = list(reward_slots)
        self.done_slots = list(done_slots)
        self.episodes = episodes
        sizes = {len(self.obs_slots), len(self.reward_slots),
                 len(self.done_slots)}
        if len(sizes) != 1 or not self.obs_slots:
            raise ValueError("obs_slots, reward_slots and done_slots must "
                             "be equally long, with at least one slot")
        _check_rng(seed, 0)

    def __call__(self, actions: torch.Tensor, slot: int,
                 counter: int) -> None:
        """One step of every env into slot `slot` under launch `counter`."""
        self.env.step(self.state, actions, self.seed, counter,
                      obs_out=self.obs_slots[slot],
                      reward_out=self.reward_slots[slot],
                      done_out=self.done_slots[slot],
                      episodes=self.episodes)


class BoundCartPoleStep(BoundStep):
    """CartPole's bound step (K5b's lean launch path). Bind time checks
    the state, the episode accumulator and every slot's buffers (obs rows
    on 16-byte boundaries, for K5b's float4 stores; reward and done
    sharing one row stride) and builds one `_CartPoleArgs` per slot. A
    step checks only the action tensor (int64 [N], contiguous, on the
    state's device) and the counter, then makes one 4-argument C call. On
    the CPU a step runs the plain version."""

    def __init__(self, env: "DeviceCartPole", state, obs_slots,
                 reward_slots, done_slots, seed: int, episodes=None):
        super().__init__(env, state, obs_slots, reward_slots, done_slots,
                         seed, episodes)
        s, t = state["s"], state["t"]
        if s.dim() != 2:
            raise ValueError(f"s must be [N, 4], got {tuple(s.shape)}")
        n, device = s.shape[0], s.device
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"no cartpole_step kernel for {device}")
        _check_cartpole_state(s, t, n, device)
        eps = _episode_pointers(episodes, n, device)
        self.device, self._shape = device, (n,)
        self._cuda = device.type == "cuda"
        self._index = device.index
        self._args = []  # one per slot, alive as long as the step
        for i, (obs, rew, done) in enumerate(zip(
                self.obs_slots, self.reward_slots, self.done_slots)):
            obs_stride = _row_stride(f"obs_slots[{i}]", obs, n, (4,),
                                     torch.float32, device, align=16)
            out_stride = _row_stride(f"reward_slots[{i}]", rew, n, (),
                                     torch.float32, device)
            if _row_stride(f"done_slots[{i}]", done, n, (), torch.bool,
                           device) != out_stride:
                raise ValueError(f"reward_slots[{i}] and done_slots[{i}] "
                                 "must share one row stride")
            if self._cuda:
                self._args.append(_CartPoleArgs(
                    s.data_ptr(), t.data_ptr(), obs.data_ptr(),
                    rew.data_ptr(), done.data_ptr(), *eps, obs_stride,
                    out_stride, seed, n, env.max_steps, 0, 1))
        self._addresses = [ctypes.addressof(a) for a in self._args]

    def __call__(self, actions: torch.Tensor, slot: int,
                 counter: int) -> None:
        if not 0 <= counter < _U64:
            raise ValueError(f"counter {counter} is not a 64-bit unsigned "
                             "value")
        if not self._cuda:
            _check_state("actions", actions, self._shape, torch.int64,
                         self.device)
            _cartpole_step_plain(
                self.state["s"], self.state["t"], actions,
                self.obs_slots[slot], self.reward_slots[slot],
                self.done_slots[slot], self.episodes, self.env.max_steps,
                self.seed, counter, False)
            return
        if actions.dtype is not torch.int64 \
                or actions.shape != self._shape \
                or actions.get_device() != self._index \
                or not actions.is_contiguous():
            _check_state("actions", actions, self._shape, torch.int64,
                         self.device)
        CARTPOLE_BOUND_KERNEL.launch(self._addresses[slot],
                                     actions.data_ptr(), counter,
                                     device_stream_handle(self._index))


# ---------------------------------------------------------------------
# The envs
# ---------------------------------------------------------------------
class DeviceEnv:
    """A batched env whose step is one kernel (see module docstring).
    Subclasses set the spaces, `obs_dtype`, `STATE` (state key -> (torch
    dtype, per-env shape)) and `_launch`."""

    observation_space = None
    action_space = None
    obs_dtype: torch.dtype = torch.float32
    STATE: Dict[str, Tuple[torch.dtype, Tuple[int, ...]]] = {}

    def _launch(self, state, actions, obs, reward, done, episodes, seed,
                counter, reset):
        raise NotImplementedError

    def empty_obs(self, n: int, device) -> torch.Tensor:
        return torch.empty((n,) + tuple(self.observation_space.shape),
                           dtype=self.obs_dtype, device=device)

    def reset(self, n: int, seed: int, *, device="cuda", counter: int = 0,
              obs_out: Optional[torch.Tensor] = None
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """n fresh envs: (state, obs). The draws are those of `counter`
        under `seed`; the obs go into `obs_out` when given."""
        state = {k: torch.empty((n,) + shape, dtype=dtype, device=device)
                 for k, (dtype, shape) in self.STATE.items()}
        obs = self.empty_obs(n, device) if obs_out is None else obs_out
        self._launch(state, None, obs, None, None, None, seed, counter,
                     True)
        return state, obs

    def step(self, state: Dict[str, torch.Tensor], actions: torch.Tensor,
             seed: int, counter: int, *,
             obs_out: Optional[torch.Tensor] = None,
             reward_out: Optional[torch.Tensor] = None,
             done_out: Optional[torch.Tensor] = None,
             episodes: Optional[EpisodeAccumulator] = None):
        """One step of every env, in place: (state, obs, reward f32 [N],
        done bool [N]). Each launch needs its own `counter`."""
        some = next(iter(state.values()))
        n, device = some.shape[0], some.device
        obs = self.empty_obs(n, device) if obs_out is None else obs_out
        reward = torch.empty(n, dtype=torch.float32, device=device) \
            if reward_out is None else reward_out
        done = torch.empty(n, dtype=torch.bool, device=device) \
            if done_out is None else done_out
        self._launch(state, actions, obs, reward, done, episodes, seed,
                     counter, False)
        return state, obs, reward, done

    def bind(self, state: Dict[str, torch.Tensor],
             obs_slots: Sequence[torch.Tensor],
             reward_slots: Sequence[torch.Tensor],
             done_slots: Sequence[torch.Tensor], *, seed: int,
             episodes: Optional[EpisodeAccumulator] = None) -> BoundStep:
        """`step` of `state` into fixed per-slot buffers (see
        `BoundStep`); the result is called as `(actions, slot,
        counter)`."""
        return BoundStep(self, state, obs_slots, reward_slots, done_slots,
                         seed, episodes)

    def state_from_numpy(self, arrays: Dict[str, np.ndarray], device="cpu"
                         ) -> Dict[str, torch.Tensor]:
        """A JAX env state (per-env dicts stacked into numpy arrays, as
        `jax.vmap(env.reset)` returns them) as this env's state."""
        return {k: torch.from_numpy(np.array(arrays[k])).to(
            device=device, dtype=dtype) for k, (dtype, _) in
            self.STATE.items()}


class DeviceSyntheticAtari(DeviceEnv):
    """SyntheticAtari on the device (`jax_env.py:45-82`): 84x84x4 uint8
    frames of noise on [0, 64) with the target's band of rows at +128,
    reward 1 when the action matches the target, a new target every step,
    fixed episode length. One K5a launch per batched step."""

    obs_dtype = torch.uint8
    STATE = {"t": (torch.int32, ()), "target": (torch.int32, ())}

    def __init__(self, episode_len: int = 1000, num_actions: int = 6):
        self.episode_len = episode_len
        self.num_actions = num_actions
        self.observation_space = Box(0, 255, shape=FRAME_SHAPE,
                                     dtype=np.uint8)
        self.action_space = Discrete(num_actions)

    def _launch(self, state, actions, obs, reward, done, episodes, seed,
                counter, reset):
        fn = _dispatch(state["t"], _synthetic_atari_step_plain,
                       _synthetic_atari_step_cuda, "synthetic_atari_step")
        fn(state["t"], state["target"], actions, obs, reward, done,
           episodes, self.num_actions, self.episode_len, seed, counter,
           reset)


class DeviceCartPole(DeviceEnv):
    """CartPole on the device (`jax_env.py:85-132`), with the dynamics
    and termination of `env.py:CartPole`; obs = state. One K5b launch
    per batched step; `bind` gives the checked-once launch path."""

    STATE = {"s": (torch.float32, (4,)), "t": (torch.int32, ())}

    def __init__(self, max_steps: int = 200):
        init_cartpole_constants(self, max_steps)

    def _launch(self, state, actions, obs, reward, done, episodes, seed,
                counter, reset):
        fn = _dispatch(state["s"], _cartpole_step_plain,
                       _cartpole_step_cuda, "cartpole_step")
        fn(state["s"], state["t"], actions, obs, reward, done, episodes,
           self.max_steps, seed, counter, reset)

    def bind(self, state, obs_slots, reward_slots, done_slots, *,
             seed: int, episodes: Optional[EpisodeAccumulator] = None
             ) -> "BoundCartPoleStep":
        """K5b's lean launch path: see `BoundCartPoleStep`."""
        return BoundCartPoleStep(self, state, obs_slots, reward_slots,
                                 done_slots, seed, episodes)


# -- registry ------------------------------------------------------------
_DEVICE_REGISTRY = {}


def register_device_env(name: str, creator) -> None:
    """Register `creator(env_config) -> DeviceEnv`."""
    _DEVICE_REGISTRY[name] = creator


def make_device_env(name: str, env_config: dict = None) -> DeviceEnv:
    env_config = env_config or {}
    if name not in _DEVICE_REGISTRY:
        raise ValueError(
            f"no device-resident env registered under {name!r}; "
            f"registered: {sorted(_DEVICE_REGISTRY)}. Anakin mode needs "
            "a DeviceEnv (rllib/env/device_env.py) — host envs can only "
            "run in the local or Sebulba (inline-actor) paths.")
    return _DEVICE_REGISTRY[name](env_config)


def has_device_env(name) -> bool:
    return isinstance(name, str) and name in _DEVICE_REGISTRY


register_device_env("SyntheticAtari-v0",
                    lambda cfg: DeviceSyntheticAtari(
                        episode_len=cfg.get("episode_len", 1000),
                        num_actions=cfg.get("num_actions", 6)))
register_device_env("CartPole-v0", lambda cfg: DeviceCartPole(max_steps=200))
register_device_env("CartPole-v1", lambda cfg: DeviceCartPole(max_steps=500))
