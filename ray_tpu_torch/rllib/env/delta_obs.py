"""Delta-encoded observation feeding for host-env (Sebulba) rollouts.

The port's own copy of `ray_tpu/rllib/env/delta_obs.py` (numpy only).

On the Sebulba actor split (host envs -> device inference) every env
step ships one observation frame host->device: 7,056 bytes for an 84x84
uint8 frame. Consecutive Atari frames are nearly identical (a sprite
moves, the background stays), so the host ships only (index, value)
pairs for changed pixels and the device applies them to a RETAINED
device-side frame buffer (`evaluation/device_sampler.py`, kernel K3 in
`csrc/obs_apply.cu`):

    frames[row, idx] = val      # idx == H*W (pad) is dropped

Rows whose change count exceeds the budget (episode resets, scene cuts)
fall back to full-frame rows, so correctness never depends on
compressibility.

Three pieces:

- `DeltaStep`: the wire format — fixed-budget [N, K] uint16 indices +
  uint8 values (pad index = H*W, dropped on apply) plus a ragged list of
  full-frame fallback rows.
- `DeltaEncoder`: wraps ANY frame-emitting `BatchedEnv`; diffs against
  the previous frame on the host.
- `BatchedSpriteAtari` (registered as `SpriteAtari-v0`): a
  temporally-coherent synthetic Atari env that emits deltas NATIVELY (a
  static per-episode background with a moving 8x8 sprite, ~1.8% of
  pixels changing per step). The learnable signal is the sprite's
  horizontal band: reward = 1 iff action == band(sprite center x).

Enabled via the IMPALA config keys `obs_delta` ("auto"/True/False) and
`obs_delta_budget`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .batched_env import BatchedEnv
from .spaces import Box, Discrete


class DeltaStep(NamedTuple):
    """Sparse frame update for N env slots.

    `idx`/`val` are fixed-shape [N, K]: flat pixel indices (uint16) and
    their new values (uint8). Pad entries carry idx == H*W (one past the
    end) and are dropped by the out-of-bounds-dropping scatter on both
    host and device. Duplicate indices within a row are NOT allowed
    (scatter order would be unspecified); producers must emit
    conflict-free deltas.

    `full_rows`/`full_frames` ([B] int32, [B, H*W] uint8, B variable)
    replace whole rows — resets and over-budget rows. Full rows are
    applied BEFORE the sparse delta; their delta entries must be pad.
    """

    idx: np.ndarray
    val: np.ndarray
    full_rows: np.ndarray
    full_frames: np.ndarray


def apply_delta_host(frames_flat: np.ndarray, ds: DeltaStep) -> None:
    """Apply a DeltaStep in place to a host [N, H*W + 1] buffer.

    The +1 trash column absorbs pad writes (idx == H*W), mirroring the
    device scatter's mode='drop'. Used by tests and host-side consumers
    to prove bit-exactness against the device reconstruction.
    """
    if len(ds.full_rows):
        frames_flat[ds.full_rows, :-1] = ds.full_frames
    np.put_along_axis(
        frames_flat, ds.idx.astype(np.int64), ds.val, axis=1)


def all_pad_delta(n: int, k: int, hw: int,
                  full_frames: np.ndarray = None) -> DeltaStep:
    """A DeltaStep with no sparse entries: all-pad idx/val, plus every
    row as a full frame when `full_frames` is given (resets), or no rows
    at all (a no-op delta). The single constructor for the wire format's
    pad convention — keep host and device producers on this helper."""
    if full_frames is not None:
        rows = np.arange(n, dtype=np.int32)
    else:
        rows = np.empty(0, np.int32)
        full_frames = np.empty((0, hw), np.uint8)
    return DeltaStep(
        idx=np.full((n, k), hw, np.uint16),
        val=np.zeros((n, k), np.uint8),
        full_rows=rows,
        full_frames=full_frames)


class DeltaEncoder(BatchedEnv):
    """Generic host-side delta encoder for any frame-emitting BatchedEnv.

    Keeps the previously-emitted frames; each step diffs the new frames
    against them per row. Rows with <= budget changed pixels become
    sparse entries; the rest (and every reset row on the first step)
    become full-frame fallback rows. The plain `vector_step` API still
    works and returns full frames, so host-side samplers are unaffected.
    """

    def __init__(self, inner: BatchedEnv, budget: int = 256):
        shape = inner.observation_space.shape
        if len(shape) != 3 or shape[2] != 1:
            raise ValueError(
                "DeltaEncoder needs single-channel [H, W, 1] frames; env "
                f"emits {shape}")
        if inner.observation_space.dtype != np.uint8:
            raise ValueError(
                "DeltaEncoder needs uint8 frames (the wire format is "
                f"uint8 values); env emits {inner.observation_space.dtype}")
        if shape[0] * shape[1] >= np.iinfo(np.uint16).max:
            raise ValueError("frame too large for uint16 pixel indices")
        self.inner = inner
        self.delta_budget = int(budget)
        self.num_envs = inner.num_envs
        self.observation_space = inner.observation_space
        self.action_space = inner.action_space
        self._hw = shape[0] * shape[1]
        self._prev = None  # [N, H*W] uint8

    # -- plain BatchedEnv API (host samplers) --------------------------
    def vector_reset(self):
        obs = np.asarray(self.inner.vector_reset())
        self._prev = obs.reshape(self.num_envs, self._hw).copy()
        return obs

    def vector_step(self, actions):
        obs, rewards, dones = self.inner.vector_step(actions)
        self._prev = np.asarray(obs).reshape(
            self.num_envs, self._hw).copy()
        return obs, rewards, dones

    # -- delta API ------------------------------------------------------
    def vector_reset_delta(self) -> DeltaStep:
        obs = np.asarray(self.inner.vector_reset())
        self._prev = obs.reshape(self.num_envs, self._hw).copy()
        return self._all_full()

    def _all_full(self) -> DeltaStep:
        return all_pad_delta(self.num_envs, self.delta_budget, self._hw,
                             full_frames=self._prev.copy())

    def vector_step_delta(self, actions):
        obs, rewards, dones = self.inner.vector_step(actions)
        new = np.asarray(obs).reshape(self.num_envs, self._hw)
        n, k, hw = self.num_envs, self.delta_budget, self._hw
        changed = new != self._prev
        counts = changed.sum(axis=1)
        idx = np.full((n, k), hw, np.uint16)
        val = np.zeros((n, k), np.uint8)
        # Vectorized packing: one global nonzero, then each entry's
        # position within its row (no per-row Python on the hot path).
        rows_nz, cols_nz = np.nonzero(changed)
        if len(rows_nz):
            starts = np.searchsorted(rows_nz, np.arange(n))
            within = np.arange(len(rows_nz)) - starts[rows_nz]
            ok = counts[rows_nz] <= k
            idx[rows_nz[ok], within[ok]] = cols_nz[ok]
            val[rows_nz[ok], within[ok]] = new[rows_nz[ok], cols_nz[ok]]
        full_rows = np.flatnonzero(counts > k).astype(np.int32)
        ds = DeltaStep(idx=idx, val=val, full_rows=full_rows,
                       full_frames=new[full_rows].copy())
        self._prev = new.copy()
        return ds, rewards, dones

    def seed(self, seed=None):
        self.inner.seed(seed)

    def close(self):
        self.inner.close()


class BatchedSpriteAtari(BatchedEnv):
    """Temporally-coherent Atari-shaped env with native delta emission.

    Frames: [84, 84, 1] uint8 — a per-episode static noise background
    (values 0..63, drawn from a small pool) with an 8x8 bright sprite
    (value 224) drifting across it, bouncing off the walls. Per step only
    the sprite's old and new footprints change: <= 128 of 7,056 pixels
    (1.8%), in the measured range of real ALE frameskip-4 deltas.

    Signal (same band idea as `BatchedSyntheticAtari`): the rewarded
    action is the horizontal band (of `num_actions` equal bands) that
    contains the sprite's center. The sprite drifts a few pixels per
    step, so the target is stable for several steps but the policy must
    track it — random play scores 1/num_actions, perfect play ~1.

    Episode clocks start staggered so resets (full-frame rows) spread
    across steps instead of arriving as one N-row burst.

    `vector_step` returns full frames (host-sampler compatible);
    `vector_step_delta` returns a `DeltaStep` and costs no frame diff —
    the env knows its own dirty pixels. Both views are maintained from
    the same canonical buffer, so they are bit-identical by construction.
    """

    H = W = 84
    SPRITE = 8
    SPRITE_VAL = 224

    def __init__(self, num_envs: int, episode_len: int = 1000,
                 num_actions: int = 6, pool_size: int = 16,
                 speed: int = 3, seed=None):
        self.num_envs = num_envs
        self.episode_len = int(episode_len)
        self.num_actions = int(num_actions)
        self.pool_size = int(pool_size)
        self.speed = int(speed)
        self.observation_space = Box(0, 255, shape=(self.H, self.W, 1),
                                     dtype=np.uint8)
        self.action_space = Discrete(self.num_actions)
        self._hw = self.H * self.W
        # Budget: old footprint + new footprint, conflict-free.
        self.delta_budget = 2 * self.SPRITE * self.SPRITE
        self._rng = np.random.default_rng(seed)
        self._init_state()

    def _init_state(self):
        n, s = self.num_envs, self.SPRITE
        self._pool = self._rng.integers(
            0, 64, size=(self.pool_size, self.H, self.W), dtype=np.uint8)
        self._bg_idx = self._rng.integers(0, self.pool_size, size=n)
        self._x = self._rng.integers(0, self.W - s, size=n).astype(
            np.int64)
        self._y = self._rng.integers(0, self.H - s, size=n).astype(
            np.int64)
        self._vx = self._rng.choice([-1, 1], size=n) * self._rng.integers(
            1, self.speed + 1, size=n)
        self._vy = self._rng.choice([-1, 1], size=n) * self._rng.integers(
            1, self.speed + 1, size=n)
        # Staggered clocks: resets spread over the episode horizon.
        self._t = self._rng.integers(0, self.episode_len, size=n)
        # Canonical frames, flat, +1 trash column for pad writes.
        self._frames = np.empty((n, self._hw + 1), np.uint8)
        for i in range(n):
            self._draw_full(i)

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)
        self._init_state()

    # ------------------------------------------------------------------
    def _draw_full(self, i: int):
        s = self.SPRITE
        frame = self._pool[self._bg_idx[i]].copy()
        frame[self._y[i]:self._y[i] + s,
              self._x[i]:self._x[i] + s] = self.SPRITE_VAL
        self._frames[i, :-1] = frame.reshape(-1)

    def _targets(self) -> np.ndarray:
        cx = self._x + self.SPRITE // 2
        return (cx * self.num_actions) // self.W

    def _obs(self) -> np.ndarray:
        return self._frames[:, :-1].reshape(
            self.num_envs, self.H, self.W, 1).copy()

    def vector_reset(self):
        self._init_state()
        return self._obs()

    def vector_reset_delta(self) -> DeltaStep:
        self._init_state()
        return all_pad_delta(self.num_envs, self.delta_budget, self._hw,
                             full_frames=self._frames[:, :-1].copy())

    # ------------------------------------------------------------------
    def _advance(self):
        """Move sprites (bounce), advance clocks; returns (old_x, old_y,
        dones)."""
        s = self.SPRITE
        old_x, old_y = self._x.copy(), self._y.copy()
        self._t += 1
        dones = self._t >= self.episode_len
        nx = self._x + self._vx
        ny = self._y + self._vy
        for v, p, hi in ((self._vx, nx, self.W - s),
                         (self._vy, ny, self.H - s)):
            under, over = p < 0, p > hi
            p[under] = -p[under]
            p[over] = 2 * hi - p[over]
            v[under | over] *= -1
            np.clip(p, 0, hi, out=p)
        self._x, self._y = nx, ny
        if dones.any():
            rows = np.flatnonzero(dones)
            m = len(rows)
            self._t[rows] = 0
            self._bg_idx[rows] = self._rng.integers(
                0, self.pool_size, size=m)
            self._x[rows] = self._rng.integers(0, self.W - s, size=m)
            self._y[rows] = self._rng.integers(0, self.H - s, size=m)
            self._vx[rows] = self._rng.choice([-1, 1], size=m) * \
                self._rng.integers(1, self.speed + 1, size=m)
            self._vy[rows] = self._rng.choice([-1, 1], size=m) * \
                self._rng.integers(1, self.speed + 1, size=m)
        return old_x, old_y, dones

    def _rect_idx(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Flat pixel indices of each row's SPRITE x SPRITE rect:
        [N, S*S] int64."""
        s = self.SPRITE
        dy = np.arange(s)
        dx = np.arange(s)
        rows = (y[:, None] + dy[None, :])  # [N, S]
        cols = (x[:, None] + dx[None, :])  # [N, S]
        return (rows[:, :, None] * self.W
                + cols[:, None, :]).reshape(len(x), s * s)

    def vector_step(self, actions):
        ds, rewards, dones = self.vector_step_delta(actions)
        del ds  # canonical frames already updated
        return self._obs(), rewards, dones

    def vector_step_delta(self, actions):
        n, s, hw = self.num_envs, self.SPRITE, self._hw
        rewards = (np.asarray(actions) == self._targets()).astype(
            np.float32)
        old_x, old_y, dones = self._advance()

        # Erase entries: old-rect pixels restored to background — except
        # those inside the new rect (the draw entries own them; duplicate
        # indices are forbidden by the DeltaStep contract).
        old_idx = self._rect_idx(old_x, old_y)          # [N, S*S]
        new_idx = self._rect_idx(self._x, self._y)      # [N, S*S]
        oy = old_idx // self.W
        ox = old_idx % self.W
        in_new = ((ox >= self._x[:, None]) & (ox < self._x[:, None] + s)
                  & (oy >= self._y[:, None]) & (oy < self._y[:, None] + s))
        # Gather erase values straight from the pool ([N, S*S] reads) —
        # no full [N, H, W] background materialization on the hot path.
        erase_val = self._pool.reshape(self.pool_size, hw)[
            self._bg_idx[:, None], old_idx]
        erase_idx = np.where(in_new, hw, old_idx)
        draw_val = np.full_like(new_idx, self.SPRITE_VAL, dtype=np.uint8)

        idx = np.concatenate([erase_idx, new_idx], axis=1).astype(
            np.uint16)
        val = np.concatenate(
            [erase_val.astype(np.uint8), draw_val], axis=1)

        # Reset rows get full frames; their sparse entries become pad.
        if dones.any():
            rows = np.flatnonzero(dones).astype(np.int32)
            idx[rows] = hw
            val[rows] = 0
            for i in rows:
                self._draw_full(int(i))
            full_frames = self._frames[rows, :-1].copy()
        else:
            rows = np.empty(0, np.int32)
            full_frames = np.empty((0, hw), np.uint8)

        ds = DeltaStep(idx=idx, val=val, full_rows=rows,
                       full_frames=full_frames)
        # Keep the canonical buffer current via the same delta the
        # consumer sees (single source of truth). Done rows' entries are
        # all pad, so the scatter only touches their trash column.
        np.put_along_axis(
            self._frames, idx.astype(np.int64), val, axis=1)
        return ds, rewards, dones


class SpriteAtari:
    """Single-env view of `BatchedSpriteAtari` (probe envs, host
    samplers). Implements the plain `Env` interface (`env.py:20`)."""

    def __init__(self, **kwargs):
        self._b = BatchedSpriteAtari(1, **kwargs)
        self.observation_space = self._b.observation_space
        self.action_space = self._b.action_space

    def reset(self):
        return self._b.vector_reset()[0]

    def step(self, action):
        obs, rewards, dones = self._b.vector_step(
            np.asarray([action]))
        return obs[0], float(rewards[0]), bool(dones[0]), {}

    def seed(self, seed=None):
        self._b.seed(seed)

    def close(self):
        pass
