"""Port parity: the Sebulba device sampler and its observation kernel.

- `apply_obs` (the CPU side of the K3 kernel) against the JAX sampler's
  own jitted `_apply_fn` and `_full_fn(b)` on the same numpy inputs, in
  every mode (delta + stack, delta without stack, frame + stack), with
  pad entries, out-of-range indices, full rows and done rows: bit for
  bit; and against the numpy oracle `apply_delta_host`.
- The port's `DeviceSebulbaSampler` against the JAX package's on the
  same seeded envs, from the same (converted) weights, argmax actions,
  the model at float32 (no argmax can flip on a bf16 rounding): groups 1
  and 2, k 1 and 2, delta on and off, stack 0 and 4, over 3 fragments
  that cross resets. Integer and uint8 columns and the transfer
  accounting are equal; the float columns agree within F32_TOL.
- The reference's lag-k and composition tests
  (`tests/test_sebulba_pipeline.py:159-250`), ported.
- Grouped against serial (the port's own comparison; the reference's
  byte-identity test is not an oracle): integer columns equal, floats
  within F32_TOL.
"""

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.agents.impala.vtrace_policy import VTraceJaxPolicy
from ray_tpu.rllib.env import delta_obs as jax_delta_obs
from ray_tpu.rllib.env.device_frame_stack import \
    DeviceFrameStack as JaxDeviceFrameStack
from ray_tpu.rllib.evaluation.device_sampler import \
    DeviceSebulbaSampler as JaxDeviceSebulbaSampler
from ray_tpu_torch.models import distributions
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.agents.impala.vtrace_policy import VTraceTorchPolicy
from ray_tpu_torch.rllib.env.batched_env import BatchedCartPole
from ray_tpu_torch.rllib.env.delta_obs import BatchedSpriteAtari
from ray_tpu_torch.rllib.env.device_frame_stack import DeviceFrameStack
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.evaluation.device_sampler import (
    DeviceSebulbaSampler, _apply_obs_plain, apply_obs)

HW = 84 * 84
# Float columns (logits, values, logp) come out of the same f32 conv
# trunk run by XLA and by PyTorch, which sum in different orders:
# measured differences are ~1e-7 against values of order 1e-2..1.
F32_TOL = 1e-5
SMALL_CNN = {"conv_filters": ((4, 8, 4), (8, 4, 2)),
             "compute_dtype": "f32"}

INT_COLUMNS = (sb.OBS, sb.BOOTSTRAP_OBS, sb.ACTIONS, sb.REWARDS, sb.DONES,
               sb.EPS_ID, sb.T, sb.POLICY_LAG)
FLOAT_COLUMNS = (sb.ACTION_DIST_INPUTS, sb.VF_PREDS, sb.ACTION_LOGP)
COUNTED = ("bytes_h2d", "bytes_d2h", "steps", "policy_lag_sum",
           "fetch_waits")


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _policies(obs_shape, num_actions=6, model=None):
    """A JAX V-trace policy and the port's, with the JAX weights."""
    cfg = {"model": dict(model or SMALL_CNN), "seed": 0,
           "rollout_fragment_length": 4}
    space = Box(0, 255, obs_shape, np.uint8)
    from ray_tpu.rllib.env.spaces import Box as JaxBox
    from ray_tpu.rllib.env.spaces import Discrete as JaxDiscrete
    jax_policy = VTraceJaxPolicy(JaxBox(0, 255, obs_shape, np.uint8),
                                 JaxDiscrete(num_actions), dict(cfg))
    policy = VTraceTorchPolicy(space, Discrete(num_actions),
                               dict(cfg, device="cpu"))
    policy.set_weights({k: v.numpy() for k, v in flax_to_state_dict(
        jax_policy.get_weights()).items()})
    return jax_policy, policy


# ---------------------------------------------------------------------
# K3's plain version against the JAX sampler's programs
# ---------------------------------------------------------------------
def _step_inputs(n, K, seed):
    """One packed delta step with pad entries, out-of-range indices and
    done rows, plus bucketed full rows (pad rows == n)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(HW + 40)[:K] for _ in range(n)])
    idx[:, ::6] = HW  # pad entries
    idx = idx.astype(np.uint16)
    val = rng.integers(0, 256, (n, K), dtype=np.uint8)
    done = rng.random(n) < 0.4
    packed = np.concatenate([idx.view(np.uint8), val,
                             done.astype(np.uint8)[:, None]], axis=1)
    m = 3
    rows = np.full(4, n, np.int32)
    rows[:m] = rng.permutation(n)[:m]
    fulls = rng.integers(0, 256, (4, HW), dtype=np.uint8)
    fulls[m:] = 0
    frames = rng.integers(0, 256, (n, HW), dtype=np.uint8)
    stack = rng.integers(0, 256, (n, 84, 84, 4), dtype=np.uint8)
    return dict(idx=idx, val=val, done=done, packed=packed, rows=rows,
                fulls=fulls, frames=frames, stack=stack)


def _jax_sampler(env, stack, use_delta=True):
    env = JaxDeviceFrameStack(env, 4) if stack else env
    jax_policy, _ = _policies(env.observation_space.shape)
    return JaxDeviceSebulbaSampler(env, jax_policy, 4, explore=False,
                                   use_delta=use_delta)


@pytest.mark.parametrize("stack", [4, 0])
@pytest.mark.parametrize("full_rows", [True, False])
def test_apply_obs_delta_matches_jax_programs(stack, full_rows):
    n = 6
    jax_env = jax_delta_obs.BatchedSpriteAtari(n, seed=0)
    js = _jax_sampler(jax_env, stack)
    K = jax_env.delta_budget
    x = _step_inputs(n, K, seed=stack + full_rows)
    frames_j = jnp.asarray(x["frames"])
    if full_rows:
        frames_j = js._full_fn(4)(frames_j, jnp.asarray(x["rows"]),
                                  jnp.asarray(x["fulls"]))
    obs_j, frames_j = js._apply_fn(
        jnp.asarray(x["stack"]) if stack else None, frames_j,
        jnp.asarray(x["packed"]))

    frames = torch.from_numpy(x["frames"].copy())
    kw = {"rows": torch.from_numpy(x["rows"]),
          "fulls": torch.from_numpy(x["fulls"])} if full_rows else {}
    obs = apply_obs(frames, (84, 84, 1),
                    packed=torch.from_numpy(x["packed"]),
                    stack=torch.from_numpy(x["stack"]) if stack else None,
                    **kw)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(frames_j))
    assert obs.dtype == torch.uint8
    # The numpy oracle: the host apply into a frame buffer with a trash
    # column (the wire format pads with HW; larger indices drop alike).
    host = np.concatenate([x["frames"], np.zeros((n, 1), np.uint8)], 1)
    ds = jax_delta_obs.DeltaStep(
        idx=np.minimum(x["idx"], HW), val=x["val"],
        full_rows=x["rows"][:3] if full_rows else np.empty(0, np.int32),
        full_frames=x["fulls"][:3] if full_rows else np.empty((0, HW),
                                                              np.uint8))
    jax_delta_obs.apply_delta_host(host, ds)
    np.testing.assert_array_equal(frames.numpy(), host[:, :-1])
    if stack:  # done rows refill, the others roll
        d = x["done"]
        np.testing.assert_array_equal(
            obs.numpy()[d], np.repeat(host[d, :-1].reshape(-1, 84, 84, 1),
                                      4, axis=-1))
        np.testing.assert_array_equal(obs.numpy()[~d][..., :3],
                                      x["stack"][~d][..., 1:])
    else:  # a copy, never a view of the frames the next step mutates
        assert obs.data_ptr() != frames.data_ptr()


def test_apply_obs_frame_mode_matches_jax_program():
    n = 5
    js = _jax_sampler(jax_delta_obs.BatchedSpriteAtari(n, seed=0), 4,
                      use_delta=False)
    assert not js.delta
    x = _step_inputs(n, 8, seed=9)
    frame = x["frames"].reshape(n, 84, 84, 1)
    obs_j = js._apply_fn(jnp.asarray(x["stack"]), jnp.asarray(frame),
                         jnp.asarray(x["done"]))
    frame_t = torch.from_numpy(frame.copy())
    obs = apply_obs(frame_t, (84, 84, 1),
                    done=torch.from_numpy(x["done"]),
                    stack=torch.from_numpy(x["stack"]))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(frame_t.numpy(), frame)  # read only


def test_apply_obs_plain_is_the_cpu_path():
    x = _step_inputs(3, 16, seed=1)
    a, b = (torch.from_numpy(x["frames"].copy()) for _ in range(2))
    got = apply_obs(a, (84, 84, 1), packed=torch.from_numpy(x["packed"]))
    want = _apply_obs_plain(b, (84, 84, 1),
                            packed=torch.from_numpy(x["packed"]))
    assert torch.equal(got, want) and torch.equal(a, b)


# ---------------------------------------------------------------------
# The sampler end to end against the JAX sampler
# ---------------------------------------------------------------------
def _sprite_envs(pkg_sprite, stack_cls, groups, stack, n=4, base_seed=11):
    envs = []
    for g in range(groups):
        e = pkg_sprite(n // groups, episode_len=5, seed=base_seed + 7 * g)
        envs.append(stack_cls(e, 4) if stack else e)
    return envs if groups > 1 else envs[0]


@pytest.mark.parametrize("stack", [0, 4])
@pytest.mark.parametrize("delta", [True, False])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("groups", [1, 2])
def test_sampler_matches_jax_sampler(groups, k, delta, stack):
    T = 4
    jax_envs = _sprite_envs(jax_delta_obs.BatchedSpriteAtari,
                            JaxDeviceFrameStack, groups, stack)
    envs = _sprite_envs(BatchedSpriteAtari, DeviceFrameStack, groups,
                        stack)
    first = jax_envs[0] if groups > 1 else jax_envs
    jax_policy, policy = _policies(first.observation_space.shape)
    js = JaxDeviceSebulbaSampler(jax_envs, jax_policy, T, explore=False,
                                 use_delta=delta, onchip_steps=k)
    ps = DeviceSebulbaSampler(envs, policy, T, explore=False,
                              use_delta=delta, onchip_steps=k, seed=0)
    assert ps.delta == js.delta == delta
    assert ps.frame_stack == js.frame_stack == stack
    resets = 0
    for frag in range(3):
        want, got = js.sample(), ps.sample()
        assert set(got) == set(want)
        for col in INT_COLUMNS:
            g, w = _host(got[col]), _host(want[col])
            assert g.shape == w.shape, col
            np.testing.assert_array_equal(g, w, err_msg=f"{col} @ {frag}")
        for col in FLOAT_COLUMNS:
            np.testing.assert_allclose(
                _host(got[col]), _host(want[col]), rtol=F32_TOL,
                atol=F32_TOL, err_msg=f"{col} @ {frag}")
        assert isinstance(got[sb.OBS], torch.Tensor)
        resets += int(_host(got[sb.DONES]).sum())
    assert resets > 0  # the fragments crossed episode boundaries
    jt, pt = js.transfer_stats(), ps.transfer_stats()
    assert {k: pt[k] for k in COUNTED} == {k: jt[k] for k in COUNTED}
    assert [tuple(m) for m in ps.get_metrics()] == [
        tuple(m) for m in js.get_metrics()]


# ---------------------------------------------------------------------
# The reference's lag-k and composition tests, ported
# ---------------------------------------------------------------------
class _CountingFrameEnv:
    """BatchedEnv emitting [N, 4, 4, 1] uint8 frames whose value is the
    global step counter — the recorded OBS column can be checked against
    ground truth exactly (as `tests/test_sebulba_pipeline.py:59`)."""

    def __init__(self, num_envs, episode_len=1000):
        self.num_envs = num_envs
        self.episode_len = episode_len
        self.observation_space = Box(0, 255, shape=(4, 4, 1),
                                     dtype=np.uint8)
        self.action_space = Discrete(3)
        self._count = 0
        self._t = np.zeros(num_envs, np.int64)

    def _frames(self):
        return np.full((self.num_envs, 4, 4, 1), self._count % 256,
                       np.uint8)

    def vector_reset(self):
        self._count = 0
        self._t[:] = 0
        return self._frames()

    def vector_step(self, actions):
        self._count += 1
        self._t += 1
        dones = self._t >= self.episode_len
        self._t[dones] = 0
        return self._frames(), np.zeros(self.num_envs, np.float32), dones

    def seed(self, seed=None):
        pass


def _port_policy(obs_shape, num_actions, model=None):
    cfg = {"model": dict(model or {"fcnet_hiddens": [8],
                                   "conv_filters": ((4, 2, 1),),
                                   "compute_dtype": "f32"}),
           "seed": 0, "device": "cpu", "rollout_fragment_length": 4}
    return VTraceTorchPolicy(Box(0, 255, obs_shape, np.uint8),
                             Discrete(num_actions), cfg)


def test_fragment_must_tile_windows():
    env = _CountingFrameEnv(2)
    policy = _port_policy((4, 4, 1), 3)
    with pytest.raises(ValueError, match="multiple"):
        DeviceSebulbaSampler(env, policy, rollout_fragment_length=5,
                             onchip_steps=2)


def test_groups_require_equal_sizes():
    policy = _port_policy((4, 4, 1), 3)
    with pytest.raises(ValueError, match="same number of env slots"):
        DeviceSebulbaSampler([_CountingFrameEnv(3), _CountingFrameEnv(1)],
                             policy, rollout_fragment_length=5)


def test_lagk_logits_obs_and_lag_column():
    N, T, k = 3, 6, 2
    env = _CountingFrameEnv(N)
    policy = _port_policy((4, 4, 1), 3)
    sampler = DeviceSebulbaSampler(
        env, policy, rollout_fragment_length=T, explore=False,
        onchip_steps=k)
    batch = sampler.sample()
    obs = _host(batch[sb.OBS]).reshape(N, T, 4, 4, 1)
    di = _host(batch[sb.ACTION_DIST_INPUTS]).reshape(N, T, -1)
    logp = _host(batch[sb.ACTION_LOGP]).reshape(N, T)
    vf = _host(batch[sb.VF_PREDS]).reshape(N, T)
    acts = _host(batch[sb.ACTIONS]).reshape(N, T)
    lag = _host(batch[sb.POLICY_LAG]).reshape(N, T)

    # The lag column records each transition's selection staleness.
    np.testing.assert_array_equal(lag, np.tile(np.arange(T) % k, (N, 1)))
    # Recorded observations are the TRUE per-step observations.
    for t in range(T):
        np.testing.assert_array_equal(obs[:, t],
                                      np.full((N, 4, 4, 1), t, np.uint8))
    for w in range(T // k):
        head = w * k
        # Behaviour logits/value are shared across the window ...
        for j in range(1, k):
            np.testing.assert_array_equal(di[:, head + j], di[:, head])
            np.testing.assert_array_equal(vf[:, head + j], vf[:, head])
        # ... and match a fresh forward at the head obs.
        with torch.no_grad():
            want_di, want_vf = policy.model(torch.from_numpy(
                np.ascontiguousarray(obs[:, head])))
        np.testing.assert_allclose(di[:, head], want_di.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(vf[:, head], want_vf.numpy(),
                                   rtol=1e-5, atol=1e-6)
        # Deterministic selection: every sub-step takes the argmax.
        np.testing.assert_array_equal(
            acts[:, head:head + k],
            np.tile(np.argmax(di[:, head], axis=-1)[:, None], (1, k)))
        for j in range(k):
            z = di[:, head + j]
            ref = (z[np.arange(N), acts[:, head + j]]
                   - np.log(np.exp(z).sum(-1)))
            np.testing.assert_allclose(logp[:, head + j], ref, rtol=1e-4,
                                       atol=1e-5)
    # One blocking fetch per window, not per step.
    st = sampler.transfer_stats()
    assert st["fetch_waits"] == T // k
    assert st["policy_lag_sum"] == int((np.arange(T) % k).sum()) * N


def test_onchip_composes_with_groups_delta_and_stack():
    """Delta env + device frame stack + 2 groups + k=2 windows still
    reconstruct the true observations."""
    N_PER, T, k = 2, 6, 2
    env_a, env_b = (DeviceFrameStack(
        BatchedSpriteAtari(N_PER, episode_len=8, seed=s), 4) for s in (3, 5))
    policy = _port_policy((84, 84, 4), 6, model=SMALL_CNN)
    sampler = DeviceSebulbaSampler(
        [env_a, env_b], policy, rollout_fragment_length=T, explore=False,
        onchip_steps=k)
    assert sampler.delta and len(sampler.groups) == 2
    batch = sampler.sample()
    boot = _host(batch[sb.BOOTSTRAP_OBS])
    canon = np.concatenate(
        [env_a.inner._frames[:, :-1], env_b.inner._frames[:, :-1]])
    np.testing.assert_array_equal(
        boot[:, :, :, -1].reshape(2 * N_PER, -1), canon)
    # BOOTSTRAP_OBS is also step 0 of the next fragment.
    nxt = sampler.sample()
    obs = _host(nxt[sb.OBS]).reshape(2, N_PER, T, 84, 84, 4)
    np.testing.assert_array_equal(obs[:, :, 0].reshape(boot.shape), boot)
    assert batch.count == 2 * N_PER * T


# ---------------------------------------------------------------------
# Grouped against serial: a pure pipelining change
# ---------------------------------------------------------------------
class _FixedCartPole(BatchedCartPole):
    """CartPole whose row i always resets to a given state, so serial row
    i and its group-split twin reset identically."""

    def __init__(self, states, max_steps=200):
        states = np.asarray(states, np.float64)
        super().__init__(len(states), max_steps=max_steps, seed=0)
        self._init = states

    def _reset_rows(self, mask):
        self._state[mask] = self._init[mask]
        self._t[mask] = 0


STATES = np.array([[0.01, -0.02, 0.03, 0.04], [-0.02, 0.01, -0.04, 0.02],
                   [0.05, 0.9, 0.20, 1.5], [-0.05, -0.9, -0.20, -1.5]])


def test_groups2_match_serial():
    cfg = {"model": {"fcnet_hiddens": [16]}, "seed": 0, "device": "cpu",
           "rollout_fragment_length": 10}
    env = _FixedCartPole(STATES)
    policy = VTraceTorchPolicy(env.observation_space, env.action_space, cfg)
    serial = DeviceSebulbaSampler(env, policy, 10, explore=False)
    grouped = DeviceSebulbaSampler(
        [_FixedCartPole(STATES[:2]), _FixedCartPole(STATES[2:])], policy,
        10, explore=False)
    assert len(grouped.groups) == 2
    for r in range(3):
        bs, bg = serial.sample(), grouped.sample()
        for col in INT_COLUMNS + (sb.OBS,):
            g, s = _host(bg[col]), _host(bs[col])
            if s.dtype.kind == "f":  # CartPole obs are f32 states
                np.testing.assert_allclose(g, s, rtol=F32_TOL, atol=F32_TOL,
                                           err_msg=f"{col} @ {r}")
            else:
                np.testing.assert_array_equal(g, s, err_msg=f"{col} @ {r}")
                assert g.dtype == s.dtype, col
        for col in FLOAT_COLUMNS:
            np.testing.assert_allclose(_host(bg[col]), _host(bs[col]),
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"{col} @ {r}")
    assert sum(m.episode_length for m in serial.metrics) > 0


# ---------------------------------------------------------------------
# The wire actions: one host buffer per group, reused by every window
# ---------------------------------------------------------------------
@pytest.mark.parametrize("k,groups", [(1, 1), (5, 1), (5, 2), (1, 2)])
def test_actions_column_holds_every_windows_draws(k, groups):
    """Exploring, over fragments of several windows: the ACTIONS column
    holds, for each window, the Gumbel-max draws of that window's logits
    with the uniforms that window took from the sampler's generator
    (`torch.rand((k, n, A))`, windows in dispatch order, groups in turn),
    although every window's actions pass through the group's one host
    buffer. So no window's actions are overwritten by the next, and the
    draws are the ones the sampler took before the buffer existed."""
    T, n, seed, frags = 10, 4, 5, 3
    envs = _sprite_envs(BatchedSpriteAtari, DeviceFrameStack, groups, 4,
                        n=n)
    policy = _port_policy((84, 84, 4), 6, model=SMALL_CNN)
    sampler = DeviceSebulbaSampler(envs, policy, T, explore=True,
                                   onchip_steps=k, seed=seed)
    per, windows = n // groups, T // k
    gen = torch.Generator().manual_seed(seed)
    # draws[W][g]: window W of group g (window 0 primes the pipeline).
    draws = [[torch.rand((k, per, 6), generator=gen) for _ in range(groups)]
             for _ in range(frags * windows)]
    distinct = set()
    for frag in range(frags):
        batch = sampler.sample()
        acts = _host(batch[sb.ACTIONS]).reshape(groups, per, T)
        di = _host(batch[sb.ACTION_DIST_INPUTS]).reshape(groups, per, T, 6)
        for w in range(windows):
            for g in range(groups):
                want, _ = distributions._sample_logp_k_plain(
                    torch.from_numpy(di[g, :, w * k]),
                    draws[frag * windows + w][g], k, True)
                np.testing.assert_array_equal(
                    acts[g, :, w * k:(w + 1) * k], want.numpy().T,
                    err_msg=f"fragment {frag} window {w} group {g}")
                distinct.update(want.numpy().ravel().tolist())
    assert _host(batch[sb.ACTIONS]).dtype == np.int32
    assert len(distinct) > 1  # the draws vary: an exploring check
