"""Port parity: the Anakin path on the CPU (device-resident envs,
`AnakinOptimizer`, IMPALA's anakin config), against the JAX package.

- The envs' plain versions (what the CUDA kernels K5a/K5b are held to on
  the card) against `jax_env.py`: CartPole's dynamics, done flags and
  rewards on the same states and actions; SyntheticAtari's reward, clock,
  done flags and frame layout; the random parts (frame noise, targets,
  CartPole resets) by distribution, since Philox and jax.random never
  agree bit for bit.
- One update on a batch recorded by the port's optimizer, through the
  port's `apply_update` and through `VTraceJaxPolicy`'s loss + optax,
  from the same weights.
- Episode bookkeeping against a numpy recomputation from the recorded
  rewards and dones.
- The counterpart of `test_sebulba_anakin.py::test_anakin_impala_learns_
  cartpole`, and `validate_config` against the reference's.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats as sps

from ray_tpu.rllib.agents.impala import impala as jax_impala
from ray_tpu.rllib.agents.impala.vtrace_policy import VTraceJaxPolicy
from ray_tpu.rllib.env.jax_env import JaxCartPole, JaxSyntheticAtari
from ray_tpu.rllib.env.spaces import Box as JaxBox
from ray_tpu.rllib.env.spaces import Discrete as JaxDiscrete
from ray_tpu.rllib.sample_batch import SampleBatch as JaxSampleBatch
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer, impala
from ray_tpu_torch.rllib.env import device_env as de

# Float32 states after one Euler step: XLA's and PyTorch's cos/sin may
# differ in the last bit; the JAX package holds its env to the host env
# within the same rtol (test_sebulba_anakin.py:506).
STATE_RTOL = 1e-5
# Loss and stats: f32 sums over the batch in different orders (as in
# test_torch_impala.py).
STAT_TOL = 1e-5
GRAD_ATOL = 2e-6
# Chi-square / KS tests of the random parts: fail below this p-value.
P_MIN = 1e-4


def _jax_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


# ---------------------------------------------------------------------
# Philox
# ---------------------------------------------------------------------
def _philox_python(c, k):
    """Philox4x32-10 with Python integers (no overflow to work around)."""
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + de.PHILOX_W0) & 0xFFFFFFFF,
                 (k[1] + de.PHILOX_W1) & 0xFFFFFFFF]
        p0, p1 = de.PHILOX_M0 * c[0], de.PHILOX_M1 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & 0xFFFFFFFF, p1 & 0xFFFFFFFF,
             ((p0 >> 32) ^ c[3] ^ k[1]) & 0xFFFFFFFF, p0 & 0xFFFFFFFF]
    return c


@pytest.mark.parametrize("counter,key,want", [
    # Random123's known-answer vectors for philox4x32-10.
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    got = de.philox4x32([torch.tensor(c) for c in counter], key)
    assert [int(w) for w in got] == list(want)
    assert _philox_python(counter, key) == list(want)


def test_philox_limbs_match_python_integers():
    """The 16-bit-limb products equal exact integer arithmetic on random
    counters and keys, the top bits included."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, (4, 64), dtype=np.uint64).astype(
        np.int64)
    key = tuple(int(k) for k in rng.integers(0, 1 << 32, 2))
    got = de.philox4x32([torch.from_numpy(w) for w in words], key)
    for i in range(64):
        want = _philox_python([int(w[i]) for w in words], key)
        assert [int(g[i]) for g in got] == want


# ---------------------------------------------------------------------
# CartPole
# ---------------------------------------------------------------------
def _cartpole_states(rng, max_steps):
    """States away from every threshold and near each one (x, theta,
    both signs, stepping over and staying inside; t at the last step and
    the one before). Returns (s [n, 4] f32, t [n] int32)."""
    rows, ts = [], []
    for _ in range(16):
        rows.append(rng.uniform(-0.05, 0.05, 4))
        ts.append(rng.integers(0, max_steps - 2))
    for sign in (1.0, -1.0):
        for vel in (0.1, -0.1, 0.01):
            rows.append([sign * 2.3995, sign * vel, 0.01, 0.0])
            rows.append([0.0, 0.0, sign * 0.2089, sign * vel])
            ts += [5, 5]
    for t in (max_steps - 1, max_steps - 2):
        rows.append(rng.uniform(-0.05, 0.05, 4))
        ts.append(t)
    return np.array(rows, np.float32), np.array(ts, np.int32)


@pytest.mark.parametrize("action", [0, 1])
def test_cartpole_step_matches_jax(action):
    max_steps = 200
    jenv, env = JaxCartPole(max_steps), de.DeviceCartPole(max_steps)
    s, t = _cartpole_states(np.random.default_rng(action), max_steps)
    n = len(s)
    actions = np.full(n, action, np.int64)
    actions[::3] = 1 - action  # both actions in every batch
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jstate, jobs, jrew, jdone = jax.vmap(jenv.step)(
        {"s": s, "t": t}, actions, keys)
    jstate, jobs = _jax_state(jstate), np.asarray(jobs)
    jdone = np.asarray(jdone)

    state = env.state_from_numpy({"s": s, "t": t})
    state, obs, rew, done = env.step(state, torch.from_numpy(actions),
                                     seed=0, counter=1)
    np.testing.assert_array_equal(done.numpy(), jdone)
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    assert rew.dtype == torch.float32 and done.dtype == torch.bool
    # The states near thresholds really land on both sides of them,
    # clear of the last-bit differences the rtol allows.
    live = ~jdone
    assert 0 < live.sum() < n and jdone[-2] and not jdone[-1]
    margin = np.minimum(np.abs(np.abs(jobs[:, 0]) - 2.4),
                        np.abs(np.abs(jobs[:, 2]) - 12 * 2 * np.pi / 360))
    assert (margin[16:-2] > 1e-4).all()
    np.testing.assert_allclose(state["s"].numpy()[live], jobs[live],
                               rtol=STATE_RTOL)
    np.testing.assert_array_equal(state["t"].numpy(), jstate["t"])
    # Done rows restart: |s| <= 0.05, t = 0; obs is the new state.
    assert (np.abs(state["s"].numpy()[jdone]) <= np.float32(0.05)).all()
    assert (state["t"].numpy()[jdone] == 0).all()
    assert torch.equal(obs, state["s"])


def test_cartpole_reset_is_uniform():
    env = de.DeviceCartPole()
    state, obs = env.reset(4096, seed=3, device="cpu")
    s = state["s"].numpy()
    assert s.dtype == np.float32 and torch.equal(obs, state["s"])
    assert (state["t"].numpy() == 0).all()
    assert (s >= np.float32(-0.05)).all() and (s < np.float32(0.05)).all()
    for col in range(4):
        p = sps.kstest(s[:, col], sps.uniform(loc=-0.05, scale=0.1).cdf)
        assert p.pvalue > P_MIN, (col, p)
    # Another counter draws other states.
    other, _ = env.reset(4096, seed=3, device="cpu", counter=1)
    assert not torch.equal(other["s"], state["s"])


# ---------------------------------------------------------------------
# SyntheticAtari
# ---------------------------------------------------------------------
def _check_frames(obs, target, num_actions):
    """Band rows (all bytes >= 128) are exactly the target's rows, band
    bytes lie in [128, 192) and every other byte in [0, 64)."""
    obs = obs.numpy()
    band = 84 // num_actions
    rows = np.arange(84)
    for n, tgt in enumerate(target.numpy()):
        in_band = (rows >= tgt * band) & (rows < (tgt + 1) * band)
        frame = obs[n]
        assert (frame[in_band] >= 128).all() and (frame[in_band] < 192).all()
        assert (frame[~in_band] < 64).all()


def test_synthetic_atari_matches_jax_contract():
    episode_len, A, n = 5, 6, 8
    jenv = JaxSyntheticAtari(episode_len=episode_len, num_actions=A)
    env = de.DeviceSyntheticAtari(episode_len=episode_len, num_actions=A)
    vstep = jax.vmap(jenv.step)
    jstate, jobs = jax.vmap(jenv.reset)(
        jax.random.split(jax.random.PRNGKey(0), n))
    jstate = _jax_state(jstate)
    assert np.asarray(jobs).shape == (n, 84, 84, 4)
    # The port's own trajectory from the JAX reset state: its clock and
    # done flags follow JAX's exactly; its rewards follow its own targets.
    own = env.state_from_numpy(jstate)
    state, obs = env.reset(n, seed=0, device="cpu")
    assert obs.shape == (n, 84, 84, 4) and obs.dtype == torch.uint8
    assert (state["t"] == 0).all()
    _check_frames(obs, state["target"], A)
    rng = np.random.default_rng(0)
    boundaries = 0
    for step in range(episode_len + 2):
        actions = rng.integers(0, A, n)
        actions[::2] = jstate["target"][::2]  # rewarded rows every step
        jnext, _, jrew, jdone = vstep(
            jstate, actions, jax.random.split(jax.random.PRNGKey(step), n))
        jnext = _jax_state(jnext)
        a = torch.from_numpy(actions)
        # From JAX's state: the same reward, clock and done flags.
        carried = env.state_from_numpy(jstate)
        carried, obs, rew, done = env.step(carried, a, seed=0,
                                           counter=step + 1)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(carried["t"].numpy(), jnext["t"])
        _check_frames(obs, carried["target"], A)
        # The port's own trajectory.
        before = own["target"].clone()
        own, obs, rew, done = env.step(own, a, seed=1, counter=step + 1)
        assert torch.equal(rew, (a == before).float())
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(own["t"].numpy(), jnext["t"])
        _check_frames(obs, own["target"], A)
        jstate = jnext
        boundaries += int(np.asarray(jdone).all())
    assert boundaries == 1  # every env crossed the episode boundary once


def test_synthetic_atari_noise_and_targets_are_uniform():
    """Noise bytes are uniform on [0, 64) and targets uniform on [0, A):
    chi-square over 64 (resp. A) values at a fixed seed, p > P_MIN."""
    A, n = 6, 64
    env = de.DeviceSyntheticAtari(num_actions=A)
    state, obs = env.reset(n, seed=11, device="cpu")
    noise, targets = [], [state["target"].numpy()]
    for step in range(1, 4):
        state, obs, _, _ = env.step(state, torch.zeros(n, dtype=torch.int64),
                                    seed=11, counter=step)
        noise.append((obs.numpy() & 0x7F).ravel())
        targets.append(state["target"].numpy())
    counts = np.bincount(np.concatenate(noise), minlength=128)
    assert counts[64:].sum() == 0
    assert sps.chisquare(counts[:64]).pvalue > P_MIN
    big, _ = env.reset(8192, seed=12, device="cpu")
    targets.append(big["target"].numpy())
    tcounts = np.bincount(np.concatenate(targets), minlength=A)
    assert len(tcounts) == A
    assert sps.chisquare(tcounts).pvalue > P_MIN


def test_state_from_numpy_and_registry():
    env = de.make_device_env("SyntheticAtari-v0", {"episode_len": 7})
    assert isinstance(env, de.DeviceSyntheticAtari) and env.episode_len == 7
    assert de.make_device_env("CartPole-v1").max_steps == 500
    assert de.has_device_env("CartPole-v0")
    assert not de.has_device_env("SpriteAtari-v0")
    with pytest.raises(ValueError, match="no device-resident env") as err:
        de.make_device_env("SpriteAtari-v0")
    for name in ("CartPole-v0", "CartPole-v1", "SyntheticAtari-v0"):
        assert name in str(err.value)
    state = env.state_from_numpy({"t": np.array([1, 2], np.int64),
                                  "target": np.array([3, 4])})
    assert state["t"].dtype == torch.int32 and state["t"].tolist() == [1, 2]
    assert state["target"].dtype == torch.int32


def test_wrappers_refuse_devices_without_a_kernel():
    env = de.DeviceCartPole()
    state = {"s": torch.zeros(2, 4, device="meta"),
             "t": torch.zeros(2, dtype=torch.int32, device="meta")}
    with pytest.raises(ValueError, match="no cartpole_step kernel"):
        env.step(state, torch.zeros(2, dtype=torch.int64, device="meta"),
                 0, 1)


# ---------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------
SMALL_CNN = {"conv_filters": [[4, 8, 4], [8, 4, 2]], "compute_dtype": "f32"}
SMALL_FC = {"fcnet_hiddens": [16, 16]}


def _anakin(**over):
    cfg = {"anakin": True, "num_workers": 0, "min_iter_time_s": 0,
           "device": "cpu", "seed": 0}
    cfg.update(over)
    return IMPALATrainer(config=cfg)


@pytest.mark.parametrize("env,model", [
    ("SyntheticAtari-v0", SMALL_CNN), ("CartPole-v0", SMALL_FC)],
    ids=["atari-cnn", "cartpole-fc"])
def test_anakin_update_matches_jax_policy(env, model):
    """One batch recorded by the port's optimizer (N=4, T=5) through the
    port's factored update and through VTraceJaxPolicy's loss + optax
    update, from the same weights: loss, stats and post-update weights
    within test_torch_impala.py's tolerances."""
    n, T, lr = 4, 5, 0.001
    t = _anakin(env=env, num_envs_per_worker=n, rollout_fragment_length=T,
                anakin_updates_per_call=1, model=model, lr=lr)
    try:
        policy = t.get_policy()
        space = policy.observation_space
        cfg = {"model": model, "rollout_fragment_length": T, "seed": 0,
               "lr": lr, "grad_clip": 40.0}
        jax_policy = VTraceJaxPolicy(
            JaxBox(space.low, space.high, space.shape, space.dtype),
            JaxDiscrete(policy.action_space.n), dict(cfg))
        policy.set_weights({k: v.numpy() for k, v in flax_to_state_dict(
            jax_policy.get_weights()).items()})
        w0 = policy.get_weights()
        with policy._update_lock:
            batch = t.optimizer._rollout()
        cols = {k: v.numpy().copy() for k, v in batch.items()}
        assert cols[sb.OBS].shape == (n * T,) + space.shape
        assert cols[sb.BOOTSTRAP_OBS].shape == (n,) + space.shape
        assert cols[sb.DONES].dtype == np.float32

        jax_grads, _ = jax_policy._grad_fn(
            jax_policy.params,
            jax_policy._device_batch(JaxSampleBatch(cols)),
            jax_policy._next_rng(), jax_policy.loss_state)
        jax_grads = {k: v.numpy() for k, v in flax_to_state_dict(
            jax.tree.map(np.asarray, jax_grads)).items()}
        jax_out = jax_policy.learn_on_batch(JaxSampleBatch(cols))
        with policy._update_lock:
            stats = policy.apply_update(batch)
        out = {k: float(v.detach()) for k, v in stats.items()}
        assert set(out) == set(jax_out)
        for k in out:
            np.testing.assert_allclose(out[k], jax_out[k], rtol=STAT_TOL,
                                       atol=STAT_TOL, err_msg=k)
        # On-policy: the behaviour logits are the rollout's own.
        assert abs(out["mean_kl_behaviour"]) < 1e-6

        after = policy.get_weights()
        jax_after = {k: v.numpy() for k, v in flax_to_state_dict(
            jax.tree.map(np.asarray, jax_policy.get_weights())).items()}
        # The bound of test_torch_impala.py: Adam's first step moves a
        # weight by lr*g/(|g|+eps); a gradient difference d moves that by
        # at most lr*eps*d/(|g|+eps)^2, never more than 2*lr.
        eps = 1e-7
        scale = min(1.0, 40.0 / out["grad_gnorm"])
        for k in after:
            g = np.abs(jax_grads[k]) * scale
            bound = np.minimum(lr * eps * GRAD_ATOL * scale / (g + eps) ** 2,
                               2 * lr) + 1e-7
            diff = np.abs(after[k] - jax_after[k])
            assert (diff <= bound).all(), (k, diff.max())
            assert np.abs(after[k] - w0[k]).max() > 0.5 * lr, k
    finally:
        t.stop()


def _recompute_episodes(rewards, dones):
    """numpy episode bookkeeping over time-ordered [steps, N] rewards and
    dones from the first step on: per step, the completed episodes'
    reward sum, length sum and count."""
    ep_rew = np.zeros(rewards.shape[1], np.float32)
    ep_len = np.zeros(rewards.shape[1], np.int64)
    out = []
    for r, d in zip(rewards, dones):
        ep_rew += r
        ep_len += 1
        out.append((float(ep_rew[d].sum()), float(ep_len[d].sum()),
                    float(d.sum())))
        ep_rew[d], ep_len[d] = 0.0, 0
    return np.array(out)


def test_anakin_episode_bookkeeping_matches_numpy():
    """Episodes of 10 steps, calls of 2 updates x 3 steps: calls 2 and 4
    complete one episode per env, calls 1 and 3 none (call 1's means stay
    NaN, call 3 keeps call 2's). Counters advance by M*N*T per call."""
    n, T, M = 4, 3, 2
    t = _anakin(env="SyntheticAtari-v0", env_config={"episode_len": 10},
                num_envs_per_worker=n, rollout_fragment_length=T,
                anakin_updates_per_call=M, model=SMALL_CNN)
    opt = t.optimizer
    recorded = []  # per update: time-major rewards, dones [T, n]
    rollout = opt._rollout

    def recording_rollout():
        batch = rollout()
        recorded.append((batch[sb.REWARDS].reshape(n, T).numpy().T.copy(),
                         batch[sb.DONES].reshape(n, T).numpy().T > 0))
        return batch

    opt._rollout = recording_rollout
    try:
        totals, means = [], []
        for call in range(4):
            r = t.train()
            per_step = _recompute_episodes(
                np.concatenate([x[0] for x in recorded]),
                np.concatenate([x[1] for x in recorded]))
            rew_sum, len_sum, count = per_step[-M * T:].sum(0)
            assert count == (n if call in (1, 3) else 0)
            if count:
                assert r["episode_reward_mean"] == rew_sum / count
                assert r["episode_len_mean"] == len_sum / count == 10.0
            assert r["timesteps_this_iter"] == M * n * T
            assert r["num_steps_sampled"] == r["num_steps_trained"] \
                == (call + 1) * M * n * T
            totals.append(r["episodes_total"])
            means.append((r["episode_reward_mean"], r["episode_len_mean"]))
        assert totals == [0, n, n, 2 * n]
        assert np.isnan(means[0]).all()
        assert means[2] == means[1]
        assert t.get_policy().global_timestep == 4 * M * n * T
        stats = opt.stats()
        assert stats["anakin"] is True and stats["updates_per_call"] == M
        assert stats["timing"]["anakin_call_time_ms"] > 0
        assert set(r["info"]["learner"]) == {
            "total_loss", "policy_loss", "vf_loss", "entropy",
            "mean_kl_behaviour", "vtrace_mean_vs"}
    finally:
        t.stop()


def test_anakin_impala_learns_cartpole():
    """The counterpart of test_sebulba_anakin.py:359: same config (32
    envs, 20-step fragments, lr 3e-3, seed 0, 10 updates per call), same
    bar (best > 150 within 10 iterations). No threads: deterministic."""
    t = _anakin(env="CartPole-v0", num_envs_per_worker=32,
                rollout_fragment_length=20, train_batch_size=640, lr=3e-3)
    best = 0.0
    try:
        for _ in range(10):
            r = t.train()
            rew = r.get("episode_reward_mean", float("nan"))
            if rew == rew:
                best = max(best, rew)
            if best > 150:
                break
    finally:
        t.stop()
    assert best > 150, f"anakin IMPALA failed to learn: best={best}"
    assert r["timesteps_this_iter"] == 32 * 20 * 10


def _base(**over):
    cfg = {"rollout_fragment_length": 5, "train_batch_size": 20,
           "num_envs_per_worker": 4}
    cfg.update(over)
    return cfg


def test_validate_config_anakin_overrides_match_reference():
    want, got = (_base(anakin=True, train_batch_size=999),
                 _base(anakin=True, train_batch_size=999))
    jax_impala.validate_config(want)
    impala.validate_config(got)
    for key in ("train_batch_size", "num_envs_per_worker",
                "_anakin_num_envs"):
        assert got[key] == want[key], key
    assert got["train_batch_size"] == 20 and got["_anakin_num_envs"] == 4


def test_host_only_env_under_anakin_names_the_device_registry():
    with pytest.raises(ValueError, match="device-resident") as err:
        _anakin(env="SpriteAtari-v0", num_envs_per_worker=2,
                rollout_fragment_length=4)
    assert "SyntheticAtari-v0" in str(err.value)
