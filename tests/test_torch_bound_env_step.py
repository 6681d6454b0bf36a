"""The device envs' bound step (`DeviceEnv.bind`) on the CPU.

CartPole's bound step (`BoundCartPoleStep`, K5b's lean launch path) runs
the plain version here, as the kernel's wrapper does for CPU tensors:
- over steps that cross episode ends, into per-slot views of env-major
  buffers with the episode accumulator, it equals `DeviceEnv.step` into
  the same slots bit for bit (state, obs, reward, done, every episode
  field; tolerance 0), and JAX's `JaxCartPole.step` from the same states
  and actions (done and reward exactly; the live states within 1e-5
  relative, XLA's and PyTorch's cos/sin may differ in the last bit);
  the episode sums equal a numpy recomputation from the recorded
  rewards and dones;
- `bind` refuses each wrong buffer when it is called (dtype, shape,
  device, contiguity, obs rows off 16 bytes, mismatched slots); a step
  then checks only the action tensor and the counter;
- `AnakinOptimizer` binds once and its rollout goes through the bound
  step, equal to a rollout through the generic `step`.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.env.jax_env import JaxCartPole
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
from ray_tpu_torch.rllib.env import device_env as de
from ray_tpu_torch.rllib.env import device_env_check as dec

# XLA's and PyTorch's cos/sin may differ in the last bit of a step
# (test_torch_anakin.py's STATE_RTOL).
STATE_RTOL = 1e-5
MAX_STEPS = 200
SEED = 11


def _start(n, seed):
    """Numpy-seeded CartPole states near both thresholds and at the last
    steps, with random running and completed episode sums."""
    env = de.DeviceCartPole(MAX_STEPS)
    state, _, episodes = dec.env_case(env, n, "cpu", seed)
    return env, state, episodes


def _buffers(n, T):
    """Env-major [n, T] buffers and their per-slot views, as the Anakin
    optimizer lays them out (obs of step t in slot t + 1, the bootstrap
    buffer after the last)."""
    obs = torch.full((n, T, 4), 7.0)
    boot = torch.full((n, 4), 7.0)
    rew = torch.full((n, T), -1.0)
    done = torch.zeros(n, T, dtype=torch.bool)
    slots = ([obs[:, t] for t in range(1, T)] + [boot], rew.unbind(1),
             done.unbind(1))
    return (obs, boot, rew, done), slots


def _actions(n, T, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (T, n)))


@pytest.mark.parametrize("n", [6, 37])
def test_bound_step_equals_step_and_jax(n):
    T = 12
    actions = _actions(n, T, seed=n)
    env_a, state_a, ep_a = _start(n, seed=n)
    env_b, state_b, ep_b = _start(n, seed=n)
    s0, t0 = state_a["s"].clone(), state_a["t"].clone()
    ep0 = [x.clone() for x in ep_a.tensors()]
    (obs_a, boot_a, rew_a, done_a), slots_a = _buffers(n, T)
    (obs_b, boot_b, rew_b, done_b), slots_b = _buffers(n, T)
    bound = env_a.bind(state_a, *slots_a, seed=SEED, episodes=ep_a)
    assert isinstance(bound, de.BoundCartPoleStep)
    jenv = JaxCartPole(MAX_STEPS)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    states = [s0.numpy().copy()]
    for t in range(T):
        prev_s, prev_t = state_a["s"].numpy().copy(), \
            state_a["t"].numpy().copy()
        bound(actions[t], t, 1 + t)
        env_b.step(state_b, actions[t], SEED, 1 + t,
                   obs_out=slots_b[0][t], reward_out=slots_b[1][t],
                   done_out=slots_b[2][t], episodes=ep_b)
        # JAX from the same state: done, reward and the live next states.
        jstate, jobs, jrew, jdone = jax.vmap(jenv.step)(
            {"s": prev_s, "t": prev_t}, actions[t].numpy(), keys)
        jdone = np.asarray(jdone)
        np.testing.assert_array_equal(done_a[:, t].numpy(), jdone)
        np.testing.assert_array_equal(rew_a[:, t].numpy(), np.asarray(jrew))
        live = ~jdone
        np.testing.assert_allclose(state_a["s"].numpy()[live],
                                   np.asarray(jobs)[live], rtol=STATE_RTOL)
        np.testing.assert_array_equal(state_a["t"].numpy(),
                                      np.asarray(jstate["t"]))
        states.append(state_a["s"].numpy().copy())
    # Bit for bit against the generic step.
    for a, b in [(state_a["s"], state_b["s"]), (state_a["t"], state_b["t"]),
                 (obs_a, obs_b), (boot_a, boot_b), (rew_a, rew_b),
                 (done_a, done_b)] + list(zip(ep_a.tensors(),
                                              ep_b.tensors())):
        assert torch.equal(a, b)
    # The slots hold the steps' observations (slot 0 untouched).
    assert (obs_a[:, 0] == 7.0).all()
    for t in range(1, T):
        np.testing.assert_array_equal(obs_a[:, t].numpy(), states[t])
    np.testing.assert_array_equal(boot_a.numpy(), states[T])
    # Episodes ended, and the sums are those of the recorded steps.
    dones = done_a.numpy()
    assert dones.sum() >= 3
    ep_rew, ep_len = ep0[0].numpy().astype(np.float64), ep0[1].numpy()
    done_rew = ep0[2].numpy().astype(np.float64)
    done_len, done_cnt = ep0[3].numpy().copy(), ep0[4].numpy().copy()
    ep_rew, ep_len = ep_rew.copy(), ep_len.copy()
    for t in range(T):
        ep_rew += rew_a[:, t].numpy()
        ep_len += 1
        d = dones[:, t]
        done_rew[d] += ep_rew[d]
        done_len[d] += ep_len[d]
        done_cnt[d] += 1
        ep_rew[d], ep_len[d] = 0.0, 0
    for got, want in zip(ep_a.tensors(), (ep_rew, ep_len, done_rew,
                                          done_len, done_cnt)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_bound_step_without_episodes_equals_step():
    n, T = 9, 5
    actions = _actions(n, T, seed=1)
    env, state_a, _ = _start(n, seed=3)
    _, state_b, _ = _start(n, seed=3)
    (obs_a, boot_a, rew_a, done_a), slots_a = _buffers(n, T)
    (obs_b, boot_b, rew_b, done_b), slots_b = _buffers(n, T)
    bound = env.bind(state_a, *slots_a, seed=SEED)
    for t in range(T):
        bound(actions[t], t, 40 + t)
        env.step(state_b, actions[t], SEED, 40 + t, obs_out=slots_b[0][t],
                 reward_out=slots_b[1][t], done_out=slots_b[2][t])
    for a, b in [(state_a["s"], state_b["s"]), (state_a["t"], state_b["t"]),
                 (obs_a, obs_b), (boot_a, boot_b), (rew_a, rew_b),
                 (done_a, done_b)]:
        assert torch.equal(a, b)


def test_generic_bound_step_equals_step():
    """SyntheticAtari's bound step is the generic one: `step` into the
    slot's views, byte for byte."""
    n, T = 3, 3
    env = de.DeviceSyntheticAtari(episode_len=2)
    out = []
    for use_bind in (True, False):
        state, _ = env.reset(n, SEED, device="cpu")
        obs = torch.zeros((n, T + 1) + de.FRAME_SHAPE, dtype=torch.uint8)
        rew = torch.zeros(n, T)
        done = torch.zeros(n, T, dtype=torch.bool)
        ep = de.EpisodeAccumulator(n, "cpu")
        slots = ([obs[:, t + 1] for t in range(T)], rew.unbind(1),
                 done.unbind(1))
        bound = env.bind(state, *slots, seed=SEED, episodes=ep)
        assert type(bound) is de.BoundStep
        for t in range(T):
            a = torch.arange(n, dtype=torch.int64) + t
            if use_bind:
                bound(a, t, 1 + t)
            else:
                env.step(state, a, SEED, 1 + t, obs_out=slots[0][t],
                         reward_out=slots[1][t], done_out=slots[2][t],
                         episodes=ep)
        out.append([state["t"], state["target"], obs, rew, done,
                    *ep.tensors()])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert out[0][4].any()


def _bad_slot(kind):
    """A [4, 4] obs slot, [4] reward or done slot, wrong in one way."""
    base = {
        "obs dtype": torch.zeros(4, 4, dtype=torch.float64),
        "obs shape": torch.zeros(4, 5),
        "obs device": torch.zeros(4, 4, device="meta"),
        "obs rows": torch.zeros(4, 8)[:, ::2],
        "obs 16-byte": torch.zeros(4 * 4 + 1)[1:].view(4, 4),
        "reward dtype": torch.zeros(4, dtype=torch.float64),
        "reward shape": torch.zeros(5),
        "done dtype": torch.zeros(4, dtype=torch.uint8),
        "done stride": torch.zeros(4, 5, dtype=torch.bool)[:, 0],
    }
    return base[kind]


BIND_REFUSALS = [
    ("obs dtype", "obs_slots\\[1\\] must be torch.float32"),
    ("obs shape", "obs_slots\\[1\\] must be"),
    ("obs device", "obs_slots\\[1\\] is on meta"),
    ("obs rows", "obs_slots\\[1\\]: each row must be contiguous"),
    ("obs 16-byte", "obs_slots\\[1\\]: rows must start on 16-byte"),
    ("reward dtype", "reward_slots\\[1\\] must be torch.float32"),
    ("reward shape", "reward_slots\\[1\\] must be"),
    ("done dtype", "done_slots\\[1\\] must be torch.bool"),
    ("done stride", "must share one row stride"),
]


@pytest.mark.parametrize("kind,match", BIND_REFUSALS,
                         ids=[k for k, _ in BIND_REFUSALS])
def test_bind_refuses_a_wrong_slot(kind, match):
    n, T = 4, 3
    env, state, ep = _start(n, seed=0)
    _, (obs, rew, done) = _buffers(n, T)
    obs, rew, done = list(obs), list(rew), list(done)
    bad = _bad_slot(kind)
    if kind.startswith("obs"):
        obs[1] = bad
    elif kind.startswith("reward"):
        rew[1] = bad
    else:
        done[1] = bad
    with pytest.raises(ValueError, match=match):
        env.bind(state, obs, rew, done, seed=SEED, episodes=ep)


STATE_REFUSALS = [
    ("s dtype", "s must be torch.float32"),
    ("s contiguity", "s is not contiguous"),
    ("s 16-byte", "s must start on a 16-byte boundary"),
    ("t device", "t is on meta, the state on cpu"),
    ("t dtype", "t must be torch.int32"),
    ("episodes", "episodes.ep_len must be"),
    ("slot count", "equally long"),
    ("seed", "seed -1 is not a 64-bit"),
]


@pytest.mark.parametrize("kind,match", STATE_REFUSALS,
                         ids=[k for k, _ in STATE_REFUSALS])
def test_bind_refuses_a_wrong_state(kind, match):
    n, T = 4, 3
    env, state, ep = _start(n, seed=0)
    _, (obs, rew, done) = _buffers(n, T)
    obs, rew, done = list(obs), list(rew), list(done)
    seed = SEED
    if kind == "s dtype":
        state["s"] = state["s"].double()
    elif kind == "s contiguity":
        state["s"] = torch.zeros(4, 4).t()
    elif kind == "s 16-byte":
        state["s"] = torch.zeros(4 * 4 + 1)[1:].view(4, 4)
    elif kind == "t device":
        state["t"] = state["t"].to("meta")
    elif kind == "t dtype":
        state["t"] = state["t"].long()
    elif kind == "episodes":
        ep.ep_len = ep.ep_len.float()
    elif kind == "slot count":
        rew = rew[:-1]
    else:
        seed = -1
    with pytest.raises(ValueError, match=match):
        env.bind(state, obs, rew, done, seed=seed, episodes=ep)


def test_bound_step_checks_the_actions_and_counter():
    n, T = 4, 2
    env, state, ep = _start(n, seed=0)
    _, slots = _buffers(n, T)
    bound = env.bind(state, *slots, seed=SEED, episodes=ep)
    good = torch.zeros(n, dtype=torch.int64)
    for bad, match in [(good.int(), "actions must be torch.int64"),
                       (torch.zeros(n + 1, dtype=torch.int64),
                        "actions must be"),
                       (torch.zeros(2 * n, dtype=torch.int64)[::2],
                        "actions is not contiguous"),
                       (good.to("meta"), "actions is on meta")]:
        with pytest.raises(ValueError, match=match):
            bound(bad, 0, 1)
    with pytest.raises(ValueError, match="counter"):
        bound(good, 0, 1 << 64)
    with pytest.raises(IndexError):
        bound(good, T, 1)
    bound(good, T - 1, 1)


def test_anakin_rollout_takes_the_bound_step(monkeypatch):
    """The optimizer binds once; its rollout's T env steps go through
    the bound step (the plain version here, one call per step, never
    `DeviceEnv.step`), and the fragment equals one recorded through the
    generic step."""
    cfg = {"env": "CartPole-v0", "anakin": True, "num_workers": 0,
           "num_envs_per_worker": 5, "rollout_fragment_length": 7,
           "anakin_updates_per_call": 1, "min_iter_time_s": 0,
           "model": {"fcnet_hiddens": [8]}, "device": "cpu", "seed": 3}
    batches = []
    for generic in (False, True):
        trainer = IMPALATrainer(config=dict(cfg))
        try:
            opt = trainer.optimizer
            assert isinstance(opt._env_step, de.BoundCartPoleStep)
            calls = []
            plain = de._cartpole_step_plain
            monkeypatch.setattr(de, "_cartpole_step_plain",
                                lambda *a: calls.append(1) or plain(*a))
            if generic:
                b = opt._env_step
                opt._env_step = de.BoundStep(
                    b.env, b.state, b.obs_slots, b.reward_slots,
                    b.done_slots, b.seed, b.episodes)
            else:
                monkeypatch.setattr(de.DeviceCartPole, "step",
                                    lambda *a, **k: pytest.fail("step"))
            with trainer.get_policy()._update_lock:
                batch = opt._rollout()
            assert len(calls) == 7
            batches.append({k: v.clone() for k, v in batch.items()})
            batches[-1]["episodes"] = torch.stack(
                [x.double() for x in opt._episodes.tensors()])
        finally:
            monkeypatch.undo()
            trainer.stop()
    assert set(batches[0]) == set(batches[1])
    for k in batches[0]:
        assert torch.equal(batches[0][k], batches[1][k]), k
