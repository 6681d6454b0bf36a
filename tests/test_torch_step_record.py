"""The per-step host records of the two sampling tails, on the CPU.

`TorchPolicy.compute_actions` (a Categorical policy) and
`SACPolicy.compute_actions` hand K2 and K9f a host record that the
kernel fills on the card and the plain version fills by copy here. These
tests hold, on the CPU:

- the record's layout (the one `csrc/categorical.cu` writes);
- that a fragment's columns are, row for row, what each step drew (a
  record reused without a copy would leave every row the last step's);
- that two threads calling `compute_actions` at once each get their own
  columns;
- that the sampler's batches for IMPALA, PPO and SAC are byte-equal to
  those of the tails as they were before the records (each env step's
  columns read back with `.cpu()`), for the same seeds;
- that `get_action_dist` raises the reference's error types.
"""

import threading
import types

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import numpy as np
import pytest
import torch

from ray_tpu.models.distributions import get_action_dist as jax_get_dist
from ray_tpu.rllib.env import spaces as jax_spaces
from ray_tpu_torch.models import distributions
from ray_tpu_torch.models.distributions import (ActionRecord, StepRecord,
                                                get_action_dist)
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.agents.impala.vtrace_policy import VTraceTorchPolicy
from ray_tpu_torch.rllib.agents.ppo import PPOTorchPolicy
from ray_tpu_torch.rllib.agents.sac import SACPolicy
from ray_tpu_torch.rllib.env import spaces
from ray_tpu_torch.rllib.env.registry import make_env
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.policy.torch_policy import to_device


# ---------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------
@pytest.mark.parametrize("B,A", [(32, 6), (16, 6), (3, 1), (5, 18)])
def test_step_record_layout_is_the_kernels(B, A):
    """actions int64 [B] | logp f32 [B] | value f32 [B] | logits f32
    [B, A], back to back from the buffer's start."""
    record = StepRecord(B, A, pin=False)
    base = record.buffer.data_ptr()
    assert record.buffer.numel() == B * (8 + 4 + 4 + 4 * A)
    for column, offset, dtype, shape in (
            (record.actions, 0, torch.int64, (B,)),
            (record.logp, 8 * B, torch.float32, (B,)),
            (record.value, 12 * B, torch.float32, (B,)),
            (record.logits, 16 * B, torch.float32, (B, A))):
        assert column.data_ptr() - base == offset
        assert column.dtype == dtype and tuple(column.shape) == shape
    for view, column in zip(record.numpy, (record.actions, record.logp,
                                           record.value, record.logits)):
        assert view.ctypes.data == column.data_ptr()
    host = ActionRecord(B, A, pin=False)
    assert host.buffer.numel() == 4 * B * A
    assert host.numpy.ctypes.data == host.buffer.data_ptr()


def test_cpu_record_gets_what_the_plain_tail_returns():
    """On the CPU, `sample_logp` fills the record by copy: its columns
    are the returned actions and logp, the logits and the value; the
    returned columns are copies, not views of the record."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(7, 5, generator=gen)
    value = torch.randn(7, generator=gen)
    u = torch.rand(7, 5, generator=gen)
    record = StepRecord(7, 5, pin=False)
    before = distributions.CATEGORICAL_KERNEL.launches
    actions, logp = distributions.sample_logp(logits, u, True, value=value,
                                              record=record)
    assert distributions.CATEGORICAL_KERNEL.launches == before
    got = record.columns()
    np.testing.assert_array_equal(got[0], actions.numpy())
    np.testing.assert_array_equal(got[1], logp.numpy())
    np.testing.assert_array_equal(got[2], value.numpy())
    np.testing.assert_array_equal(got[3], logits.numpy())
    record.buffer.zero_()
    assert got[0].any() or got[3].any()
    with pytest.raises(ValueError, match="StepRecord"):
        distributions.sample_logp(logits, u, True,
                                  record=StepRecord(7, 6, pin=False))


def test_cpu_action_record_gets_the_squashed_actions():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 6, generator=gen)
    z = torch.randn(4, 3, generator=gen)
    host = ActionRecord(4, 3, pin=False)
    actions, _ = distributions.squashed_gaussian_sample_logp(
        x, z, -2.0, 2.0, host_actions=host)
    np.testing.assert_array_equal(host.columns(), actions.numpy())
    with pytest.raises(ValueError, match="ActionRecord"):
        distributions.squashed_gaussian_sample_logp(
            x, z, -2.0, 2.0, host_actions=ActionRecord(4, 2, pin=False))


# ---------------------------------------------------------------------
# a fragment's columns are each step's draws
# ---------------------------------------------------------------------
def _cartpole_worker(policy_cls, T, num_envs, seed=0, **config):
    return RolloutWorker(
        env_creator=lambda cfg: make_env("CartPole-v0", cfg),
        policy_cls=policy_cls,
        policy_config=dict({"model": {"fcnet_hiddens": [8]},
                            "rollout_fragment_length": T, "device": "cpu"},
                           **config),
        num_envs=num_envs, rollout_fragment_length=T, seed=seed,
        pack_fragments=True)


def test_fragment_rows_are_each_steps_draws(monkeypatch):
    """Local mode, 3 envs x 12 steps in one packed fragment: every row's
    ACTIONS, ACTION_LOGP, ACTION_DIST_INPUTS and VF_PREDS equal what its
    env step drew (the tail's outputs and inputs, kept per step)."""
    T, n = 12, 3
    draws = []
    real = distributions.sample_logp

    def spy(logits, u=None, explore=True, **kw):
        actions, logp = real(logits, u, explore, **kw)
        draws.append((actions.clone(), logp.clone(), kw["value"].clone(),
                      logits.clone()))
        return actions, logp

    monkeypatch.setattr(distributions, "sample_logp", spy)
    worker = _cartpole_worker(VTraceTorchPolicy, T, n)
    batch = worker.sample()
    worker.stop()
    assert len(draws) == T and batch.count == n * T
    for k, col in enumerate((sb.ACTIONS, sb.ACTION_LOGP, sb.VF_PREDS,
                             sb.ACTION_DIST_INPUTS)):
        got = np.asarray(batch[col]).reshape((n, T) + draws[0][k].shape[1:])
        want = np.stack([d[k].numpy() for d in draws], axis=1)
        np.testing.assert_array_equal(got, want, err_msg=col)
    # The draws differ from step to step (else the check sees nothing).
    assert not np.array_equal(draws[0][3].numpy(), draws[-1][3].numpy())


# ---------------------------------------------------------------------
# two threads at once
# ---------------------------------------------------------------------
OBS_DIM = 4


def _policy(kind):
    if kind == "categorical":
        return VTraceTorchPolicy(
            spaces.Box(-1.0, 1.0, (OBS_DIM,)), spaces.Discrete(5),
            {"model": {"fcnet_hiddens": [16]}, "device": "cpu", "seed": 0})
    return SACPolicy(spaces.Box(-1.0, 1.0, (OBS_DIM,)),
                     spaces.Box(-2.0, 2.0, (2,)),
                     {"actor_hiddens": [16], "critic_hiddens": [16],
                      "pure_exploration_steps": 0, "device": "cpu",
                      "seed": 0})


def _obs(seed, n=6):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, OBS_DIM)).astype(np.float32)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)


@pytest.mark.parametrize("kind", ["categorical", "squashed"])
def test_two_threads_in_flight_get_their_own_columns(kind, monkeypatch):
    """Thread A's step fills its record and stops before reading it;
    the main thread runs a whole step of the same batch size; then A
    reads: each gets the columns of its own observations (argmax / mean
    actions, so each step's result is known in advance)."""
    policy = _policy(kind)
    obs_a, obs_b = _obs(1), _obs(2)
    want_a = policy.compute_actions(obs_a, explore=False)
    want_b = policy.compute_actions(obs_b, explore=False)
    cls = StepRecord if kind == "categorical" else ActionRecord
    filled, other_done = threading.Event(), threading.Event()
    real_columns = cls.columns

    def columns(record):
        if threading.current_thread().name == "A":
            filled.set()
            assert other_done.wait(30)
        return real_columns(record)

    monkeypatch.setattr(cls, "columns", columns)
    out = {}
    thread = threading.Thread(
        target=lambda: out.update(a=policy.compute_actions(
            obs_a, explore=False)), name="A")
    thread.start()
    assert filled.wait(30)
    out["b"] = policy.compute_actions(obs_b, explore=False)
    other_done.set()
    thread.join(30)
    assert not thread.is_alive()
    _same(out["a"], want_a)
    _same(out["b"], want_b)


@pytest.mark.parametrize("kind", ["categorical", "squashed"])
def test_many_steps_from_two_threads_get_their_own_columns(kind):
    """Two threads, 100 steps each, the same batch size, free-running."""
    policy = _policy(kind)
    obs = {"a": _obs(3), "b": _obs(4)}
    want = {k: policy.compute_actions(v, explore=False)
            for k, v in obs.items()}
    errors = []

    def run(name):
        try:
            for _ in range(100):
                _same(policy.compute_actions(obs[name], explore=False),
                      want[name])
        except AssertionError as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in obs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors[0]


# ---------------------------------------------------------------------
# batches byte-equal to the tails as they were before the records
# ---------------------------------------------------------------------
def _before_categorical(self, obs_batch, state_batches=None, explore=True,
                        prev_action_batch=None, prev_reward_batch=None):
    """`TorchPolicy.compute_actions` before the step record: the tail,
    then the four columns read back with `.cpu()`."""
    obs = self._to_device(obs_batch)
    with self._update_lock, torch.no_grad():
        dist_inputs, value = self.model(obs)
        actions, logp = self.dist_class(dist_inputs).sample_with_logp(
            self.generator, explore=explore)
    extra = {sb.ACTION_LOGP: logp.cpu().numpy(),
             sb.ACTION_DIST_INPUTS: dist_inputs.cpu().numpy(),
             sb.VF_PREDS: value.cpu().numpy()}
    return actions.cpu().numpy(), [], extra


def _before_sac(self, obs_batch, state_batches=None, explore=True,
                prev_action_batch=None, prev_reward_batch=None):
    """`SACPolicy.compute_actions` before the host output (its acted
    branch; the runs below have no pure-exploration steps)."""
    obs = to_device(obs_batch, self.device)
    with self._update_lock, torch.no_grad():
        z = self._normals(obs.shape[0]) if explore else None
        actions, _ = distributions.squashed_gaussian_sample_logp(
            self.actor(obs), z, self.low, self.high, explore)
    actions = actions.cpu().numpy()
    self.global_timestep += len(actions)
    return actions, [], {}


def _pendulum_worker(policy_cls, config, seed=0, explore=True):
    return RolloutWorker(
        env_creator=lambda cfg: make_env("Pendulum-v0", cfg),
        policy_cls=policy_cls, policy_config=dict(config, device="cpu"),
        num_envs=2, rollout_fragment_length=10, seed=seed, explore=explore)


SAMPLERS = {
    "impala": (lambda: _cartpole_worker(VTraceTorchPolicy, 10, 3),
               _before_categorical),
    "ppo_discrete": (lambda: _cartpole_worker(PPOTorchPolicy, 10, 3,
                                              use_gae=True),
                     _before_categorical),
    "ppo_box": (lambda: _pendulum_worker(
        PPOTorchPolicy, {"model": {"fcnet_hiddens": [8],
                                   "free_log_std": True}}),
                _before_categorical),
    "sac": (lambda: _pendulum_worker(
        SACPolicy, {"actor_hiddens": [8], "critic_hiddens": [8],
                    "pure_exploration_steps": 0, "use_gae": False}), _before_sac),
    "sac_evaluation": (lambda: _pendulum_worker(
        SACPolicy, {"actor_hiddens": [8], "critic_hiddens": [8],
                    "pure_exploration_steps": 0, "use_gae": False}, explore=False),
                       _before_sac),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_batches_are_byte_equal_to_the_copy_tail(name):
    """Three fragments of the same seeded worker, once as the tree runs
    it and once with each step's columns read back as before: every
    column equal in dtype, shape and bytes."""
    make, before = SAMPLERS[name]
    runs = []
    for patch in (False, True):
        worker = make()
        if patch:
            worker.policy.compute_actions = types.MethodType(
                before, worker.policy)
        runs.append([worker.sample() for _ in range(3)])
        worker.stop()
    for got, want in zip(*runs):
        assert sorted(got.keys()) == sorted(want.keys())
        for k in want.keys():
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


# ---------------------------------------------------------------------
# get_action_dist's errors (ROADMAP Queue C)
# ---------------------------------------------------------------------
class _Unknown:
    """A space neither package maps to a distribution."""


@pytest.mark.parametrize("space", ["multi_discrete", "base_space",
                                   "unknown"])
def test_get_action_dist_raises_the_references_errors(space):
    made = {
        "multi_discrete": (lambda: jax_spaces.MultiDiscrete([2, 3]),
                           lambda: spaces.MultiDiscrete([2, 3])),
        "base_space": (jax_spaces.Space, spaces.Space),
        "unknown": (_Unknown, _Unknown),
    }[space]
    with pytest.raises(Exception) as want:
        jax_get_dist(made[0]())
    with pytest.raises(Exception) as got:
        get_action_dist(made[1]())
    assert type(got.value) is type(want.value)
    assert type(want.value) is (NotImplementedError
                                if space == "multi_discrete"
                                else ValueError)


def test_multi_discrete_is_the_references():
    ours, ref = spaces.MultiDiscrete([2, 3, 4]), \
        jax_spaces.MultiDiscrete([2, 3, 4])
    assert ours.shape == ref.shape and repr(ours) == repr(ref)
    rng = np.random.default_rng(0)
    x = ours.sample(rng)
    assert ours.contains(x) and ref.contains(x)
    assert not ours.contains([2, 0, 0]) and not ref.contains([2, 0, 0])
    np.testing.assert_array_equal(
        x, ref.sample(np.random.default_rng(0)))
