"""The per-step host records of the four sampling tails, on the CPU.

`TorchPolicy.compute_actions` (a Categorical or a Box policy),
`DQNPolicy.compute_actions` and `SACPolicy.compute_actions` hand K2, K7,
K8 and K9f a host record that the kernel fills on the card and the
plain version fills by copy here. These tests hold, on the CPU:

- the records' layouts (the ones `csrc/categorical.cu`,
  `csrc/diag_gaussian.cu` and `csrc/eps_greedy.cu` write);
- that a fragment's columns are, row for row, what each step drew (a
  record reused without a copy would leave every row the last step's);
- that two threads calling `compute_actions` at once each get their own
  columns;
- that the sampler's batches for IMPALA, PPO (discrete and Box), DQN
  and SAC are byte-equal to those of the tails as they were before the
  records (each env step's columns read back with `.cpu()`), for the
  same seeds;
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
from ray_tpu_torch.models import eps_greedy as k8
from ray_tpu_torch.models.distributions import (ActionRecord, StepRecord,
                                                get_action_dist)
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.agents.dqn import DQNPolicy, dqn_policy
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
            (record.inputs, 16 * B, torch.float32, (B, A))):
        assert column.data_ptr() - base == offset
        assert column.dtype == dtype and tuple(column.shape) == shape
    for view, column in zip(record.numpy, (record.actions, record.logp,
                                           record.value, record.inputs)):
        assert view.ctypes.data == column.data_ptr()
    host = ActionRecord(B, A, pin=False)
    assert host.buffer.numel() == 4 * B * A
    assert host.numpy.ctypes.data == host.buffer.data_ptr()


@pytest.mark.parametrize("B,d", [(8, 1), (256, 6), (3, 17)])
def test_box_step_record_layout_is_the_kernels(B, d):
    """K7's record: actions f32 [B, d] | logp f32 [B] | value f32 [B] |
    inputs f32 [B, 2d], back to back from the buffer's start; the
    distribution's `step_record` makes it."""
    record = distributions.DiagGaussian.step_record(B, 2 * d, pin=False)
    assert record.shape == (B, 2 * d) and record.action_dim == d
    base = record.buffer.data_ptr()
    assert record.buffer.numel() == 4 * B * (d + 2 + 2 * d)
    for column, offset, shape in (
            (record.actions, 0, (B, d)),
            (record.logp, 4 * B * d, (B,)),
            (record.value, 4 * B * (d + 1), (B,)),
            (record.inputs, 4 * B * (d + 2), (B, 2 * d))):
        assert column.data_ptr() - base == offset
        assert column.dtype == torch.float32
        assert tuple(column.shape) == shape
    for view, column in zip(record.numpy, (record.actions, record.logp,
                                           record.value, record.inputs)):
        assert view.ctypes.data == column.data_ptr()
    cat = distributions.Categorical.step_record(B, 5, pin=False)
    assert cat.action_dim is None and cat.actions.dtype == torch.int64


@pytest.mark.parametrize("B", [1, 16, 4096])
def test_int64_action_record_layout_is_k8s(B):
    """K8's host output: int64 [B] from the buffer's start."""
    host = ActionRecord(B, pin=False, dtype=torch.int64)
    assert host.shape == (B,) and host.dtype == torch.int64
    assert host.buffer.numel() == 8 * B
    assert host.actions.data_ptr() == host.buffer.data_ptr()
    assert host.numpy.dtype == np.int64 and host.numpy.shape == (B,)
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


@pytest.mark.parametrize("explore", [True, False])
def test_cpu_box_record_gets_what_the_plain_tail_returns(explore):
    """On the CPU, `gaussian_sample_logp` without a record returns the
    plain version's columns; with a Box step record it returns None and
    fills the record with the same columns by copy; a record of another
    kind raises."""
    gen = torch.Generator().manual_seed(2)
    inputs = torch.randn(6, 4, generator=gen)
    value = torch.randn(6, generator=gen)
    z = torch.randn(6, 2, generator=gen) if explore else None
    actions, logp = distributions._gaussian_sample_logp_plain(inputs, z,
                                                              explore)
    record = StepRecord(6, 4, pin=False, action_dim=2)
    before = distributions.DIAG_GAUSSIAN_KERNEL.launches
    out = distributions.gaussian_sample_logp(inputs, z, explore)
    assert torch.equal(out[0], actions) and torch.equal(out[1], logp)
    record.buffer.zero_()
    assert distributions.gaussian_sample_logp(
        inputs, z, explore, value=value, record=record) is None
    got = record.columns()
    for g, w in zip(got, (actions, logp, value, inputs)):
        assert g.tobytes() == w.numpy().tobytes()
    assert distributions.DIAG_GAUSSIAN_KERNEL.launches == before
    with pytest.raises(ValueError, match="StepRecord"):
        distributions.gaussian_sample_logp(
            inputs, z, explore, record=StepRecord(6, 4, pin=False))


@pytest.mark.parametrize("eps", [0.0, 0.5, 1.0])
def test_cpu_int64_record_gets_the_eps_greedy_actions(eps):
    """On the CPU, `eps_greedy` without a host output returns the plain
    version's actions; with an int64 host output it returns None and
    fills it by copy; a host output of another dtype or shape raises."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(9, 6, generator=gen)
    u = torch.rand(9, 2, generator=gen)
    want = k8._eps_greedy_plain(q, u, eps)
    host = ActionRecord(9, pin=False, dtype=torch.int64)
    assert torch.equal(k8.eps_greedy(q, u, eps), want)
    host.buffer.zero_()
    assert k8.eps_greedy(q, u, eps, host_actions=host) is None
    np.testing.assert_array_equal(host.columns(), want.numpy())
    with pytest.raises(ValueError, match="ActionRecord"):
        k8.eps_greedy(q, u, eps, host_actions=ActionRecord(9, pin=False))
    with pytest.raises(ValueError, match="ActionRecord"):
        k8.eps_greedy(q, u, eps, host_actions=ActionRecord(
            8, pin=False, dtype=torch.int64))


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


def _dqn_worker(T, num_envs, eps):
    worker = _cartpole_worker(DQNPolicy, T, num_envs, use_gae=False)
    worker.policy.set_epsilon(eps)
    return worker


@pytest.mark.parametrize("kind", ["diag_gaussian", "eps_greedy"])
def test_box_and_dqn_fragment_rows_are_each_steps_draws(kind, monkeypatch):
    """As above for the two tails that write only the record: 2 Pendulum
    envs x 12 steps of a Box PPO policy (ACTIONS, ACTION_LOGP, VF_PREDS
    and ACTION_DIST_INPUTS against the plain tail on each step's inputs
    and normals), and 3 CartPole envs x 12 steps of DQN at epsilon 0.5
    (ACTIONS against the plain tail on each step's Q-values and
    uniforms)."""
    T, draws = 12, []
    if kind == "diag_gaussian":
        n, real = 2, distributions.gaussian_sample_logp

        def spy(inputs, z=None, explore=True, **kw):
            a, logp = distributions._gaussian_sample_logp_plain(
                inputs, z, explore)
            draws.append((a, logp, kw["value"].clone(), inputs.clone()))
            return real(inputs, z, explore, **kw)

        monkeypatch.setattr(distributions, "gaussian_sample_logp", spy)
        worker = RolloutWorker(
            env_creator=lambda cfg: make_env("Pendulum-v0", cfg),
            policy_cls=PPOTorchPolicy,
            policy_config={"model": {"fcnet_hiddens": [8],
                                     "free_log_std": True},
                           "device": "cpu"},
            num_envs=n, rollout_fragment_length=T, seed=0,
            pack_fragments=True)
        cols = (sb.ACTIONS, sb.ACTION_LOGP, sb.VF_PREDS,
                sb.ACTION_DIST_INPUTS)
    else:
        n, real = 3, dqn_policy.eps_greedy

        def spy(q, u, eps, **kw):
            draws.append((k8._eps_greedy_plain(q, u, eps),))
            return real(q, u, eps, **kw)

        monkeypatch.setattr(dqn_policy, "eps_greedy", spy)
        worker = _dqn_worker(T, n, 0.5)
        cols = (sb.ACTIONS,)
    batch = worker.sample()
    worker.stop()
    assert len(draws) == T and batch.count == n * T
    for k, col in enumerate(cols):
        got = np.asarray(batch[col]).reshape((n, T) + draws[0][k].shape[1:])
        want = np.stack([d[k].numpy() for d in draws], axis=1)
        assert got.dtype == want.dtype, col
        np.testing.assert_array_equal(got, want, err_msg=col)
    assert not np.array_equal(draws[0][0].numpy(), draws[-1][0].numpy()) \
        or not np.array_equal(draws[1][0].numpy(), draws[-2][0].numpy())


# ---------------------------------------------------------------------
# two threads at once
# ---------------------------------------------------------------------
OBS_DIM = 4


def _policy(kind):
    obs_space = spaces.Box(-1.0, 1.0, (OBS_DIM,))
    if kind == "categorical":
        return VTraceTorchPolicy(
            obs_space, spaces.Discrete(5),
            {"model": {"fcnet_hiddens": [16]}, "device": "cpu", "seed": 0})
    if kind == "diag_gaussian":
        return PPOTorchPolicy(
            obs_space, spaces.Box(-2.0, 2.0, (3,)),
            {"model": {"fcnet_hiddens": [16]}, "device": "cpu", "seed": 0})
    if kind == "eps_greedy":
        return DQNPolicy(obs_space, spaces.Discrete(5),
                         {"model": {"fcnet_hiddens": [16]}, "hiddens": [16],
                          "device": "cpu", "seed": 0})
    return SACPolicy(obs_space,
                     spaces.Box(-2.0, 2.0, (2,)),
                     {"actor_hiddens": [16], "critic_hiddens": [16],
                      "pure_exploration_steps": 0, "device": "cpu",
                      "seed": 0})


THREAD_KINDS = ["categorical", "squashed", "diag_gaussian", "eps_greedy"]
RECORD_CLASS = {"categorical": StepRecord, "diag_gaussian": StepRecord,
                "squashed": ActionRecord, "eps_greedy": ActionRecord}


def _obs(seed, n=6):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, OBS_DIM)).astype(np.float32)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)


@pytest.mark.parametrize("kind", THREAD_KINDS)
def test_two_threads_in_flight_get_their_own_columns(kind, monkeypatch):
    """Thread A's step fills its record and stops before reading it;
    the main thread runs a whole step of the same batch size; then A
    reads: each gets the columns of its own observations (argmax / mean
    actions, so each step's result is known in advance)."""
    policy = _policy(kind)
    obs_a, obs_b = _obs(1), _obs(2)
    want_a = policy.compute_actions(obs_a, explore=False)
    want_b = policy.compute_actions(obs_b, explore=False)
    assert not np.array_equal(want_a[0], want_b[0])
    cls = RECORD_CLASS[kind]
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


@pytest.mark.parametrize("kind", THREAD_KINDS)
def test_columns_outlive_the_next_step(kind):
    """What `compute_actions` returns is the caller's: the next step of
    the same batch size, which reuses the record, leaves it as it was."""
    policy = _policy(kind)
    first = policy.compute_actions(_obs(5), explore=False)
    kept = (first[0].copy(), {k: v.copy() for k, v in first[2].items()})
    second = policy.compute_actions(_obs(6), explore=False)
    assert not np.array_equal(second[0], kept[0])
    _same(first, kept[:1] + (None, kept[1]))


@pytest.mark.parametrize("kind", THREAD_KINDS)
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
def _before_step_record(self, obs_batch, state_batches=None, explore=True,
                        prev_action_batch=None, prev_reward_batch=None):
    """`TorchPolicy.compute_actions` before the step record (a Box
    policy's until it took one too): the tail, then the four columns
    read back with `.cpu()`."""
    obs = self._to_device(obs_batch)
    with self._update_lock, torch.no_grad():
        dist_inputs, value = self.model(obs)
        actions, logp = self.dist_class(dist_inputs).sample_with_logp(
            self.generator, explore=explore)
    extra = {sb.ACTION_LOGP: logp.cpu().numpy(),
             sb.ACTION_DIST_INPUTS: dist_inputs.cpu().numpy(),
             sb.VF_PREDS: value.cpu().numpy()}
    return actions.cpu().numpy(), [], extra


def _before_dqn(self, obs_batch, state_batches=None, explore=True,
                prev_action_batch=None, prev_reward_batch=None):
    """`DQNPolicy.compute_actions` before the host output: the forward,
    the uniforms and the tail, the actions read back with `.cpu()`."""
    obs = self._to_device(obs_batch)
    eps = self.cur_epsilon if explore else 0.0
    with self._update_lock, torch.no_grad():
        q, _ = self.model(obs)
        u = torch.rand((q.shape[0], 2), generator=self.generator,
                       dtype=torch.float32, device=self.device)
        actions = k8.eps_greedy(q.contiguous(), u, eps)
    return actions.cpu().numpy(), [], {}


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
               _before_step_record),
    "ppo_discrete": (lambda: _cartpole_worker(PPOTorchPolicy, 10, 3,
                                              use_gae=True),
                     _before_step_record),
    "ppo_box": (lambda: _pendulum_worker(
        PPOTorchPolicy, {"model": {"fcnet_hiddens": [8],
                                   "free_log_std": True}}),
                _before_step_record),
    "dqn": (lambda: _dqn_worker(10, 3, 0.5), _before_dqn),
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
