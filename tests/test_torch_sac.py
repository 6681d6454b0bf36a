"""Port parity: SAC in local mode, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's SAC
pieces and the port's:
- the squashed-Gaussian tail's plain version (K9f's) against the JAX
  policy's `_dist` + `_sample_action` on the same actor output, with the
  normals JAX draws handed to the port (d = 1 and 6, bounds +-1 and +-2,
  saturating tanh, clipped log_std); its plain backward (K9b's) against
  `jax.grad` and against torch autograd of the plain forward; torch
  generator samples against `jax.random` samples by distribution;
- one `learn_with_td` of `SACPolicy` against JAX's from the same
  weights on the same batch, with JAX's two normal draws handed to the
  port (twin Q on and off, n-step 1 and 3);
- pure-exploration actions (bit for bit), deterministic actions and
  `compute_td_error`;
- the counterparts of `tests/test_continuous.py::TestSAC`.

The learning test runs torch on one thread (the ops are tiny; more
threads only contend) and is deterministic from its seed.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.distributions import SquashedGaussian as JaxSquashed
from ray_tpu.rllib.agents import registry as jax_registry
from ray_tpu.rllib.agents.sac.sac_policy import SACPolicy as JaxSACPolicy
from ray_tpu.rllib.env.spaces import Box as JaxBox
from ray_tpu.rllib.sample_batch import SampleBatch as JaxSampleBatch
from ray_tpu_torch.models import distributions
from ray_tpu_torch.models.convert import (sac_weights_from_flax,
                                          sac_weights_to_flax)
from ray_tpu_torch.models.distributions import SquashedGaussian
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.agents import registry
from ray_tpu_torch.rllib.agents.dqn import DQNTrainer, SimpleQTrainer
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
from ray_tpu_torch.rllib.agents.ppo import PPOTrainer
from ray_tpu_torch.rllib.agents.sac import (DEFAULT_CONFIG, SACPolicy,
                                            SACTrainer)
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# The tail against JAX: the same f32 steps; XLA's tanh, exp and log1p
# are not PyTorch's to the last ulp.
TAIL_TOL = 1e-6
# Gradients, and one update against JAX: sums over rows and layers in
# other orders; |port - JAX| <= TOL * (1 + |JAX|).
TOL = 1e-5
OBS_DIM = 3


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _assert_near(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert np.all(err <= tol), f"{what}: largest scaled error {err.max()}"


# ---------------------------------------------------------------------
# the squashed-Gaussian tail (K9f's and K9b's plain versions)
# ---------------------------------------------------------------------
class _JaxTail:
    """The JAX SAC policy's `_dist` and `_sample_action` on a given
    actor output: the actor is the identity."""

    _dist = JaxSACPolicy._dist
    _sample_action = JaxSACPolicy._sample_action

    def __init__(self, low, high, d):
        self.low, self.high, self.action_dim = low, high, d
        self.actor = types.SimpleNamespace(apply=lambda params, obs: obs)


def _tail_inputs(B, d, seed, margin=0.0):
    """x [B, 2d] f32: every third row's mean large (|pre| >= 10: tanh
    saturates), raw log_std over [-25, 5) (beyond both clip bounds),
    kept `margin` away from the bounds (the clip's kinks)."""
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal((B, d)) * 3.0
    mean[::3] *= 6.0
    raw = rng.uniform(-25.0, 5.0, (B, d))
    if margin:
        near = (np.abs(raw + 20.0) < margin) | (np.abs(raw - 2.0) < margin)
        raw = np.where(near, raw + 3 * margin, raw)
    return np.concatenate([mean, raw], axis=1).astype(np.float32)


@pytest.mark.parametrize("d", [1, 6])
@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (-2.0, 2.0)])
def test_plain_tail_matches_jax_sample_action(d, low, high):
    """Action and logp within 1e-6 + 1e-6 |JAX| of the jitted JAX tail,
    fed JAX's own normals; not exploring, the action is JAX `act_fn`'s
    deterministic one."""
    B = 257
    x = _tail_inputs(B, d, seed=d)
    key = jax.random.PRNGKey(d + 10)
    tail = _JaxTail(low, high, d)
    want_a, want_logp = jax.jit(
        lambda x, k: tail._sample_action(None, x, k))(x, key)
    z = np.array(jax.random.normal(key, (B, d)))
    std = np.exp(np.clip(x[:, d:], -20.0, 2.0))
    assert np.any(np.abs(x[:, :d] + std * z) >= 10.0)
    assert np.any(x[:, d:] < -20.0) and np.any(x[:, d:] > 2.0)
    got_a, got_logp = distributions.squashed_gaussian_sample_logp(
        torch.from_numpy(x), torch.from_numpy(z), low, high)
    assert got_a.dtype == torch.float32 and got_a.shape == (B, d)
    assert got_logp.shape == (B,)
    for got, want in ((got_a, want_a), (got_logp, want_logp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TAIL_TOL, atol=TAIL_TOL)
    det, _ = distributions.squashed_gaussian_sample_logp(
        torch.from_numpy(x), None, low, high, explore=False)
    want_det = low + (jnp.tanh(x[:, :d]) + 1.0) * (high - low) / 2.0
    np.testing.assert_allclose(det.numpy(), np.asarray(want_det),
                               rtol=TAIL_TOL, atol=TAIL_TOL)


@pytest.mark.parametrize("d", [1, 6])
@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (-2.0, 2.0)])
@pytest.mark.parametrize("grads", ["both", "actions", "logp"])
def test_plain_backward_matches_jax_grad_and_autograd(d, low, high, grads):
    """The plain backward (K9b's) is the gradient of sum(w_a * action) +
    sum(w_l * logp) with respect to x: against `jax.grad` of JAX's tail
    and against torch autograd of the plain forward, within 1e-5 of
    1 + |reference|; raw log_std at least 1e-3 from the clip bounds. The
    autograd function's gradient is the plain backward's."""
    B = 64
    x = _tail_inputs(B, d, seed=d + 3, margin=1e-3)
    rng = np.random.default_rng(d)
    w_a = rng.standard_normal((B, d)).astype(np.float32) \
        if grads != "logp" else None
    w_l = rng.standard_normal(B).astype(np.float32) \
        if grads != "actions" else None
    key = jax.random.PRNGKey(d)
    tail = _JaxTail(low, high, d)

    def objective(x):
        a, logp = tail._sample_action(None, x, key)
        out = jnp.sum(w_a * a) if w_a is not None else 0.0
        return out + (jnp.sum(w_l * logp) if w_l is not None else 0.0)

    want = np.asarray(jax.grad(objective)(x))
    z = torch.from_numpy(np.array(jax.random.normal(key, (B, d))))
    g_a = torch.from_numpy(w_a) if w_a is not None else None
    g_l = torch.from_numpy(w_l) if w_l is not None else None
    xt = torch.from_numpy(x)
    got = distributions._squashed_gaussian_backward_plain(
        xt, z, g_a, g_l, low, high, True)
    assert got.shape == (B, 2 * d)
    _assert_near(got.numpy(), want, TOL, "against jax.grad")
    xg = xt.clone().requires_grad_(True)
    a, logp = distributions._squashed_gaussian_plain(xg, z, low, high, True)
    loss = (a * g_a).sum() if g_a is not None else 0.0
    if g_l is not None:
        loss = loss + (logp * g_l).sum()
    loss.backward()
    _assert_near(got.numpy(), xg.grad.numpy(), TOL, "against autograd")
    xf = xt.clone().requires_grad_(True)
    a, logp = distributions.squashed_gaussian_sample_logp(xf, z, low, high)
    loss = (a * g_a).sum() if g_a is not None else 0.0
    if g_l is not None:
        loss = loss + (logp * g_l).sum()
    loss.backward()
    assert torch.equal(xf.grad, got)


def test_tail_gradient_is_zero_where_log_std_is_clipped():
    x = torch.tensor([[0.3, -25.0], [0.3, 4.0], [0.3, 0.5]])
    g = distributions._squashed_gaussian_backward_plain(
        x, torch.ones(3, 1), torch.ones(3, 1), torch.ones(3), -1.0, 1.0,
        True)
    assert g[0, 1] == 0 and g[1, 1] == 0 and g[2, 1] != 0


def test_samples_match_jax_samples_by_distribution():
    """Four (mean, log_std) settings, 40,000 draws each, squashed to
    [-2, 2]: the port's samples (normals from a torch generator) and
    JAX's (`jax.random`) agree in mean and variance per setting within 5
    standard errors of the difference."""
    settings = np.array([[0.0, 0.0], [1.5, -1.0], [-0.5, 1.0],
                         [3.0, -3.0]], np.float32)
    n = 40000
    x = np.repeat(settings, n, axis=0)
    got = SquashedGaussian(torch.from_numpy(x), low=-2.0, high=2.0).sample(
        torch.Generator().manual_seed(0)).numpy().reshape(4, n)
    want = np.asarray(JaxSquashed(x, low=-2.0, high=2.0).sample(
        jax.random.PRNGKey(0))).reshape(4, n)
    assert np.all(np.abs(got) <= 2.0)
    for a, b in zip(got, want):
        se_mean = np.sqrt(a.var() / n + b.var() / n)
        assert abs(a.mean() - b.mean()) <= 5 * se_mean + 1e-9
        m4 = [np.mean((s - s.mean()) ** 4) for s in (a, b)]
        se_var = np.sqrt((m4[0] - a.var() ** 2) / n
                         + (m4[1] - b.var() ** 2) / n)
        assert abs(a.var() - b.var()) <= 5 * se_var + 1e-9


def test_cpu_inputs_never_touch_the_kernels():
    before = (distributions.SQUASHED_GAUSSIAN_KERNEL.launches,
              distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches)
    x = torch.zeros(4, 2, requires_grad=True)
    a, logp = distributions.squashed_gaussian_sample_logp(
        x, torch.ones(4, 1), -2.0, 2.0)
    (a.sum() + logp.sum()).backward()
    assert (distributions.SQUASHED_GAUSSIAN_KERNEL.launches,
            distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches) \
        == before
    with pytest.raises(ValueError, match="normals"):
        distributions.squashed_gaussian_sample_logp(x, None, -2.0, 2.0)
    with pytest.raises(ValueError, match="no squashed_gaussian kernel"):
        distributions.squashed_gaussian_sample_logp(
            torch.zeros(2, 2, device="meta"), None, -1.0, 1.0, False)


# ---------------------------------------------------------------------
# the policy: one update, actions, TD errors
# ---------------------------------------------------------------------
def _policy_config(twin_q=True, n_step=1, **over):
    cfg = {"actor_hiddens": [32, 32], "critic_hiddens": [32, 32],
           "twin_q": twin_q, "n_step": n_step, "gamma": 0.95,
           "actor_lr": 1e-3, "critic_lr": 1e-3, "alpha_lr": 1e-3,
           "initial_alpha": 0.5, "seed": 0}
    cfg.update(over)
    return cfg


def _policies(d=2, **cfg):
    """(JAX SACPolicy, port SACPolicy) with the same online weights and
    the same target critic (perturbed away from the online one)."""
    cfg = _policy_config(**cfg)
    jax_pol = JaxSACPolicy(JaxBox(-1.0, 1.0, (OBS_DIM,)),
                           JaxBox(-2.0, 2.0, (d,)), cfg)
    weights = jax.tree.map(np.asarray, jax_pol.get_weights())
    rng = np.random.default_rng(1)
    weights["target"] = jax.tree.map(
        lambda v: (v + 0.1 * rng.standard_normal(v.shape)).astype(
            np.float32), weights["target"])
    jax_pol.set_weights(weights)
    pol = SACPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Box(-2.0, 2.0, (d,)),
                    dict(cfg, device="cpu"))
    pol.set_weights(sac_weights_from_flax(weights))
    return jax_pol, pol


def _batch(n=64, d=2, weights=False, seed=2):
    rng = np.random.default_rng(seed)
    cols = {
        sb.OBS: rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        sb.ACTIONS: rng.uniform(-2.0, 2.0, (n, d)).astype(np.float32),
        sb.REWARDS: rng.standard_normal(n).astype(np.float32),
        sb.NEW_OBS: rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        sb.DONES: rng.random(n) < 0.25,
    }
    if weights:
        cols["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return cols


def _jax_key(jax_pol):
    """The key JAX's next `_next_rng()` returns (`sac_policy.py:127`)."""
    return jax.random.fold_in(jax.random.PRNGKey(0),
                              jax_pol._rng_counter + 1)


@pytest.mark.parametrize("twin_q", [True, False], ids=["twin", "single"])
@pytest.mark.parametrize("n_step,weights", [(1, False), (3, True)],
                         ids=["nstep1", "nstep3-weights"])
def test_learn_with_td_matches_jax(twin_q, n_step, weights):
    """One update from the same weights on the same batch, the port
    handed JAX's two normal draws (`split` of the policy's next key, as
    `sac_policy.py:203` takes them): every stat, |td|, the new actor,
    critic, target critic and log_alpha within 1e-5 of 1 + |JAX|."""
    d, n = 2, 64
    jax_pol, pol = _policies(d, twin_q=twin_q, n_step=n_step)
    cols = _batch(n, d, weights=weights)
    rng_c, rng_a = jax.random.split(_jax_key(jax_pol))
    normals = (np.asarray(jax.random.normal(rng_c, (n, d))),
               np.asarray(jax.random.normal(rng_a, (n, d))))
    want, want_td = jax_pol.learn_with_td(JaxSampleBatch(dict(cols)))
    got, got_td = pol.learn_with_td(SampleBatch(dict(cols)),
                                    _normals=normals)
    assert set(got) == set(want) == {"critic_loss", "actor_loss",
                                     "alpha_loss", "alpha", "mean_q",
                                     "entropy"}
    for k, v in want.items():
        _assert_near(got[k], v, TOL, k)
    assert got_td.dtype == np.float32 and got_td.shape == (n,)
    _assert_near(got_td, want_td, TOL, "|td|")
    want_w = sac_weights_from_flax(jax.tree.map(np.asarray,
                                                jax_pol.get_weights()))
    got_w = pol.get_weights()
    for part in ("online", "target"):
        for net, value in want_w[part].items():
            if net == "log_alpha":
                _assert_near(got_w[part][net], value, TOL, "log_alpha")
                continue
            assert set(got_w[part][net]) == set(value)
            for k, v in value.items():
                _assert_near(got_w[part][net][k], v, TOL,
                             f"{part} {net} {k}")
    assert not np.allclose(want_w["online"]["log_alpha"], np.log(0.5))


@pytest.mark.parametrize("twin_q", [True, False], ids=["twin", "single"])
def test_compute_td_error_matches_jax(twin_q):
    """`compute_td_error` against JAX's `td_fn`, the port handed the
    normal draw of JAX's next key."""
    d, n = 2, 64
    jax_pol, pol = _policies(d, twin_q=twin_q)
    cols = _batch(n, d, seed=5)
    z = np.asarray(jax.random.normal(_jax_key(jax_pol), (n, d)))
    want = jax_pol.compute_td_error(JaxSampleBatch(dict(cols)))
    got = pol.compute_td_error(SampleBatch(dict(cols)), _normals=z)
    assert got.shape == (n,)
    _assert_near(got, want, TOL, "td")


def test_pure_exploration_is_bit_equal_and_deterministic_actions_match():
    """While the policy's timestep is below `pure_exploration_steps`,
    exploring actions are `RandomState(seed).uniform`'s, bit for bit as
    in JAX; not exploring, the actions are JAX `act_fn`'s deterministic
    ones within 1e-6 + 1e-6 |JAX|."""
    jax_pol, pol = _policies(2, pure_exploration_steps=40)
    obs = np.random.default_rng(4).standard_normal((8, OBS_DIM)).astype(
        np.float32)
    for _ in range(5):
        want = jax_pol.compute_actions(obs)[0]
        got = pol.compute_actions(obs)[0]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert pol.global_timestep == jax_pol.global_timestep == 40
    want = np.asarray(jax_pol.compute_actions(obs, explore=False)[0])
    got = pol.compute_actions(obs, explore=False)[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # Past pure exploration: the tail's draws, inside the bounds.
    got, state, extra = pol.compute_actions(obs)
    assert state == [] and extra == {} and got.shape == (8, 2)
    assert np.all(np.abs(got) <= 2.0)
    assert pol.global_timestep == 56


def test_networks_match_jax_parameter_for_parameter():
    """DEFAULT_CONFIG on Pendulum: the actor [3 -> 256 -> 256 -> 2] and
    twin critic towers [4 -> 256 -> 256 -> 1], f32; as many parameters
    as the JAX policy's, and the converter's way back gives its
    weights' tree."""
    cfg = {k: DEFAULT_CONFIG[k] for k in (
        "twin_q", "actor_hiddens", "critic_hiddens", "initial_alpha")}
    jax_pol = JaxSACPolicy(JaxBox(-8.0, 8.0, (3,)), JaxBox(-2.0, 2.0, (1,)),
                           dict(cfg, seed=0))
    pol = SACPolicy(Box(-8.0, 8.0, (3,)), Box(-2.0, 2.0, (1,)),
                    dict(cfg, seed=0, device="cpu"))
    assert [n for n, _ in pol.actor.named_children()] == \
        ["fc_0", "fc_1", "out"]
    assert [n for n, _ in pol.critic.named_children()] == \
        ["q1_fc_0", "q1_fc_1", "q1_out", "q2_fc_0", "q2_fc_1", "q2_out"]
    assert pol.actor.fc_0.in_features == 3 and pol.actor.out.out_features \
        == 2 and pol.critic.q1_fc_0.in_features == 4
    jax_weights = jax.tree.map(np.asarray, jax_pol.get_weights())
    n_jax = sum(int(np.prod(v.shape))
                for v in jax.tree.leaves(jax_weights["online"]))
    assert pol.num_params() == n_jax == 201989
    back = sac_weights_to_flax(pol.get_weights())
    assert jax.tree.structure(back) == jax.tree.structure(jax_weights)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_weights)):
        assert a.shape == b.shape and a.dtype == np.float32


def test_update_target_state_and_weights_round_trip():
    _, pol = _policies(2)
    pol.learn_with_td(SampleBatch(_batch()))
    state = pol.get_state()
    assert set(state["weights"]) == {"online", "target"}
    assert set(state["opt_state"]) == {"actor", "critic", "alpha"}
    _, other = _policies(2, twin_q=True)
    other.set_state(state)
    assert other._update_count == 1
    for part in ("online", "target"):
        for net, value in state["weights"][part].items():
            got = other.get_weights()[part][net]
            if net == "log_alpha":
                np.testing.assert_array_equal(got, value)
                continue
            for k, v in value.items():
                np.testing.assert_array_equal(got[k], v)
    pol.update_target()
    for t, o in zip(pol.target_critic.parameters(),
                    pol.critic.parameters()):
        assert torch.equal(t, o) and t.data_ptr() != o.data_ptr()
        assert not t.requires_grad
    # The online parameters alone leave the target critic as it is.
    target = pol.get_weights()["target"]
    pol.set_weights(other.get_weights()["online"])
    np.testing.assert_array_equal(
        pol.get_weights()["target"]["critic"]["q1_out.bias"],
        target["critic"]["q1_out.bias"])


def test_postprocess_trajectory_matches_jax():
    """n-step folding and `no_done_at_end`, as the JAX policy does them."""
    jax_pol, pol = _policies(2, n_step=3, no_done_at_end=True)
    cols = _batch(7, 2, seed=9)
    cols[sb.DONES] = np.arange(7) == 6
    want = jax_pol.postprocess_trajectory(JaxSampleBatch(
        {k: v.copy() for k, v in cols.items()}))
    got = pol.postprocess_trajectory(SampleBatch(
        {k: v.copy() for k, v in cols.items()}))
    for k in cols:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not np.any(got[sb.DONES])


@pytest.mark.parametrize("over,match", [
    ({"worker_side_prioritization": True}, "A6"),
    ({"num_gpus_for_learner": 2}, "A8"),
])
def test_unported_options_raise(over, match):
    with pytest.raises(NotImplementedError, match=match):
        SACPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Box(-1.0, 1.0, (1,)),
                  dict(_policy_config(), device="cpu", **over))
    with pytest.raises(ValueError, match="Box"):
        SACPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(3), {"device": "cpu"})


# ---------------------------------------------------------------------
# the trainer: tests/test_continuous.py::TestSAC
# ---------------------------------------------------------------------
def test_sac_learns_pendulum(one_thread):
    """The JAX test's config and bar: the best evaluation reward mean >=
    -300 within 36 iterations, and alpha tuned below its initial 1."""
    t = SACTrainer(config={
        "env": "Pendulum-v0",
        "num_workers": 0,
        "actor_hiddens": [64, 64],
        "critic_hiddens": [64, 64],
        "buffer_size": 40000,
        "learning_starts": 500,
        "pure_exploration_steps": 500,
        "train_batch_size": 128,
        "rollout_fragment_length": 1,
        "timesteps_per_iteration": 600,
        "no_done_at_end": True,
        "evaluation_interval": 3,
        "evaluation_num_episodes": 3,
        "seed": 0,
        "device": "cpu",
    })
    best = -1e9
    alpha = None
    try:
        for _ in range(36):
            r = t.train()
            alpha = r["info"]["learner"].get("alpha", alpha)
            if "evaluation" in r:
                best = max(best, r["evaluation"]["episode_reward_mean"])
                if best >= -300:
                    break
    finally:
        t.stop()
    assert best >= -300, f"SAC failed to learn Pendulum: best={best}"
    assert alpha is not None and alpha < 1.0


def test_sac_registry_and_cli_name():
    """The ported names give their trainers; the JAX package's other
    names raise, naming the ROADMAP item that ports them; together they
    are the JAX registry's names."""
    for name, cls in (("SAC", SACTrainer), ("DQN", DQNTrainer),
                      ("SimpleQ", SimpleQTrainer), ("PPO", PPOTrainer),
                      ("IMPALA", IMPALATrainer)):
        assert registry.get_trainer_class(name) is cls
    for name, item in (("DDPG", "A11"), ("TD3", "A11"),
                       ("APEX_DDPG", "A6")):
        with pytest.raises(NotImplementedError, match=item):
            registry.get_trainer_class(name)
    with pytest.raises(ValueError, match="unknown algorithm"):
        registry.get_trainer_class("NoSuchAlgorithm")
    assert set(registry.ALGORITHMS) | set(registry.NOT_PORTED) \
        == set(jax_registry.ALGORITHMS)
    assert not set(registry.ALGORITHMS) & set(registry.NOT_PORTED)
