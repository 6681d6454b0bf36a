"""Port parity: the DiagGaussian action distribution and the FC network
with `free_log_std` (Box actions, PPO's continuous path).

`logp`/`entropy`/`kl` against the JAX package's `DiagGaussian` at 1e-6
on the same numpy inputs. The sampling tail's plain version (the CPU
side of the K7 kernel) with fixed normals against numpy's arithmetic,
exploring and not. jax.random and torch.Generator streams never agree,
so the port's draws are held to their distribution: the mean and
variance of 1e5 seeded draws, and their logp against the closed form.
The FC network with `free_log_std` against flax on converted weights
(f32, 1e-5).
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from ray_tpu.models import catalog as jax_catalog
from ray_tpu.models.distributions import DiagGaussian as JaxDiagGaussian
from ray_tpu.rllib.env.spaces import Box as JaxBox
from ray_tpu_torch.models import catalog, distributions
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.models.distributions import DiagGaussian
from ray_tpu_torch.rllib.env.spaces import Box

TOL = 1e-6
# f32 networks on the CPU, as tests/test_torch_models.py states it.
F32_TOL = 1e-5


def _inputs(B, d, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal((B, d)).astype(np.float32) * 2.0
    log_std = rng.uniform(-2.0, 1.0, (B, d)).astype(np.float32)
    return np.concatenate([mean, log_std], axis=-1)


def test_logp_entropy_kl_match_jax():
    p, q = _inputs(64, 3, 0), _inputs(64, 3, 1)
    x = np.random.default_rng(2).standard_normal((64, 3)).astype(
        np.float32)
    jp, jq = JaxDiagGaussian(p), JaxDiagGaussian(q)
    tp, tq = DiagGaussian(torch.from_numpy(p)), DiagGaussian(
        torch.from_numpy(q))
    np.testing.assert_allclose(tp.logp(torch.from_numpy(x)), jp.logp(x),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tp.entropy(), jp.entropy(), rtol=TOL,
                               atol=TOL)
    # The old distribution comes first: KL(p || q) != KL(q || p).
    np.testing.assert_allclose(tp.kl(tq), jp.kl(jq), rtol=TOL, atol=TOL)
    assert not np.allclose(tp.kl(tq), tq.kl(tp))
    np.testing.assert_array_equal(tp.deterministic_sample(),
                                  jp.deterministic_sample())


def test_lazy_std_gives_the_same_logp_entropy_kl_and_gradients():
    """`mean`, `log_std` and `std` are computed at their first read:
    sampling reads none of them, and `logp`, `entropy` and `kl` and
    their gradients equal the eager formulas' (chunk and exp up front)
    bit for bit."""
    p, q = _inputs(32, 3, 3), _inputs(32, 3, 4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (32, 3)).astype(np.float32))

    def eager(pi, qi):
        mean, log_std = torch.chunk(pi, 2, dim=-1)
        q_mean, q_log_std = torch.chunk(qi, 2, dim=-1)
        std, q_std = torch.exp(log_std), torch.exp(q_log_std)
        logp = (-0.5 * torch.sum(((x - mean) / std) ** 2, dim=-1)
                - distributions.gaussian_log_norm(3)
                - torch.sum(log_std, dim=-1))
        entropy = torch.sum(log_std, dim=-1) + 0.5 * 3 * (
            1.0 + np.log(2.0 * np.pi))
        kl = torch.sum(q_log_std - log_std + (std ** 2 + (mean - q_mean)
                                              ** 2) / (2.0 * q_std ** 2)
                       - 0.5, dim=-1)
        return logp, entropy, kl

    def lazy(pi, qi):
        dp, dq = DiagGaussian(pi), DiagGaussian(qi)
        dp.sample_with_logp(torch.Generator().manual_seed(0))
        assert not {"mean", "log_std", "std"} & set(vars(dp))
        return dp.logp(x), dp.entropy(), dp.kl(dq)

    for make in (eager, lazy):
        pi = torch.from_numpy(p).requires_grad_(True)
        qi = torch.from_numpy(q).requires_grad_(True)
        outs = make(pi, qi)
        grads = [torch.autograd.grad(o.sum(), (pi, qi), allow_unused=True,
                                     retain_graph=True)
                 for o in outs]
        if make is eager:
            want = (outs, grads)
    for got, w in zip(outs, want[0]):
        assert torch.equal(got, w)
    for got, w in zip(grads, want[1]):
        for g, gw in zip(got, w):
            assert (g is None and gw is None) or torch.equal(g, gw)


def _numpy_tail(inputs, z, explore):
    """The K7 arithmetic in numpy float32, sums in column order."""
    d = inputs.shape[1] // 2
    mean, log_std = inputs[:, :d], inputs[:, d:]
    std = np.exp(log_std)
    actions = mean + std * z if explore else mean.copy()
    y = (actions - mean) / std
    sq = np.zeros(len(inputs), np.float32)
    sls = np.zeros(len(inputs), np.float32)
    for j in range(d):
        sq = sq + y[:, j] * y[:, j]
        sls = sls + log_std[:, j]
    log_norm = np.float32(distributions.gaussian_log_norm(d))
    return actions, (np.float32(-0.5) * sq - log_norm) - sls


# (8, 1): Pendulum's 8 envs; (4096, 17): a MuJoCo-sized box at 4096
# envs; (5, 40): d over one warp's 32 lanes.
@pytest.mark.parametrize("B,d", [(8, 1), (4096, 17), (5, 40)])
@pytest.mark.parametrize("explore", [True, False])
def test_plain_tail_is_numpy_arithmetic(B, d, explore):
    inputs = _inputs(B, d, seed=B + d)
    z = np.random.default_rng(d).standard_normal((B, d)).astype(np.float32)
    actions, logp = distributions.gaussian_sample_logp(
        torch.from_numpy(inputs), torch.from_numpy(z), explore)
    want_actions, want_logp = _numpy_tail(inputs, z, explore)
    assert actions.dtype == torch.float32 and logp.dtype == torch.float32
    assert actions.shape == (B, d) and logp.shape == (B,)
    # numpy's exp may differ from torch's by an ulp.
    np.testing.assert_allclose(actions.numpy(), want_actions, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(logp.numpy(), want_logp, rtol=TOL, atol=TOL)
    if not explore:
        # The mean itself, bit for bit, and logp at the mode.
        np.testing.assert_array_equal(actions.numpy(), inputs[:, :d])
    # logp of the actions agrees with DiagGaussian.logp (JAX's formula).
    np.testing.assert_allclose(
        logp.numpy(), DiagGaussian(torch.from_numpy(inputs)).logp(
            actions).numpy(), rtol=1e-5, atol=1e-5)


def test_draws_follow_the_distribution():
    """1e5 draws per row from a seeded generator: the sample mean within
    5 standard errors of `mean`, the sample variance within 5 of std^2,
    and logp equal to scipy's log-density of the draws."""
    n = 100_000
    inputs = np.array([[0.5, -1.0, 0.0, np.log(0.3)]], np.float32)
    dist = DiagGaussian(torch.from_numpy(np.repeat(inputs, n, 0)))
    gen = torch.Generator().manual_seed(0)
    actions, logp = dist.sample_with_logp(gen)
    a = actions.numpy().astype(np.float64)
    mean = inputs[0, :2].astype(np.float64)
    std = np.exp(inputs[0, 2:].astype(np.float64))
    se = std / np.sqrt(n)
    assert (np.abs(a.mean(0) - mean) < 5 * se).all(), a.mean(0)
    var_se = std ** 2 * np.sqrt(2.0 / (n - 1))
    assert (np.abs(a.var(0, ddof=1) - std ** 2) < 5 * var_se).all()
    # The draws are Gaussian: a KS test per dimension.
    for j in range(2):
        assert stats.kstest((a[:, j] - mean[j]) / std[j], "norm").pvalue \
            > 1e-3
    want = stats.norm.logpdf(a, mean, std).sum(-1)
    np.testing.assert_allclose(logp.numpy(), want, rtol=1e-5, atol=1e-5)
    # Another seed, other draws; the same seed, the same draws.
    again = dist.sample_with_logp(torch.Generator().manual_seed(0))[0]
    other = dist.sample_with_logp(torch.Generator().manual_seed(1))[0]
    assert torch.equal(again, actions) and not torch.equal(other, actions)


def test_box_maps_to_diag_gaussian():
    dist_class, dim = distributions.get_action_dist(Box(-2.0, 2.0, (3,)))
    assert dist_class is DiagGaussian and dim == 6


def test_wrapper_refuses_devices_without_a_kernel():
    inputs = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="no diag_gaussian kernel"):
        distributions.gaussian_sample_logp(inputs, None, False)


@pytest.mark.parametrize("free_log_std", [True, False])
def test_fc_network_matches_flax(free_log_std):
    """Pendulum's shapes (obs 3, a 1-dim box): with `free_log_std` the
    logits layer emits the mean and the state-independent log_std
    parameter follows it; without, the logits layer emits both."""
    space, outputs = (3,), 2
    mcfg = {"fcnet_hiddens": [32, 32], "free_log_std": free_log_std}
    jax_model = jax_catalog.get_model(
        JaxBox(-1.0, 1.0, space, np.float32), outputs, mcfg)
    obs = np.random.default_rng(0).standard_normal((16,) + space).astype(
        np.float32)
    params = jax.tree.map(np.asarray, jax_model.init(
        jax.random.PRNGKey(0), obs[:1]))
    if free_log_std:
        assert "log_std" in params["params"]
        params["params"]["log_std"] = np.array([-0.7], np.float32)
    model = catalog.get_model(Box(-1.0, 1.0, space), outputs, mcfg)
    assert (model.log_std is not None) == free_log_std
    model.load_state_dict(flax_to_state_dict(params))
    want_logits, want_value = jax_model.apply(params, obs)
    with torch.no_grad():
        logits, value = model(torch.from_numpy(obs))
    assert logits.shape == (16, outputs)
    np.testing.assert_allclose(logits, want_logits, rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(value, want_value, rtol=F32_TOL,
                               atol=F32_TOL)
    if free_log_std:
        np.testing.assert_array_equal(logits[:, 1].numpy(), np.float32(-0.7))
        # A fresh model's log_std starts at zero, as flax's.
        fresh = catalog.get_model(Box(-1.0, 1.0, space), outputs, mcfg)
        assert torch.equal(fresh.log_std, torch.zeros(1))
