"""Port parity: the Categorical action distribution.

`logp`/`entropy`/`kl` against the JAX package's `Categorical` at 1e-6
on the same numpy logits. The sampling tail's plain version (the CPU
side of the K2 kernel) with fixed uniforms against a numpy Gumbel-max,
exactly. jax.random and torch.Generator streams never agree, so the
port's sampler itself is held to a chi-square distribution test. The
same for the k-step tail (the CPU side of the K2k kernel): exact against
numpy on fixed uniforms, argmax and logp against JAX's `Categorical`,
and k seeded draws per row against softmax, independent of each other.
"""

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import numpy as np
import pytest
import torch
from scipy import stats

from ray_tpu.models.distributions import Categorical as JaxCategorical
from ray_tpu_torch.models import distributions
from ray_tpu_torch.models.distributions import Categorical

TOL = 1e-6


def _logits(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 2.0


def _np_log_softmax(x):
    z = x - x.max(-1, keepdims=True)
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


def test_logp_entropy_kl_match_jax():
    p, q = _logits((3, 5, 6), 0), _logits((3, 5, 6), 1)
    actions = np.random.default_rng(2).integers(0, 6, (3, 5))
    jp, jq = JaxCategorical(p), JaxCategorical(q)
    tp, tq = Categorical(torch.from_numpy(p)), Categorical(torch.from_numpy(q))
    np.testing.assert_allclose(
        tp.logp(torch.from_numpy(actions)), jp.logp(actions.astype(np.int32)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tp.entropy(), jp.entropy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tp.kl(tq), jp.kl(jq), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,A", [(32, 6), (257, 18), (4, 1)])
def test_plain_tail_is_numpy_gumbel_max(B, A):
    logits = _logits((B, A), seed=B)
    u = np.random.default_rng(A).random((B, A), dtype=np.float32)
    actions, logp = distributions.sample_logp(
        torch.from_numpy(logits), torch.from_numpy(u), explore=True)
    score = logits - np.log(-np.log(np.maximum(
        u, np.finfo(np.float32).tiny)))
    want = np.argmax(score, axis=-1)
    np.testing.assert_array_equal(actions.numpy(), want)
    assert actions.dtype == torch.int64 and logp.dtype == torch.float32
    want_logp = np.take_along_axis(_np_log_softmax(logits),
                                   want[:, None], -1)[:, 0]
    np.testing.assert_allclose(logp, want_logp, rtol=TOL, atol=TOL)


def test_plain_tail_not_exploring_is_first_argmax():
    logits = np.array([[0.5, 2.0, 2.0, -1.0],
                       [3.0, 3.0, 3.0, 3.0],
                       [-1.0, -2.0, -3.0, 7.0]], np.float32)
    actions, logp = distributions.sample_logp(
        torch.from_numpy(logits), None, explore=False)
    np.testing.assert_array_equal(actions.numpy(), [1, 0, 3])
    np.testing.assert_allclose(
        logp, _np_log_softmax(logits)[np.arange(3), [1, 0, 3]],
        rtol=TOL, atol=TOL)
    det = Categorical(torch.from_numpy(logits)).deterministic_sample()
    np.testing.assert_array_equal(det.numpy(), [1, 0, 3])


def test_sampler_matches_softmax_chi_square():
    """20k draws of the port's sampler (policy-style: uniforms from a
    seeded torch.Generator) against softmax(logits), chi-square p>1e-3."""
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -3.0])
    n = 20000
    gen = torch.Generator().manual_seed(0)
    actions, logp = Categorical(logits.expand(n, 6)).sample_with_logp(gen)
    counts = np.bincount(actions.numpy(), minlength=6)
    probs = torch.softmax(logits, -1).numpy().astype(np.float64)
    _, p_value = stats.chisquare(counts, n * probs / probs.sum())
    assert p_value > 1e-3, (counts, n * probs)
    np.testing.assert_allclose(
        logp.numpy(), np.log(probs)[actions.numpy()], rtol=1e-5, atol=1e-5)


def test_sampling_is_seeded():
    logits = torch.from_numpy(_logits((64, 6)))
    a = Categorical(logits).sample(torch.Generator().manual_seed(7))
    b = Categorical(logits).sample(torch.Generator().manual_seed(7))
    c = Categorical(logits).sample(torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cpu_inputs_never_touch_the_kernel():
    before = distributions.CATEGORICAL_KERNEL.launches
    Categorical(torch.zeros(4, 3)).sample(torch.Generator().manual_seed(0))
    assert distributions.CATEGORICAL_KERNEL.launches == before


@pytest.mark.parametrize("k,N,A", [(1, 32, 6), (5, 32, 6), (8, 65, 18)])
def test_plain_k_tail_is_numpy_gumbel_max(k, N, A):
    """Draw j of each row is the Gumbel-max of the row's logits with the
    uniforms u[j]: exactly numpy's, logp within 1e-6."""
    logits = _logits((N, A), seed=k + N)
    u = np.random.default_rng(A).random((k, N, A), dtype=np.float32)
    actions, logp = distributions.sample_logp_k(
        torch.from_numpy(logits), torch.from_numpy(u), explore=True)
    assert actions.shape == (k, N) and actions.dtype == torch.int64
    score = logits[None] - np.log(-np.log(np.maximum(
        u, np.finfo(np.float32).tiny)))
    want = np.argmax(score, axis=-1)
    np.testing.assert_array_equal(actions.numpy(), want)
    want_logp = np.take_along_axis(
        np.broadcast_to(_np_log_softmax(logits), (k, N, A)),
        want[..., None], -1)[..., 0]
    np.testing.assert_allclose(logp, want_logp, rtol=TOL, atol=TOL)
    if k == 1:  # the single-step tail on the same uniforms
        a1, l1 = distributions.sample_logp(
            torch.from_numpy(logits), torch.from_numpy(u[0]), explore=True)
        assert torch.equal(a1, actions[0]) and torch.equal(l1, logp[0])


def test_plain_k_tail_not_exploring_matches_jax():
    """explore=False: every draw of the window is JAX's
    `deterministic_sample`, with JAX's logp of it (1e-6)."""
    logits = _logits((40, 7), seed=3)
    logits[0, :3] = 5.0  # a tie: the first maximum
    actions, logp = distributions.sample_logp_k(
        torch.from_numpy(logits), None, explore=False, k=3)
    jd = JaxCategorical(logits)
    want = np.asarray(jd.deterministic_sample())
    for j in range(3):
        np.testing.assert_array_equal(actions[j].numpy(), want)
        np.testing.assert_allclose(
            logp[j], np.asarray(jd.logp(want.astype(np.int32))), rtol=TOL,
            atol=TOL)
    assert int(actions[0, 0]) == 0


def test_k_draws_match_softmax_and_are_independent():
    """k=5 draws per row from a seeded generator (the Sebulba window):
    the draws of every position j follow softmax (chi-square p>1e-3), and
    a window's k draws are independent — the share of windows whose k
    actions are all equal is sum_a p_a^k (binomial z < 4)."""
    k, n = 5, 20000
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -3.0])
    probs = torch.softmax(logits, -1).numpy().astype(np.float64)
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(0)
    actions, logp = Categorical(logits.expand(n, 6)).sample_k_with_logp(
        gen, k)
    actions = actions.numpy()
    for j in range(k):
        counts = np.bincount(actions[j], minlength=6)
        _, p_value = stats.chisquare(counts, n * probs)
        assert p_value > 1e-3, (j, counts, n * probs)
    np.testing.assert_allclose(logp.numpy(), np.log(probs)[actions],
                               rtol=1e-5, atol=1e-5)
    all_equal = (actions == actions[0]).all(axis=0).mean()
    want = float((probs ** k).sum())
    z = abs(all_equal - want) / np.sqrt(want * (1 - want) / n)
    assert z < 4.0, (all_equal, want)
    # Seeded: the same generator seed gives the same window.
    again = Categorical(logits.expand(n, 6)).sample_k_with_logp(
        torch.Generator().manual_seed(0), k)[0].numpy()
    np.testing.assert_array_equal(again, actions)


def test_cpu_inputs_never_touch_the_k_kernel():
    before = distributions.CATEGORICAL_K_KERNEL.launches
    Categorical(torch.zeros(4, 3)).sample_k_with_logp(
        torch.Generator().manual_seed(0), 3)
    assert distributions.CATEGORICAL_K_KERNEL.launches == before


# ---------------------------------------------------------------------
# SquashedGaussian (SAC)
# ---------------------------------------------------------------------
def _squashed_pair(low=-2.0, high=2.0, seed=0):
    from ray_tpu.models.distributions import SquashedGaussian as JaxSquashed
    from ray_tpu_torch.models.distributions import SquashedGaussian
    inputs = np.random.default_rng(seed).standard_normal((10, 4)).astype(
        np.float32) * 3
    return (JaxSquashed(inputs, low=low, high=high),
            SquashedGaussian(torch.from_numpy(inputs), low=low, high=high),
            inputs)


def test_squashed_gaussian_bounds():
    """`test_rllib_core.py::test_squashed_gaussian_bounds`'s check: samples
    lie in [low, high]; with a seeded generator they repeat."""
    _, d, _ = _squashed_pair()
    s = d.sample(torch.Generator().manual_seed(0))
    assert s.shape == (10, 2)
    assert bool((s >= -2.0).all()) and bool((s <= 2.0).all())
    assert torch.equal(s, d.sample(torch.Generator().manual_seed(0)))


def test_squashed_gaussian_matches_jax():
    """deterministic_sample, logp of given actions (arctanh unsquash with
    the 1e-8 guard) and entropy against the JAX package's class."""
    jd, d, _ = _squashed_pair(-1.0, 0.5, seed=1)
    np.testing.assert_allclose(d.deterministic_sample().numpy(),
                               jd.deterministic_sample(), rtol=TOL,
                               atol=TOL)
    actions = np.random.default_rng(2).uniform(-0.99, 0.49, (10, 2)).astype(
        np.float32)
    np.testing.assert_allclose(d.logp(torch.from_numpy(actions)).numpy(),
                               jd.logp(actions), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.entropy().numpy(), jd.entropy(), rtol=TOL,
                               atol=TOL)
    sample, logp = d.sample_with_logp(torch.Generator().manual_seed(3))
    assert sample.shape == (10, 2) and logp.shape == (10,)
    assert distributions.SquashedGaussian.required_input_dim(
        distributions.Box(-1.0, 1.0, (3,))) == 6


def test_box_keeps_the_diag_gaussian():
    """As in the JAX package, a Box maps to DiagGaussian; SAC builds its
    squashed tail itself."""
    from ray_tpu_torch.rllib.env.spaces import Box
    assert distributions.get_action_dist(Box(-1.0, 1.0, (2,))) == \
        (distributions.DiagGaussian, 4)
