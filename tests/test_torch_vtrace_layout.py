"""K1's launch plan, its strided inputs, and K9b's strided gradients, on
the CPU.

`vtrace_plan` decides K1's grid (`csrc/vtrace.cu`): tiles of batch
columns, each walked over chunks of T staged in shared memory. The
kernel runs only on a card; its plan is pure Python, so the properties
the kernel relies on are held here: the (tile, chunk) cells cover every
(t, b) once, the staged chunks fit the shared memory a block gets, and
the grid fills an H100 at the Anakin shape. `vtrace_kernel_args`, which
makes the wrapper's input arguments, is held to read the learner's
views where they lie (no copy) and to name what it refuses.

The rest holds the port against the JAX package on the same numpy
inputs: V-trace on batch-major views (as `vtrace_policy._time_major`
gives them), and the squashed-Gaussian tail's gradient when autograd
hands the tail a column slice of the critic's concat gradient and the
expand of a sum, which its backward now takes as they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.agents.impala import vtrace as jax_vtrace
from ray_tpu.rllib.agents.sac.sac_policy import SACPolicy as JaxSACPolicy
from ray_tpu_torch.models import distributions
from ray_tpu_torch.rllib.agents.impala import vtrace
from ray_tpu_torch.rllib.agents.impala.vtrace_policy import _time_major

TOL = 1e-5
# The checked shapes: the learner's 50 x 32, Anakin's 16 x 4096, CartPole
# Anakin's 20 x 32, Sebulba's 25 x 64, a data-parallel rank's 50 x 16, the
# chip check's 500 x 4096, a ragged B of 37, and edges of the plan's rules
# (one step, one column, T on both sides of the one-chunk limit).
PLAN_SHAPES = [(50, 32), (16, 4096), (20, 32), (25, 64), (50, 16),
               (500, 4096), (50, 37), (1, 1), (7, 5), (200, 1024),
               (93, 4096), (94, 4096), (1000, 3), (97, 131), (3, 4133),
               (2, 100000)]


def _cells(T, B):
    """The (t_lo, t_hi, b_lo, b_hi) cells the kernel walks, from the plan
    as `csrc/vtrace.cu` reads it."""
    plan = vtrace.vtrace_plan(T, B)
    for j in range(plan.tiles):
        for c in range(plan.chunks):
            t_hi = T - c * plan.chunk
            yield (max(0, t_hi - plan.chunk), t_hi, j * plan.tile,
                   min((j + 1) * plan.tile, B))


@pytest.mark.parametrize("T,B", PLAN_SHAPES)
def test_plan_covers_every_step_of_every_column_once(T, B):
    covered = np.zeros((T, B), np.int64)
    for t_lo, t_hi, b_lo, b_hi in _cells(T, B):
        assert 0 <= t_lo < t_hi <= T and 0 <= b_lo < b_hi <= B  # no empty
        covered[t_lo:t_hi, b_lo:b_hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("T,B", PLAN_SHAPES)
def test_plan_stays_within_a_blocks_shared_memory(T, B):
    """A tile is one walker warp at most, a power of two; the launch's
    shared memory (the staged inputs, two stages when T takes more than
    one chunk, and the work arrays) fits the default 48 KB a block gets,
    and the chunk is the longest that fits (as even as T allows)."""
    plan = vtrace.vtrace_plan(T, B)
    assert 8 <= plan.tile <= 32 and plan.tile & (plan.tile - 1) == 0
    assert plan.tiles == -(-B // plan.tile)
    assert plan.chunks == -(-T // plan.chunk)
    assert plan.stages == (2 if plan.chunks > 1 else 1)
    assert plan.shared_bytes == vtrace.vtrace_shared_bytes(
        T, plan.tile, plan.chunk)
    assert plan.shared_bytes <= vtrace.VTRACE_SHARED_BYTES == 48 * 1024
    if plan.chunks > 1:
        longer = -(-T // (plan.chunks - 1))
        assert vtrace.vtrace_shared_bytes(T, plan.tile, longer) \
            > vtrace.VTRACE_SHARED_BYTES


@pytest.mark.parametrize("length", range(1, 70))
def test_staged_lines_hold_a_line_from_its_16_byte_boundary(length):
    """A staged line holds `length` elements that start up to 3 floats
    past a 16-byte boundary, in whole 16-byte vectors, an odd number of
    them (neighbouring lines start in distinct banks)."""
    pitch = vtrace._line_pitch(length)
    assert pitch % 4 == 0 and (pitch // 4) % 2 == 1
    assert pitch >= length + 3


def test_plan_fills_the_card_at_the_anakin_shape():
    assert vtrace.vtrace_plan(16, 4096).tiles >= 128
    assert vtrace.vtrace_plan(50, 32).tiles >= 1
    assert vtrace.vtrace_plan(50, 37).tiles >= 2  # the ragged column
    # Long T walks double-buffered chunks; the learner's T is one chunk.
    assert vtrace.vtrace_plan(500, 4096).chunks > 1
    assert vtrace.vtrace_plan(50, 32).chunks == 1


def _learner_views(T, B, seed=0, dtype=torch.float32):
    """The kernel's inputs as `vtrace_loss` makes them: batch-major
    [B * T] columns turned time-major by `_time_major` (views), the
    log_rhos a fresh [T, B] tensor, the bootstrap [B]."""
    rng = np.random.default_rng(seed)
    flat = {k: torch.tensor(rng.standard_normal(B * T), dtype=dtype)
            for k in ("discounts", "rewards", "values")}
    views = {k: _time_major(v, T) for k, v in flat.items()}
    views["log_rhos"] = torch.tensor(rng.uniform(-1.5, 1.5, (T, B)),
                                     dtype=dtype)
    views["bootstrap_value"] = torch.tensor(rng.standard_normal(B),
                                            dtype=dtype)
    return flat, views


def _args(views):
    return vtrace.vtrace_kernel_args(
        views["log_rhos"], views["discounts"], views["rewards"],
        views["values"], views["bootstrap_value"])


@pytest.mark.parametrize("T,B", [(50, 32), (16, 4096), (25, 64), (7, 5)])
def test_kernel_args_read_the_learners_views_in_place(T, B):
    """Batch-major views go to the kernel as (address, 1, T): the very
    storage of the flat columns, not a copy."""
    flat, views = _learner_views(T, B)
    args = _args(views)
    assert len(args) == 4 * 3 + 2
    log_rhos, discounts, rewards, values = (args[3 * k:3 * k + 3]
                                            for k in range(4))
    assert log_rhos == (views["log_rhos"].data_ptr(), B, 1)
    for name, got in (("discounts", discounts), ("rewards", rewards),
                      ("values", values)):
        assert not views[name].is_contiguous()
        assert got == (flat[name].data_ptr(), 1, T), name
    assert args[12:] == (views["bootstrap_value"].data_ptr(), 1)


def test_kernel_args_pass_time_major_and_offset_views_as_they_are():
    """Time-major inputs go as (address, B, 1); a view at a storage
    offset keeps its own address; a dimension of size 1 passes stride 1
    whatever its stride; the bootstrap may be strided."""
    T, B = 6, 4
    base = torch.zeros(T * B + 3)
    x = base[3:].view(T, B)
    boot = torch.zeros(2 * B)[::2]
    args = vtrace.vtrace_kernel_args(x, x, x, x, boot)
    assert args[:12] == (x.data_ptr(), B, 1) * 4
    assert x.data_ptr() == base.data_ptr() + 3 * 4
    assert args[12:] == (boot.data_ptr(), 2)
    column = torch.zeros(T, 2)[:, ::2]  # [T, 1], strides (2, 2)
    args = vtrace.vtrace_kernel_args(column, column, column, column,
                                     torch.zeros(1))
    assert args[:3] == (column.data_ptr(), 2, 1)


def test_kernel_args_name_what_they_refuse():
    _, views = _learner_views(6, 4)
    with pytest.raises(ValueError, match="rewards is torch.float64"):
        _args(dict(views, rewards=views["rewards"].double()))
    with pytest.raises(ValueError, match=r"values is \(6, 5\)"):
        _args(dict(views, values=torch.zeros(6, 5)))
    with pytest.raises(ValueError, match="bootstrap_value is"):
        _args(dict(views, bootstrap_value=torch.zeros(3)))
    with pytest.raises(ValueError, match=r"\[T, B\] inputs"):
        _args(dict(views, log_rhos=torch.zeros(6)))
    # Neither stride is 1: every other column, or an expand.
    with pytest.raises(ValueError, match=r"discounts has strides \(8, 2\)"):
        _args(dict(views, discounts=torch.zeros(6, 8)[:, ::2]))
    with pytest.raises(ValueError, match="values has strides"):
        _args(dict(views, values=torch.zeros(1, 1).expand(6, 4)))


@pytest.mark.parametrize("T,B", [(7, 5), (50, 32), (20, 37)])
def test_batch_major_views_match_jax(T, B):
    """`from_importance_weights` on the learner's transposed views equals
    the JAX function on the same numbers, time-major."""
    flat, views = _learner_views(T, B, seed=T + B)
    views["discounts"] = _time_major(
        0.95 * (flat["discounts"] > -1.0).float(), T)
    got = vtrace.from_importance_weights(**views)
    want = jax_vtrace.from_importance_weights(
        **{k: v.contiguous().numpy() for k, v in views.items()})
    np.testing.assert_allclose(got.vs.numpy(), want.vs, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.pg_advantages.numpy(),
                               want.pg_advantages, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------
# K9b's upstream gradients as the SAC actor step hands them over
# ---------------------------------------------------------------------
class _JaxTail:
    """The JAX SAC policy's `_dist` and `_sample_action` on a given actor
    output: the actor is the identity."""

    _dist = JaxSACPolicy._dist
    _sample_action = JaxSACPolicy._sample_action

    def __init__(self, low, high, d):
        self.low, self.high, self.action_dim = low, high, d
        self.actor = type("Identity", (), {
            "apply": staticmethod(lambda params, obs: obs)})()


def _tail_inputs(B, d, seed):
    """x [B, 2d]: means with saturating rows, raw log_std over both clip
    bounds but at least 1e-3 from them (the clip's kinks)."""
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal((B, d)) * 3.0
    mean[::3] *= 6.0
    raw = rng.uniform(-25.0, 5.0, (B, d))
    near = (np.abs(raw + 20.0) < 1e-3) | (np.abs(raw - 2.0) < 1e-3)
    raw = np.where(near, raw + 3e-3, raw)
    return np.concatenate([mean, raw], axis=1).astype(np.float32)


@pytest.mark.parametrize("d", [1, 6])
@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (-2.0, 2.0)])
def test_tail_gradient_from_the_critics_concat_matches_jax(d, low, high,
                                                           monkeypatch):
    """The actor loss's shape: the tail's actions enter a critic through
    concat([obs, a]), and a sum of logp. Autograd then hands the tail's
    backward g_a as a column slice (row stride obs_dim + d) and g_logp
    as an expand (stride 0); the backward takes them as they are, and
    the gradient to x equals `jax.grad` of the same objective through
    JAX's `_sample_action` (1e-5 of 1 + |JAX|) and, bit for bit, the
    plain backward on dense copies."""
    B, obs_dim, hidden = 64, 3, 5
    rng = np.random.default_rng(d + 20)
    x = _tail_inputs(B, d, seed=d + 21)
    obs = rng.standard_normal((B, obs_dim)).astype(np.float32)
    w = rng.standard_normal((obs_dim + d, hidden)).astype(np.float32)
    key = jax.random.PRNGKey(d + 22)
    tail = _JaxTail(low, high, d)

    def objective(x):
        a, logp = tail._sample_action(None, x, key)
        return jnp.sum(jnp.concatenate([obs, a], axis=-1) @ w) \
            + 0.7 * jnp.sum(logp)

    want = np.asarray(jax.grad(objective)(x))
    z = torch.from_numpy(np.array(jax.random.normal(key, (B, d))))
    seen = []
    plain = distributions._squashed_gaussian_backward_plain

    def recording(x, z, g_a, g_logp, *rest):
        seen.append((g_a, g_logp))
        return plain(x, z, g_a, g_logp, *rest)

    monkeypatch.setattr(distributions, "_squashed_gaussian_backward_plain",
                        recording)
    xt = torch.from_numpy(x).requires_grad_(True)
    a, logp = distributions.squashed_gaussian_sample_logp(xt, z, low, high)
    loss = torch.sum(torch.cat([torch.from_numpy(obs), a], dim=-1)
                     @ torch.from_numpy(w)) + 0.7 * torch.sum(logp)
    (got,) = torch.autograd.grad(loss, [xt])
    (g_a, g_logp), = seen
    assert g_a.shape == (B, d) and g_a.stride() == (obs_dim + d, 1)
    assert g_logp.shape == (B,) and g_logp.stride() == (0,)
    err = np.abs(got.numpy() - want) / (1.0 + np.abs(want))
    assert err.max() <= TOL, err.max()
    dense = plain(xt.detach(), z, g_a.contiguous(), g_logp.contiguous(),
                  low, high, True)
    assert torch.equal(got, dense)


@pytest.mark.parametrize("absent", ["g_a", "g_logp"])
def test_tail_gradient_with_one_upstream_gradient_absent(absent):
    """Only the actions, or only the logp, reach the loss: the other
    gradient is None in the backward, read as zeros."""
    B, d = 16, 2
    x = torch.from_numpy(_tail_inputs(B, d, seed=5)).requires_grad_(True)
    z = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, d)).astype(np.float32))
    a, logp = distributions.squashed_gaussian_sample_logp(x, z, -2.0, 2.0)
    loss = logp.sum() if absent == "g_a" else a.sum()
    (got,) = torch.autograd.grad(loss, [x])
    ones_a, ones_l = torch.ones(B, d), torch.ones(B)
    want = distributions._squashed_gaussian_backward_plain(
        x.detach(), z, None if absent == "g_a" else ones_a,
        None if absent == "g_logp" else ones_l, -2.0, 2.0, True)
    assert torch.equal(got, want)
