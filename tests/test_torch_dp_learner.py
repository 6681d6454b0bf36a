"""Port parity: the data-parallel IMPALA learner.

One V-trace update on a 4-rank gloo world of the port against
`VTraceJaxPolicy` on a 4-device JAX mesh, from identical weights
(converted flax -> torch) and one packed batch of 8 fragments x T=5 on
the full-width Nature CNN with an f32 trunk; rank r learns on rows
[r*n/4, (r+1)*n/4), JAX's P("dp") split. fp32 and q8 exchanges, grad
clip 40 and 0.01. Then the CartPole trainer on a 2-rank world, q8 and
fp32, and the config refusals of a world.

A finding of the reference this port does not copy: the V-trace loss
sums over rows (`vtrace_policy.py:163-171`), but the JAX q8 path divides
the summed gradient by D (`pmean_quantized`) and reports 1/D of
`total_loss`. On this batch with grad_clip 40 (virtual CPU devices):
fp32 on 1, 2 or 4 devices gives grad_gnorm 41.02626 and total_loss
-1.97049; q8 on 2 devices 20.51315 / -0.98524, on 4 devices 10.25787 /
-0.49262, so the fp32 arm clips and the q8 arm does not. The port's
exchange is a psum for a sum loss under either codec: its q8 gradient is
D x JAX's, and its stats are the fp32 arm's.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks
from ray_tpu.parallel import collectives as jax_collectives
from ray_tpu.parallel import mesh as mesh_lib
from ray_tpu.rllib.agents.impala.vtrace_policy import VTraceJaxPolicy
from ray_tpu.rllib.env.spaces import Box as JaxBox
from ray_tpu.rllib.env.spaces import Discrete as JaxDiscrete
from ray_tpu.rllib.sample_batch import SampleBatch as JaxSampleBatch
from ray_tpu._private import serialization
from ray_tpu_torch.models.convert import flax_leaves, flax_to_state_dict
from ray_tpu_torch.parallel.distributed import launch
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
from test_torch_impala import GRAD_ATOL, STAT_TOL

FRAGMENTS, T, A, D = 8, 5, 6, 4
FRAME = (84, 84, 4)
Q8B = serialization.Q8_BLOCK
ARMS = [(40.0, "fp32"), (40.0, "q8"), (0.01, "fp32"), (0.01, "q8")]
# Elements of the q8 gradient (1,693,696 packed) where the port's sum and
# D x JAX's differ by more than the rounding bound: a code moved across a
# rounding boundary by a local-gradient difference below GRAD_ATOL (or by
# the jitted JAX scale's ulp). Measured: 54 on this batch (0.0032%).
MAX_MOVED_CODES = 200


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    n = FRAGMENTS * T
    return {
        sb.OBS: rng.integers(0, 256, (n,) + FRAME, dtype=np.uint8),
        sb.NEW_OBS: rng.integers(0, 256, (n,) + FRAME, dtype=np.uint8),
        sb.ACTIONS: rng.integers(0, A, n),
        sb.REWARDS: rng.standard_normal(n).astype(np.float32),
        sb.DONES: rng.random(n) < 0.2,
        sb.ACTION_DIST_INPUTS: rng.standard_normal((n, A)).astype(
            np.float32),
    }


def _state_dict(flax_tree):
    return {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, flax_tree)).items()}


def _packed(state_dict):
    """Gradients by parameter name -> the exchange's packed f32 buffer
    (flax leaf order, block-aligned slots)."""
    slots = []
    for _, _, leaf in flax_leaves({k: torch.from_numpy(np.asarray(v))
                                   for k, v in state_dict.items()}):
        flat = leaf.reshape(-1).numpy()
        slot = np.zeros(-(-flat.size // Q8B) * Q8B, np.float32)
        slot[:flat.size] = flat
        slots.append(slot)
    return np.concatenate(slots)


@pytest.fixture(scope="module")
def jax_side():
    devices = jax.devices()[:D]
    if len(devices) < D:
        pytest.skip(f"need {D} JAX devices")
    mesh = mesh_lib.make_mesh(devices=devices, axis_names=("dp",))
    cols = _columns()
    out = {}
    for grad_clip, codec in ARMS:
        if (grad_clip, codec) == (0.01, "q8"):
            continue
        policy = VTraceJaxPolicy(
            JaxBox(0, 255, FRAME, np.uint8), JaxDiscrete(A),
            {"model": {"compute_dtype": "f32"},
             "rollout_fragment_length": T, "seed": 0,
             "grad_clip": grad_clip, "_mesh": mesh,
             "allreduce_codec": codec})
        arm = {"weights0": policy.get_weights(),
               "payload": jax_collectives.payload_bytes(policy.params,
                                                        codec)}
        batch = policy._device_batch(JaxSampleBatch(cols))
        if codec == "fp32":
            grads, _ = policy._grad_fn(policy.params, batch,
                                       policy._next_rng(),
                                       policy.loss_state)
        else:
            _, _, grads, _ = jax.jit(policy._loss_grad)(
                policy.params, batch, policy._next_rng(),
                policy.loss_state, policy._ef_state)
        arm["grads"] = _state_dict(grads)
        arm["stats"] = policy.learn_on_batch(JaxSampleBatch(cols))
        arm["global_timestep"] = policy.global_timestep
        arm["weights"] = _state_dict(policy.get_weights())
        out[(grad_clip, codec)] = arm
    return out


@pytest.fixture(scope="module")
def port_side(jax_side):
    weights = _state_dict(jax_side[(40.0, "fp32")]["weights0"])
    return launch(torch_dp_ranks.dp_update_rank, D, "gloo", D, weights,
                  _columns(), T, ARMS, timeout=600)


def _same_on_every_rank(port_side, arm):
    first = port_side[0][arm]
    for other in port_side[1:]:
        o = other[arm]
        assert o["stats"] == first["stats"]
        for key in ("grads", "weights"):
            for k in first[key]:
                np.testing.assert_array_equal(o[key][k], first[key][k])
    return first


@pytest.mark.parametrize("grad_clip", [40.0, 0.01])
def test_fp32_update_matches_jax_mesh(jax_side, port_side, grad_clip):
    """Stats, exchanged gradients and the post-Adam parameters within
    slice 1's tolerances; every rank bit-equal."""
    ours = _same_on_every_rank(port_side, (grad_clip, "fp32"))
    theirs = jax_side[(grad_clip, "fp32")]
    assert set(ours["stats"]) == set(theirs["stats"])
    for k, v in ours["stats"].items():
        np.testing.assert_allclose(v, theirs["stats"][k], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=k)
    for k, g in ours["grads"].items():
        np.testing.assert_allclose(g, theirs["grads"][k], rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)
    # The bound of test_torch_impala.py: Adam's first step moves a
    # weight by lr * g / (|g| + eps).
    # On this batch both clips take optax's clip branch (norm 41.03).
    lr, eps = 0.0005, 1e-7
    scale = min(1.0, grad_clip / ours["stats"]["grad_gnorm"])
    assert ours["stats"]["grad_gnorm"] > grad_clip
    w0 = _state_dict(theirs["weights0"])
    for k, after in ours["weights"].items():
        g = np.abs(theirs["grads"][k]) * scale
        bound = np.minimum(lr * eps * GRAD_ATOL * scale / (g + eps) ** 2,
                           2 * lr) + 1e-7
        assert (np.abs(after - theirs["weights"][k]) <= bound).all(), k
        np.testing.assert_allclose(np.abs(after - w0[k]).max(), lr,
                                   rtol=1e-2)


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_global_timestep_counts_the_world(jax_side, port_side, codec):
    """Each rank learns on 1/D of the rows, and counts the whole world's,
    as the JAX learner, one program over the mesh, counts the batch."""
    want = jax_side[(40.0, "fp32")]["global_timestep"]
    assert want == FRAGMENTS * T
    for rank in port_side:
        assert rank[(40.0, codec)]["global_timestep"] == want


@pytest.mark.parametrize("grad_clip", [40.0, 0.01])
def test_q8_stats_equal_fp32_arm(port_side, grad_clip):
    """The stats do not depend on the codec (total_loss included, unlike
    the JAX q8 path's 1/D): only grad_gnorm, taken after the exchange,
    does."""
    q8 = _same_on_every_rank(port_side, (grad_clip, "q8"))["stats"]
    fp = port_side[0][(grad_clip, "fp32")]["stats"]
    assert set(q8) == set(fp)
    for k in fp:
        if k != "grad_gnorm":
            assert q8[k] == fp[k], k
    np.testing.assert_allclose(q8["grad_gnorm"], fp["grad_gnorm"],
                               rtol=1e-2)


def _block_bound(port_side):
    """Per packed element: Σ over senders of the sender's block amax/254,
    from each rank's packed local gradient (v = g: the residual starts
    at zero)."""
    amax = [np.abs(r[(40.0, "q8")]["local_packed"].reshape(-1, Q8B)).max(
        axis=1) for r in port_side]
    return np.repeat(np.sum(amax, axis=0) / 254.0, Q8B)


def test_q8_gradient_within_block_bound_of_jax_fp32(jax_side, port_side):
    ours = _packed(port_side[0][(40.0, "q8")]["grads"])
    fp32 = _packed(jax_side[(40.0, "fp32")]["grads"])
    diff = np.abs(ours - fp32)
    assert (diff <= _block_bound(port_side) + GRAD_ATOL).all(), diff.max()


def test_q8_gradient_is_d_times_jax_q8(jax_side, port_side):
    """The port's psum equals D x JAX's pmean (x4 is exact) up to what
    the senders' local gradients, which differ by less than GRAD_ATOL,
    can move: each sender's block amax, so its scale by GRAD_ATOL / 127
    (plus the jitted JAX scale's ulp, see test_torch_collectives.py),
    so each term by |q| times that; and D ulps of the summed terms'
    magnitude for the order of the sum. Beyond that, only codes a
    local-gradient difference moved across a rounding boundary: those
    elements are counted, and each differs by at most one code step of
    every sender more."""
    ranks = [r[(40.0, "q8")] for r in port_side]
    ours = _packed(ranks[0]["grads"])
    theirs = np.float32(D) * _packed(jax_side[(40.0, "q8")]["grads"])
    bound = D * np.finfo(np.float32).tiny
    terms, step = 0.0, 0.0
    for r in ranks:
        q, s = serialization.q8_quantize(r["local_packed"])
        scale = np.repeat(s, Q8B)
        terms = terms + np.abs(serialization.q8_dequantize(q, s))
        bound = bound + np.abs(q.astype(np.float32)) * (
            GRAD_ATOL / 127 + np.spacing(scale))
        step = step + scale
    bound = bound + D * np.spacing(terms.astype(np.float32))
    diff = np.abs(ours - theirs)
    moved = diff > bound
    assert moved.sum() <= MAX_MOVED_CODES, moved.sum()
    assert (diff[moved] <= (bound + step)[moved]).all()


def test_q8_residual_is_v_minus_dequant(port_side):
    for r in port_side:
        arm = r[(40.0, "q8")]
        v = arm["local_packed"]
        q, s = serialization.q8_quantize(v)
        np.testing.assert_array_equal(
            arm["residual"], v - serialization.q8_dequantize(q, s))
        assert np.abs(arm["residual"]).max() > 0
        assert arm["ef_round_trip"]


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_payload_bytes_match_jax(jax_side, port_side, codec):
    arm = port_side[0][(40.0, codec)]
    assert arm["payload"] == jax_side[(40.0, codec)]["payload"]
    # One update accounted: the analytic and the real wire bytes.
    assert arm["counters"]["allreduce_bytes"] == arm["payload"]
    assert arm["counters"]["allreduce_wire_bytes"] == arm["wire_bytes"]
    assert arm["counters"]["allreduce_ms"] > 0
    if codec == "q8":
        fp32 = port_side[0][(40.0, "fp32")]["payload"]
        assert (arm["payload"], fp32) == (1_694_335, 6_750_876)
        assert arm["wire_bytes"] == 1654 * (Q8B + 4)


# ---------------------------------------------------------------------
# the trainer on a 2-rank world
# ---------------------------------------------------------------------
TRAINER_ITERS = 8
REFUSALS = [
    {"num_gpus_for_learner": 2, "train_batch_size": 60},
    {"num_tpus_for_learner": 4},
    {"num_gpus_for_learner": 2, "anakin": True},
    {"num_gpus_for_learner": 2, "num_inline_actors": 1},
    {"num_gpus_for_learner": 3},
    {"num_gpus_for_learner": 2, "collective_backend": "nccl"},
]


@pytest.fixture(scope="module")
def trainer_world():
    return launch(torch_dp_ranks.trainer_rank, 2, "gloo", 2,
                  TRAINER_ITERS, REFUSALS, timeout=600)


@pytest.mark.parametrize("codec", ["q8", "fp32"])
def test_trainer_ranks_stay_equal(trainer_world, codec):
    """Rank 0's parameters at setup, equal on both ranks after every
    iteration; each rank holds its half of the envs; the results count
    the whole world."""
    a, b = trainer_world[0][codec], trainer_world[1][codec]
    assert a["codec"] == b["codec"] == codec
    assert a["digests"] == b["digests"]
    assert len(set(a["digests"])) == TRAINER_ITERS + 1  # they do move
    assert (a["num_envs"], a["first_env"]) == (1, 0)
    assert (b["num_envs"], b["first_env"]) == (1, 1)
    for i, (ra, rb) in enumerate(zip(a["results"], b["results"])):
        assert ra["timesteps_total"] == 80 * (i + 1)
        assert ra["num_steps_trained"] == 80 * (i + 1)
        assert ra["learner"] == rb["learner"]
        assert ra["episodes_this_iter"] == rb["episodes_this_iter"]
        if np.isfinite(ra["episode_reward_mean"]):
            assert ra["episode_reward_mean"] == rb["episode_reward_mean"]


def test_trainer_q8_accounts_fewer_bytes_and_learns(trainer_world):
    """JAX's criteria (`test_collectives.py:391-404`): >= 3.5x fewer
    accounted exchange bytes, best_q8 >= 0.5 * best_fp32 - 10."""
    q8, fp = trainer_world[0]["q8"], trainer_world[0]["fp32"]
    assert fp["counters"]["allreduce_bytes"] \
        / q8["counters"]["allreduce_bytes"] >= 3.5
    assert q8["counters"]["allreduce_wire_bytes"] \
        > q8["counters"]["allreduce_bytes"]  # padding travels too
    best = {}
    for name, arm in (("q8", q8), ("fp32", fp)):
        rewards = [r["episode_reward_mean"] for r in arm["results"]
                   if np.isfinite(r["episode_reward_mean"])]
        assert rewards
        best[name] = max(rewards)
    assert best["q8"] >= 0.5 * best["fp32"] - 10, best


def test_ranks_draw_different_actions_from_equal_weights(trainer_world):
    """The rank is part of the sampling generator's seed only."""
    a, b = trainer_world[0]["q8"], trainer_world[1]["q8"]
    assert a["digests"][0] == b["digests"][0]
    assert not np.array_equal(a["actions"], b["actions"])


def test_world_config_refusals(trainer_world):
    errors = trainer_world[0]["refusals"]
    assert errors == trainer_world[1]["refusals"]
    want = [("ValueError", "whole 20-step fragments"),
            ("ValueError", "num_gpus_for_learner"),
            ("NotImplementedError", "ROADMAP"),
            ("NotImplementedError", "Sebulba"),
            ("ValueError", "has 2 rank"),
            ("ValueError", "initialized with 'gloo'")]
    for got, (kind, text) in zip(errors, want):
        assert got is not None and got[0] == kind and text in got[1], got


def test_world_of_many_needs_an_initialized_world():
    with pytest.raises(RuntimeError, match="torch.distributed world"):
        IMPALATrainer(config=dict(torch_dp_ranks.CARTPOLE,
                                  num_gpus_for_learner=2))
