"""The port's hand-written CUDA kernels against their plain versions.

Tests marked `gpu` need a CUDA device and skip without one (the fixture
decides, never the import). Run them on a card with
`python -m pytest tests/test_torch_kernels.py -m gpu`. This file imports
torch and numpy only, so it also runs where JAX is not installed; the
plain versions are held against JAX in test_torch_vtrace.py and
test_torch_distributions.py. The rest checks the build plumbing, which
runs anywhere.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import cuda_build
from ray_tpu_torch.models import catalog, convert, distributions, eps_greedy
from ray_tpu_torch.models.convert import flax_pack_plan
from ray_tpu_torch.parallel import collectives, q8_check
from ray_tpu_torch.rllib.agents.impala import vtrace
from ray_tpu_torch.rllib.env import device_env, device_env_check
from ray_tpu_torch.rllib.evaluation import device_sampler

# The kernels run the plain versions' f32 arithmetic in another order
# (fused multiply-adds, a warp-shuffle sum): 1e-5.
TOL = 1e-5


@pytest.fixture
def cuda():
    """The card, with TF32 off (f32 comparisons), restored afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _vtrace_inputs(T, B, device, seed=0):
    rng = np.random.default_rng(seed)
    arrays = dict(
        log_rhos=rng.uniform(-1.5, 1.5, (T, B)),
        discounts=0.99 * (rng.random((T, B)) > 0.1),
        rewards=rng.standard_normal((T, B)),
        values=rng.standard_normal((T, B)),
        bootstrap_value=rng.standard_normal(B))
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in arrays.items()}


@pytest.mark.gpu
# (16, 4096) and (20, 32): the Anakin paths' shapes (SyntheticAtari and
# CartPole).
@pytest.mark.parametrize("T,B", [(50, 32), (7, 5), (200, 1024), (16, 4096),
                                 (20, 32)])
@pytest.mark.parametrize("clips", [(1.0, 1.0, 1.0), (None, None, 0.9)])
def test_vtrace_kernel_matches_plain(cuda, T, B, clips):
    clip_rho, clip_pg_rho, lambda_ = clips
    inputs = _vtrace_inputs(T, B, cuda, seed=T + B)
    kw = dict(clip_rho_threshold=clip_rho,
              clip_pg_rho_threshold=clip_pg_rho, lambda_=lambda_)
    before = vtrace.VTRACE_KERNEL.launches
    got = vtrace.from_importance_weights(**inputs, **kw)
    torch.cuda.synchronize()
    assert vtrace.VTRACE_KERNEL.launches == before + 1
    want = vtrace._from_importance_weights_plain(**inputs, **kw)
    torch.testing.assert_close(got.vs, want.vs, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got.pg_advantages, want.pg_advantages,
                               rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_vtrace_kernel_rejects_what_it_cannot_take(cuda):
    inputs = _vtrace_inputs(6, 4, cuda)
    args = (1.0, 1.0, 1.0)
    bad = dict(inputs, rewards=inputs["rewards"].double())
    with pytest.raises(ValueError, match="float32"):
        vtrace._from_importance_weights_cuda(*bad.values(), *args)
    bad = dict(inputs, values=torch.empty(6, 5, device=cuda))
    with pytest.raises(ValueError, match=r"values is \(6, 5\)"):
        vtrace._from_importance_weights_cuda(*bad.values(), *args)
    bad = dict(inputs, rewards=torch.empty(6, 8, device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="rewards has strides"):
        vtrace._from_importance_weights_cuda(*bad.values(), *args)
    bad = dict(inputs, bootstrap_value=inputs["bootstrap_value"][:3])
    with pytest.raises(ValueError, match="bootstrap_value"):
        vtrace._from_importance_weights_cuda(*bad.values(), *args)
    bad = dict(inputs, discounts=inputs["discounts"].cpu())
    with pytest.raises(ValueError, match="discounts is on"):
        vtrace._from_importance_weights_cuda(*bad.values(), *args)


def _vtrace_views(T, B, device, layout, seed=0):
    """K1's inputs in one layout: "time_major" (contiguous [T, B]),
    "batch_major" (the learner's [B * T] columns seen through
    `_time_major`: strides (1, T); log_rhos stays [T, B] contiguous, as
    `from_logits` makes it) or "offset" (the same views, each starting 1
    to 3 floats past a 16-byte boundary, the bootstrap every other
    element of a [2B] tensor)."""
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import _time_major
    dense = _vtrace_inputs(T, B, device, seed=seed)
    if layout == "time_major":
        return dense
    views = {}
    for shift, k in enumerate(("discounts", "rewards", "values")):
        flat = dense[k].t().contiguous().reshape(-1)
        if layout == "offset":
            room = torch.zeros(T * B + 4, device=device)
            room[shift + 1:shift + 1 + T * B] = flat
            flat = room[shift + 1:shift + 1 + T * B]
        views[k] = _time_major(flat, T)
    if layout == "offset":
        room = torch.zeros(T * B + 4, device=device)
        room[3:3 + T * B] = dense["log_rhos"].reshape(-1)
        views["log_rhos"] = room[3:3 + T * B].view(T, B)
        boot = torch.zeros(2 * B, device=device)
        boot[::2] = dense["bootstrap_value"]
        views["bootstrap_value"] = boot[::2]
    return dict(dense, **views)


def _device_ops(fn, reps=20):
    """CUDA kernels and copies that one call of `fn` enqueues
    (torch.profiler, after a warm-up call), to the nearest whole number:
    for backward calls, which run on autograd's device thread, the
    profiler has recorded 19 kernels in 20 calls on an H100."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))
              and e.self_device_time_total > 0]
    return round(sum(e.count for e in events) / reps)


# The learner's 50 x 32, Anakin's 16 x 4096, CartPole Anakin's 20 x 32,
# the long 500 x 4096 (double-buffered chunks) and a ragged B of 37.
VTRACE_LAYOUT_SHAPES = [(50, 32), (16, 4096), (20, 32), (500, 4096),
                        (50, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,B", VTRACE_LAYOUT_SHAPES)
@pytest.mark.parametrize("layout", ["time_major", "batch_major", "offset"])
def test_vtrace_kernel_reads_strided_views_in_place(cuda, T, B, layout):
    """K1 on each layout against the plain version on dense copies
    (1e-5 + 1e-5 |plain|), one launch, the inputs untouched."""
    inputs = _vtrace_views(T, B, cuda, layout, seed=T + B)
    saved = {k: v.clone() for k, v in inputs.items()}
    before = vtrace.VTRACE_KERNEL.launches
    got = vtrace.from_importance_weights(**inputs)
    torch.cuda.synchronize()
    assert vtrace.VTRACE_KERNEL.launches == before + 1
    want = vtrace._from_importance_weights_plain(
        *(v.contiguous() for v in inputs.values()), 1.0, 1.0, 1.0)
    assert got.vs.is_contiguous() and got.pg_advantages.is_contiguous()
    torch.testing.assert_close(got.vs, want.vs, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got.pg_advantages, want.pg_advantages,
                               rtol=TOL, atol=TOL)
    for k, v in inputs.items():
        assert torch.equal(v, saved[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("T,B", [(50, 32), (16, 4096)])
def test_vtrace_kernel_enqueues_one_device_operation(cuda, T, B):
    """From the learner's batch-major views to vs and pg on the card: K1
    alone, no transposing copy before it."""
    inputs = _vtrace_views(T, B, cuda, "batch_major")
    assert _device_ops(lambda: vtrace.from_importance_weights(**inputs)) \
        == 1


@pytest.mark.gpu
# (4096, 6) and (32, 2): the Anakin paths' shapes; (16, 6): PPO Atari's.
@pytest.mark.parametrize("B,A", [(32, 6), (1024, 18), (5, 100), (3, 1),
                                 (4096, 6), (32, 2), (16, 6)])
@pytest.mark.parametrize("explore", [True, False])
def test_categorical_kernel_matches_plain(cuda, B, A, explore):
    gen = torch.Generator(device=cuda).manual_seed(B * A)
    logits = torch.randn(B, A, generator=gen, device=cuda) * 3.0
    u = torch.rand(B, A, generator=gen, device=cuda) if explore else None
    before = distributions.CATEGORICAL_KERNEL.launches
    actions, logp = distributions.sample_logp(logits, u, explore)
    torch.cuda.synchronize()
    assert distributions.CATEGORICAL_KERNEL.launches == before + 1
    want_actions, want_logp = distributions._sample_logp_plain(
        logits, u, explore)
    assert actions.dtype == torch.int64 and logp.dtype == torch.float32
    assert torch.equal(actions, want_actions)
    torch.testing.assert_close(logp, want_logp, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_categorical_kernel_takes_the_first_maximum(cuda):
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]],
                          device=cuda)
    actions, _ = distributions.sample_logp(logits, None, explore=False)
    assert actions.tolist() == [1, 0]
    u = torch.full_like(logits, 0.5)  # equal noise keeps the tie
    actions, _ = distributions.sample_logp(logits, u, explore=True)
    assert actions.tolist() == [1, 0]


@pytest.mark.gpu
def test_categorical_kernel_rejects_what_it_cannot_take(cuda):
    logits = torch.zeros(4, 6, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        distributions._sample_logp_cuda(logits.half(), None, False)
    with pytest.raises(ValueError, match="uniforms"):
        distributions._sample_logp_cuda(logits, torch.rand(4, 5,
                                                           device=cuda), True)
    with pytest.raises(ValueError, match="contiguous"):
        distributions._sample_logp_cuda(torch.zeros(6, 4, device=cuda).t(),
                                        None, False)


@pytest.mark.gpu
def test_policy_on_the_card_launches_both_kernels(cuda):
    """One env step launches K2 once; one update launches K1 once; the
    update's loss and stats agree with the same update on the CPU."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import \
        VTraceTorchPolicy
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    T, n = 5, 20
    cfg = {"model": {"compute_dtype": "f32"}, "rollout_fragment_length": T,
           "seed": 0}
    space = Box(0, 255, (84, 84, 4), np.uint8)
    card = VTraceTorchPolicy(space, Discrete(6), dict(cfg, device="cuda"))
    host = VTraceTorchPolicy(space, Discrete(6), dict(cfg, device="cpu"))
    host.set_weights(card.get_weights())
    rng = np.random.default_rng(0)
    obs = rng.integers(0, 256, (n, 84, 84, 4), dtype=np.uint8)
    k2 = distributions.CATEGORICAL_KERNEL.launches
    actions, _, extra = card.compute_actions(obs)
    assert distributions.CATEGORICAL_KERNEL.launches == k2 + 1
    assert actions.shape == (n,) and extra[sb.ACTION_LOGP].shape == (n,)
    batch = SampleBatch({
        sb.OBS: obs, sb.NEW_OBS: obs[::-1].copy(),
        sb.ACTIONS: actions, sb.REWARDS: rng.standard_normal(n).astype(
            np.float32),
        sb.DONES: rng.random(n) < 0.2,
        sb.ACTION_DIST_INPUTS: extra[sb.ACTION_DIST_INPUTS]})
    k1 = vtrace.VTRACE_KERNEL.launches
    got = card.learn_on_batch(batch)
    assert vtrace.VTRACE_KERNEL.launches == k1 + 1
    want = host.learn_on_batch(batch)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert next(card.model.parameters()).device.type == "cuda"


# K2 with the step record: the local-mode sampler's 32 x 6, PPO Atari's
# 16 x 6, a wide action set and a single action.
STEP_RECORD_SHAPES = [(32, 6), (16, 6), (1024, 18), (3, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,A", STEP_RECORD_SHAPES)
@pytest.mark.parametrize("explore", [True, False])
def test_categorical_step_record_equals_device_outputs(cuda, B, A, explore):
    """K2 with a pinned step record: the device outputs equal the plain
    version's (actions exactly, logp within TOL); after the record's
    event, its actions and logp equal the device outputs and its logits
    and value columns the device tensors, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(B * A + 5)
    logits = torch.randn(B, A, generator=gen, device=cuda) * 3.0
    value = torch.randn(B, generator=gen, device=cuda)
    u = torch.rand(B, A, generator=gen, device=cuda) if explore else None
    record = distributions.StepRecord(B, A, pin=True)
    record.buffer.fill_(0xff)
    before = distributions.CATEGORICAL_KERNEL.launches
    actions, logp = distributions.sample_logp(logits, u, explore,
                                              value=value, record=record)
    record.record_done(cuda)
    assert distributions.CATEGORICAL_KERNEL.launches == before + 1
    got_actions, got_logp, got_value, got_logits = record.columns()
    want_actions, want_logp = distributions._sample_logp_plain(
        logits, u, explore)
    assert torch.equal(actions, want_actions)
    torch.testing.assert_close(logp, want_logp, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_actions, actions.cpu().numpy())
    assert got_logp.tobytes() == logp.cpu().numpy().tobytes()
    assert got_value.tobytes() == value.cpu().numpy().tobytes()
    assert got_logits.tobytes() == logits.cpu().numpy().tobytes()


@pytest.mark.gpu
def test_categorical_step_record_reused_over_many_steps(cuda):
    """The policy's pattern: one record, many steps in a row on one
    stream, each step's columns copied out after its event and then
    overwritten by the next step."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    record = distributions.StepRecord(32, 6, pin=True)
    for step in range(64):
        logits = torch.randn(32, 6, generator=gen, device=cuda) * 3.0
        value = torch.randn(32, generator=gen, device=cuda)
        u = torch.rand(32, 6, generator=gen, device=cuda)
        actions, logp = distributions.sample_logp(
            logits, u, step % 2 == 0, value=value, record=record)
        record.record_done(cuda)
        got = record.columns()
        want = (actions, logp, value, logits)
        for g, w in zip(got, want):
            assert g.tobytes() == w.cpu().numpy().tobytes(), step


@pytest.mark.gpu
def test_categorical_step_record_rejects_a_pageable_record(cuda):
    """A record the card cannot map (pageable memory) fails the call
    before any launch; the runtime's error does not leak into the next
    launch; a record of another shape, or a value without a record,
    raises ValueError."""
    logits = torch.randn(32, 6, device=cuda)
    value = torch.randn(32, device=cuda)
    u = torch.rand(32, 6, device=cuda)
    before = distributions.CATEGORICAL_KERNEL.launches
    with pytest.raises(RuntimeError, match="categorical"):
        distributions.sample_logp(
            logits, u, True, value=value,
            record=distributions.StepRecord(32, 6, pin=False))
    assert distributions.CATEGORICAL_KERNEL.launches == before
    with pytest.raises(ValueError, match="StepRecord"):
        distributions.sample_logp(
            logits, u, True, record=distributions.StepRecord(32, 5,
                                                             pin=True))
    with pytest.raises(ValueError, match="value"):
        distributions._sample_logp_cuda(logits, u, True, value)
    with pytest.raises(ValueError, match="value"):
        distributions._sample_logp_cuda(
            logits, u, True, value[:16],
            distributions.StepRecord(32, 6, pin=True))
    a, _ = distributions.sample_logp(logits, u, True)
    torch.cuda.synchronize()
    assert torch.equal(a, distributions._sample_logp_plain(logits, u,
                                                           True)[0])


@pytest.mark.gpu
def test_policy_step_record_on_the_card_matches_the_cpu(cuda):
    """`compute_actions` of a Categorical policy on the card (f32 model,
    argmax actions) returns the CPU policy's columns, with the same
    dtypes and shapes, step after step, launching K2 once per step."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import \
        VTraceTorchPolicy
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete
    cfg = {"model": {"fcnet_hiddens": [64]}, "seed": 0}
    space = Box(-1.0, 1.0, (8,))
    card = VTraceTorchPolicy(space, Discrete(6), dict(cfg, device="cuda"))
    host = VTraceTorchPolicy(space, Discrete(6), dict(cfg, device="cpu"))
    host.set_weights(card.get_weights())
    rng = np.random.default_rng(0)
    k2 = distributions.CATEGORICAL_KERNEL.launches
    for step in range(20):
        obs = rng.uniform(-1.0, 1.0, (32, 8)).astype(np.float32)
        got = card.compute_actions(obs, explore=False)
        want = host.compute_actions(obs, explore=False)
        assert got[0].dtype == want[0].dtype == np.int64
        np.testing.assert_array_equal(got[0], want[0])
        for k in (sb.ACTION_LOGP, sb.ACTION_DIST_INPUTS, sb.VF_PREDS):
            assert got[2][k].dtype == want[2][k].dtype == np.float32, k
            assert got[2][k].shape == want[2][k].shape, k
            np.testing.assert_allclose(got[2][k], want[2][k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert distributions.CATEGORICAL_KERNEL.launches == k2 + 20


# K7 tolerance, stated by the kernel's contract: 1e-6 absolute + 1e-6
# relative on actions and logp (exp may differ from PyTorch's by an ulp;
# every other step is the plain version's, in its order).
GAUSSIAN_TOL = 1e-6


@pytest.mark.gpu
# (8, 1): Pendulum's 8 envs; (4096, 17): a MuJoCo-sized box; (5, 40): d
# over a warp's 32 lanes; (3, 2): Pendulum-like at a ragged B.
@pytest.mark.parametrize("B,d", [(8, 1), (4096, 17), (5, 40), (3, 2)])
@pytest.mark.parametrize("explore", [True, False])
def test_diag_gaussian_kernel_matches_plain(cuda, B, d, explore):
    gen = torch.Generator(device=cuda).manual_seed(B * d)
    mean = torch.randn(B, d, generator=gen, device=cuda) * 2.0
    log_std = torch.rand(B, d, generator=gen, device=cuda) * 3.0 - 2.0
    inputs = torch.cat([mean, log_std], dim=1).contiguous()
    z = torch.randn(B, d, generator=gen, device=cuda) if explore else None
    before = distributions.DIAG_GAUSSIAN_KERNEL.launches
    actions, logp = distributions.gaussian_sample_logp(inputs, z, explore)
    torch.cuda.synchronize()
    assert distributions.DIAG_GAUSSIAN_KERNEL.launches == before + 1
    want_actions, want_logp = distributions._gaussian_sample_logp_plain(
        inputs, z, explore)
    assert actions.dtype == torch.float32 and actions.shape == (B, d)
    torch.testing.assert_close(actions, want_actions, rtol=GAUSSIAN_TOL,
                               atol=GAUSSIAN_TOL)
    torch.testing.assert_close(logp, want_logp, rtol=GAUSSIAN_TOL,
                               atol=GAUSSIAN_TOL)
    if not explore:
        assert torch.equal(actions, mean)


@pytest.mark.gpu
def test_diag_gaussian_kernel_rejects_what_it_cannot_take(cuda):
    inputs = torch.zeros(4, 6, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        distributions._gaussian_sample_logp_cuda(inputs.half(), None, False)
    with pytest.raises(ValueError, match="2d"):
        distributions._gaussian_sample_logp_cuda(
            torch.zeros(4, 5, device=cuda), None, False)
    with pytest.raises(ValueError, match="normals"):
        distributions._gaussian_sample_logp_cuda(
            inputs, torch.zeros(4, 2, device=cuda), True)
    with pytest.raises(ValueError, match="contiguous"):
        distributions._gaussian_sample_logp_cuda(
            torch.zeros(6, 4, device=cuda).t(), None, False)


@pytest.mark.gpu
def test_ppo_policy_on_the_card_launches_k7_and_matches_the_cpu(cuda):
    """One Pendulum env step launches K7 once; one sgd_learn on the card
    (f32, TF32 off) equals the same phase on the CPU from the same
    weights, batch and permutations (1e-4 on the stats)."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.ppo import PPOTorchPolicy
    from ray_tpu_torch.rllib.env.spaces import Box
    from ray_tpu_torch.rllib.policy import torch_policy
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    cfg = {"model": {"fcnet_hiddens": [64, 64], "free_log_std": True},
           "seed": 0, "lr": 1e-3}
    obs_space, act_space = Box(-8.0, 8.0, (3,)), Box(-2.0, 2.0, (1,))
    card = PPOTorchPolicy(obs_space, act_space, dict(cfg, device="cuda"))
    host = PPOTorchPolicy(obs_space, act_space, dict(cfg, device="cpu"))
    host.set_weights(card.get_weights())
    n = 256
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((n, 3)).astype(np.float32)
    k7 = distributions.DIAG_GAUSSIAN_KERNEL.launches
    actions, _, extra = card.compute_actions(obs)
    assert distributions.DIAG_GAUSSIAN_KERNEL.launches == k7 + 1
    assert actions.shape == (n, 1) and actions.dtype == np.float32
    batch = {sb.OBS: obs, sb.ACTIONS: actions, **extra,
             sb.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
             sb.VALUE_TARGETS: rng.standard_normal(n).astype(np.float32)}
    perms = [torch.from_numpy(rng.permutation(n)) for _ in range(4)]
    out = {}
    for name, policy in (("cuda", card), ("cpu", host)):
        queue = list(perms)
        real = torch_policy.epoch_permutation
        torch_policy.epoch_permutation = \
            lambda g, m, device: queue.pop(0).to(device)
        try:
            out[name] = policy.sgd_learn(SampleBatch(batch), 4, 64)
        finally:
            torch_policy.epoch_permutation = real
    for k, v in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _gaussian_inputs(B, d, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    mean = torch.randn(B, d, generator=gen, device=device) * 2.0
    log_std = torch.rand(B, d, generator=gen, device=device) * 3.0 - 2.0
    inputs = torch.cat([mean, log_std], dim=1).contiguous()
    value = torch.randn(B, generator=gen, device=device)
    z = torch.randn(B, d, generator=gen, device=device)
    return inputs, value, z


# K7 with the step record: PPO Pendulum's 8 x 1, a 6-dim box at 256
# envs, and a MuJoCo-sized 17-dim box at 4096.
BOX_RECORD_SHAPES = [(8, 1), (256, 6), (4096, 17)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,d", BOX_RECORD_SHAPES)
@pytest.mark.parametrize("explore", [True, False])
def test_diag_gaussian_step_record_equals_device_outputs(cuda, B, d,
                                                         explore):
    """K7 with a pinned step record and no device outputs (null
    pointers): after the record's event its actions and logp equal the
    device outputs of a call without a record, and its inputs and value
    the device tensors, bit for bit; the device outputs are within
    GAUSSIAN_TOL of the plain version."""
    inputs, value, z = _gaussian_inputs(B, d, cuda, seed=B * d + 7)
    z = z if explore else None
    record = distributions.StepRecord(B, 2 * d, pin=True, action_dim=d)
    record.buffer.fill_(0xff)
    before = distributions.DIAG_GAUSSIAN_KERNEL.launches
    actions, logp = distributions.gaussian_sample_logp(inputs, z, explore)
    assert distributions.gaussian_sample_logp(
        inputs, z, explore, value=value, record=record) is None
    record.record_done(cuda)
    got = record.columns()
    want_actions, want_logp = distributions._gaussian_sample_logp_plain(
        inputs, z, explore)
    torch.testing.assert_close(actions, want_actions, rtol=GAUSSIAN_TOL,
                               atol=GAUSSIAN_TOL)
    torch.testing.assert_close(logp, want_logp, rtol=GAUSSIAN_TOL,
                               atol=GAUSSIAN_TOL)
    for g, w in zip(got, (actions, logp, value, inputs)):
        assert g.dtype == np.float32 and g.shape == tuple(w.shape)
        assert g.tobytes() == w.cpu().numpy().tobytes()
    assert distributions.DIAG_GAUSSIAN_KERNEL.launches == before + 2


@pytest.mark.gpu
def test_diag_gaussian_step_record_reused_over_many_steps(cuda):
    """The policy's pattern: one record, many steps in a row on one
    stream with no device outputs, each step's columns copied out after
    its event and held against the same step with device outputs."""
    record = distributions.StepRecord(8, 2, pin=True, action_dim=1)
    for step in range(64):
        inputs, value, z = _gaussian_inputs(8, 1, cuda, seed=step)
        explore = step % 2 == 0
        zz = z if explore else None
        distributions.gaussian_sample_logp(inputs, zz, explore, value=value,
                                           record=record)
        record.record_done(cuda)
        got = record.columns()
        actions, logp = distributions.gaussian_sample_logp(inputs, zz,
                                                           explore)
        for g, w in zip(got, (actions, logp, value, inputs)):
            assert g.tobytes() == w.cpu().numpy().tobytes(), step


@pytest.mark.gpu
def test_diag_gaussian_rejects_a_pageable_record(cuda):
    """A record the card cannot map fails before any launch and its
    runtime error does not leak into the next launch; a record of
    another kind or width, or a value without a record, raises
    ValueError."""
    inputs, value, z = _gaussian_inputs(8, 1, cuda, seed=1)
    before = distributions.DIAG_GAUSSIAN_KERNEL.launches
    with pytest.raises(RuntimeError, match="diag_gaussian"):
        distributions.gaussian_sample_logp(
            inputs, z, True, value=value, record=distributions.StepRecord(
                8, 2, pin=False, action_dim=1))
    assert distributions.DIAG_GAUSSIAN_KERNEL.launches == before
    with pytest.raises(ValueError, match="StepRecord"):
        distributions.gaussian_sample_logp(
            inputs, z, True, record=distributions.StepRecord(8, 2,
                                                             pin=True))
    with pytest.raises(ValueError, match="StepRecord"):
        distributions.gaussian_sample_logp(
            inputs, z, True, record=distributions.StepRecord(
                8, 4, pin=True, action_dim=2))
    with pytest.raises(ValueError, match="value"):
        distributions._gaussian_sample_logp_cuda(inputs, z, True, value)
    a, _ = distributions.gaussian_sample_logp(inputs, z, True)
    torch.testing.assert_close(
        a, distributions._gaussian_sample_logp_plain(inputs, z, True)[0],
        rtol=GAUSSIAN_TOL, atol=GAUSSIAN_TOL)


@pytest.mark.gpu
def test_box_policy_step_record_on_the_card_matches_the_cpu(cuda):
    """`compute_actions` of a Box PPO policy on the card (f32 model, mean
    actions) returns the CPU policy's four columns, with the same dtypes
    and shapes, step after step, launching K7 once per step; exploring,
    the card's actions are finite and its logp is the CPU's formula at
    them."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.ppo import PPOTorchPolicy
    from ray_tpu_torch.rllib.env.spaces import Box
    cfg = {"model": {"fcnet_hiddens": [64, 64], "free_log_std": True},
           "seed": 0}
    obs_space, act_space = Box(-8.0, 8.0, (3,)), Box(-2.0, 2.0, (2,))
    card = PPOTorchPolicy(obs_space, act_space, dict(cfg, device="cuda"))
    host = PPOTorchPolicy(obs_space, act_space, dict(cfg, device="cpu"))
    host.set_weights(card.get_weights())
    rng = np.random.default_rng(0)
    k7 = distributions.DIAG_GAUSSIAN_KERNEL.launches
    for step in range(20):
        obs = rng.standard_normal((8, 3)).astype(np.float32)
        got = card.compute_actions(obs, explore=False)
        want = host.compute_actions(obs, explore=False)
        assert got[0].dtype == want[0].dtype == np.float32
        assert got[0].shape == want[0].shape == (8, 2)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        for k in (sb.ACTION_LOGP, sb.ACTION_DIST_INPUTS, sb.VF_PREDS):
            assert got[2][k].dtype == want[2][k].dtype == np.float32, k
            assert got[2][k].shape == want[2][k].shape, k
            np.testing.assert_allclose(got[2][k], want[2][k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    actions, _, extra = card.compute_actions(obs)
    assert np.isfinite(actions).all()
    want_logp = distributions.DiagGaussian(torch.from_numpy(
        extra[sb.ACTION_DIST_INPUTS])).logp(torch.from_numpy(actions))
    np.testing.assert_allclose(extra[sb.ACTION_LOGP], want_logp.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert distributions.DIAG_GAUSSIAN_KERNEL.launches == k7 + 21


def _q_values(B, A, device, seed):
    """Q-values with, from B=4 on, a row of ties, a row holding a NaN,
    an all-NaN row and a row tied at its maximum."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, A, generator=gen, device=device)
    if B >= 4:
        q[0] = 0.5
        q[1, A // 2] = float("nan")
        q[2] = float("nan")
        q[3, 0] = q[3, A - 1] = 9.0
    u = torch.rand(B, 2, generator=gen, device=device)
    return q, u


@pytest.mark.gpu
# (1, 6): the DQN Atari path's (one env, 6 actions); (1, 2): the DQN
# CartPole path's; (32, 18), (4096, 18): the full Atari action set;
# (5, 40): A over a warp's 32 lanes; (3, 1): one action.
@pytest.mark.parametrize("B,A", [(1, 6), (1, 2), (32, 18), (4096, 18),
                                 (5, 40), (3, 1)])
@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
def test_eps_greedy_kernel_matches_plain(cuda, B, A, eps):
    """K8 and its plain version agree exactly on the same uniforms."""
    q, u = _q_values(B, A, cuda, seed=B * A)
    before = eps_greedy.EPS_GREEDY_KERNEL.launches
    got = eps_greedy.eps_greedy(q, u, eps)
    torch.cuda.synchronize()
    assert eps_greedy.EPS_GREEDY_KERNEL.launches == before + 1
    want = eps_greedy._eps_greedy_plain(q, u, eps)
    assert got.dtype == torch.int64 and got.shape == (B,)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_eps_greedy_kernel_takes_the_first_maximum_and_nan(cuda):
    nan, inf = float("nan"), float("inf")
    q = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                      [1.0, nan, 5.0, nan], [nan, nan, nan, nan],
                      [-inf, -inf, -inf, -inf], [1.0, inf, 2.0, inf]],
                     device=cuda)
    u = torch.full((6, 2), 0.5, device=cuda)
    assert eps_greedy.eps_greedy(q, u, 0.0).tolist() == [1, 0, 1, 0, 0, 1]
    top = float(np.nextafter(np.float32(1), np.float32(0)))
    u = torch.tensor([[0.0, top]] * 6, device=cuda)
    assert eps_greedy.eps_greedy(q, u, 0.5).tolist() == [3] * 6


@pytest.mark.gpu
def test_eps_greedy_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(4, 6, device=cuda)
    u = torch.zeros(4, 2, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        eps_greedy._eps_greedy_cuda(q.half(), u, 0.1)
    with pytest.raises(ValueError, match="uniforms"):
        eps_greedy._eps_greedy_cuda(q, torch.zeros(4, 3, device=cuda), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        eps_greedy._eps_greedy_cuda(torch.zeros(6, 4, device=cuda).t(), u,
                                    0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("image", [True, False], ids=["frames", "flat"])
def test_dqn_policy_on_the_card_launches_k8_and_matches_the_cpu(cuda,
                                                                 image):
    """One env step of a 16-env batch launches K8 once; one
    learn_with_td on the card (f32 trunk, TF32 off) equals the same
    update on the CPU from the same online and target weights (1e-4 on
    the stats and |td|)."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.dqn import DQNPolicy
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    if image:
        space, shape = Box(0, 255, (84, 84, 4), np.uint8), (84, 84, 4)
    else:
        space, shape = Box(-1.0, 1.0, (4,)), (4,)
    cfg = {"model": {"compute_dtype": "f32", "fcnet_hiddens": [64]},
           "hiddens": [64], "n_step": 3, "seed": 0}
    card = DQNPolicy(space, Discrete(6), dict(cfg, device="cuda"))
    host = DQNPolicy(space, Discrete(6), dict(cfg, device="cpu"))
    weights = card.get_weights()
    rng = np.random.default_rng(0)
    weights["target"] = {k: v + 0.01 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in weights["target"].items()}
    card.set_weights(weights)
    host.set_weights(weights)
    n = 32

    def frames(*lead):
        if image:
            return rng.integers(0, 256, lead + shape, dtype=np.uint8)
        return rng.standard_normal(lead + shape).astype(np.float32)

    card.set_epsilon(0.3)
    k8 = eps_greedy.EPS_GREEDY_KERNEL.launches
    actions, state, extra = card.compute_actions(frames(16))
    assert eps_greedy.EPS_GREEDY_KERNEL.launches == k8 + 1
    assert actions.shape == (16,) and state == [] and extra == {}
    batch = SampleBatch({
        sb.OBS: frames(n), sb.NEW_OBS: frames(n),
        sb.ACTIONS: rng.integers(0, 6, n),
        sb.REWARDS: rng.standard_normal(n).astype(np.float32),
        sb.DONES: rng.random(n) < 0.2,
        "weights": rng.uniform(0.2, 1.0, n).astype(np.float32)})
    got, got_td = card.learn_with_td(batch)
    want, want_td = host.learn_with_td(batch)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got_td, want_td, rtol=1e-4, atol=1e-4)


# K8 with the host output: the DQN Atari path's 1 x 6, CartPole's 1 x 2,
# and the full Atari action set at 32 and 4096 rows (ties and NaN rows).
HOST_ACTION_SHAPES = [(1, 6), (1, 2), (32, 18), (4096, 18)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,A", HOST_ACTION_SHAPES)
@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
def test_eps_greedy_host_actions_equal_device_actions(cuda, B, A, eps):
    """K8 with a pinned int64 host output and no device output (a null
    pointer): after its event the host actions equal the device actions
    of a call without a host output and the plain version's."""
    q, u = _q_values(B, A, cuda, seed=B * A + 3)
    host = distributions.ActionRecord(B, pin=True, dtype=torch.int64)
    host.buffer.fill_(0xff)
    before = eps_greedy.EPS_GREEDY_KERNEL.launches
    got = eps_greedy.eps_greedy(q, u, eps)
    assert eps_greedy.eps_greedy(q, u, eps, host_actions=host) is None
    host.record_done(cuda)
    want = eps_greedy._eps_greedy_plain(q, u, eps)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(host.columns(), got.cpu().numpy())
    assert eps_greedy.EPS_GREEDY_KERNEL.launches == before + 2


@pytest.mark.gpu
def test_eps_greedy_host_actions_reused_over_many_steps(cuda):
    """The policy's pattern: one host output, many steps in a row on one
    stream with no device output, each step's actions copied out after
    its event and held against the plain version."""
    host = distributions.ActionRecord(1, pin=True, dtype=torch.int64)
    for step in range(64):
        q, u = _q_values(1, 6, cuda, seed=step)
        eps = (0.0, 0.3, 1.0)[step % 3]
        eps_greedy.eps_greedy(q, u, eps, host_actions=host)
        host.record_done(cuda)
        got = host.columns()
        np.testing.assert_array_equal(
            got, eps_greedy._eps_greedy_plain(q, u, eps).cpu().numpy(),
            err_msg=str(step))


@pytest.mark.gpu
def test_eps_greedy_rejects_a_pageable_host_output(cuda):
    """A host output the card cannot map fails before any launch and its
    runtime error does not leak into the next launch; one of another
    dtype or shape raises ValueError."""
    q, u = _q_values(4, 6, cuda, seed=2)
    before = eps_greedy.EPS_GREEDY_KERNEL.launches
    with pytest.raises(RuntimeError, match="eps_greedy"):
        eps_greedy.eps_greedy(q, u, 0.3, host_actions=distributions.
                              ActionRecord(4, pin=False, dtype=torch.int64))
    assert eps_greedy.EPS_GREEDY_KERNEL.launches == before
    with pytest.raises(ValueError, match="ActionRecord"):
        eps_greedy.eps_greedy(q, u, 0.3, host_actions=distributions.
                              ActionRecord(4, pin=True))
    with pytest.raises(ValueError, match="ActionRecord"):
        eps_greedy.eps_greedy(q, u, 0.3, host_actions=distributions.
                              ActionRecord(5, pin=True, dtype=torch.int64))
    got = eps_greedy.eps_greedy(q, u, 0.3)
    assert torch.equal(got, eps_greedy._eps_greedy_plain(q, u, 0.3))


@pytest.mark.gpu
def test_dqn_policy_host_actions_on_the_card_match_the_cpu(cuda):
    """`compute_actions` of a DQN policy on the card (f32 model, greedy
    actions) returns the CPU policy's int64 actions step after step,
    launching K8 once per step."""
    from ray_tpu_torch.rllib.agents.dqn import DQNPolicy
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete
    cfg = {"model": {"fcnet_hiddens": [64]}, "hiddens": [64], "seed": 0}
    space = Box(-1.0, 1.0, (4,))
    card = DQNPolicy(space, Discrete(6), dict(cfg, device="cuda"))
    host = DQNPolicy(space, Discrete(6), dict(cfg, device="cpu"))
    host.set_weights(card.get_weights())
    rng = np.random.default_rng(0)
    k8 = eps_greedy.EPS_GREEDY_KERNEL.launches
    for step in range(20):
        obs = rng.standard_normal((16, 4)).astype(np.float32)
        got, _, extra = card.compute_actions(obs, explore=False)
        want, _, _ = host.compute_actions(obs, explore=False)
        assert got.dtype == want.dtype == np.int64 and extra == {}
        np.testing.assert_array_equal(got, want)
    assert eps_greedy.EPS_GREEDY_KERNEL.launches == k8 + 20


def _squashed_inputs(B, d, device, seed, margin=0.0):
    """K9 inputs: every third row's mean scaled so that |pre| >= 10 (tanh
    saturates), raw log_std over [-25, 5) (beyond both clip bounds),
    with `margin` kept away from the bounds (the backward's mask)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mean = torch.randn(B, d, generator=gen, device=device) * 3.0
    mean[::3] *= 6.0
    raw = torch.rand(B, d, generator=gen, device=device) * 30.0 - 25.0
    if margin:
        near = ((raw + 20.0).abs() < margin) | ((raw - 2.0).abs() < margin)
        raw = torch.where(near, raw + 3 * margin, raw)
    z = torch.randn(B, d, generator=gen, device=device)
    return torch.cat([mean, raw], dim=1).contiguous(), z


# (1, 1): SAC Pendulum's env step; (256, 1): its update; (256, 6) and
# (4096, 17): larger boxes; (5, 40): d over a warp's 32 lanes.
SQUASHED_SHAPES = [(1, 1), (256, 1), (256, 6), (4096, 17), (5, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,d", SQUASHED_SHAPES)
@pytest.mark.parametrize("explore", [True, False])
@pytest.mark.parametrize("low,high", [(-2.0, 2.0), (-1.0, 0.5)])
def test_squashed_gaussian_kernel_matches_plain(cuda, B, d, explore, low,
                                                high):
    x, z = _squashed_inputs(B, d, cuda, seed=B * d)
    zz = z if explore else None
    before = distributions.SQUASHED_GAUSSIAN_KERNEL.launches
    actions, logp = distributions.squashed_gaussian_sample_logp(
        x, zz, low, high, explore)
    torch.cuda.synchronize()
    assert distributions.SQUASHED_GAUSSIAN_KERNEL.launches == before + 1
    want_actions, want_logp = distributions._squashed_gaussian_plain(
        x, zz, low, high, explore)
    assert actions.shape == (B, d) and logp.shape == (B,)
    torch.testing.assert_close(actions, want_actions, rtol=TOL, atol=TOL)
    torch.testing.assert_close(logp, want_logp, rtol=TOL, atol=TOL)
    assert bool((actions >= low).all()) and bool((actions <= high).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,d", SQUASHED_SHAPES)
@pytest.mark.parametrize("grads", ["both", "no_g_a", "no_g_logp"])
def test_squashed_gaussian_backward_kernel_matches_plain(cuda, B, d, grads):
    """K9b against the plain backward, raw log_std at least 1e-3 from the
    clip bounds; and the autograd function's gradient launches K9b."""
    x, z = _squashed_inputs(B, d, cuda, seed=B * d + 1, margin=1e-3)
    gen = torch.Generator(device=cuda).manual_seed(7)
    g_a = None if grads == "no_g_a" else torch.randn(
        B, d, generator=gen, device=cuda)
    g_logp = None if grads == "no_g_logp" else torch.randn(
        B, generator=gen, device=cuda)
    got = distributions._squashed_gaussian_backward_cuda(
        x, z, g_a, g_logp, -2.0, 2.0, True)
    want = distributions._squashed_gaussian_backward_plain(
        x, z, g_a, g_logp, -2.0, 2.0, True)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    xg = x.clone().requires_grad_(True)
    actions, logp = distributions.squashed_gaussian_sample_logp(
        xg, z, -2.0, 2.0)
    before = distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches
    loss = (actions * g_a).sum() if g_a is not None else 0.0
    if g_logp is not None:
        loss = loss + (logp * g_logp).sum()
    loss.backward()
    assert distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches \
        == before + 1
    torch.testing.assert_close(xg.grad, want, rtol=TOL, atol=TOL)


def _strided_gradients(B, d, device, g_a_layout, g_logp_layout, obs_dim=3):
    """Upstream gradients as autograd hands them to the tail: g_a a
    column slice of a [B, obs_dim + d] concat gradient ("slice"), the
    expand of a sum ("expand", strides 0), dense, or None; g_logp the
    expand of a sum, every other element of a [2B] tensor ("strided"),
    dense, or None."""
    gen = torch.Generator(device=device).manual_seed(B * d + 11)
    g_a = {"slice": lambda: torch.randn(B, obs_dim + d, generator=gen,
                                        device=device)[:, obs_dim:],
           "expand": lambda: torch.randn(1, 1, generator=gen,
                                         device=device).expand(B, d),
           "dense": lambda: torch.randn(B, d, generator=gen, device=device),
           "none": lambda: None}[g_a_layout]()
    g_logp = {"expand": lambda: torch.randn(1, generator=gen,
                                            device=device).expand(B),
              "strided": lambda: torch.randn(2 * B, generator=gen,
                                             device=device)[::2],
              "dense": lambda: torch.randn(B, generator=gen, device=device),
              "none": lambda: None}[g_logp_layout]()
    return g_a, g_logp


@pytest.mark.gpu
@pytest.mark.parametrize("B,d", [(256, 1), (1, 1), (256, 6), (5, 40)])
@pytest.mark.parametrize("g_a_layout,g_logp_layout", [
    ("slice", "expand"), ("slice", "dense"), ("expand", "strided"),
    ("slice", "none"), ("none", "expand"), ("dense", "dense")])
def test_squashed_gaussian_backward_reads_strided_gradients(
        cuda, B, d, g_a_layout, g_logp_layout):
    """K9b on autograd's views equals the plain backward on dense copies
    bit for bit, directly and through the autograd function; through it
    the backward enqueues K9b alone (no copy of a gradient)."""
    x, z = _squashed_inputs(B, d, cuda, seed=B * d + 2, margin=1e-3)
    g_a, g_logp = _strided_gradients(B, d, cuda, g_a_layout, g_logp_layout)
    dense = [None if g is None else g.contiguous() for g in (g_a, g_logp)]
    want = distributions._squashed_gaussian_backward_plain(
        x, z, *dense, -2.0, 2.0, True)
    got = distributions._squashed_gaussian_backward_cuda(
        x, z, g_a, g_logp, -2.0, 2.0, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    xg = x.clone().requires_grad_(True)
    actions, logp = distributions.squashed_gaussian_sample_logp(
        xg, z, -2.0, 2.0)
    outs = [o for o, g in zip((actions, logp), (g_a, g_logp))
            if g is not None]
    grads = [g for g in (g_a, g_logp) if g is not None]
    before = distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches
    (g_x,) = torch.autograd.grad(outs, [xg], grads, retain_graph=True)
    assert distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches \
        == before + 1
    assert torch.equal(g_x, want)
    assert _device_ops(lambda: torch.autograd.grad(
        outs, [xg], grads, retain_graph=True)) == 1


@pytest.mark.gpu
def test_sac_actor_step_tail_backward_enqueues_one_device_operation(
        cuda, monkeypatch):
    """The actor step hands the tail's backward g_a as a column slice of
    the critics' concat gradient (row stride obs_dim + d) and g_logp
    dense; K9b reads them as they are, once per step, and the tail's
    backward on those gradients enqueues one device operation."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.sac import SACPolicy
    from ray_tpu_torch.rllib.env.spaces import Box
    policy = SACPolicy(Box(-8.0, 8.0, (3,)), Box(-2.0, 2.0, (1,)),
                       {"device": "cuda", "seed": 0})
    seen = []
    launch = distributions._squashed_backward_launch

    def recording(x, z, g_a, g_logp, *rest):
        seen.append((g_a, g_logp))
        return launch(x, z, g_a, g_logp, *rest)

    monkeypatch.setattr(distributions, "_squashed_backward_launch",
                        recording)
    gen = torch.Generator(device=cuda).manual_seed(0)
    obs = torch.randn(256, 3, generator=gen, device=cuda)
    z = torch.randn(256, 1, generator=gen, device=cuda)
    before = distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches
    policy.actor_step({sb.OBS: obs}, z)
    torch.cuda.synchronize()
    assert distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches \
        == before + 1
    (g_a, g_logp), = seen
    assert g_a.shape == (256, 1) and g_a.stride() == (4, 1)
    assert g_logp.shape == (256,)
    x = policy.actor(obs).detach().requires_grad_(True)
    actions, logp = distributions.squashed_gaussian_sample_logp(
        x, z, tail=policy._tail_constants)
    assert _device_ops(lambda: torch.autograd.grad(
        (actions, logp), [x], (g_a, g_logp), retain_graph=True)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("B,d", [(1, 1), (256, 1), (4096, 17)])
@pytest.mark.parametrize("explore", [True, False])
def test_squashed_gaussian_host_actions_equal_device_actions(cuda, B, d,
                                                             explore):
    """K9f with a pinned host output: after its event the host actions
    equal the device actions bit for bit, over many calls in a row that
    reuse the output; the device outputs still match the plain version."""
    host = distributions.ActionRecord(B, d, pin=True)
    before = distributions.SQUASHED_GAUSSIAN_KERNEL.launches
    for step in range(16):
        x, z = _squashed_inputs(B, d, cuda, seed=B * d + step)
        zz = z if explore else None
        actions, logp = distributions.squashed_gaussian_sample_logp(
            x, zz, -2.0, 2.0, explore, host_actions=host)
        host.record_done(cuda)
        got = host.columns()
        assert got.tobytes() == actions.cpu().numpy().tobytes(), step
    assert distributions.SQUASHED_GAUSSIAN_KERNEL.launches == before + 16
    want_actions, want_logp = distributions._squashed_gaussian_plain(
        x, zz, -2.0, 2.0, explore)
    torch.testing.assert_close(actions, want_actions, rtol=TOL, atol=TOL)
    torch.testing.assert_close(logp, want_logp, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_squashed_gaussian_rejects_a_pageable_host_output(cuda):
    x, z = _squashed_inputs(4, 2, cuda, seed=3)
    before = distributions.SQUASHED_GAUSSIAN_KERNEL.launches
    with pytest.raises(RuntimeError, match="squashed_gaussian"):
        distributions.squashed_gaussian_sample_logp(
            x, z, -1.0, 1.0, host_actions=distributions.ActionRecord(
                4, 2, pin=False))
    assert distributions.SQUASHED_GAUSSIAN_KERNEL.launches == before
    with pytest.raises(ValueError, match="ActionRecord"):
        distributions.squashed_gaussian_sample_logp(
            x, z, -1.0, 1.0, host_actions=distributions.ActionRecord(
                4, 1, pin=True))
    got, _ = distributions.squashed_gaussian_sample_logp(x, z, -1.0, 1.0)
    want, _ = distributions._squashed_gaussian_plain(x, z, -1.0, 1.0, True)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_squashed_gaussian_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(4, 6, device=cuda)
    z = torch.zeros(4, 3, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        distributions._squashed_gaussian_cuda(x.half(), None, -1.0, 1.0,
                                              False)
    with pytest.raises(ValueError, match="2d"):
        distributions._squashed_gaussian_cuda(
            torch.zeros(4, 5, device=cuda), None, -1.0, 1.0, False)
    with pytest.raises(ValueError, match="normals"):
        distributions._squashed_gaussian_cuda(
            x, torch.zeros(4, 2, device=cuda), -1.0, 1.0, True)
    with pytest.raises(ValueError, match="contiguous"):
        distributions._squashed_gaussian_cuda(
            torch.zeros(6, 4, device=cuda).t(), None, -1.0, 1.0, False)
    with pytest.raises(ValueError, match="gradients"):
        distributions._squashed_gaussian_backward_cuda(
            x, z, torch.zeros(4, 2, device=cuda), None, -1.0, 1.0, True)
    with pytest.raises(ValueError, match="gradients"):
        distributions._squashed_gaussian_backward_cuda(
            x, z, None, torch.zeros(3, device=cuda), -1.0, 1.0, True)
    with pytest.raises(ValueError, match="gradients"):
        distributions._squashed_gaussian_backward_cuda(
            x, z, None, torch.zeros(4, device=cuda).double(), -1.0, 1.0,
            True)


@pytest.mark.gpu
@pytest.mark.parametrize("twin_q", [True, False])
def test_sac_policy_on_the_card_launches_k9_and_matches_the_cpu(cuda,
                                                                 twin_q):
    """Past pure exploration an env step launches K9f once; an update
    launches K9f twice and K9b once; one learn_with_td on the card (f32,
    TF32 off) with injected normals equals the same update on the CPU
    (1e-4 on the stats, |td| and every parameter)."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.sac import SACPolicy
    from ray_tpu_torch.rllib.env.spaces import Box
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    obs_space, act_space = Box(-8.0, 8.0, (3,)), Box(-2.0, 2.0, (2,))
    cfg = {"actor_hiddens": [64, 64], "critic_hiddens": [64, 64],
           "twin_q": twin_q, "pure_exploration_steps": 0, "seed": 0,
           "initial_alpha": 0.5}
    card = SACPolicy(obs_space, act_space, dict(cfg, device="cuda"))
    host = SACPolicy(obs_space, act_space, dict(cfg, device="cpu"))
    host.set_weights(card.get_weights())
    rng = np.random.default_rng(0)
    n = 256
    f, b = (distributions.SQUASHED_GAUSSIAN_KERNEL,
            distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL)
    k9f, k9b = f.launches, b.launches
    actions, state, extra = card.compute_actions(
        rng.standard_normal((16, 3)).astype(np.float32))
    assert f.launches == k9f + 1 and b.launches == k9b
    assert actions.shape == (16, 2) and state == [] and extra == {}
    assert np.all(np.abs(actions) <= 2.0)
    batch = SampleBatch({
        sb.OBS: rng.standard_normal((n, 3)).astype(np.float32),
        sb.NEW_OBS: rng.standard_normal((n, 3)).astype(np.float32),
        sb.ACTIONS: rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32),
        sb.REWARDS: rng.standard_normal(n).astype(np.float32),
        sb.DONES: rng.random(n) < 0.2})
    normals = (rng.standard_normal((n, 2)).astype(np.float32),
               rng.standard_normal((n, 2)).astype(np.float32))
    got, got_td = card.learn_with_td(batch, _normals=normals)
    assert f.launches == k9f + 3 and b.launches == k9b + 1
    want, want_td = host.learn_with_td(batch, _normals=normals)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got_td, want_td, rtol=1e-4, atol=1e-4)
    got_w, want_w = card.get_weights(), host.get_weights()
    for part in ("online", "target"):
        for net, value in want_w[part].items():
            if net == "log_alpha":
                np.testing.assert_allclose(got_w[part][net], value,
                                           rtol=1e-4, atol=1e-4)
                continue
            for k, v in value.items():
                np.testing.assert_allclose(got_w[part][net][k], v,
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=f"{part} {net} {k}")


def _obs_apply_inputs(n, K, S, mode, hw, device, seed=0):
    """K3 inputs: delta rows with pad entries, out-of-range indices, a
    quarter of the rows replaced whole ("delta-all": every row) and some
    done rows; or a frame upload with a done upload. S=0: no stack."""
    rng = np.random.default_rng(seed)
    side = int(round(hw ** 0.5))
    done = rng.random(n) < 0.25
    kw = {}
    if mode in ("delta", "delta-all"):
        idx = np.stack([rng.permutation(hw + 16)[:K] for _ in range(n)])
        idx[:, ::5] = hw
        idx = idx.astype(np.uint16)
        val = rng.integers(0, 256, (n, K), dtype=np.uint8)
        packed = np.concatenate([idx.view(np.uint8), val,
                                 done.astype(np.uint8)[:, None]], axis=1)
        m = n if mode == "delta-all" else max(1, n // 4)
        b = 1 << (m - 1).bit_length()
        rows = np.full(b, n, np.int32)
        rows[:m] = rng.permutation(n)[:m]
        kw.update(packed=np.ascontiguousarray(packed), rows=rows,
                  fulls=rng.integers(0, 256, (b, hw), dtype=np.uint8))
    else:
        kw["done"] = done
    if S:
        shape = (n, side, side, S) if side * side == hw else (n, hw, 1, S)
        kw["stack"] = rng.integers(0, 256, shape, dtype=np.uint8)
    frames = rng.integers(0, 256, (n, hw), dtype=np.uint8)
    kw = {k: torch.from_numpy(v).to(device) for k, v in kw.items()}
    frame_shape = (side, side, 1) if side * side == hw else (hw, 1, 1)
    return torch.from_numpy(frames).to(device), frame_shape, kw


OBS_APPLY_CASES = [
    (32, 128, 4, "delta", 7056), (32, 0, 4, "frame", 7056),
    (32, 128, 0, "delta", 7056), (512, 1024, 4, "delta", 7056),
    # Frames that are not a whole number of 16-byte vectors, and stacks
    # of other depths, take the kernel's byte-wise paths.
    (5, 7, 3, "delta", 36), (3, 4, 4, "delta", 36),
    (4, 9, 1, "delta", 64), (6, 0, 2, "frame", 49),
    # The (row, pixel-chunk) grid: one row in 28 chunks; 7 rows whose
    # last chunk is ragged (7056 = 27 x 256 + 144); bench.py's 192 envs
    # per group (7 chunks); every row replaced, done rows mixed in; a
    # frame of 1,000 pixels (byte-wise paths, 4 chunks, the last of
    # 232); frame mode and no stack on the chunked grid.
    (1, 128, 4, "delta", 7056), (7, 128, 4, "delta", 7056),
    (192, 128, 4, "delta", 7056), (32, 128, 4, "delta-all", 7056),
    (7, 64, 4, "delta-all", 7056), (3, 64, 3, "delta", 1000),
    (3, 64, 0, "delta", 1000), (7, 0, 4, "frame", 7056),
    (7, 128, 0, "delta", 7056), (7, 0, 0, "delta", 7056),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,K,S,mode,hw", OBS_APPLY_CASES)
def test_obs_apply_kernel_matches_plain(cuda, n, K, S, mode, hw):
    """The observation and the updated frames equal the plain version's
    bit for bit."""
    frames, shape, kw = _obs_apply_inputs(n, K, S, mode, hw, cuda,
                                          seed=n + K)
    f_kernel, f_plain = frames.clone(), frames.clone()
    before = device_sampler.OBS_APPLY_KERNEL.launches
    got = device_sampler.apply_obs(f_kernel, shape, **kw)
    torch.cuda.synchronize()
    assert device_sampler.OBS_APPLY_KERNEL.launches == before + 1
    want = device_sampler._apply_obs_plain(f_plain, shape, **kw)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(f_kernel, f_plain)
    if mode == "frame":
        assert torch.equal(f_kernel, frames)  # read only


@pytest.mark.gpu
@pytest.mark.parametrize("n,S", [(1, 4), (7, 4), (32, 4), (7, 3), (32, 0)])
def test_obs_apply_kernel_writes_both_sides_of_every_chunk_edge(cuda, n, S):
    """Delta entries at the last pixel of each chunk and the first of the
    next, at pixels 0 and HW-1, and at indices >= HW (dropped): the
    observation and the frames equal the plain version's bit for bit."""
    hw = 7056
    chunks, chunk = device_sampler.obs_apply_plan(n, hw)
    assert chunks > 1
    edges = [c * chunk + d for c in range(1, chunks) for d in (-1, 0)]
    idx = np.array(edges + [0, hw - 1, hw, hw + 5, 65535], np.uint16)
    K = len(idx)
    rng = np.random.default_rng(n)
    done = np.arange(n) % 3 == 1
    packed = np.concatenate([
        np.tile(idx, (n, 1)).view(np.uint8),
        rng.integers(0, 256, (n, K), dtype=np.uint8),
        done.astype(np.uint8)[:, None]], axis=1)
    frames = torch.from_numpy(rng.integers(0, 256, (n, hw), dtype=np.uint8)
                              ).to(cuda)
    kw = {"packed": torch.from_numpy(np.ascontiguousarray(packed)).to(cuda)}
    if S:
        kw["stack"] = torch.from_numpy(rng.integers(
            0, 256, (n, 84, 84, S), dtype=np.uint8)).to(cuda)
    f_kernel, f_plain = frames.clone(), frames.clone()
    got = device_sampler.apply_obs(f_kernel, (84, 84, 1), **kw)
    want = device_sampler._apply_obs_plain(f_plain, (84, 84, 1), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(f_kernel, f_plain)
    assert not torch.equal(f_kernel, frames)


@pytest.mark.gpu
@pytest.mark.parametrize("n,K,S,mode,hw", [
    (32, 128, 4, "delta", 7056), (7, 64, 4, "delta-all", 7056),
    (32, 0, 4, "frame", 7056), (3, 64, 3, "delta", 1000)])
def test_group_obs_apply_matches_plain_over_steps(cuda, n, K, S, mode, hw):
    """The sampler's launch path (`GroupObsApply`: fixed buffers checked
    once) over three steps, each output the next step's stack, against
    the plain version: equal bit for bit, one launch per step."""
    frames, shape, kw = _obs_apply_inputs(n, K, S, mode, hw, cuda, seed=n)
    stack = kw.pop("stack")
    f_kernel, f_plain = frames.clone(), frames.clone()
    delta = mode != "frame"
    apply = device_sampler.GroupObsApply(
        cuda, n, shape, stack, f_kernel if delta else None)
    s_kernel = s_plain = stack
    before = device_sampler.OBS_APPLY_KERNEL.launches
    for _ in range(3):
        s_kernel = apply(f_kernel, s_kernel, **kw)
        s_plain = device_sampler._apply_obs_plain(f_plain, shape, **kw,
                                                  stack=s_plain)
    torch.cuda.synchronize()
    assert device_sampler.OBS_APPLY_KERNEL.launches == before + 3
    assert torch.equal(s_kernel, s_plain) and torch.equal(f_kernel, f_plain)


@pytest.mark.gpu
def test_group_obs_apply_checks_its_fixed_buffers_once(cuda):
    frames, shape, kw = _obs_apply_inputs(4, 8, 4, "delta", 64, cuda)
    with pytest.raises(ValueError, match="stack is torch.float32"):
        device_sampler.GroupObsApply(cuda, 4, shape, kw["stack"].float(),
                                     frames)
    with pytest.raises(ValueError, match="frames is not contiguous"):
        device_sampler.GroupObsApply(cuda, 4, shape, kw["stack"],
                                     frames.t().contiguous().t())
    apply = device_sampler.GroupObsApply(cuda, 4, shape, kw["stack"],
                                         frames)
    # What a call brings is still checked on every call.
    with pytest.raises(ValueError, match="packed is on"):
        apply(frames, kw["stack"], packed=kw["packed"].cpu())
    with pytest.raises(ValueError, match="rows is torch.int64"):
        apply(frames, kw["stack"], packed=kw["packed"],
              rows=kw["rows"].long(), fulls=kw["fulls"])
    with pytest.raises(ValueError, match="fulls must be"):
        apply(frames, kw["stack"], packed=kw["packed"], rows=kw["rows"],
              fulls=kw["fulls"][:, :-1].contiguous())


@pytest.mark.gpu
def test_stream_handle_follows_the_current_stream(cuda):
    x = torch.zeros(1, device=cuda)
    assert cuda_build.stream_handle(x) \
        == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert cuda_build.stream_handle(x) == side.cuda_stream
        assert cuda_build.device_stream_handle(x.get_device()) \
            == side.cuda_stream


@pytest.mark.gpu
def test_obs_apply_kernel_rejects_what_it_cannot_take(cuda):
    frames, shape, kw = _obs_apply_inputs(4, 8, 4, "delta", 64, cuda)
    bad = dict(kw, stack=kw["stack"].float())
    with pytest.raises(ValueError, match="stack is torch.float32"):
        device_sampler._apply_obs_cuda(frames, shape, **bad)
    bad = dict(kw, rows=kw["rows"].long())
    with pytest.raises(ValueError, match="rows is torch.int64"):
        device_sampler._apply_obs_cuda(frames, shape, **bad)
    bad = dict(kw, packed=kw["packed"].cpu())
    with pytest.raises(ValueError, match="packed is on"):
        device_sampler._apply_obs_cuda(frames, shape, **bad)
    bad = dict(kw, packed=kw["packed"][:, :-2].contiguous())
    with pytest.raises(ValueError, match="3K\\+1"):
        device_sampler._apply_obs_cuda(frames, shape, **bad)
    with pytest.raises(ValueError, match="done upload"):
        device_sampler._apply_obs_cuda(frames, shape,
                                       stack=kw["stack"])


CATEGORICAL_K_CASES = [(1, 32, 6), (5, 32, 6), (8, 4096, 18), (3, 7, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,N,A", CATEGORICAL_K_CASES)
@pytest.mark.parametrize("explore", [True, False])
def test_categorical_k_kernel_matches_plain(cuda, k, N, A, explore):
    gen = torch.Generator(device=cuda).manual_seed(k * N * A)
    logits = torch.randn(N, A, generator=gen, device=cuda) * 3.0
    u = torch.rand(k, N, A, generator=gen, device=cuda) if explore \
        else None
    before = distributions.CATEGORICAL_K_KERNEL.launches
    actions, logp = distributions.sample_logp_k(logits, u, explore, k)
    torch.cuda.synchronize()
    assert distributions.CATEGORICAL_K_KERNEL.launches == before + 1
    want_actions, want_logp = distributions._sample_logp_k_plain(
        logits, u, k, explore)
    assert actions.shape == (k, N) and actions.dtype == torch.int64
    assert torch.equal(actions, want_actions)
    torch.testing.assert_close(logp, want_logp, rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("explore", [True, False])
def test_categorical_k_at_one_equals_categorical(cuda, explore):
    """The sampler's k=1 windows run K2k: at k=1 it picks exactly what
    K2 picks, with the same logp bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    logits = torch.randn(32, 6, generator=gen, device=cuda) * 3.0
    u = torch.rand(1, 32, 6, generator=gen, device=cuda)
    a_k, logp_k = distributions.sample_logp_k(
        logits, u if explore else None, explore, 1)
    a, logp = distributions.sample_logp(logits, u[0] if explore else None,
                                        explore)
    assert torch.equal(a_k[0], a) and torch.equal(logp_k[0], logp)


@pytest.mark.gpu
@pytest.mark.parametrize("k,N,A", [(1, 32, 6), (5, 32, 6), (8, 4096, 18)])
def test_categorical_k_host_actions_equal_device_actions(cuda, k, N, A):
    """Many windows in a row on one stream, each writing its int32 wire
    actions into its own pinned buffer through the mapped address: after
    each window's event, the host buffer equals the device's int64
    actions; the actions and logp equal the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(k + N + A)
    windows = []
    before = distributions.CATEGORICAL_K_KERNEL.launches
    for w in range(64):
        logits = torch.randn(N, A, generator=gen, device=cuda) * 3.0
        u = torch.rand(k, N, A, generator=gen, device=cuda)
        host = torch.full((k, N), -1, dtype=torch.int32, pin_memory=True)
        actions, logp = distributions.sample_logp_k(logits, u, True, k,
                                                    host_actions=host)
        event = torch.cuda.Event()
        event.record()
        windows.append((logits, u, host, actions, logp, event))
    assert distributions.CATEGORICAL_K_KERNEL.launches == before + 64
    for logits, u, host, actions, logp, event in windows:
        event.synchronize()
        assert torch.equal(host.long(), actions.cpu())
        want_actions, want_logp = distributions._sample_logp_k_plain(
            logits, u, k, True)
        assert torch.equal(actions, want_actions)
        torch.testing.assert_close(logp, want_logp, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_categorical_k_host_actions_reused_buffer(cuda):
    """The sampler's pattern: one pinned buffer per group, each window
    read (copied out) after its event, then overwritten by the next."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    host = torch.empty((5, 32), dtype=torch.int32, pin_memory=True)
    for _ in range(50):
        logits = torch.randn(32, 6, generator=gen, device=cuda) * 3.0
        u = torch.rand(5, 32, 6, generator=gen, device=cuda)
        actions, _ = distributions.sample_logp_k(logits, u, True, 5,
                                                 host_actions=host)
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        got = host.numpy().copy()
        np.testing.assert_array_equal(got, actions.cpu().numpy())


@pytest.mark.gpu
def test_categorical_k_with_host_actions_at_one_equals_categorical(cuda):
    """k=1 with the wire output still picks exactly what K2 picks."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    logits = torch.randn(32, 6, generator=gen, device=cuda) * 3.0
    u = torch.rand(1, 32, 6, generator=gen, device=cuda)
    host = torch.empty((1, 32), dtype=torch.int32, pin_memory=True)
    a_k, logp_k = distributions.sample_logp_k(logits, u, True, 1,
                                              host_actions=host)
    a, logp = distributions.sample_logp(logits, u[0], True)
    torch.cuda.synchronize()
    assert torch.equal(a_k[0], a) and torch.equal(logp_k[0], logp)
    assert torch.equal(host[0].long(), a.cpu())


@pytest.mark.gpu
def test_categorical_k_rejects_a_pageable_host_buffer(cuda):
    """A host buffer the card cannot write (pageable memory) fails the
    call before any launch; the error does not leak into the next launch
    of the same library."""
    logits = torch.randn(32, 6, device=cuda)
    u = torch.rand(5, 32, 6, device=cuda)
    pageable = torch.empty((5, 32), dtype=torch.int32)
    before = distributions.CATEGORICAL_K_KERNEL.launches
    with pytest.raises(RuntimeError, match="categorical_k"):
        distributions.sample_logp_k(logits, u, True, 5,
                                    host_actions=pageable)
    assert distributions.CATEGORICAL_K_KERNEL.launches == before
    with pytest.raises(ValueError, match="host_actions"):
        distributions.sample_logp_k(
            logits, u, True, 5,
            host_actions=torch.empty((5, 32), dtype=torch.int64,
                                     pin_memory=True))
    with pytest.raises(ValueError, match="host_actions"):
        distributions.sample_logp_k(
            logits, u, True, 5,
            host_actions=torch.empty((5, 32), dtype=torch.int32,
                                     device=cuda))
    a, _ = distributions.sample_logp(logits, u[0], True)
    actions, _ = distributions.sample_logp_k(logits, u, True, 5)
    torch.cuda.synchronize()
    assert torch.equal(actions[0], a)


@pytest.mark.gpu
def test_categorical_k_kernel_rejects_what_it_cannot_take(cuda):
    logits = torch.zeros(4, 6, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        distributions._sample_logp_k_cuda(logits.double(), None, 2, False)
    with pytest.raises(ValueError, match="uniforms"):
        distributions._sample_logp_k_cuda(
            logits, torch.rand(3, 4, 6, device=cuda), 2, True)
    with pytest.raises(ValueError, match="k=0"):
        distributions._sample_logp_k_cuda(logits, None, 0, False)


@pytest.mark.gpu
@pytest.mark.parametrize("groups,k", [(1, 1), (2, 2)])
def test_sebulba_sampler_on_the_card_matches_the_cpu(cuda, groups, k):
    """The Sebulba sampler on the card (K3 per group per step, K2k per
    window) against the same sampler on the CPU, f32 model, argmax
    actions: integer and uint8 columns equal, floats within 1e-4."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import \
        VTraceTorchPolicy
    from ray_tpu_torch.rllib.env.delta_obs import BatchedSpriteAtari
    from ray_tpu_torch.rllib.env.device_frame_stack import DeviceFrameStack
    n, T = 4, 6
    cfg = {"model": {"compute_dtype": "f32",
                     "conv_filters": ((8, 8, 4), (8, 4, 2))},
           "rollout_fragment_length": T, "seed": 0}

    def envs():
        out = [DeviceFrameStack(BatchedSpriteAtari(
            n // groups, episode_len=5, seed=3 + g), 4)
            for g in range(groups)]
        return out if groups > 1 else out[0]

    space = DeviceFrameStack(BatchedSpriteAtari(1), 4).observation_space
    card = VTraceTorchPolicy(space, BatchedSpriteAtari(1).action_space,
                             dict(cfg, device="cuda"))
    host = VTraceTorchPolicy(space, BatchedSpriteAtari(1).action_space,
                             dict(cfg, device="cpu"))
    host.set_weights(card.get_weights())
    samplers = [device_sampler.DeviceSebulbaSampler(
        envs(), p, T, explore=False, onchip_steps=k, seed=0)
        for p in (card, host)]
    k3 = device_sampler.OBS_APPLY_KERNEL.launches
    k2k = distributions.CATEGORICAL_K_KERNEL.launches
    for _ in range(3):
        got, want = (s.sample() for s in samplers)
        for col in want:
            g, w = got[col], want[col]
            g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
            w = w.numpy() if isinstance(w, torch.Tensor) else w
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                           err_msg=col)
            else:
                np.testing.assert_array_equal(g, w, err_msg=col)
    torch.cuda.synchronize()
    assert device_sampler.OBS_APPLY_KERNEL.launches - k3 == 3 * T * groups
    assert distributions.CATEGORICAL_K_KERNEL.launches - k2k \
        == 3 * (T // k) * groups
    counts = [{key: v for key, v in s.transfer_stats().items()
               if key not in ("t_fetch_s", "t_env_s")} for s in samplers]
    assert counts[0] == counts[1]


DEVICE_ENV_CASES = [("atari", n) for n in (1, 37, 256, 4096)] \
    + [("cartpole", n) for n in (1, 37, 129, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n", DEVICE_ENV_CASES)
@pytest.mark.parametrize("reset", [False, True])
def test_device_env_kernels_match_plain(cuda, kind, n, reset):
    """K5a/K5b against their plain versions on the card, writing into a
    strided slot of an env-major buffer: every output byte for byte (the
    CartPole state within 1 ulp), the neighbouring slots untouched, one
    launch for the kernel and none for the plain version."""
    env = device_env.DeviceSyntheticAtari() if kind == "atari" \
        else device_env.DeviceCartPole()
    got = device_env_check.compare_with_plain(env, n, reset, seed=n,
                                              device=cuda)
    assert got["max_ulps"] <= 1
    assert got["ends"] > 0 or reset or n < 5


@pytest.mark.gpu
def test_device_env_kernels_reject_what_they_cannot_take(cuda):
    env = device_env.DeviceSyntheticAtari()
    state, actions, ep = device_env_check.env_case(env, 4, cuda, seed=0)
    obs, rew = env.empty_obs(4, cuda), torch.empty(4, device=cuda)
    done = torch.empty(4, dtype=torch.bool, device=cuda)
    step = device_env._synthetic_atari_step_cuda

    def call(**over):
        a = dict(t=state["t"], target=state["target"], actions=actions,
                 obs=obs, reward=rew, done=done, episodes=ep)
        a.update(over)
        step(*a.values(), 6, 1000, 0, 1, False)

    with pytest.raises(ValueError, match="int32"):
        call(t=state["t"].long())
    with pytest.raises(ValueError, match="not contiguous"):
        call(target=torch.zeros(8, dtype=torch.int32, device=cuda)[::2])
    with pytest.raises(ValueError, match="is on cpu"):
        call(t=state["t"].cpu())
    with pytest.raises(ValueError, match="actions is on cpu"):
        call(actions=actions.cpu())
    with pytest.raises(ValueError, match="uint8"):
        call(obs=obs.float())
    with pytest.raises(ValueError, match="16-byte"):
        call(obs=torch.empty(4 * 28224 + 1, dtype=torch.uint8,
                             device=cuda)[1:].view(4, 84, 84, 4))
    with pytest.raises(ValueError, match="episodes"):
        bad = device_env.EpisodeAccumulator(4, cuda)
        bad.ep_len = bad.ep_len.float()
        call(episodes=bad)
    cp = device_env.DeviceCartPole()
    cstate, cactions, _ = device_env_check.env_case(cp, 4, cuda, seed=0)
    cobs = cp.empty_obs(4, cuda)
    with pytest.raises(ValueError, match="float32"):
        device_env._cartpole_step_cuda(
            cstate["s"].double(), cstate["t"], cactions, cobs, rew, done,
            None, 200, 0, 1, False)
    with pytest.raises(ValueError, match="not contiguous"):
        device_env._cartpole_step_cuda(
            torch.zeros(4, 4, device=cuda).t(), cstate["t"], cactions,
            cobs, rew, done, None, 200, 0, 1, False)
    with pytest.raises(ValueError, match="is on cpu"):
        device_env._cartpole_step_cuda(
            cstate["s"].cpu(), cstate["t"], cactions, cobs, rew, done,
            None, 200, 0, 1, False)


# K5b through the bound step (the Anakin optimizer's launch path): the
# CartPole Anakin shape (32), a ragged block (37), many blocks (4096) and
# one env; 6 steps each, crossing episode ends.
@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 32, 37, 4096])
def test_cartpole_bound_step_matches_plain(cuda, n):
    """Every output of 6 bound steps equals the plain version's (the
    state and obs within 1 ulp, the rest byte for byte, slot 0
    untouched), one launch of the bound entry point per step."""
    got = device_env_check.compare_bound_with_plain(n, 6, seed=n,
                                                    device=cuda)
    assert got["max_ulps"] <= 1
    assert got["ends"] > 0 or n < 5


@pytest.mark.gpu
def test_cartpole_bound_step_is_one_device_operation(cuda):
    env, state, ep, actions, _, slots = device_env_check.bound_case(
        32, 4, cuda, seed=1)
    step = env.bind(state, *slots, seed=5, episodes=ep)
    before = device_env.CARTPOLE_KERNEL.launches
    assert _device_ops(lambda: step(actions[0], 0, 9)) == 1
    assert device_env.CARTPOLE_KERNEL.launches == before


@pytest.mark.gpu
def test_cartpole_bound_step_checks_only_the_actions(cuda):
    env, state, ep, actions, _, slots = device_env_check.bound_case(
        8, 2, cuda, seed=2)
    step = env.bind(state, *slots, seed=5, episodes=ep)
    before = device_env.CARTPOLE_BOUND_KERNEL.launches
    for bad, match in [(actions[0].int(), "int64"),
                       (actions[0].cpu(), "actions is on cpu"),
                       (actions[:, :4], "actions must be"),
                       (torch.zeros(16, dtype=torch.int64,
                                    device=cuda)[::2], "not contiguous")]:
        with pytest.raises(ValueError, match=match):
            step(bad, 0, 1)
    with pytest.raises(ValueError, match="counter"):
        step(actions[0], 0, -1)
    assert device_env.CARTPOLE_BOUND_KERNEL.launches == before
    with pytest.raises(ValueError, match="16-byte"):
        env.bind(state, [torch.zeros(8 * 4 + 1, device=cuda)[1:].view(8, 4),
                         slots[0][1]], *slots[1:], seed=5, episodes=ep)


@pytest.mark.gpu
def test_cartpole_anakin_rollout_takes_the_bound_step(cuda):
    """A CartPole Anakin call (2 updates x 5 env steps): every env step
    launches K5b through the bound entry point, none through the
    generic one."""
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
    t = IMPALATrainer(config={
        "env": "CartPole-v0", "anakin": True, "num_workers": 0,
        "num_envs_per_worker": 32, "rollout_fragment_length": 5,
        "anakin_updates_per_call": 2, "min_iter_time_s": 0,
        "model": {"fcnet_hiddens": [16]}, "seed": 0,
        "device": str(cuda)})
    try:
        kernels = (device_env.CARTPOLE_BOUND_KERNEL,
                   device_env.CARTPOLE_KERNEL)
        before = [k.launches for k in kernels]
        stats = t.optimizer.step()
        assert [k.launches - b for k, b in zip(kernels, before)] == [10, 0]
        assert all(np.isfinite(v) for v in stats.values())
    finally:
        t.stop()


def _anakin_trainer(device, n=8, T=4, updates=1):
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
    return IMPALATrainer(config={
        "env": "SyntheticAtari-v0", "anakin": True, "num_workers": 0,
        "num_envs_per_worker": n, "rollout_fragment_length": T,
        "anakin_updates_per_call": updates, "min_iter_time_s": 0,
        "model": {"conv_filters": [[8, 8, 4], [8, 4, 2]]}, "seed": 0,
        "device": str(device)})


@pytest.mark.gpu
def test_anakin_runs_with_one_seed_record_equal_trajectories(cuda):
    batches = []
    for _ in range(2):
        t = _anakin_trainer(cuda)
        try:
            with t.get_policy()._update_lock:
                batch = t.optimizer._rollout()
            batches.append({k: v.clone() for k, v in batch.items()})
        finally:
            t.stop()
    assert set(batches[0]) == set(batches[1])
    for k in batches[0]:
        assert torch.equal(batches[0][k], batches[1][k]), k


@pytest.mark.gpu
def test_anakin_call_enqueues_without_a_host_sync(cuda):
    """One whole call (2 updates x 4 env steps) is enqueued under
    set_sync_debug_mode("error"); only `finish` reads back. Launches: the
    env kernel and the sampling kernel once per env step, V-trace once
    per update."""
    t = _anakin_trainer(cuda, n=16, T=4, updates=2)
    try:
        t.train()  # warm-up: cuDNN and cuBLAS set themselves up
        kernels = (device_env.SYNTHETIC_ATARI_KERNEL,
                   distributions.CATEGORICAL_KERNEL, vtrace.VTRACE_KERNEL)
        before = [k.launches for k in kernels]
        opt = t.optimizer
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = opt.enqueue()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        stats = opt.finish(pending)
        assert [k.launches - b for k, b in zip(kernels, before)] \
            == [8, 8, 2]
        assert all(np.isfinite(v) for v in stats.values())
    finally:
        t.stop()


def _nb(obs_shape, num_actions, dtype=np.float32):
    """Blocks of a network's packed gradient (the exchange's shape)."""
    from ray_tpu_torch.rllib.env.spaces import Box
    model = catalog.get_model(Box(0, 255, obs_shape, dtype), num_actions,
                              {})
    return flax_pack_plan(model, collectives.Q8_BLOCK).nb


@pytest.mark.gpu
# The Nature CNN's packed gradient (1,654 blocks) live and with the edge
# cases, the CartPole FC net's, a 64M-element buffer, and tiny buffers.
@pytest.mark.parametrize("shape,edge", [("nature", False), ("nature", True),
                                        ("cartpole", True), (65536, False),
                                        (1, True), (5, True)])
def test_q8_encode_kernel_matches_plain(cuda, shape, edge):
    nb = {"nature": 1654, "cartpole": None}.get(shape, shape)
    if nb is None:
        nb = _nb((4,), 2)
    before = collectives.Q8_ENCODE_KERNEL.launches
    q8_check.check_encode(nb, seed=nb, edge=edge)
    assert collectives.Q8_ENCODE_KERNEL.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 8])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("nb", [1654, 7])
def test_q8_gather_sum_kernel_matches_plain(cuda, world, mean, nb):
    before = collectives.Q8_GATHER_SUM_KERNEL.launches
    q8_check.check_gather_sum(world, nb, mean, seed=world * nb)
    assert collectives.Q8_GATHER_SUM_KERNEL.launches == before + 1


def _model_of(name):
    from ray_tpu_torch.rllib.env.spaces import Box
    if name == "nature_cnn":
        return catalog.get_model(Box(0, 255, (84, 84, 4), np.uint8), 6, {})
    if name == "cartpole_fc":
        return catalog.get_model(Box(-1.0, 1.0, (4,)), 2, {})
    return catalog.get_model(Box(-1.0, 1.0, (3,)), 2, {"free_log_std": True})


# K6b with the leaf table: the Nature CNN's (the data-parallel path's,
# nb 1,654), the CartPole FC net's and PPO Pendulum's (free_log_std).
@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 8])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("name", ["nature_cnn", "cartpole_fc",
                                  "pendulum_fc"])
def test_q8_gather_sum_unpack_matches_plain(cuda, world, mean, name):
    """Bit for bit against its plain version and the packed-order K6b
    indexed by the plan's `unpack_index`, one launch."""
    before = collectives.Q8_GATHER_UNPACK_KERNEL.launches
    q8_check.check_gather_sum_unpack(_model_of(name), world, mean,
                                     seed=world, device=cuda)
    assert collectives.Q8_GATHER_UNPACK_KERNEL.launches == before + 1


@pytest.mark.gpu
def test_q8_decode_is_one_device_operation(cuda):
    decode, gathered, _ = q8_check.check_gather_sum_unpack(
        _model_of("nature_cnn"), 2, False, seed=4, device=cuda)
    assert _device_ops(lambda: decode(gathered, False)) == 1


@pytest.mark.gpu
def test_q8_decode_matches_the_cpu(cuda):
    """K6b with the leaf table on the card equals the plain version on
    the CPU."""
    model = _model_of("cartpole_fc")
    plan = flax_pack_plan(model, collectives.Q8_BLOCK)
    table = convert.flax_leaf_table(model, collectives.Q8_BLOCK)
    gathered = q8_check.gathered_case(2, plan.nb, seed=6, device="cpu")
    card = collectives.Q8Decode(table, plan.nb, cuda)(gathered.to(cuda),
                                                      True)
    host = collectives.Q8Decode(table, plan.nb, "cpu")(gathered, True)
    assert torch.equal(card.cpu(), host)
    with pytest.raises(ValueError, match="gathered wire images"):
        collectives.Q8Decode(table, plan.nb, cuda)(gathered, True)


@pytest.mark.gpu
def test_q8_kernels_match_the_cpu(cuda):
    """K6a and K6b on the card equal the plain versions on the CPU (which
    the CPU tests hold equal to numpy's q8_quantize)."""
    g_np, ef_np = q8_check.packed_case(64, seed=3)
    out = {}
    for device in ("cuda", "cpu"):
        ef = torch.from_numpy(ef_np).to(device)
        wire = collectives.q8_encode_ef(torch.from_numpy(g_np).to(device),
                                        ef)
        total = collectives.q8_gather_sum(torch.stack([wire, wire]), 64)
        out[device] = [t.cpu() for t in (wire, ef, total)]
    for card, host in zip(out["cuda"], out["cpu"]):
        assert torch.equal(card, host)


@pytest.mark.gpu
def test_q8_kernels_reject_what_they_cannot_take(cuda):
    g = torch.zeros(2 * collectives.Q8_BLOCK, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        collectives.q8_encode_ef(g.double(), g.double())
    with pytest.raises(ValueError, match="is on"):
        collectives.q8_encode_ef(g, g.cpu())
    with pytest.raises(ValueError, match="aligned"):
        collectives.q8_encode_ef(
            torch.zeros(2 * collectives.Q8_BLOCK + 1, device=cuda)[1:], g)
    with pytest.raises(ValueError, match="contiguous"):
        collectives.q8_encode_ef(g, torch.zeros(
            4 * collectives.Q8_BLOCK, device=cuda)[::2])
    wire = collectives.q8_encode_ef(g, torch.zeros_like(g))
    with pytest.raises(ValueError, match="expected"):
        collectives.q8_gather_sum(wire[None, :-4], 2)
    with pytest.raises(ValueError, match="contiguous"):
        collectives.q8_gather_sum(
            torch.stack([wire, wire], dim=1).t(), 2)


def test_new_kernels_have_sources_and_entry_points():
    for kernel in (distributions.DIAG_GAUSSIAN_KERNEL,
                   distributions.CATEGORICAL_K_KERNEL,
                   device_sampler.OBS_APPLY_KERNEL,
                   device_env.SYNTHETIC_ATARI_KERNEL,
                   device_env.CARTPOLE_KERNEL,
                   collectives.Q8_ENCODE_KERNEL,
                   collectives.Q8_GATHER_SUM_KERNEL):
        source = kernel.source.read_text()
        assert kernel.source.is_file()
        assert f'extern "C" int {kernel.symbol}(' in source
        assert "kernel_error_string" in source
    # K2k builds from the same source as K2, into the same library.
    assert distributions.CATEGORICAL_K_KERNEL.source \
        == distributions.CATEGORICAL_KERNEL.source
    assert distributions.CATEGORICAL_K_KERNEL.library_path() \
        == distributions.CATEGORICAL_KERNEL.library_path()
    # K5a and K5b share device_env.cu's library.
    assert device_env.SYNTHETIC_ATARI_KERNEL.source.name == "device_env.cu"
    assert device_env.CARTPOLE_KERNEL.library_path() \
        == device_env.SYNTHETIC_ATARI_KERNEL.library_path()
    # K6a and K6b share q8.cu's library.
    assert collectives.Q8_ENCODE_KERNEL.source.name == "q8.cu"
    assert collectives.Q8_GATHER_SUM_KERNEL.library_path() \
        == collectives.Q8_ENCODE_KERNEL.library_path()


def test_bound_and_unpack_entry_points_share_their_libraries():
    """K5b's bound entry point and K6b's leaf-table form live in the
    sources (and libraries) of the generic ones."""
    for kernel, other in ((device_env.CARTPOLE_BOUND_KERNEL,
                           device_env.CARTPOLE_KERNEL),
                          (collectives.Q8_GATHER_UNPACK_KERNEL,
                           collectives.Q8_GATHER_SUM_KERNEL)):
        source = kernel.source.read_text()
        assert f'extern "C" int {kernel.symbol}(' in source
        assert kernel.library_path() == other.library_path()
        assert kernel.name != other.name
    # The ctypes mirror of K5b's argument struct names the C struct's
    # fields in order.
    source = device_env.CARTPOLE_KERNEL.source.read_text()
    body = source[source.index("struct CartPoleArgs {"):]
    body = body[:body.index("};")]
    names = [f for f, _ in device_env._CartPoleArgs._fields_]
    positions = [body.index(f" {name};") for name in names]
    assert positions == sorted(positions)


def test_eps_greedy_kernel_has_its_source_and_entry_point():
    kernel = eps_greedy.EPS_GREEDY_KERNEL
    source = kernel.source.read_text()
    assert kernel.source.name == "eps_greedy.cu"
    assert f'extern "C" int {kernel.symbol}(' in source
    assert "kernel_error_string" in source
    # A library of its own, named by its own source.
    assert kernel.library_path().name.startswith("libeps_greedy-")


def test_wrappers_refuse_devices_without_a_kernel():
    frames = torch.zeros(2, 16, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no obs_apply kernel"):
        device_sampler.apply_obs(frames, (4, 4, 1),
                                 done=torch.zeros(2, device="meta"))
    logits = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="no categorical_k kernel"):
        distributions.sample_logp_k(logits, None, False, 2)


def test_build_targets_hopper_and_tracks_the_source(tmp_path):
    kernel = cuda_build.CudaKernel("probe", "vtrace.cu", "vtrace_forward",
                                   [])
    assert kernel.source.is_file()
    assert "-gencode=arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    path = kernel.library_path()
    assert path.parent == cuda_build.BUILD_DIR
    copy = tmp_path / "vtrace.cu"
    copy.write_text(kernel.source.read_text() + "\n// edited\n")
    kernel.source = copy
    assert kernel.library_path() != path


def test_build_all_runs_one_nvcc_per_source(monkeypatch):
    started = []
    monkeypatch.setattr(cuda_build.CudaKernel, "start_build",
                        lambda self, verbose=False:
                        started.append(self.source.name))
    monkeypatch.setattr(cuda_build.CudaKernel, "finish_build",
                        lambda self, proc: "")
    reports = cuda_build.build_all(
        [vtrace.VTRACE_KERNEL, distributions.CATEGORICAL_KERNEL,
         distributions.CATEGORICAL_K_KERNEL,
         device_sampler.OBS_APPLY_KERNEL, device_env.SYNTHETIC_ATARI_KERNEL,
         device_env.CARTPOLE_KERNEL, collectives.Q8_ENCODE_KERNEL,
         collectives.Q8_GATHER_SUM_KERNEL,
         distributions.DIAG_GAUSSIAN_KERNEL])
    assert sorted(started) == ["categorical.cu", "device_env.cu",
                               "diag_gaussian.cu", "obs_apply.cu", "q8.cu",
                               "vtrace.cu"]
    assert sorted(reports) == sorted(started)


def test_launch_count_is_exact_across_threads():
    import threading
    kernel = cuda_build.CudaKernel("probe", "vtrace.cu", "vtrace_forward",
                                   [])
    kernel._fn = lambda *args: 0  # a launch that always succeeds
    threads = [threading.Thread(
        target=lambda: [kernel.launch() for _ in range(2000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernel.launches == 8 * 2000


def test_no_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    from torch.utils import cpp_extension
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
