"""Port parity: the V-trace learner and the IMPALA trainer.

One learner update of the port (`VTraceTorchPolicy`) against the JAX
package's `VTraceJaxPolicy` from identical weights (converted flax ->
torch) and an identical packed batch (B=2 fragments of T=5 steps,
Nature CNN at full width, f32 trunk, on the CPU): the loss, every stat,
the gradients and the parameters after clip + Adam. Then the port's
counterpart of `test_impala.py::TestIMPALA::test_local_mode_learns`.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.agents.impala.vtrace_policy import VTraceJaxPolicy
from ray_tpu.rllib.env.spaces import Box as JaxBox
from ray_tpu.rllib.env.spaces import Discrete as JaxDiscrete
from ray_tpu.rllib.sample_batch import SampleBatch as JaxSampleBatch
from ray_tpu_torch.models import distributions
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer, vtrace
from ray_tpu_torch.rllib.agents.impala.vtrace_policy import VTraceTorchPolicy
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.policy.torch_policy import clip_by_global_norm_
from ray_tpu_torch.rllib.sample_batch import SampleBatch

B, T, A = 2, 5, 6
FRAME = (84, 84, 4)
# Loss and stats: f32 sums of 10 rows through the conv trunk, taken in
# different orders by XLA and PyTorch: rtol 1e-5.
STAT_TOL = 1e-5
# Gradients: measured agreement is ~7e-7 against gradients up to 1.5;
# 2e-6 absolute is ~1e-6 of the largest gradient.
GRAD_ATOL = 2e-6


def _batch_columns(seed=0):
    rng = np.random.default_rng(seed)
    n = B * T
    return {
        sb.OBS: rng.integers(0, 256, (n,) + FRAME, dtype=np.uint8),
        sb.NEW_OBS: rng.integers(0, 256, (n,) + FRAME, dtype=np.uint8),
        sb.ACTIONS: rng.integers(0, A, n),
        sb.REWARDS: rng.standard_normal(n).astype(np.float32),
        sb.DONES: rng.random(n) < 0.2,
        sb.ACTION_DIST_INPUTS: rng.standard_normal((n, A)).astype(
            np.float32),
    }


def _policies(grad_clip):
    cfg = {"model": {"compute_dtype": "f32"}, "rollout_fragment_length": T,
           "seed": 0, "grad_clip": grad_clip}
    jax_policy = VTraceJaxPolicy(JaxBox(0, 255, FRAME, np.uint8),
                                 JaxDiscrete(A), dict(cfg))
    policy = VTraceTorchPolicy(Box(0, 255, FRAME, np.uint8), Discrete(A),
                               dict(cfg, device="cpu"))
    policy.set_weights({k: v.numpy() for k, v in flax_to_state_dict(
        jax_policy.get_weights()).items()})
    return jax_policy, policy


def _as_state_dict(flax_tree):
    return {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, flax_tree)).items()}


@pytest.mark.parametrize("grad_clip", [40.0, 0.01])
def test_one_update_matches_jax_policy(grad_clip):
    """grad_clip 40 leaves the gradients as they are (norm ~16); 0.01
    takes optax's clip branch."""
    jax_policy, policy = _policies(grad_clip)
    cols = _batch_columns()
    w0 = policy.get_weights()

    # Loss, stats and pre-clip gradients.
    jax_grads, jax_stats = jax_policy._grad_fn(
        jax_policy.params, jax_policy._device_batch(JaxSampleBatch(cols)),
        jax_policy._next_rng(), jax_policy.loss_state)
    loss, stats = policy._loss_fn(policy, policy.model, policy._device_batch(
        SampleBatch(cols)))
    loss.backward()
    assert set(stats) == set(jax_stats)
    for k, v in stats.items():
        np.testing.assert_allclose(v.item(), float(jax_stats[k]),
                                   rtol=STAT_TOL, atol=STAT_TOL, err_msg=k)
    jax_grads = _as_state_dict(jax_grads)
    grads = {k: p.grad.numpy() for k, p in policy.model.named_parameters()}
    assert set(grads) == set(jax_grads)
    for k in grads:
        np.testing.assert_allclose(grads[k], jax_grads[k], rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)
    policy.model.zero_grad(set_to_none=True)

    # One full update: clip by global norm, then Adam (eps 1e-7).
    jax_out = jax_policy.learn_on_batch(JaxSampleBatch(cols))
    out = policy.learn_on_batch(SampleBatch(cols))
    assert set(out) == set(jax_out)
    for k in out:
        np.testing.assert_allclose(out[k], jax_out[k], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=k)
    assert (out["grad_gnorm"] > grad_clip) == (grad_clip < 1.0)
    after, jax_after = policy.get_weights(), _as_state_dict(
        jax_policy.get_weights())
    # Adam's first step moves each weight by lr*g/(|g|+eps); a gradient
    # difference d changes that by at most lr*eps*d/(|g|+eps)^2 (and
    # never by more than 2*lr), so the bound is taken per element at
    # d = GRAD_ATOL scaled by the clip factor.
    lr, eps = policy.config["lr"], 1e-7
    scale = min(1.0, grad_clip / out["grad_gnorm"])
    for k in after:
        g = np.abs(jax_grads[k]) * scale
        bound = np.minimum(lr * eps * GRAD_ATOL * scale / (g + eps) ** 2,
                           2 * lr) + 1e-7
        diff = np.abs(after[k] - jax_after[k])
        assert (diff <= bound).all(), (k, diff.max())
        # Both packages really moved the weights, by about lr.
        np.testing.assert_allclose(np.abs(after[k] - w0[k]).max(), lr,
                                   rtol=1e-2)


def test_clip_matches_optax_semantics():
    grads = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = clip_by_global_norm_(grads, 10.0)
    assert float(norm) == 5.0 and grads[0].tolist() == [3.0, 4.0]
    norm = clip_by_global_norm_(grads, 2.5)
    assert float(norm) == 5.0
    np.testing.assert_allclose(grads[0].numpy(), [1.5, 2.0], rtol=1e-7)
    norm = clip_by_global_norm_(grads, None)
    np.testing.assert_allclose(float(norm), 2.5, rtol=1e-7)


def _cartpole_config(**over):
    cfg = {
        "env": "CartPole-v0",
        "num_workers": 0,
        "rollout_fragment_length": 20,
        "train_batch_size": 80,
        "num_envs_per_worker": 2,
        "model": {"fcnet_hiddens": [32, 32]},
        "lr": 0.001,
        "min_iter_time_s": 0,
        "device": "cpu",
    }
    cfg.update(over)
    return cfg


def test_local_mode_learns():
    """Same config, seed and bar as the JAX package's test. The bar is
    close for both packages: over seeds 0-5 the JAX trainer clears it
    for 1 of 6, the port for 2 of 6 (seed 0 is one of them)."""
    t = IMPALATrainer(config=_cartpole_config(lr=0.005, seed=0))
    best = -np.inf
    try:
        for _ in range(30):
            result = t.train()
            r = result.get("episode_reward_mean")
            if r is not None and np.isfinite(r):
                best = max(best, r)
            if best > 40:
                break
    finally:
        t.stop()
    assert np.isfinite(result["info"]["learner"]["total_loss"])
    assert result["num_steps_trained"] > 0
    assert best > 40, best


def test_kernels_run_once_per_step_and_update(monkeypatch):
    """The sampling tail runs once per env step (for all envs at once)
    and V-trace once per update: counted at the wrappers' dispatch on
    the CPU, where the card counts kernel launches."""
    calls = {"sample": 0, "vtrace": 0}
    real_sample, real_vtrace = (distributions.sample_logp,
                                vtrace.from_importance_weights)

    def count_sample(*a, **kw):
        calls["sample"] += 1
        return real_sample(*a, **kw)

    def count_vtrace(*a, **kw):
        calls["vtrace"] += 1
        return real_vtrace(*a, **kw)

    monkeypatch.setattr(distributions, "sample_logp", count_sample)
    monkeypatch.setattr(vtrace, "from_importance_weights", count_vtrace)
    t = IMPALATrainer(config=_cartpole_config(seed=1))
    try:
        for _ in range(2):
            result = t.train()
    finally:
        t.stop()
    assert result["num_steps_sampled"] == 160
    assert calls["sample"] == 160 // 2  # 2 envs per step
    assert calls["vtrace"] == result["num_steps_trained"] // 80 == 2
    assert t.get_policy().model.logits.weight.device.type == "cpu"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def test_policy_state_round_trip():
    cfg = {"model": {"fcnet_hiddens": [8]}, "rollout_fragment_length": T,
           "device": "cpu", "seed": 3}
    a = VTraceTorchPolicy(Box(-1.0, 1.0, (4,)), Discrete(2), dict(cfg))
    b = VTraceTorchPolicy(Box(-1.0, 1.0, (4,)), Discrete(2),
                          dict(cfg, seed=4))
    obs = np.random.default_rng(0).standard_normal((3, 4)).astype(
        np.float32)
    batch = SampleBatch({
        sb.OBS: obs[:1].repeat(T, 0), sb.NEW_OBS: obs[:1].repeat(T, 0),
        sb.ACTIONS: np.zeros(T, np.int64),
        sb.REWARDS: np.ones(T, np.float32), sb.DONES: np.zeros(T, bool),
        sb.ACTION_DIST_INPUTS: np.zeros((T, 2), np.float32)})
    a.learn_on_batch(batch)  # Adam now holds moments
    state = a.get_state()
    b.set_state(state)
    for k, v in a.get_weights().items():
        np.testing.assert_array_equal(b.get_weights()[k], v)
    actions, state_out, extra = a.compute_actions(obs, explore=False)
    assert actions.shape == (3,) and actions.dtype == np.int64
    assert state_out == []
    assert extra[sb.ACTION_DIST_INPUTS].shape == (3, 2)
    np.testing.assert_array_equal(
        actions, b.compute_actions(obs, explore=False)[0])
    np.testing.assert_allclose(a.value_function(obs), extra[sb.VF_PREDS],
                               rtol=1e-6)
    # The saved state is a copy: a later update leaves it as it was.
    moments = [t.clone() for t in _tensors(state["opt_state"])]
    assert moments
    weights = {k: v.copy() for k, v in state["weights"].items()}
    a.learn_on_batch(batch)
    for before, after in zip(moments, _tensors(state["opt_state"])):
        assert torch.equal(before, after)
    for k, v in weights.items():
        np.testing.assert_array_equal(state["weights"][k], v)


def test_validate_config():
    with pytest.raises(ValueError, match="multiple"):
        IMPALATrainer(config=_cartpole_config(
            rollout_fragment_length=30, train_batch_size=100))
    # Minibatches are whole fragments (the reference's check).
    with pytest.raises(ValueError, match="sgd_minibatch_size must be a "
                                         "multiple"):
        IMPALATrainer(config=_cartpole_config(sgd_minibatch_size=30))
    # Remote workers are ported on the local-mode runtime: without it
    # they raise, as the reference's do without `ray_tpu.init()`.
    with pytest.raises(RuntimeError, match=r"init\(local_mode=True\)"):
        IMPALATrainer(config=_cartpole_config(num_workers=2))
    # Inline actors are ported (Sebulba device rollouts); their
    # host-sampler variant is not yet.
    with pytest.raises(NotImplementedError, match="not ported"):
        IMPALATrainer(config=_cartpole_config(
            num_inline_actors=1, device_rollouts=False))
    # Anakin mode is ported: it raises the reference's error for workers.
    with pytest.raises(ValueError, match="anakin mode is fully "
                                         "device-resident"):
        IMPALATrainer(config=_cartpole_config(anakin=True, num_workers=2))
