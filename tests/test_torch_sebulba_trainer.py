"""Port parity: IMPALA on the Sebulba inline-actor path, on the CPU.

The port's counterparts of the JAX package's trainer tests for this path
(`tests/test_sebulba_anakin.py:335`, `tests/test_delta_obs.py:229-272`,
`tests/test_sebulba_pipeline.py:254-326`), with the same configs and
bars, plus `validate_config` held to the reference's errors on the same
configs.
"""

import time

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import pytest

from ray_tpu.rllib.agents.impala import impala as jax_impala
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer, impala
from ray_tpu_torch.rllib.evaluation.device_sampler import \
    DeviceSebulbaSampler

HW = 84 * 84


def _trainer(**config):
    return IMPALATrainer(config=dict(config, num_workers=0,
                                     min_iter_time_s=0, device="cpu"))


def test_inline_sebulba_impala_learns_cartpole():
    """Same config and bar as the JAX package's test: best episode
    reward mean > 60 within 25 iterations, seed 0."""
    t = _trainer(env="CartPole-v0", num_inline_actors=1,
                 num_envs_per_worker=16, rollout_fragment_length=20,
                 train_batch_size=320, lr=3e-3, seed=0)
    best = 0.0
    try:
        for _ in range(25):
            r = t.train()
            rew = r.get("episode_reward_mean")
            if rew == rew:  # not nan
                best = max(best, rew)
            if best > 60:
                break
    finally:
        t.stop()
    assert best > 60, f"inline IMPALA failed to learn: best={best}"


def test_impala_sprite_delta_trains():
    t = _trainer(env="SpriteAtari-v0", env_config={"episode_len": 40},
                 num_inline_actors=1, num_envs_per_worker=4,
                 rollout_fragment_length=10, train_batch_size=40,
                 device_frame_stack=4, seed=0)
    try:
        sampler = t.optimizer._inline_actors[0].sampler
        assert isinstance(sampler, DeviceSebulbaSampler) and sampler.delta
        r = t.train()
        assert r["timesteps_this_iter"] >= 40
        pol = t.workers.local_worker.policy
        assert pol.observation_space.shape == (84, 84, 4)
        # Wire accounting: well under one full frame per step.
        st = sampler.transfer_stats()
        assert st["bytes_h2d"] / max(1, st["steps"]) < HW / 3
    finally:
        t.stop()


def test_obs_delta_false_disables():
    t = _trainer(env="SpriteAtari-v0", env_config={"episode_len": 40},
                 num_inline_actors=1, num_envs_per_worker=2,
                 rollout_fragment_length=5, train_batch_size=10,
                 device_frame_stack=4, obs_delta=False, seed=0)
    try:
        assert not t.optimizer._inline_actors[0].sampler.delta
        t.train()
    finally:
        t.stop()


def test_trainer_rejects_untiled_onchip_steps():
    with pytest.raises(ValueError, match="sebulba_onchip_steps"):
        _trainer(env="CartPole-v0", num_inline_actors=1,
                 num_envs_per_worker=4, rollout_fragment_length=5,
                 train_batch_size=20, sebulba_onchip_steps=2)


def test_host_vector_sampler_is_not_ported():
    with pytest.raises(NotImplementedError, match="VectorSampler"):
        _trainer(env="CartPole-v0", num_inline_actors=1,
                 num_envs_per_worker=2, rollout_fragment_length=5,
                 device_rollouts=False)


def test_sebulba_smoke_accounting():
    """k=5 windows, 2 groups: the accounting carries the lag fields, an
    actor never waits or steps envs longer than wall-clock, and the mean
    selection lag is bounded by (k-1)/2."""
    t0 = time.perf_counter()
    t = _trainer(env="SpriteAtari-v0", env_config={"episode_len": 30},
                 num_inline_actors=1, num_envs_per_worker=4,
                 rollout_fragment_length=10, train_batch_size=40,
                 device_frame_stack=4, sebulba_env_groups=2,
                 sebulba_onchip_steps=5, seed=0)
    try:
        opt = t.optimizer
        sampler = opt._inline_actors[0].sampler
        assert len(sampler.groups) == 2 and sampler.k == 5
        for _ in range(2):
            r = t.train()
        assert r["episodes_this_iter"] >= 0
        transfer = opt.stats()["transfer"]
        for field in ("policy_lag_sum", "fetch_waits", "t_fetch_s",
                      "t_env_s", "steps", "bytes_h2d", "bytes_d2h"):
            assert field in transfer, field
        assert transfer["policy_lag_sum"] > 0
        elapsed = time.perf_counter() - t0
        st = sampler.transfer_stats()
        assert st["t_fetch_s"] <= elapsed
        assert st["t_env_s"] <= elapsed
        assert 0 < st["policy_lag_sum"] / st["steps"] <= 2.0
    finally:
        t.stop()
    assert not any(a.is_alive() for a in opt._inline_actors)


def _base(**over):
    cfg = {"rollout_fragment_length": 5, "train_batch_size": 20,
           "num_envs_per_worker": 4}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("over", [
    {"device_frame_stack": 4},
    {"num_inline_actors": 1, "num_workers": 2},
    {"num_inline_actors": 1, "anakin": True},
    {"num_inline_actors": 1, "sebulba_onchip_steps": 0},
    {"num_inline_actors": 1, "sebulba_onchip_steps": 2},
    {"num_inline_actors": 1, "sebulba_env_groups": 0},
    {"anakin": True, "num_workers": 2},
    {"anakin": True, "model": {"use_lstm": True}},
], ids=["stack-without-actors", "with-workers", "with-anakin", "k0",
        "untiled-k", "groups0", "anakin-with-workers", "anakin-lstm"])
def test_validate_config_errors_match_reference(over):
    with pytest.raises(ValueError) as want:
        jax_impala.validate_config(_base(**over))
    with pytest.raises(ValueError) as got:
        impala.validate_config(_base(**over))
    assert str(got.value) == str(want.value)


def test_validate_config_inline_overrides_match_reference():
    want, got = _base(num_inline_actors=1, train_batch_size=999), \
        _base(num_inline_actors=1, train_batch_size=999)
    jax_impala.validate_config(want)
    impala.validate_config(got)
    for key in ("train_batch_size", "num_envs_per_worker",
                "_inline_num_envs"):
        assert got[key] == want[key], key
    assert got["train_batch_size"] == 20
