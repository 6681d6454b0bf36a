"""Port parity: the trainer's evaluation episodes (`_maybe_evaluate`).

The port's `Trainer` runs `evaluation_num_episodes` episodes on a
separate evaluation worker every `evaluation_interval` iterations, as
the JAX package's `Trainer._maybe_evaluate`/`_evaluate` do
(`ray_tpu/rllib/agents/trainer.py:285-330`): the same iterations carry
an `"evaluation"` result, each summarising at least that many episodes.
The evaluation worker acts without exploring: its actions are the
actor's deterministic ones, and it takes no draw from the learner's
generator or its own.
"""

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import numpy as np
import pytest
import torch

from ray_tpu.rllib.agents.sac import SACTrainer as JaxSACTrainer
from ray_tpu_torch.models import distributions
from ray_tpu_torch.rllib.agents.sac import SACTrainer

CONFIG = {
    "env": "Pendulum-v0",
    "num_workers": 0,
    "actor_hiddens": [16, 16],
    "critic_hiddens": [16, 16],
    "learning_starts": 30,
    "pure_exploration_steps": 20,
    "train_batch_size": 16,
    "timesteps_per_iteration": 40,
    "no_done_at_end": True,
    "evaluation_num_episodes": 2,
    "seed": 0,
}


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_evaluation_comes_every_interval_like_the_jax_trainer(one_thread):
    """interval 2 over 5 iterations: the second and fourth carry
    "evaluation" in both packages, each over >= 2 whole Pendulum
    episodes; without an interval there is none."""
    cfg = dict(CONFIG, evaluation_interval=2)
    port = SACTrainer(config=dict(cfg, device="cpu"))
    ref = JaxSACTrainer(config=dict(cfg))
    try:
        for i in range(5):
            got, want = port.train(), ref.train()
            assert ("evaluation" in got) == ("evaluation" in want) \
                == (i % 2 == 1), i
            if "evaluation" in got:
                for ev in (got["evaluation"], want["evaluation"]):
                    assert ev["episodes_this_iter"] >= 2
                    assert ev["episode_len_mean"] == 200.0
                    assert np.isfinite(ev["episode_reward_mean"])
    finally:
        port.stop()
        ref.stop()
    t = SACTrainer(config=dict(CONFIG, device="cpu"))
    try:
        assert "evaluation" not in t.train()
    finally:
        t.stop()


def test_evaluation_acts_deterministically(one_thread):
    """The evaluation worker's policy acts with `explore=False`: every
    action is the squashed mean of the learner's actor at that
    observation (its weights synced first), and neither the learner's
    generator nor the evaluation policy's takes a draw."""
    t = SACTrainer(config=dict(CONFIG, device="cpu",
                               evaluation_interval=1,
                               evaluation_num_episodes=1))
    try:
        t.train()
        learner = t.get_policy()
        ev_policy = t._eval_worker.policy
        seen = []
        real = ev_policy.compute_actions

        def record(obs, *args, explore=True, **kwargs):
            actions = real(obs, *args, explore=explore, **kwargs)
            seen.append((np.array(obs), explore, actions[0]))
            return actions

        ev_policy.compute_actions = record
        states = [learner.generator.get_state(),
                  ev_policy.generator.get_state()]
        np_state = ev_policy._np_rng.get_state()[1].copy()
        result = t._evaluate()
        assert result["episodes_this_iter"] >= 1
        assert len(seen) == 200 and not any(e for _, e, _ in seen)
        assert torch.equal(learner.generator.get_state(), states[0])
        assert torch.equal(ev_policy.generator.get_state(), states[1])
        np.testing.assert_array_equal(ev_policy._np_rng.get_state()[1],
                                      np_state)
        for obs, _, actions in seen:
            with torch.no_grad():
                want, _ = distributions.squashed_gaussian_sample_logp(
                    learner.actor(torch.from_numpy(obs)), None, learner.low,
                    learner.high, explore=False)
            np.testing.assert_array_equal(actions, want.numpy())
    finally:
        t.stop()
