"""Port parity: DQN and SimpleQ in local mode, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
DQN pieces and the port's:
- `QNetwork` on converted weights (flax -> torch): frames through the
  bf16 conv trunk within bf16 tolerance, flat observations within 1e-5;
  dueling and not;
- `dqn_loss` and one `learn_with_td` of `DQNPolicy`, from the same
  online and target weights on the same batch, with double Q on and
  off, n-step 3 and importance weights;
- `adjust_nstep`, the segment trees and the replay buffers (the same
  rows and importance weights at the same indexes);
- the epsilon-greedy tail's plain version (K8's): at epsilon 0 equal to
  JAX's `eps_action_fn` on the same Q-values, at 0.3 and 1 by
  distribution;
- the counterparts of `tests/test_dqn.py`'s trainer tests, with the
  same configs and bars.

The trainer tests run torch on one thread: the ops are tiny, and more
threads only contend (the CartPole bar takes ~20 s on one, minutes on
eight). With one seed the learning run is deterministic.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models.networks import QNetwork as JaxQNetwork
from ray_tpu.rllib.agents.dqn import dqn_policy as jax_dqn_policy
from ray_tpu.rllib.env.spaces import Box as JaxBox
from ray_tpu.rllib.env.spaces import Discrete as JaxDiscrete
from ray_tpu.rllib.optimizers import replay_buffer as jax_replay
from ray_tpu.rllib.optimizers import segment_tree as jax_tree
from ray_tpu.rllib.sample_batch import SampleBatch as JaxSampleBatch
from ray_tpu_torch.models import eps_greedy as k8
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.models.networks import QNetwork
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.agents.dqn import (DEFAULT_CONFIG, DQNPolicy,
                                            DQNTrainer, SimpleQTrainer)
from ray_tpu_torch.rllib.agents.dqn import dqn_policy
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.optimizers import replay_buffer, segment_tree
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.utils.schedules import LinearSchedule

# f32 on the CPU: means over 32 rows through two 16-wide layers, summed
# in other orders by XLA and PyTorch: 1e-5.
STAT_TOL = 1e-5
# One Adam step from the same weights: each weight within 1e-4 of
# JAX's, relative (atol 1e-6 for weights near 0).
WEIGHT_RTOL, WEIGHT_ATOL = 1e-4, 1e-6
FRAME = (84, 84, 4)
OBS_DIM, NUM_ACTIONS = 4, 3


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _state(tree):
    return {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, tree)).items()}


# ---------------------------------------------------------------------
# QNetwork
# ---------------------------------------------------------------------
@pytest.mark.parametrize("image", [True, False], ids=["frames", "flat"])
@pytest.mark.parametrize("dueling", [True, False],
                         ids=["dueling", "plain"])
def test_qnetwork_matches_flax(image, dueling):
    """Frames: the conv trunk in bf16 in both packages, so the bound is
    one bf16 ulp (2^-8) of the outputs' scale; flat: f32, 1e-5."""
    rng = np.random.default_rng(3)
    shape = FRAME if image else (OBS_DIM,)
    obs = (rng.integers(0, 256, (5,) + shape, dtype=np.uint8) if image
           else rng.standard_normal((5,) + shape).astype(np.float32))
    hiddens = (32,) if image else (16, 16)
    jax_model = JaxQNetwork(num_actions=6, hiddens=hiddens,
                            dueling=dueling)
    params = jax_model.init(jax.random.PRNGKey(0), obs[:1])
    model = QNetwork(shape, 6, hiddens=hiddens, dueling=dueling)
    model.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    assert model.compute_dtype == torch.bfloat16
    want_q, want_max = (np.asarray(x) for x in jax_model.apply(params, obs))
    with torch.no_grad():
        q, q_max = (x.numpy() for x in model(torch.from_numpy(obs)))
    assert q.dtype == np.float32 and q.shape == (5, 6)
    tol = 2.0 ** -8 * np.abs(want_q).max() if image else STAT_TOL
    np.testing.assert_allclose(q, want_q, rtol=0 if image else tol,
                               atol=tol)
    np.testing.assert_allclose(q_max, want_max, rtol=0 if image else tol,
                               atol=tol)
    np.testing.assert_array_equal(q_max, q.max(-1))


# ---------------------------------------------------------------------
# the policy: dqn_loss and learn_with_td
# ---------------------------------------------------------------------
def _policy_config(double_q, n_step):
    return {"double_q": double_q, "dueling": True, "n_step": n_step,
            "hiddens": [16], "model": {"fcnet_hiddens": [16]},
            "lr": 1e-3, "gamma": 0.95, "seed": 0}


def _policies(double_q, n_step):
    """(JAX DQNPolicy, port DQNPolicy) with the same online weights and
    the same target weights (the target perturbed away from the
    online network)."""
    cfg = _policy_config(double_q, n_step)
    jax_pol = jax_dqn_policy.DQNPolicy(
        JaxBox(-1.0, 1.0, (OBS_DIM,)), JaxDiscrete(NUM_ACTIONS), cfg)
    online = jax.tree.map(np.asarray, jax_pol.get_weights()["online"])
    rng = np.random.default_rng(1)
    target = jax.tree.map(
        lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(
            np.float32), online)
    jax_pol.set_weights({"online": online, "target": target})
    pol = DQNPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(NUM_ACTIONS),
                    dict(cfg, device="cpu"))
    pol.set_weights({"online": _state(online), "target": _state(target)})
    return jax_pol, pol


def _batch(n=32, weights=True, seed=2):
    rng = np.random.default_rng(seed)
    cols = {
        sb.OBS: rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, NUM_ACTIONS, n),
        sb.REWARDS: rng.standard_normal(n).astype(np.float32),
        sb.NEW_OBS: rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        sb.DONES: rng.random(n) < 0.25,
    }
    if weights:
        cols["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return cols


CASES = [(True, 1, True), (False, 1, True), (True, 3, True),
         (False, 3, False)]
CASE_IDS = ["double-q", "no-double-q", "double-q-nstep3",
            "nstep3-no-weights"]


@pytest.mark.parametrize("double_q,n_step,weights", CASES, ids=CASE_IDS)
def test_dqn_loss_matches_jax(double_q, n_step, weights):
    jax_pol, pol = _policies(double_q, n_step)
    cols = _batch(weights=weights)
    jax_batch = {k: jax.numpy.asarray(
        v.astype(np.float32) if v.dtype == np.bool_ else v)
        for k, v in cols.items()}
    _, want = jax_dqn_policy.dqn_loss(
        jax_pol, jax_pol.params, jax_batch, jax.random.PRNGKey(0),
        jax_pol.loss_state)
    loss, got = dqn_policy.dqn_loss(pol, pol.model,
                                    pol._device_batch(SampleBatch(cols)))
    assert got["loss"] is loss and loss.requires_grad
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=k)


@pytest.mark.parametrize("double_q,n_step,weights", CASES, ids=CASE_IDS)
def test_learn_with_td_matches_jax(double_q, n_step, weights):
    """One update: the stats (with `grad_gnorm`) and |td| within 1e-5,
    the updated online weights within 1e-4 relative; the target is not
    touched."""
    jax_pol, pol = _policies(double_q, n_step)
    cols = _batch(weights=weights)
    target_before = pol.get_weights()["target"]
    want, want_td = jax_pol.learn_with_td(JaxSampleBatch(cols))
    got, got_td = pol.learn_with_td(SampleBatch(cols))
    assert set(got) == set(want) and "grad_gnorm" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=STAT_TOL, atol=STAT_TOL,
                                   err_msg=k)
    assert got_td.dtype == np.float32 and got_td.shape == (32,)
    np.testing.assert_allclose(got_td, want_td, rtol=STAT_TOL,
                               atol=STAT_TOL)
    assert pol.global_timestep == jax_pol.global_timestep == 32
    weights_now = pol.get_weights()
    want_online = _state(jax_pol.get_weights()["online"])
    for k, v in want_online.items():
        np.testing.assert_allclose(weights_now["online"][k], v,
                                   rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL,
                                   err_msg=k)
    for k, v in target_before.items():
        np.testing.assert_array_equal(weights_now["target"][k], v)


def test_compute_actions_returns_actions_only():
    _, pol = _policies(True, 1)
    obs = _batch()[sb.OBS]
    pol.set_epsilon(0.0)
    actions, state, extra = pol.compute_actions(obs)
    assert state == [] and extra == {}
    assert actions.dtype == np.int64 and actions.shape == (32,)
    with torch.no_grad():
        q, _ = pol.model(torch.from_numpy(obs))
    np.testing.assert_array_equal(actions, q.argmax(-1).numpy())
    # Not exploring ignores epsilon.
    pol.set_epsilon(1.0)
    actions, _, _ = pol.compute_actions(obs, explore=False)
    np.testing.assert_array_equal(actions, q.argmax(-1).numpy())


def test_target_network_is_a_frozen_copy():
    _, pol = _policies(True, 1)
    assert all(not p.requires_grad for p in pol.target_model.parameters())
    assert all(p.requires_grad for p in pol.model.parameters())
    assert pol.loss_state == {}
    pol.learn_with_td(SampleBatch(_batch()))
    pol.update_target()
    for a, b in zip(pol.model.parameters(), pol.target_model.parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_get_and_set_state_carry_target_and_epsilon():
    _, pol = _policies(True, 3)
    pol.learn_with_td(SampleBatch(_batch()))
    pol.set_epsilon(0.25)
    state = pol.get_state()
    assert set(state["weights"]) == {"online", "target"}
    _, other = _policies(False, 1)
    other.set_state(state)
    assert other.cur_epsilon == 0.25
    assert other.global_timestep == 32
    for which in ("online", "target"):
        for k, v in state["weights"][which].items():
            np.testing.assert_array_equal(other.get_weights()[which][k], v)
    # A bare state dict sets the online network only.
    online = {k: v + 1.0 for k, v in state["weights"]["online"].items()}
    other.set_weights(online)
    np.testing.assert_array_equal(other.get_weights()["online"]["fc_0.bias"],
                                  online["fc_0.bias"])


@pytest.mark.parametrize("over,match", [
    ({"worker_side_prioritization": True}, "A6"),
    ({"num_gpus_for_learner": 2}, "A8"),
])
def test_unported_options_raise(over, match):
    with pytest.raises(NotImplementedError, match=match):
        DQNPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(NUM_ACTIONS),
                  dict(_policy_config(True, 1), device="cpu", **over))
    with pytest.raises(ValueError, match="Discrete"):
        DQNPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Box(-1.0, 1.0, (2,)),
                  {"device": "cpu"})


def test_atari_q_network_is_the_full_width_one():
    """DEFAULT_CONFIG on 84x84x4 frames: the Nature conv trunk (3,136
    features) straight into one 256-unit layer and the dueling head;
    the same parameter count as the JAX package's network."""
    cfg = dict(DEFAULT_CONFIG, device="cpu", seed=0)
    pol = DQNPolicy(Box(0, 255, FRAME, np.uint8), Discrete(6), cfg)
    names = [n for n, _ in pol.model.named_children()]
    assert names == ["conv_0", "conv_1", "conv_2", "fc_0", "advantage",
                     "state_value"]
    assert pol.model.fc_0.in_features == 3136
    assert pol.model.fc_0.out_features == 256
    jax_model = JaxQNetwork(num_actions=6, hiddens=(256,))
    params = jax_model.init(jax.random.PRNGKey(0),
                            np.zeros((1,) + FRAME, np.uint8))
    assert pol.num_params() == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert pol.model.activation is torch.nn.functional.relu


# ---------------------------------------------------------------------
# n-step, segment trees, replay buffers
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n_step", [1, 3, 5])
def test_adjust_nstep_matches_jax(n_step):
    rng = np.random.default_rng(n_step)
    L = 7
    cols = {sb.OBS: rng.standard_normal((L, 2)).astype(np.float32),
            sb.ACTIONS: rng.integers(0, 2, L),
            sb.REWARDS: rng.standard_normal(L).astype(np.float32),
            sb.NEW_OBS: rng.standard_normal((L, 2)).astype(np.float32),
            sb.DONES: np.arange(L) == L - 1}
    want = JaxSampleBatch({k: v.copy() for k, v in cols.items()})
    got = SampleBatch({k: v.copy() for k, v in cols.items()})
    jax_dqn_policy.adjust_nstep(n_step, 0.9, want)
    dqn_policy.adjust_nstep(n_step, 0.9, got)
    for k in cols:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bad = SampleBatch({k: v.copy() for k, v in cols.items()})
    bad[sb.DONES] = np.arange(L) == 2
    with pytest.raises(ValueError, match="middle"):
        dqn_policy.adjust_nstep(3, 0.9, bad)


def test_segment_trees_match_jax():
    """The same updates give the same trees, leaf for leaf and node for
    node, and the same prefix-sum leaves."""
    rng = np.random.default_rng(0)
    cap = 100
    trees = [(jax_tree.SumSegmentTree(cap), segment_tree.SumSegmentTree(cap)),
             (jax_tree.MinSegmentTree(cap), segment_tree.MinSegmentTree(cap))]
    for _ in range(20):
        idxs = rng.integers(0, cap, 10)
        vals = rng.uniform(0.1, 5.0, 10)
        for want, got in trees:
            want.set_items(idxs, vals)
            got.set_items(idxs, vals)
    for want, got in trees:
        np.testing.assert_array_equal(got._tree, want._tree)
    (want_sum, got_sum), (want_min, got_min) = trees
    assert got_sum.sum() == want_sum.sum()
    assert got_min.min() == want_min.min()
    mass = rng.uniform(0, got_sum.sum(), 500)
    np.testing.assert_array_equal(got_sum.find_prefixsum_idx(mass),
                                  want_sum.find_prefixsum_idx(mass))


def _rows(n, offset=0, seed=0):
    rng = np.random.default_rng(seed)
    return {sb.OBS: np.arange(offset, offset + n,
                              dtype=np.float32)[:, None],
            sb.ACTIONS: rng.integers(0, 2, n),
            sb.REWARDS: rng.standard_normal(n).astype(np.float32),
            sb.NEW_OBS: np.arange(offset, offset + n,
                                  dtype=np.float32)[:, None] + 0.5,
            sb.DONES: rng.random(n) < 0.1}


def _fill(buffers, prioritized):
    """The same adds (wrapping the ring) and priority updates."""
    rng = np.random.default_rng(5)
    for i, n in enumerate((30, 25, 20)):
        cols = _rows(n, offset=100 * i, seed=i)
        for buf, batch_cls in buffers:
            buf.add_batch(batch_cls({k: v.copy() for k, v in cols.items()}))
        if prioritized:
            idxes = rng.integers(0, 64, 16)
            prios = rng.uniform(0.0, 3.0, 16)
            prios[0] = 0.0  # clamped to 1e-8
            for buf, _ in buffers:
                buf.update_priorities(idxes, prios)


@pytest.mark.parametrize("prioritized", [True, False],
                         ids=["prioritized", "uniform"])
def test_replay_buffers_match_jax_at_the_same_indexes(prioritized):
    if prioritized:
        want = jax_replay.PrioritizedReplayBuffer(64, alpha=0.6)
        got = replay_buffer.PrioritizedReplayBuffer(
            64, np.random.default_rng(0), alpha=0.6)
    else:
        want = jax_replay.ReplayBuffer(64)
        got = replay_buffer.ReplayBuffer(64, np.random.default_rng(0))
    _fill([(want, JaxSampleBatch), (got, SampleBatch)], prioritized)
    assert len(got) == len(want) == 64
    idxs = np.random.default_rng(9).integers(0, 64, 48)
    for buf in (want, got):
        buf.sample_idxes = lambda batch_size, _i=idxs: _i
    if prioritized:
        want_batch, want_idx = want.sample(48, beta=0.4)
        got_batch, got_idx = got.sample(48, beta=0.4)
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(got._sum_tree._tree,
                                      want._sum_tree._tree)
        assert got.stats() == want.stats()
    else:
        want_batch, got_batch = want.sample(48), got.sample(48)
    assert set(got_batch) == set(want_batch)
    for k in want_batch:
        np.testing.assert_array_equal(got_batch[k], want_batch[k],
                                      err_msg=k)


def test_prioritized_sampling_follows_the_generator():
    """Two buffers with generators of one seed draw the same indexes;
    the stratified draws land where the masses put them (index 7 holds
    nearly all the mass)."""
    bufs = [replay_buffer.PrioritizedReplayBuffer(
        64, np.random.default_rng(11), alpha=1.0) for _ in range(2)]
    for buf in bufs:
        buf.add_batch(SampleBatch(_rows(64)))
        prios = np.full(64, 1e-6)
        prios[7] = 1.0
        buf.update_priorities(np.arange(64), prios)
    a, b = (buf.sample(100, beta=0.4)[1] for buf in bufs)
    np.testing.assert_array_equal(a, b)
    assert (a == 7).mean() > 0.95
    uniform = [replay_buffer.ReplayBuffer(64, np.random.default_rng(3))
               for _ in range(2)]
    for buf in uniform:
        buf.add_batch(SampleBatch(_rows(64)))
    np.testing.assert_array_equal(uniform[0].sample_idxes(50),
                                  uniform[1].sample_idxes(50))


# ---------------------------------------------------------------------
# K8's plain version against eps_action_fn
# ---------------------------------------------------------------------
def _jax_eps_actions(q, eps, seed=0):
    """JAX's `eps_action_fn` on the given Q-values: a JAX DQNPolicy
    whose forward returns its input (patched before the first trace)."""
    pol = jax_dqn_policy.DQNPolicy(
        JaxBox(-1.0, 1.0, (q.shape[1],)), JaxDiscrete(q.shape[1]),
        {"hiddens": [4], "seed": 0})
    pol.apply = lambda params, obs: (obs, obs.max(-1))
    actions, _, _ = pol._eps_action_fn(pol.params, jax.numpy.asarray(q),
                                       jax.random.PRNGKey(seed), eps)
    return np.asarray(actions)


def _q_values(B, A, seed=0):
    """Random Q-values with ties, -inf, a NaN row and an all-NaN row."""
    rng = np.random.default_rng(seed)
    q = np.round(rng.standard_normal((B, A)), 1).astype(np.float32)
    q[0] = 1.5  # all tied
    q[1, 2] = np.nan
    q[2, :] = np.nan
    q[3, 0] = np.inf
    q[4, :] = -np.inf
    return q


def test_eps_greedy_plain_at_zero_equals_jax():
    q = _q_values(257, 6)
    u = torch.from_numpy(np.random.default_rng(1).random(
        (257, 2)).astype(np.float32))
    got = k8.eps_greedy(torch.from_numpy(q), u, 0.0)
    want = _jax_eps_actions(q, 0.0)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0 and got[1] == 2 and got[2] == 0 and got[3] == 0 \
        and got[4] == 0


@pytest.mark.parametrize("eps", [0.3, 1.0])
def test_eps_greedy_plain_distribution(eps):
    """The random share is eps and the random actions are uniform (each
    within 5 standard deviations); the share of non-greedy actions is
    eps (A-1)/A for the port and for JAX's eps_action_fn alike."""
    B, A = 20000, 6
    q = np.random.default_rng(2).standard_normal((B, A)).astype(np.float32)
    u = np.random.default_rng(3).random((B, 2)).astype(np.float32)
    got = k8.eps_greedy(torch.from_numpy(q), torch.from_numpy(u),
                        eps).numpy()
    greedy = q.argmax(-1)
    took = u[:, 0] < eps
    share_sd = np.sqrt(eps * (1 - eps) / B) + 1e-12
    assert abs(took.mean() - eps) <= 5 * share_sd + 1e-9
    np.testing.assert_array_equal(got[~took], greedy[~took])
    counts = np.bincount(got[took], minlength=A)
    n = took.sum()
    sd = np.sqrt(n * (1 / A) * (1 - 1 / A))
    assert np.all(np.abs(counts - n / A) <= 5 * sd), counts
    want = _jax_eps_actions(q, eps)
    p = eps * (A - 1) / A
    sd = np.sqrt(p * (1 - p) / B) + 1e-12
    for actions in (got, want):
        assert abs((actions != greedy).mean() - p) <= 5 * sd


def test_eps_greedy_takes_the_last_action_at_the_top_uniform():
    q = torch.zeros(2, 4)
    u = torch.tensor([[0.0, np.nextafter(np.float32(1), np.float32(0))],
                      [0.0, 0.0]])
    assert k8.eps_greedy(q, u, 0.5).tolist() == [3, 0]


def test_eps_greedy_refuses_a_device_without_a_kernel():
    q = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="no eps_greedy kernel"):
        k8.eps_greedy(q, torch.zeros(2, 2, device="meta"), 0.1)


# ---------------------------------------------------------------------
# the trainers: tests/test_dqn.py's configs and bars
# ---------------------------------------------------------------------
def dqn_config(**overrides):
    cfg = {
        "env": "CartPole-v0",
        "num_workers": 0,
        "learning_starts": 500,
        "buffer_size": 20000,
        "train_batch_size": 64,
        "rollout_fragment_length": 4,
        "num_envs_per_worker": 1,
        "exploration_timesteps": 4000,
        "exploration_final_eps": 0.02,
        # trained-steps keyed (reference semantics): ~every 62 train
        # batches at batch 64 == every ~250 sampled steps here.
        "target_network_update_freq": 4000,
        "timesteps_per_iteration": 500,
        "lr": 1e-3,
        "hiddens": [64],
        "model": {"fcnet_hiddens": [64]},
        "seed": 0,
        "device": "cpu",
    }
    cfg.update(overrides)
    return cfg


def test_dqn_learns_cartpole(one_thread):
    """The JAX test's bar: best episode reward mean >= 70 within 60
    iterations, seed 0."""
    t = DQNTrainer(config=dqn_config())
    best = 0
    try:
        for _ in range(60):
            r = t.train()
            best = max(best, r["episode_reward_mean"])
            if best >= 70:
                break
    finally:
        t.stop()
    assert best >= 70, f"DQN failed to learn: best={best}"


def test_simpleq_trains(one_thread):
    t = SimpleQTrainer(config=dqn_config(
        timesteps_per_iteration=300, learning_starts=200))
    try:
        r = t.train()
        assert r["num_steps_sampled"] >= 300
        assert r["num_steps_trained"] > 0
        assert np.isfinite(r["info"]["learner"].get("loss", 0.0))
        pol = t.get_policy()
        # SimpleQ: no double Q, no dueling head, uniform replay.
        assert not pol.config["double_q"] and not pol.model.dueling
        assert type(t.optimizer.replay_buffer) is replay_buffer.ReplayBuffer
    finally:
        t.stop()


def test_target_network_updates(one_thread):
    t = SimpleQTrainer(config=dqn_config(
        timesteps_per_iteration=300, learning_starts=100,
        target_network_update_freq=250))
    try:
        r = t.train()
        assert r["info"]["num_target_updates"] >= 1
        pol = t.get_policy()
        online = [p.detach().numpy().copy()
                  for p in pol.model.parameters()]
        target = [p.detach().numpy().copy()
                  for p in pol.target_model.parameters()]
        # Target synced within the last 100 steps, then online kept
        # training — they differ but not wildly.
        diffs = [np.abs(o - tg).max() for o, tg in zip(online, target)]
        assert any(d > 0 for d in diffs)
        pol.update_target()
        for o, tg in zip(online, pol.target_model.parameters()):
            np.testing.assert_allclose(o, tg.detach().numpy(), rtol=1e-6)
    finally:
        t.stop()


def test_epsilon_annealing(one_thread):
    t = SimpleQTrainer(config=dqn_config(
        exploration_timesteps=600, timesteps_per_iteration=400,
        learning_starts=100))
    try:
        r = t.train()
        # Annealed on sampled steps: 400 of 600 after one iteration.
        assert r["info"]["exploration_epsilon"] == pytest.approx(
            LinearSchedule(600, 0.02).value(r["num_steps_sampled"]))
        t.train()
        eps = t.get_policy().cur_epsilon
        assert eps == pytest.approx(0.02, abs=1e-6)
    finally:
        t.stop()


def test_dqn_trainer_runs_prioritized_replay(one_thread):
    """DQNTrainer's defaults: prioritized replay with priorities written
    back, n-step folding through the policy's postprocess hook."""
    t = DQNTrainer(config=dqn_config(
        timesteps_per_iteration=200, learning_starts=100, n_step=3))
    try:
        r = t.train()
        buf = t.optimizer.replay_buffer
        assert type(buf) is replay_buffer.PrioritizedReplayBuffer
        assert r["replay_buffer"]["max_priority"] != 1.0
        assert r["num_steps_trained"] == 64 * ((200 - 100) // 4 + 1)
        assert t.get_policy().model.dueling
    finally:
        t.stop()
