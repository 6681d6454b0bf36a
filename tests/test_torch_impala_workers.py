"""Port parity: IMPALA with remote rollout workers on the local-mode
runtime, fed versioned weight syncs.

- The counterpart of `test_impala.py::TestIMPALA::
  test_async_optimizer_with_workers` (`:198-207`) and of
  `test_weight_sync.py::TestOptimizerIntegration::
  test_impala_remote_workers_delta_sync` (`:580-596`): CartPole-v0 with
  2 workers on the CPU; steps are sampled and trained, the weights are
  broadcast as q8 deltas after the first full sync with no stale
  fallback, and every worker holds the broadcaster's receiver-view base
  bit for bit.
- The counterpart of `TestWeightBroadcaster::test_version_skip_and_routing`
  (`:461`), on real rollout workers: version skip, delta-or-full
  routing, and a worker whose decoder was reset acks "stale" and gets
  the full payload at the same version.
- The full-width Nature CNN, loaded from the JAX policy's weights
  through `models/convert.py`: after a full sync a worker's logits equal
  the learner's bit for bit; after a delta sync its weights lie within
  one q8 step of the learner's.
- `WorkerSet.sync_weights` and `sync_filters` over 2 remote workers.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib.agents.impala.vtrace_policy import VTraceJaxPolicy
from ray_tpu.rllib.env.spaces import Box as JaxBox
from ray_tpu.rllib.env.spaces import Discrete as JaxDiscrete
from ray_tpu_torch._private import serialization, weight_sync
from ray_tpu_torch._private.weight_sync import WeightSyncPayload
from ray_tpu_torch.models.convert import flax_to_state_dict
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
from ray_tpu_torch.rllib.agents.impala.vtrace_policy import VTraceTorchPolicy
from ray_tpu_torch.rllib.env.registry import make_env
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.utils.weight_broadcast import WeightBroadcaster


@pytest.fixture
def port_local():
    ray_tpu_torch.init(local_mode=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _vec(tree):
    return weight_sync.flatten_f32(tree)[0]


def q8_step_bound(payloads, n):
    """Per element, half a q8 step of the delta that built the current
    version: max|block| / 254 (the scale over 2), zero after a full
    sync."""
    bound = np.zeros(n, np.float32)
    for p in payloads:
        if p.codec == "q8_delta":
            scales = np.repeat(p.scales, serialization.Q8_BLOCK)
            bound[p.start:p.stop] = scales[:p.stop - p.start] / 2
    return bound


def check_worker_holds_base(broadcaster, worker, learner_weights):
    """After a version-gated sync: the worker's weights are the
    receiver-view base bit for bit, and within half a q8 step (plus f32
    rounding) of the learner's weights at that version."""
    broadcaster.sync(worker)
    broadcaster.drain_acks()
    assert ray_tpu_torch.get(worker.weight_sync_version.remote()) \
        == broadcaster.version
    got = _vec(ray_tpu_torch.get(worker.get_weights.remote()))
    assert got.tobytes() == broadcaster.encoder.base.tobytes()
    true = _vec(learner_weights)
    bound = q8_step_bound(broadcaster.payloads(), true.size)
    err = np.abs(got - true)
    assert np.all(err <= bound + 2 * np.spacing(np.abs(true)))


def _cartpole_config(**over):
    cfg = {"env": "CartPole-v0", "num_workers": 2, "num_envs_per_worker": 2,
           "rollout_fragment_length": 20, "train_batch_size": 80,
           "model": {"fcnet_hiddens": [16, 16]}, "lr": 1e-3,
           "min_iter_time_s": 0, "seed": 0, "device": "cpu",
           "weight_sync_codec": "q8_delta"}
    cfg.update(over)
    return cfg


def test_async_optimizer_with_workers(port_local):
    t = IMPALATrainer(config=_cartpole_config())
    try:
        for _ in range(3):
            result = t.train()
        stats = t.optimizer.stats()
        assert result["num_steps_trained"] > 0
        assert result["num_steps_sampled"] > 0
        assert result["episodes_this_iter"] > 0
        assert np.isfinite(result["info"]["learner"]["total_loss"])
        assert stats["num_weight_broadcasts"] >= 1
        assert stats["weight_sync_codec"] == "q8_delta"
        assert stats["num_weight_sync_stale_fallbacks"] == 0
        bc = t.optimizer.broadcaster
        assert bc.version >= 2 and bc.payloads()[0].codec == "q8_delta"
        for w in t.workers.remote_workers:
            check_worker_holds_base(bc, w, bc.encoder.weights)
        # The workers were built on the trainer's device, from their own
        # seeds, and sampled with their own policies.
        policies = [ray_tpu_torch.get(w.get_policy.remote())
                    for w in t.workers.remote_workers]
        assert all(p.device == torch.device("cpu") for p in policies)
        assert policies[0] is not policies[1] is not t.get_policy()
    finally:
        t.stop()


@pytest.mark.parametrize("codec", ["full", "auto"])
def test_workers_follow_the_full_codec(port_local, codec):
    # "auto" is the full codec under the local-mode runtime (q8_delta on
    # the multi-process one, `test_torch_impala_procs.py`).
    t = IMPALATrainer(config=_cartpole_config(weight_sync_codec=codec,
                                              num_workers=1))
    try:
        t.train()
        bc = t.optimizer.broadcaster
        assert bc.encoder.codec == "full"
        assert bc.payloads()[0].codec == "full"
        w = t.workers.remote_workers[0]
        check_worker_holds_base(bc, w, bc.encoder.weights)
    finally:
        t.stop()


def test_no_weight_plane_without_workers(port_local):
    # The remote path's state is built only for remote workers, so the
    # codec setting cannot touch a run that has none.
    t = IMPALATrainer(config=_cartpole_config(
        num_workers=0, weight_sync_codec="zstd-9000"))
    try:
        assert t.optimizer.broadcaster is None
        assert t.optimizer.num_weight_broadcasts == 0
        assert not hasattr(t.optimizer, "sample_tasks")
        assert "weight_sync_version" not in t.optimizer.stats()
    finally:
        t.stop()


def test_remote_workers_need_the_local_runtime():
    """Remote workers need a runtime (local mode, as in this module, or
    the multi-process one of `test_torch_impala_procs.py`): without one
    the trainer refuses before it builds anything."""
    with pytest.raises(RuntimeError, match=r"ray_tpu_torch\.init\(\)"):
        IMPALATrainer(config=_cartpole_config())


class CountingWorker(RolloutWorker):
    """A rollout worker that records every payload it receives."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seen = []

    def set_weights(self, weights):
        status = super().set_weights(weights)
        if isinstance(weights, WeightSyncPayload):
            self.seen.append((weights.codec, weights.version,
                              status["status"]))
        return status

    def payloads_seen(self):
        return list(self.seen)


def _cartpole_worker(index):
    cls = ray_tpu_torch.remote(CountingWorker)
    return cls.remote(
        lambda cfg: make_env("CartPole-v0", cfg), VTraceTorchPolicy,
        {"model": {"fcnet_hiddens": [16, 16]}, "device": "cpu",
         "rollout_fragment_length": 10},
        rollout_fragment_length=10, worker_index=index, seed=0,
        pack_fragments=True)


def test_version_skip_and_routing(port_local):
    learner = VTraceTorchPolicy(
        Box(-1.0, 1.0, (4,)), Discrete(2),
        {"model": {"fcnet_hiddens": [16, 16]}, "device": "cpu", "seed": 0})
    state = {"w": learner.get_weights()}
    a, b = _cartpole_worker(1), _cartpole_worker(2)
    bc = WeightBroadcaster(lambda: state["w"], codec="q8_delta")
    bc.broadcast()
    assert bc.sync(a)
    # Same version again: skipped, nothing re-sent.
    assert not bc.sync(a)
    assert bc.num_skipped == 1
    rng = np.random.default_rng(11)
    state["w"] = {k: v + (1e-3 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in state["w"].items()}
    bc.broadcast()
    bc.sync(a)   # held v1 -> gets the v2 delta
    bc.sync(b)   # never synced -> gets the v2 full blob
    bc.drain_acks()
    assert ray_tpu_torch.get(a.payloads_seen.remote()) == [
        ("full", 1, "ok"), ("q8_delta", 2, "ok")]
    assert ray_tpu_torch.get(b.payloads_seen.remote()) == [
        ("full", 2, "ok")]
    assert bc.num_stale_fallbacks == 0

    # A raw-dict set_weights leaves the versioned stream: `a`'s decoder
    # resets, so the v3 delta routed to it (it held v2) acks stale and
    # the broadcaster sends the full payload of the same version.
    assert ray_tpu_torch.get(a.set_weights.remote(state["w"])) == {
        "status": "ok", "version": 0}
    state["w"] = {k: v * np.float32(1.001) for k, v in state["w"].items()}
    bc.broadcast()
    bc.sync(a)
    bc.drain_acks()
    assert ray_tpu_torch.get(a.payloads_seen.remote())[2:] == [
        ("q8_delta", 3, "stale"), ("full", 3, "ok")]
    assert bc.num_stale_fallbacks == 1
    assert bc.stats()["num_weight_sync_stale_fallbacks"] == 1
    for w in (a, b):
        check_worker_holds_base(bc, w, state["w"])
    # sync_all_blocking: one broadcast, every worker on the new version.
    state["w"] = {k: v + np.float32(1e-3) for k, v in state["w"].items()}
    bc.sync_all_blocking([a, b])
    assert bc.version == 4
    for w in (a, b):
        assert ray_tpu_torch.get(w.payloads_seen.remote())[-1] \
            == ("q8_delta", 4, "ok")
        check_worker_holds_base(bc, w, state["w"])


def test_nature_cnn_from_jax_weights_through_a_sync(port_local):
    """The full-width Nature CNN, its weights the JAX policy's
    (converted), synced to a rollout worker on SyntheticAtari-v0."""
    cfg = {"model": {"compute_dtype": "f32"}, "device": "cpu", "seed": 0,
           "rollout_fragment_length": 5}
    jax_policy = VTraceJaxPolicy(JaxBox(0, 255, (84, 84, 4), np.uint8),
                                 JaxDiscrete(6), dict(cfg))
    weights = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, jax_policy.get_weights())).items()}
    learner = VTraceTorchPolicy(Box(0, 255, (84, 84, 4), np.uint8),
                                Discrete(6), dict(cfg))
    learner.set_weights(weights)
    worker = ray_tpu_torch.remote(RolloutWorker).remote(
        lambda c: make_env("SyntheticAtari-v0", c), VTraceTorchPolicy,
        dict(cfg), rollout_fragment_length=5, worker_index=1, seed=0,
        pack_fragments=True)
    bc = WeightBroadcaster(learner.get_weights, codec="q8_delta")
    obs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 84, 84, 4), dtype=np.uint8))

    def logits(policy):
        with torch.no_grad():
            return policy.model(obs)[0].numpy()

    bc.broadcast()
    assert bc.payloads()[0].codec == "full"
    bc.sync(worker)
    bc.drain_acks()
    worker_policy = ray_tpu_torch.get(worker.get_policy.remote())
    assert logits(worker_policy).tobytes() == logits(learner).tobytes()

    rng = np.random.default_rng(5)
    learner.set_weights({k: v + (1e-3 * rng.standard_normal(v.shape))
                         .astype(np.float32) for k, v in weights.items()})
    bc.broadcast()
    payloads = bc.payloads()
    assert payloads[0].codec == "q8_delta"
    full_bytes = sum(v.nbytes for v in weights.values())
    assert full_bytes / sum(p.nbytes for p in payloads) >= 3.5
    check_worker_holds_base(bc, worker, learner.get_weights())
    np.testing.assert_allclose(logits(worker_policy), logits(learner),
                               atol=1e-3)


def test_worker_set_syncs_weights_and_filters(port_local):
    """`WorkerSet.sync_weights` (the blocking fan-out: a full sync, then
    deltas) and `sync_filters` (`FilterManager.synchronize`: the remote
    workers' filter increments merged into the local filter, the merged
    filter pushed back) over 2 remote workers."""
    from ray_tpu_torch.rllib.evaluation.worker_set import WorkerSet
    cfg = {"model": {"fcnet_hiddens": [8]}, "device": "cpu", "seed": 0,
           "num_envs_per_worker": 2, "rollout_fragment_length": 10,
           "observation_filter": "MeanStdFilter", "pack_fragments": True,
           "weight_sync_codec": "q8_delta"}
    ws = WorkerSet(lambda c: make_env("CartPole-v0", c), VTraceTorchPolicy,
                   cfg, num_workers=2)
    try:
        local = ws.local_worker
        ws.sync_weights()
        want = _vec(local.get_weights())
        for w in ws.remote_workers:
            got = _vec(ray_tpu_torch.get(w.get_weights.remote()))
            assert got.tobytes() == want.tobytes()
        rng = np.random.default_rng(2)
        local.set_weights({k: v + (1e-3 * rng.standard_normal(v.shape))
                           .astype(np.float32)
                           for k, v in local.get_weights().items()})
        ws.sync_weights()
        bc = ws._broadcaster
        assert bc.payloads()[0].codec == "q8_delta" and bc.version == 2
        for w in ws.remote_workers:
            check_worker_holds_base(bc, w, local.get_weights())

        for w in ws.remote_workers:
            ray_tpu_torch.get(w.sample.remote())
        pushed = [ray_tpu_torch.get(w.get_filters.remote()).buffer.n
                  for w in ws.remote_workers]
        # Each env's first observation, then 10 steps of 2 envs.
        assert pushed == [22, 22]
        n0 = local.obs_filter.rs.n
        ws.sync_filters()
        assert local.obs_filter.rs.n == n0 + sum(pushed)
        for w in ws.remote_workers:
            f = ray_tpu_torch.get(w.get_filters.remote())
            assert f.rs.n == local.obs_filter.rs.n and f.buffer.n == 0
            np.testing.assert_array_equal(f.rs.mean, local.obs_filter.rs.mean)
    finally:
        ws.stop()
