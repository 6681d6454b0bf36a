"""Port parity: IMPALA's rollout workers in processes of their own, on
the multi-process runtime, fed q8-delta weight syncs through the object
store.

- The counterpart of `test_impala.py::TestIMPALA::
  test_async_optimizer_with_workers` (`:198-207`) on `ray_start`
  (`ray_tpu.init(num_cpus=4)`): CartPole-v0 with 2 workers, each a
  process other than the trainer's, building its policy on the CPU and
  importing no JAX; "auto" resolves to q8_delta; steps are sampled and
  trained with no stale fallback, and every worker holds the
  broadcaster's receiver-view base bit for bit.
- The counterpart of `test_weight_sync.py::TestOptimizerIntegration::
  test_impala_remote_workers_delta_sync` (`:580-596`).
- A worker in a process, fed a sequence of learner weights through the
  object store, holds after each sync what the local-mode path gives
  for the same weights (the same payloads applied in-process), bit for
  bit; its samples are numpy columns only.

One runtime serves the whole module.
"""

import os
import pickle

import numpy as np
import pytest

import ray_tpu_torch
import torch_runtime_program as program
from ray_tpu_torch._private import weight_sync
from ray_tpu_torch.models import distributions
from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
from ray_tpu_torch.rllib.agents.impala.vtrace_policy import VTraceTorchPolicy
from ray_tpu_torch.rllib.agents.ppo.ppo import PPOTorchPolicy
from ray_tpu_torch.rllib.env.registry import EnvCreator
from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.utils.weight_broadcast import WeightBroadcaster
from test_torch_impala_workers import _cartpole_config, check_worker_holds_base

BANNED = ["jax", "jaxlib", "flax", "optax", "ray_tpu", "cloudpickle", "lz4"]


@pytest.fixture(scope="module")
def procs():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _vec(tree):
    return weight_sync.flatten_f32(tree)[0]


def test_async_optimizer_with_workers(procs):
    t = IMPALATrainer(config=_cartpole_config(weight_sync_codec="auto"))
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
        infos = [ray_tpu_torch.get(w.apply.remote(
            program.rollout_worker_process, BANNED))
            for w in t.workers.remote_workers]
        pids = {info["pid"] for info in infos}
        assert len(pids) == 2 and os.getpid() not in pids
        assert all(info["device"] == "cpu" and info["modules"] == []
                   for info in infos)
        # What the driver builds for the workers on a card: K2 alone.
        assert t.workers.local_worker.policy.action_kernels() == [
            distributions.CATEGORICAL_KERNEL]
    finally:
        t.stop()


@pytest.mark.parametrize("cls", [VTraceTorchPolicy, PPOTorchPolicy],
                         ids=lambda c: c.__name__)
def test_policy_class_pickles_by_reference(cls):
    """A worker process gets the policy class by reference, through
    plain pickle: `build_torch_policy` names its module and name."""
    blob = pickle.dumps(cls)
    assert pickle.loads(blob) is cls
    assert len(blob) < 200


def test_impala_remote_workers_delta_sync(procs):
    t = IMPALATrainer(config={
        "env": "CartPole-v0", "num_workers": 1,
        "rollout_fragment_length": 32, "train_batch_size": 64,
        "model": {"fcnet_hiddens": [16, 16]}, "min_iter_time_s": 0,
        "seed": 0, "device": "cpu"})
    try:
        t.train()
        st = t.optimizer.stats()
        assert st["weight_sync_version"] >= 1
        assert st["weight_sync_codec"] == "q8_delta"
        assert st["num_weight_sync_stale_fallbacks"] == 0
    finally:
        t.stop()


def test_process_worker_matches_local_mode(procs):
    cfg = {"model": {"fcnet_hiddens": [16, 16]}, "device": "cpu",
           "rollout_fragment_length": 10, "seed": 0}
    kwargs = dict(rollout_fragment_length=10, worker_index=1, seed=0,
                  pack_fragments=True)
    remote = ray_tpu_torch.remote(RolloutWorker).remote(
        EnvCreator("CartPole-v0"), VTraceTorchPolicy, dict(cfg), **kwargs)
    # The local-mode path: the same payload objects, applied in-process.
    local = RolloutWorker(EnvCreator("CartPole-v0"), VTraceTorchPolicy,
                          dict(cfg), **kwargs)
    learner = VTraceTorchPolicy(local.env.observation_space,
                                local.env.action_space, dict(cfg))
    state = {"w": learner.get_weights()}
    bc = WeightBroadcaster(lambda: state["w"])  # "auto": q8_delta here
    rng = np.random.default_rng(3)
    for version in (1, 2, 3):
        bc.broadcast()
        assert bc.sync(remote)
        bc.drain_acks()
        for p in bc.payloads():
            assert local.set_weights(p)["status"] == "ok"
        got = _vec(ray_tpu_torch.get(remote.get_weights.remote()))
        assert ray_tpu_torch.get(remote.weight_sync_version.remote()) \
            == version
        assert got.tobytes() == _vec(local.get_weights()).tobytes()
        assert got.tobytes() == bc.encoder.base.tobytes()
        state["w"] = {k: v + (1e-3 * rng.standard_normal(v.shape))
                      .astype(np.float32) for k, v in state["w"].items()}
    assert [p.codec for p in bc.payloads()] == ["q8_delta"]
    batch = ray_tpu_torch.get(remote.sample.remote())
    assert batch.count == 10
    assert all(type(v) is np.ndarray for v in batch.values())
    ray_tpu_torch.kill(remote)
