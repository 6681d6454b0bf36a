"""Rank functions of the port's data-parallel tests.

`ray_tpu_torch.parallel.distributed.launch` pickles a rank function by
its module path and runs it in spawned processes. They live here, in a
module that imports no JAX, so that a rank starts with torch alone.
Each returns numpy arrays and plain values for the test to check.
"""

import numpy as np
import torch


def _group(world_size, backend="gloo", device="cpu"):
    from ray_tpu_torch.parallel.mesh import LearnerGroup
    torch.set_num_threads(1)
    return LearnerGroup.from_world(world_size, backend, device)


def exchange_rank(rank, packed, ef, ef_steps_grad, ef_steps):
    """The exchanges on this rank's row of identical inputs.

    packed, ef: f32 [D, nb * Q8_BLOCK]. Returns this rank's wire image
    and new residual, the q8 psum and pmean, the fp32 psum, the probe's
    seconds per codec, and the 100-step error-feedback run on a constant
    gradient (ef_steps_grad [D, n])."""
    from ray_tpu_torch.parallel import collectives
    group = _group(packed.shape[0])
    g = torch.from_numpy(packed[rank].copy())
    e = torch.from_numpy(ef[rank].copy())
    nb = g.numel() // collectives.Q8_BLOCK
    wire = collectives.q8_encode_ef(g, e.clone())
    q8_sum = collectives.psum_quantized(g, e, group)
    q8_mean = collectives.pmean_quantized(
        g, torch.from_numpy(ef[rank].copy()), group)
    fp32 = group.all_reduce_(g.clone())
    probe = {c: collectives.allreduce_probe_s(group, [g.numel()], c, 1)
             for c in collectives.CODECS}
    const = torch.from_numpy(ef_steps_grad[rank].copy())
    residual = collectives.ef_zeros(const.numel() // collectives.Q8_BLOCK,
                                    "cpu")
    total = np.zeros(const.numel(), np.float64)
    for _ in range(ef_steps):
        total += collectives.psum_quantized(const, residual, group).numpy()
    return {"wire": wire.numpy(), "ef": e.numpy(), "nb": nb,
            "q8_sum": q8_sum.numpy(), "q8_mean": q8_mean.numpy(),
            "fp32_sum": fp32.numpy(), "probe_s": probe,
            "ef_total": total, "ef_residual": residual.numpy()}


def _vtrace_policy(group, weights, frame, num_actions, T, grad_clip,
                   codec):
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import \
        VTraceTorchPolicy
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete
    cfg = {"model": {"compute_dtype": "f32"}, "rollout_fragment_length": T,
           "seed": 0, "grad_clip": grad_clip, "device": "cpu",
           "_learner_group": group, "allreduce_codec": codec}
    policy = VTraceTorchPolicy(Box(0, 255, frame, np.uint8),
                               Discrete(num_actions), cfg)
    policy.set_weights(weights)
    return policy


def dp_update_rank(rank, world_size, weights, cols, T, arms):
    """One V-trace update of this rank's contiguous share of the rows
    (JAX's P("dp") split), per (grad_clip, codec) arm: the exchanged
    gradient before the clip, and the whole update's stats and weights.
    q8 arms also return the packed local gradient, the residual, the
    byte counts and whether `ef_state` survives get_state/set_state."""
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    group = _group(world_size)
    n = len(cols["actions"]) // world_size
    local = SampleBatch({k: v[rank * n:(rank + 1) * n]
                         for k, v in cols.items()})
    frame = cols["obs"].shape[1:]
    num_actions = cols["action_dist_inputs"].shape[1]
    out = {}
    for grad_clip, codec in arms:
        policy = _vtrace_policy(group, weights, frame, num_actions, T,
                                grad_clip, codec)
        loss, _ = policy._loss_fn(policy, policy.model,
                                  policy._device_batch(local))
        loss.backward()
        arm = {}
        if codec == "q8":
            flat = torch.cat([p.grad.reshape(-1)
                              for p in policy.model.parameters()])
            arm["local_packed"] = torch.cat(
                [flat, flat.new_zeros(1)])[policy._pack_index].numpy()
        policy._exchange_gradients()
        arm["grads"] = {k: p.grad.detach().clone().numpy()
                        for k, p in policy.model.named_parameters()}
        if codec == "q8":
            arm["residual"] = policy.ef_state.clone().numpy()
            state = policy.get_state()
            other = _vtrace_policy(group, weights, frame, num_actions, T,
                                   grad_clip, codec)
            other.set_state(state)
            arm["ef_round_trip"] = bool(torch.equal(
                other.ef_state, policy.ef_state))
        fresh = _vtrace_policy(group, weights, frame, num_actions, T,
                               grad_clip, codec)
        arm["stats"] = fresh.learn_on_batch(local)
        arm["global_timestep"] = fresh.global_timestep
        arm["weights"] = fresh.get_weights()
        arm["payload"] = fresh.allreduce_payload
        arm["wire_bytes"] = fresh.allreduce_wire
        arm["counters"] = dict(fresh.counters)
        out[(grad_clip, codec)] = arm
    return out


CARTPOLE = {
    "env": "CartPole-v0",
    "num_workers": 0,
    "rollout_fragment_length": 20,
    "train_batch_size": 80,
    "num_envs_per_worker": 2,
    "model": {"fcnet_hiddens": [32, 32]},
    "lr": 0.005,
    "min_iter_time_s": 0,
    "device": "cpu",
    "seed": 0,
    "collective_backend": "gloo",
}


def _weights_digest(policy) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(policy.get_weights().items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def trainer_rank(rank, world_size, iters, refusals):
    """The CartPole IMPALA trainer on a rank of a world, per codec:
    the per-iteration results, a digest of the weights after each
    iteration, the policy's byte counters and the sampling kernel's
    actions on one shared observation batch from equal weights. Then
    each config of `refusals` is built and its error returned."""
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
    torch.set_num_threads(1)
    out = {}
    obs = np.random.default_rng(0).standard_normal((64, 4)).astype(
        np.float32)
    for codec in ("q8", "fp32"):
        t = IMPALATrainer(config=dict(CARTPOLE, allreduce_codec=codec,
                                      num_gpus_for_learner=world_size))
        policy = t.get_policy()
        arm = {"digests": [_weights_digest(policy)], "results": [],
               "num_envs": t.workers.local_worker.env.num_envs,
               "first_env": t.workers.local_worker.env.first_index,
               "actions": policy.compute_actions(obs)[0]}
        try:
            for _ in range(iters):
                r = t.train()
                arm["results"].append({
                    k: r[k] for k in ("timesteps_total", "timesteps_this_iter",
                                      "num_steps_sampled",
                                      "num_steps_trained",
                                      "episode_reward_mean",
                                      "episodes_this_iter")}
                    | {"learner": r["info"]["learner"]})
                arm["digests"].append(_weights_digest(policy))
            arm["counters"] = dict(policy.counters)
            arm["codec"] = policy.allreduce_codec
        finally:
            t.stop()
        out[codec] = arm
    errors = []
    for over in refusals:
        try:
            IMPALATrainer(config=dict(CARTPOLE, **over)).stop()
            errors.append(None)
        except (ValueError, NotImplementedError, RuntimeError) as e:
            errors.append((type(e).__name__, str(e)))
    out["refusals"] = errors
    return out


def failing_rank(rank, fail_rank):
    """Rank `fail_rank` raises; the others wait in a collective that
    never completes (the launcher must kill them)."""
    import torch.distributed as dist
    if rank == fail_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank


def failing_rank_slow_to_leave(rank, fail_rank):
    """As `failing_rank`, but the failing rank takes 2 s to leave the
    world after it has closed its connections (the others' barrier
    fails at once): its report must still reach the launcher first."""
    import time
    import torch.distributed as dist
    from ray_tpu_torch.parallel import distributed
    if rank == fail_rank:
        leave = distributed.shutdown

        def slow_shutdown():
            leave()
            time.sleep(2.0)

        distributed.shutdown = slow_shutdown
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank


def sleeping_rank(rank, seconds):
    import time
    time.sleep(seconds)
    return rank


def quick_rank(rank):
    """Returns at once: a small result, then the rank exits."""
    return rank


class LateResults:
    """A result queue whose first `get` returns nothing until a result
    has landed and its rank has had time to exit: the race in which a
    launcher's wait times out just before a rank writes its result and
    exits. The ranks put into it as into any multiprocessing queue."""

    def __init__(self, ctx, settle_s=2.0):
        self._queue = ctx.Queue()
        self._settle_s = settle_s
        self._late = True

    def put(self, payload):
        self._queue.put(payload)

    def get(self, timeout=None):
        import queue
        import time
        if self._late:
            self._late = False
            while self._queue.empty():
                time.sleep(0.01)
            time.sleep(self._settle_s)
            raise queue.Empty
        return self._queue.get(timeout=timeout)

    def get_nowait(self):
        return self._queue.get_nowait()

    def close(self):
        self._queue.close()

    def __getstate__(self):
        return {"_queue": self._queue, "_settle_s": self._settle_s,
                "_late": False}
