"""IMPALA-style async optimizer: decoupled sampling and learning.

Counterpart of `ray_tpu/rllib/optimizers/async_samples_optimizer.py`
(parity: `rllib/optimizers/async_samples_optimizer.py:19`,
`aso_learner.py:13` `LearnerThread`) in two modes:

- local mode (`num_workers=0`): the local worker samples, a
  LearnerThread owns the device update;
- Sebulba inline actors (`num_inline_actors >= 1`): `InlineActorThread`s
  step batched host envs on this process through a
  `DeviceSebulbaSampler` that selects actions with the learner's live
  policy on the device, and hand device-resident fragments straight to
  the LearnerThread.

Remote actors, the weight broadcaster, straggler detection, the elastic
fleet, the chaos hooks and the cluster-metrics gauges wait for the
runtime port, as does the host-side `VectorSampler`
(`device_rollouts=False`).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List

from ..sample_batch import SampleBatch
from ..utils.window_stat import WindowStat
from .policy_optimizer import PolicyOptimizer, Timer

logger = logging.getLogger(__name__)

LEARNER_QUEUE_MAX_SIZE = 16


class LearnerThread(threading.Thread):
    """Consumes train batches from inqueue, updates the policy on device.

    Parity: `aso_learner.py:13`. Runs on the trainer process so rollout
    collection never blocks on the device update; the policy's
    `_update_lock` keeps the sampler from reading parameters mid-update.
    """

    def __init__(self, local_worker, learner_queue_size: int = 16,
                 num_sgd_iter: int = 1, sgd_minibatch_size: int = 0,
                 sgd_sequence_length: int = 1):
        super().__init__(daemon=True, name="learner")
        self.local_worker = local_worker
        self.inqueue: "queue.Queue[SampleBatch]" = queue.Queue(
            maxsize=learner_queue_size)
        self.outqueue: "queue.Queue" = queue.Queue()
        self.num_sgd_iter = num_sgd_iter
        self.sgd_minibatch_size = sgd_minibatch_size
        self.sgd_sequence_length = sgd_sequence_length
        self.stopped = False
        self.stats = {}
        self.error = None  # first exception that killed the thread
        self.learner_queue_size = WindowStat("learner_queue_size", 50)
        self.queue_timer = Timer()
        self.grad_timer = Timer()

    def run(self):
        while not self.stopped:
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the optimizer re-raises
                logger.exception("learner thread died")
                self.error = e
                self.stopped = True

    def step(self):
        with self.queue_timer:
            try:
                batch = self.inqueue.get(timeout=0.5)
            except queue.Empty:
                return
        self.learner_queue_size.push(self.inqueue.qsize())
        with self.grad_timer:
            policy = self.local_worker.policy
            if self.sgd_minibatch_size:
                # Sequence-granular shuffling keeps V-trace fragments
                # contiguous inside each minibatch.
                stats = policy.sgd_learn(
                    batch, self.num_sgd_iter, self.sgd_minibatch_size,
                    seq_len=self.sgd_sequence_length)
            else:
                for _ in range(self.num_sgd_iter):
                    stats = policy.learn_on_batch(batch)
            self.stats = stats
        self.outqueue.put(batch.count)

    def stop(self):
        self.stopped = True


class InlineActorThread(threading.Thread):
    """Sebulba-style inline actor: steps a BatchedEnv on this process,
    with actions selected through the LEARNER's policy on the device (the
    policy's `_update_lock` serializes each selection's enqueue against
    concurrent updates), and feeds packed fragments straight into the
    learner queue. Parity: `async_samples_optimizer.py:121`, without the
    chaos hook and the metrics-plane gauges (they need the runtime)."""

    def __init__(self, sampler, learner: LearnerThread, idx: int = 0):
        super().__init__(daemon=True, name=f"inline-actor-{idx}")
        self.sampler = sampler
        self.learner = learner
        self.idx = idx
        self.stopped = False
        self.error = None  # first exception that killed the thread
        self.steps_sampled = 0  # monotonic; read without lock (int swap)

    def run(self):
        try:
            while not self.stopped:
                batch = self.sampler.sample()
                self.steps_sampled += batch.count
                while not self.stopped:
                    try:
                        self.learner.inqueue.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # noqa: BLE001 — the optimizer re-raises
            logger.exception("inline actor died")
            self.error = e
            self.stopped = True

    def stop(self):
        self.stopped = True


class AsyncSamplesOptimizer(PolicyOptimizer):
    """Sample on the local worker or on inline actors; learn on the
    LearnerThread."""

    def __init__(self, workers,
                 train_batch_size: int = 500,
                 rollout_fragment_length: int = 50,
                 learner_queue_size: int = LEARNER_QUEUE_MAX_SIZE,
                 num_sgd_iter: int = 1,
                 sgd_minibatch_size: int = 0,
                 sgd_sequence_length: int = 1,
                 num_inline_actors: int = 0,
                 inline_env=None,
                 inline_num_envs: int = 1,
                 inline_env_config=None,
                 inline_seed=None,
                 device_rollouts="auto",
                 device_frame_stack: int = 0,
                 obs_delta="auto",
                 obs_delta_budget: int = 256,
                 sebulba_env_groups: int = 1,
                 sebulba_onchip_steps: int = 1):
        super().__init__(workers)
        if workers.remote_workers:
            raise NotImplementedError(
                "remote rollout workers are not ported yet")
        self.train_batch_size = train_batch_size
        self.rollout_fragment_length = rollout_fragment_length
        self.learner = LearnerThread(
            workers.local_worker,
            learner_queue_size=learner_queue_size,
            num_sgd_iter=num_sgd_iter,
            sgd_minibatch_size=sgd_minibatch_size,
            sgd_sequence_length=sgd_sequence_length)
        # The learner thread's grad timer IS this optimizer's learn
        # phase.
        self.timers["learn"] = self.learner.grad_timer
        self.learner_stats = {}
        self._inline_actors: List[InlineActorThread] = []
        self._inline_sampled_seen = 0
        self._warm = False
        if num_inline_actors > 0:
            # Built before any thread starts: a refused config leaves
            # nothing running.
            self._build_inline_actors(
                num_inline_actors, inline_env, inline_num_envs,
                inline_env_config, inline_seed, device_rollouts,
                device_frame_stack, obs_delta, obs_delta_budget,
                sebulba_env_groups, sebulba_onchip_steps)
        self.learner.start()
        for a in self._inline_actors:
            a.start()

    def _build_inline_actors(self, num_inline_actors, inline_env,
                             inline_num_envs, inline_env_config,
                             inline_seed, device_rollouts,
                             device_frame_stack, obs_delta,
                             obs_delta_budget, sebulba_env_groups,
                             sebulba_onchip_steps):
        """One DeviceSebulbaSampler per actor (parity:
        `async_samples_optimizer.py:303-380`)."""
        from ..env.registry import make_batched_env
        from ..evaluation.device_sampler import DeviceSebulbaSampler
        policy = self.workers.local_worker.policy
        if device_rollouts is False or getattr(policy, "recurrent", False):
            raise NotImplementedError(
                "the host-side VectorSampler (device_rollouts=False or a "
                "recurrent policy) is not ported yet; inline actors run "
                "device rollouts only")
        onchip = max(1, int(sebulba_onchip_steps))
        # Double-buffered env groups: the largest group count <= the
        # requested one that tiles the env slots (one device, so no mesh
        # to tile as well).
        groups = max(1, int(sebulba_env_groups))
        while groups > 1 and inline_num_envs % groups:
            groups -= 1
        if groups != max(1, int(sebulba_env_groups)):
            logger.info(
                "sebulba_env_groups=%s does not tile %d envs; running %d "
                "group(s)", sebulba_env_groups, inline_num_envs, groups)
        for ai in range(num_inline_actors):
            def _seed(gi):
                if inline_seed is None:
                    return None
                return inline_seed + 1000 * (ai + 1) + 131 * gi
            envs = [make_batched_env(
                inline_env, inline_num_envs // groups, inline_env_config,
                seed=_seed(gi), device_frame_stack=device_frame_stack,
                obs_delta=obs_delta, obs_delta_budget=obs_delta_budget)
                for gi in range(groups)]
            sampler = DeviceSebulbaSampler(
                envs if groups > 1 else envs[0], policy,
                self.rollout_fragment_length,
                eps_id_offset=(ai + 1) << 40,
                use_delta=obs_delta is not False,
                onchip_steps=onchip,
                # The action draws' generator: a seed next to, and
                # distinct from, the actor's env-group seeds.
                seed=_seed(groups))
            self._inline_actors.append(
                InlineActorThread(sampler, self.learner, idx=ai))

    def step(self) -> dict:
        if self._inline_actors:
            return self._step_inline()
        return self._step_local()

    def _check_learner_alive(self):
        """Fail fast with the real cause when the learner thread or an
        inline actor died (neither has a recovery path)."""
        if self.learner.error is not None:
            raise RuntimeError(
                "learner thread died") from self.learner.error
        if not self.learner.is_alive() and not self.learner.stopped:
            raise RuntimeError("learner thread exited unexpectedly")
        for a in self._inline_actors:
            if a.error is not None:
                raise RuntimeError("inline actor died") from a.error

    def _step_inline(self) -> dict:
        """Inline-actor mode: actors run free on their own threads; one
        optimizer step = at least one learner update drained (parity:
        `async_samples_optimizer.py:573`)."""
        trained = 0
        # The first step includes the kernels' build and cuDNN's
        # autotuning.
        timeout = 180.0 if self._warm else 600.0
        deadline = time.monotonic() + timeout
        while trained == 0 and time.monotonic() < deadline:
            self._check_learner_alive()
            try:
                trained += self.learner.outqueue.get(timeout=1.0)
            except queue.Empty:
                continue
        if trained == 0:
            raise RuntimeError(
                "inline actors produced no trained batch within "
                f"{timeout}s (learner stalled?)")
        self._warm = True
        while not self.learner.outqueue.empty():
            trained += self.learner.outqueue.get()
        sampled_total = sum(a.steps_sampled for a in self._inline_actors)
        self.num_steps_sampled += sampled_total - self._inline_sampled_seen
        self._inline_sampled_seen = sampled_total
        self.num_steps_trained += trained
        self.learner_stats = self.learner.stats
        return self.learner_stats

    def inline_episodes(self):
        """Drain episode metrics from inline-actor samplers (merged into
        trainer results by `Trainer._result_from_optimizer`)."""
        out = []
        for a in self._inline_actors:
            out.extend(a.sampler.get_metrics())
        return out

    def _step_local(self) -> dict:
        """num_workers=0 mode: sample locally, learn on the thread."""
        batches = []
        count = 0
        with self.timers["sample"]:
            while count < self.train_batch_size:
                b = self.workers.local_worker.sample()
                batches.append(b)
                count += b.count
        train_batch = SampleBatch.concat_samples(batches)
        self.learner.inqueue.put(train_batch)
        # Generous timeout: the first update includes cuDNN autotuning
        # and the kernels' first build.
        deadline = time.monotonic() + 600.0
        trained = None
        while trained is None:
            self._check_learner_alive()
            try:
                trained = self.learner.outqueue.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        "learner produced no result within 600s")
        self.num_steps_sampled += count
        self.num_steps_trained += trained
        self.learner_stats = self.learner.stats
        return self.learner_stats

    def stats(self) -> dict:
        out = super().stats()
        out.update({
            "learner_queue": self.learner.learner_queue_size.stats(),
            "timing": {
                "learner_grad_time_ms": round(
                    1000 * self.learner.grad_timer.mean, 3),
                "learner_queue_wait_ms": round(
                    1000 * self.learner.queue_timer.mean, 3),
            },
        })
        transfer = [a.sampler.transfer_stats() for a in self._inline_actors]
        if transfer:
            out["transfer"] = {
                k: sum(t[k] for t in transfer) for k in transfer[0]}
        return out

    def stop(self):
        for a in self._inline_actors:
            a.stop()
        self.learner.stop()
        for a in self._inline_actors:
            a.join(timeout=30.0)
        self.learner.join(timeout=5.0)
