"""TorchPolicy: a policy defined by an `nn.Module` and a loss function.

Counterpart of `ray_tpu/rllib/policy/jax_policy.py` (`JaxPolicy`), for
the feedforward, single-device path:

- `compute_actions`: one network forward returns (dist_inputs, value);
  the sampling tail (draw + logp) is the K2 kernel (Discrete) or K7
  (Box) on the card (`models/distributions.py`), with uniforms or
  normals drawn from the policy's own `torch.Generator`, seeded from
  `config["seed"]`. The kernel also writes the step's actions, logp,
  dist inputs and value into a pinned step record of the calling thread
  (`StepRecord`; K7 into it alone), and the host waits once for it.
- `learn_on_batch`: loss -> backward -> clip by global norm -> Adam,
  the optax chain of `default_optimizer` (`jax_policy.py:57-63`), run
  by `apply_update`, which leaves the stats on the device (the Anakin
  optimizer enqueues many updates and reads their stats once).
- `select`: the Sebulba sampler's selection window, k draws from one
  forward (kernel K2k), left on the device.
- An explicit `torch.device` from `config["device"]` ("cuda" unless the
  caller asks for "cpu"; no fallback).
- `_update_lock` serializes updates against rollout inference and
  weight reads/writes: the async optimizer runs `learn_on_batch` on a
  LearnerThread while samplers call `compute_actions` or `select`.
- Data-parallel learning (`config["_learner_group"]`, a
  `parallel.mesh.LearnerGroup` of D >= 2 ranks, set by the trainer):
  rank 0's parameters are broadcast at construction; `apply_update`
  exchanges the gradient between `backward` and the clip (the
  collective seam of `jax_policy.py:311-329`): an fp32 all-reduce, or
  the q8 all-reduce with this rank's error-feedback residual `ef_state`
  (kernels K6a, K6b). The exchange is a psum, divided by D only when
  the policy's loss is a mean over rows (`loss_reduction`); the stats
  are reduced in one collective (`total_loss` like the gradient, the
  per-row stats averaged). The rollout generator is seeded seed + rank.

- `sgd_learn`: the minibatch-SGD phase of `jax_policy.py:502-621`
  (PPO, and IMPALA with `sgd_minibatch_size`): `num_sgd_iter` epochs,
  each one on-device permutation of whole sequences
  (`epoch_permutation`, from the policy's device generator) and its
  minibatches through `apply_update`, all enqueued with no host sync
  (`sgd_enqueue`) and read once at the end.
- `loss_state`: a dict of 0-d f32 device tensors from
  `config["loss_state"]` that the loss reads (PPO's adaptive
  `kl_coeff`), changed between updates by `update_loss_state`.
- `global_timestep` counts the world's rows: on a data-parallel rank
  its own rows times D, every rank holding an equal share
  (`jax_policy.py:498`, `:548`).
- Two constructor hooks of `JaxPolicy.__init__` (`jax_policy.py:76-82`):
  `make_model(obs_space, action_space, config) -> nn.Module` builds the
  network in place of `catalog.get_model` (DQN's Q-network), and
  `postprocess_fn(policy, batch, other_agent_batches, episode)` is what
  `postprocess_trajectory` runs (DQN's n-step folding).

Left for later slices: the fsdp layout,
`compute_gradients`/`apply_gradients`, recurrent policies and bf16
casting of the whole parameter tree (policy-level `compute_dtype`; the
Vision trunk's own bf16 compute is ported).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ...device import resolve_device
from ...models import catalog
from ...models.convert import flax_leaf_table, flax_pack_plan, unpack_leaves
from ...models.distributions import StepRecord, ThreadRecords, get_action_dist
from ...parallel import collectives
from .. import sample_batch as sb
from .policy import Policy

logger = logging.getLogger(__name__)

LOSS_REDUCTIONS = ("sum", "mean")

# Columns that the device-side loss consumes; everything else stays host-side.
_DEVICE_COLUMNS = (
    sb.OBS, sb.NEW_OBS, sb.ACTIONS, sb.REWARDS, sb.DONES, sb.ACTION_LOGP,
    sb.ACTION_DIST_INPUTS, sb.VF_PREDS, sb.ADVANTAGES, sb.VALUE_TARGETS,
    sb.PREV_ACTIONS, sb.PREV_REWARDS, sb.BOOTSTRAP_OBS, "weights",
)


def default_optimizer(parameters: Iterable[torch.nn.Parameter],
                      config: dict) -> torch.optim.Optimizer:
    """Adam with optax's default eps of the JAX package (1e-7). The
    global-norm clip that optax chains in front runs in
    `learn_on_batch` (`clip_by_global_norm_`)."""
    return torch.optim.Adam(parameters, lr=config.get("lr", 5e-5),
                            eps=config.get("adam_epsilon", 1e-7))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: Optional[float]) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: every gradient becomes
    (g / norm) * max_norm when norm >= max_norm and stays as it is
    otherwise. (torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6
    and scales below the threshold too, so it does not match.) Returns
    the pre-clip norm; no clip when `max_norm` is None or 0."""
    norm = global_norm(grads)
    if max_norm:
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class TorchPolicy(Policy):
    """A policy defined by a network + a loss function.

    loss_fn(policy, model, batch) -> (loss, stats): `batch` is a dict of
    device tensors; the loss calls `model(batch[OBS])` for the network
    outputs. `stats` values are scalar tensors. `loss_reduction` says
    how the loss reduces over rows, "sum" or "mean": it decides whether
    the data-parallel exchange divides the summed gradient by D.
    """

    def __init__(self, observation_space, action_space, config: dict,
                 loss_fn: Callable, loss_reduction: str,
                 make_model: Optional[Callable] = None,
                 postprocess_fn: Optional[Callable] = None):
        super().__init__(observation_space, action_space, config)
        if loss_reduction not in LOSS_REDUCTIONS:
            raise ValueError(f"loss_reduction {loss_reduction!r}: one of "
                             f"{LOSS_REDUCTIONS}")
        self.loss_reduction = loss_reduction
        self.group = config.get("_learner_group")
        self.device = self.group.device if self.group is not None \
            else resolve_device(config.get("device", "cuda"))
        if catalog.resolve_compute_dtype(
                config.get("compute_dtype", "auto")) != torch.float32:
            raise NotImplementedError(
                "policy-level compute_dtype bf16 (casting every parameter "
                "at the loss) is not ported yet; the Vision trunk computes "
                "in bf16 by default (model.compute_dtype)")
        self.dist_class, self.dist_dim = get_action_dist(action_space)
        seed = config.get("seed") or 0
        if make_model is not None:
            self.model = make_model(observation_space, action_space,
                                    config).to(self.device)
        else:
            self.model = catalog.get_model(
                observation_space, self.dist_dim, config.get("model"),
                generator=torch.Generator().manual_seed(seed)).to(
                    self.device)
        # Rollout noise (K2's uniforms, K7's normals) and the SGD epochs'
        # permutations. The rank is part of this seed only: parameters
        # start equal on every rank.
        rank = self.group.rank if self.group is not None else 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + rank)
        self._loss_fn = loss_fn
        self._postprocess_fn = postprocess_fn
        self.preprocessor = catalog.get_preprocessor(observation_space)
        self.optimizer = default_optimizer(self.model.parameters(), config)
        # Device scalars the loss reads, and their host values (read by
        # update hooks and get_state without a device->host copy).
        self.loss_state: Dict[str, torch.Tensor] = {}
        self.loss_state_host: Dict[str, float] = {}
        self.update_loss_state(**(config.get("loss_state") or {}))
        self.global_timestep = 0
        self._update_lock = threading.Lock()
        # Per-thread step records of `compute_actions`.
        pin = self.device.type == "cuda"
        self._step_records = ThreadRecords(
            lambda rows: self.dist_class.step_record(rows, self.dist_dim,
                                                     pin))
        self._init_exchange(config.get("allreduce_codec", "auto"))

    def _init_exchange(self, codec_value) -> None:
        """The gradient exchange of a world of D >= 2 ranks: rank 0's
        parameters broadcast, the codec, the q8 packing plan and
        residual, the byte counts and the probe. One learner device
        exchanges nothing, and q8 resolves to fp32 there, as in JAX
        (`jax_policy.py:167-173`)."""
        codec = collectives.resolve_codec(codec_value)
        if self.group is None and codec == "q8":
            logger.info("allreduce_codec=q8 with one learner device: "
                        "nothing is exchanged; running fp32")
            codec = "fp32"
        self.allreduce_codec = codec
        self.ef_state = None
        # allreduce_bytes: JAX's analytic payload count; wire bytes: what
        # this rank's transport really sends, padding included;
        # allreduce_ms: the probe's time, once per update.
        self.counters = {"allreduce_bytes": 0, "allreduce_wire_bytes": 0,
                         "allreduce_ms": 0.0}
        if self.group is None:
            return
        params = list(self.model.parameters())
        with torch.no_grad():
            flat = torch.cat([p.reshape(-1) for p in params])
            self.group.broadcast_(flat, src=0)
            for p, v in zip(params, flat.split([p.numel() for p in params])):
                p.copy_(v.view_as(p))
        if codec == "q8":
            plan = flax_pack_plan(self.model, collectives.Q8_BLOCK)
            table = flax_leaf_table(self.model, collectives.Q8_BLOCK)
            if not torch.equal(unpack_leaves(
                    torch.arange(plan.nb * collectives.Q8_BLOCK), table),
                    plan.unpack_index):
                raise RuntimeError("the q8 leaf table does not match the "
                                   "packing plan")
            self._pack_index = plan.pack_index.to(self.device)
            # K6b with the leaf table: the world's gradient comes back in
            # parameters() order, with no unpacking gather.
            self._q8_decode = collectives.Q8Decode(table, plan.nb,
                                                   self.device)
            sizes = plan.leaf_sizes
            self.ef_state = collectives.ef_zeros(plan.nb, self.device)
        else:
            sizes = [p.numel() for p in params]
        self.allreduce_payload = collectives.payload_bytes(sizes, codec)
        self.allreduce_wire = collectives.wire_bytes(sizes, codec)
        self.allreduce_probe_ms = 1e3 * collectives.allreduce_probe_s(
            self.group, sizes, codec)

    # ------------------------------------------------------------------
    def _to_device(self, array) -> torch.Tensor:
        return to_device(array, self.device)

    # ------------------------------------------------------------------
    # rollout inference
    # ------------------------------------------------------------------
    def action_kernels(self) -> list:
        return [self.dist_class.STEP_KERNEL]

    def compute_actions(self, obs_batch, state_batches=None, explore=True,
                        prev_action_batch=None, prev_reward_batch=None):
        obs = self._to_device(obs_batch)
        record = self._step_records.get(obs.shape[0])
        with self._update_lock, torch.no_grad():
            dist_inputs, value = self.model(obs)
            self.sample_step(dist_inputs, value, explore, record)
        actions, logp, value, dist_inputs = record.columns()
        return actions, [], {sb.ACTION_LOGP: logp,
                             sb.ACTION_DIST_INPUTS: dist_inputs,
                             sb.VF_PREDS: value}

    def sample_step(self, dist_inputs: torch.Tensor, value: torch.Tensor,
                    explore: bool, record: StepRecord) -> None:
        """An env step's tail after the forward: the uniforms (K2) or
        normals (K7) and the kernel, which writes the step's actions,
        logp, dist inputs and value into `record` (this thread's, made by
        the distribution's `step_record`; by copy on the CPU), then the
        record's end mark. The caller reads `record.columns()`: one wait,
        then copies, so no view outlives the thread's next step."""
        self.dist_class(dist_inputs).record_step(self.generator, explore,
                                                 value, record)
        record.record_done(self.device)

    def select(self, obs: torch.Tensor, k: int,
               generator: Optional[torch.Generator] = None,
               explore: bool = True, *,
               host_actions: Optional[torch.Tensor] = None):
        """One Sebulba selection window: the forward at `obs` (a tensor on
        `self.device`) and k action draws from its distribution (kernel
        K2k). Returns (actions int64 [k, n], logp [k, n], dist_inputs
        [n, A], value [n]), all on the device and not waited for.
        `host_actions`, an int32 [k, n] host tensor (pinned on a CUDA
        device), also receives the actions: K2k writes them there, so
        they are complete once an event recorded after this call has
        completed. The update lock is held while the work is enqueued: on
        one stream the window then reads either the whole old or the
        whole new parameters (parity: `device_sampler.py:357`
        `_dispatch_select`)."""
        with self._update_lock, torch.no_grad():
            dist_inputs, value = self.model(obs)
            actions, logp = self.dist_class(
                dist_inputs).sample_k_with_logp(generator, k, explore,
                                                host_actions=host_actions)
        return actions, logp, dist_inputs, value

    def value_function(self, obs_batch, state=None):
        obs = self._to_device(obs_batch)
        with self._update_lock, torch.no_grad():
            value = self.model(obs)[1]
        return value.cpu().numpy()

    def postprocess_trajectory(self, batch, other_agent_batches=None,
                               episode=None):
        if self._postprocess_fn is not None:
            return self._postprocess_fn(self, batch, other_agent_batches,
                                        episode)
        return batch

    # ------------------------------------------------------------------
    # learning
    # ------------------------------------------------------------------
    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: self._to_device(batch[k])
                for k in _DEVICE_COLUMNS if k in batch}

    def apply_update(self, dev_batch: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """One update on a batch of device tensors: loss -> backward ->
        clip by global norm -> Adam. Returns the loss stats and
        `grad_gnorm` as 0-d tensors on the device, not read back, so a
        caller can enqueue many updates with no host sync. The caller
        holds `_update_lock`."""
        loss, stats = self._loss_fn(self, self.model, dev_batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        stats = dict(stats)
        if self.group is not None:
            self._exchange_gradients()
            stats = self._reduce_stats(stats)
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        stats["grad_gnorm"] = clip_by_global_norm_(
            grads, self.config.get("grad_clip"))
        self.optimizer.step()
        return stats

    def _exchange_gradients(self) -> None:
        """The collective seam: every rank's gradient -> the world's, in
        `p.grad`. fp32: one all-reduce of the flattened gradient. q8:
        pack into the flax-ordered block slots, `psum_quantized` (K6a,
        all-gather, K6b) with this rank's residual; K6b writes the sum in
        parameters() order (`Q8Decode`), so `p.grad` are views of its
        output buffer until the next update's `zero_grad`."""
        params = list(self.model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        mean = self.loss_reduction == "mean"
        if self.allreduce_codec == "q8":
            packed = torch.cat([flat, flat.new_zeros(1)])[self._pack_index]
            flat = collectives.psum_quantized(
                packed, self.ef_state, self.group, mean,
                decode=self._q8_decode)
        else:
            self.group.all_reduce_(flat)
            if mean:
                flat = flat / self.group.world_size
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)
        self.counters["allreduce_bytes"] += self.allreduce_payload
        self.counters["allreduce_wire_bytes"] += self.allreduce_wire
        self.counters["allreduce_ms"] += self.allreduce_probe_ms

    def _reduce_stats(self, stats: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """All the stats in one all-reduce: `total_loss` reduced like the
        gradient (summed for a sum loss), every per-row stat averaged."""
        keys = list(stats)
        summed = self.group.all_reduce_(torch.stack(
            [stats[k].detach().float().reshape(()) for k in keys]))
        world = self.group.world_size
        return {k: v if k == "total_loss" and self.loss_reduction == "sum"
                else v / world for k, v in zip(keys, summed)}

    def learn_on_batch(self, batch) -> Dict[str, float]:
        dev_batch = self._device_batch(batch)
        with self._update_lock:
            stats = self.apply_update(dev_batch)
        self.global_timestep += self._world_rows(
            batch.count if hasattr(batch, "count")
            else len(next(iter(batch.values()))))
        return read_stats(stats)

    def sgd_learn(self, batch, num_sgd_iter: int, minibatch_size: int,
                  seq_len: int = 1) -> Dict[str, float]:
        """The whole minibatch-SGD phase (`jax_policy.py:502-549`):
        `sgd_enqueue`, then one device->host read of the last
        minibatch's stats."""
        return read_stats(self.sgd_enqueue(batch, num_sgd_iter,
                                           minibatch_size, seq_len))

    def sgd_enqueue(self, batch, num_sgd_iter: int, minibatch_size: int,
                    seq_len: int = 1) -> Dict[str, torch.Tensor]:
        """Enqueue `num_sgd_iter` epochs of minibatch updates with no
        host sync; return the last minibatch's stats as device tensors.

        The remainder rows are dropped so that minibatches tile exactly.
        Each epoch permutes whole sequences of `seq_len` rows (rows when
        `seq_len == 1`, V-trace fragments otherwise) with one
        `epoch_permutation` drawn on the device, gathers the batch in
        that order once, and runs its minibatches through `apply_update`
        (so a data-parallel rank exchanges every minibatch's gradient).
        BOOTSTRAP_OBS, one row per sequence, follows the sequence
        permutation (`jax_policy.py:589-592`)."""
        batch, num_mb = _tile_minibatches(batch, minibatch_size, seq_len)
        dev = self._device_batch(batch)
        boot = dev.pop(sb.BOOTSTRAP_OBS, None)
        num_seq = num_mb * minibatch_size // seq_len
        offsets = torch.arange(seq_len, device=self.device)
        seqs_per_mb = minibatch_size // seq_len
        with self._update_lock:
            for _ in range(num_sgd_iter):
                perm = epoch_permutation(self.generator, num_seq,
                                         self.device)
                idx = (perm[:, None] * seq_len + offsets).reshape(-1)
                shuffled = {k: v[idx] for k, v in dev.items()}
                boot_shuffled = None if boot is None else boot[perm]
                for m in range(num_mb):
                    mb = {k: v[m * minibatch_size:(m + 1) * minibatch_size]
                          for k, v in shuffled.items()}
                    if boot is not None:
                        mb[sb.BOOTSTRAP_OBS] = boot_shuffled[
                            m * seqs_per_mb:(m + 1) * seqs_per_mb]
                    stats = self.apply_update(mb)
        self.global_timestep += self._world_rows(batch.count)
        return stats

    def _world_rows(self, rows: int) -> int:
        """`rows` of this rank -> the world's. The trainer splits the
        envs evenly and every rank learns on whole fragments
        (`impala._validate_world`), so each rank holds the same count:
        no collective is needed."""
        return rows if self.group is None else rows * self.group.world_size

    def update_loss_state(self, **kwargs) -> None:
        """Set loss-state scalars. A known key is filled in place (a
        kernel launch with the value as its argument: no host->device
        copy, no sync)."""
        for k, v in kwargs.items():
            v = float(np.float32(v))  # the device value, as a float
            if k in self.loss_state:
                self.loss_state[k].fill_(v)
            else:
                self.loss_state[k] = torch.full(
                    (), v, dtype=torch.float32, device=self.device)
            self.loss_state_host[k] = v

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def get_weights(self) -> Dict[str, np.ndarray]:
        with self._update_lock:
            return host_state_dict(self.model)

    def set_weights(self, weights) -> None:
        with self._update_lock:
            load_host_state_dict(self.model, weights)

    def get_state(self):
        with self._update_lock:
            opt_state = _to_host(self.optimizer.state_dict())
            ef_state = None if self.ef_state is None \
                else _to_host(self.ef_state)
        state = {
            "weights": self.get_weights(),
            "opt_state": opt_state,
            "loss_state": dict(self.loss_state_host),
            "global_timestep": self.global_timestep,
        }
        if ef_state is not None:
            # The q8 residual (packed layout): without it a restored
            # learner re-accumulates quantization error from zero.
            state["ef_state"] = ef_state
        return state

    def set_state(self, state):
        self.set_weights(state["weights"])
        with self._update_lock:
            self.optimizer.load_state_dict(state["opt_state"])
            if state.get("ef_state") is not None \
                    and self.ef_state is not None:
                self.ef_state.copy_(torch.as_tensor(state["ef_state"]))
        self.global_timestep = state.get("global_timestep", 0)
        self.update_loss_state(**state.get("loss_state", {}))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())


def epoch_permutation(generator: torch.Generator, num_seq: int,
                      device: torch.device) -> torch.Tensor:
    """One SGD epoch's order of the `num_seq` sequences: a uniform
    permutation (int64 [num_seq]) drawn on `device` from `generator`."""
    return torch.randperm(num_seq, generator=generator, device=device)


def _tile_minibatches(batch, minibatch_size: int, seq_len: int):
    """The rows `sgd_enqueue` trains on: (batch cut to whole minibatches,
    number of minibatches). Checks of `jax_policy.py:510-536`."""
    n = batch.count
    if seq_len > 1 and minibatch_size % seq_len:
        raise ValueError(
            f"sgd minibatch_size {minibatch_size} must be a multiple of "
            f"sequence length {seq_len}")
    num_mb = max(1, n // minibatch_size)
    usable = num_mb * minibatch_size
    if usable > n:
        raise ValueError(f"sgd minibatch_size {minibatch_size} is larger "
                         f"than the batch ({n} rows)")
    if sb.BOOTSTRAP_OBS in batch:
        boot = batch[sb.BOOTSTRAP_OBS]
        if seq_len <= 1 or len(boot) * seq_len != n:
            raise ValueError(
                f"BOOTSTRAP_OBS has {len(boot)} fragments but the batch "
                f"has {n} rows at seq_len={seq_len}; packed fragment "
                "batches must run with seq_len == rollout_fragment_length")
        if usable != n:
            # Cut at fragment granularity and keep the matching
            # bootstrap rows (slice() drops the column).
            sliced = batch.slice(0, usable)
            sliced[sb.BOOTSTRAP_OBS] = boot[:usable // seq_len]
            batch = sliced
    elif usable != n:
        batch = batch.slice(0, usable)
    return batch, num_mb


def to_device(array, device: torch.device) -> torch.Tensor:
    """Column -> device tensor with `_device_batch`'s casts: f64 -> f32
    and bool -> f32 (integers and uint8 frames keep their type). A
    tensor already on `device` (the Sebulba sampler's columns) is cast
    there, never sent through the host (parity:
    `jax_policy.py:460-474`)."""
    if isinstance(array, torch.Tensor):
        if array.device != device:
            raise ValueError(f"column on {array.device}, policy on "
                             f"{device}")
        if array.dtype in (torch.float64, torch.bool):
            array = array.float()
        return array
    array = np.asarray(array)
    if array.dtype == np.float64 or array.dtype == np.bool_:
        array = array.astype(np.float32)
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        # From pinned memory the copy does not block the host (a
        # pageable one waits for everything queued on the stream).
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def host_state_dict(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """{state_dict key: float32 numpy array}, copied to the host (a copy
    on the CPU too, never a view of the live parameters)."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in module.state_dict().items()}


def load_host_state_dict(module: torch.nn.Module, weights) -> None:
    """Load {state_dict key: array} into `module`'s own tensors."""
    module.load_state_dict({k: torch.as_tensor(np.asarray(v))
                            for k, v in weights.items()})


def read_stats(stats: Dict[str, torch.Tensor],
               tail: Optional[torch.Tensor] = None):
    """Device stats -> Python floats in one device->host copy. With
    `tail`, a vector read in the same copy: returns (stats, tail as a
    numpy f32 array)."""
    values = torch.stack([v.detach().float().reshape(())
                          for v in stats.values()])
    if tail is None:
        return dict(zip(stats.keys(), values.tolist()))
    host = torch.cat([values, tail.detach().float().reshape(-1)]).cpu()
    n = len(stats)
    return dict(zip(stats.keys(), host[:n].tolist())), host[n:].numpy()


def _to_host(tree):
    """Copy every tensor of a nested dict/list to the CPU (a copy on the
    CPU too: the optimizer updates its moments in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree
