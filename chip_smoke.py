#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py dp    # phase 6 alone, on a machine of 2+ cards
    python3 chip_smoke.py dqn   # phase 9 alone (K8 built alone)
    python3 chip_smoke.py sac   # phase 10 with K9's part of phase 2
    python3 chip_smoke.py workers  # phase 11 alone (K1 and K2 built alone)

Eleven phases, any failure exits non-zero (no phase is caught, nothing
falls back to the CPU):

1. Build: the card's name and power limit, then every hand-written
   kernel of the port's paths built from `ray_tpu_torch/csrc/` (one
   `nvcc` per library, all at once) with ptxas's register/spill report.
2. Kernels vs plain: each kernel against its plain PyTorch version on
   the same inputs, at the main paths' shapes and one larger shape; max
   error against the stated tolerance, the launch count, and the time
   per call of kernel and plain version (CUDA events over many calls
   after warm-up), plus the kernel's device-only time (profiler). The
   single-step sampling kernel (K2) is also held with its step record
   in pinned host memory (actions, logp, logits and value equal to the
   device's, bit for bit), the Box tail (K7) with its step record and no
   device outputs, the epsilon-greedy tail (K8) with its int64 host
   actions and no device output, and SAC's tail (K9f) with its host
   actions; the host time of an env step's tail after the forward (K2's
   from the logits to the four numpy columns, K7's from the dist inputs
   and value to the four columns, K8's from the Q-values to the numpy
   actions, K9f's acting tail from the actor's output to the numpy
   actions) is timed at the local-mode, PPO Atari, PPO Pendulum, DQN
   Atari and CartPole, and SAC shapes. The k-step sampling kernel at k=1 is also held equal
   to the single-step one, and its int32 wire actions in pinned host
   memory equal to its device actions; the observation kernel is also
   held through the Sebulba sampler's own launch path (`GroupObsApply`)
   and timed at n=32 and at bench.py's n=192, besides n=1 and 7 (its
   pixel-chunk grid with a ragged last chunk) and 512.
3. Local-mode trainer: `IMPALATrainer(config=...).train()` on
   SyntheticAtari-v0 (84x84x4 uint8 frames, 6 actions) with the
   full-width Nature CNN (bf16 trunk), 32 envs x 50-step fragments,
   1600-row updates. Every kernel's launch count is set to 0 just before
   and read just after; each must have launched (the sampling tail once
   per env step, V-trace once per update). Then one learner update of
   the trained weights on the card is held against the same update on
   the CPU.
4. Sebulba trainer: `IMPALATrainer` with 2 inline actors x 64 envs of
   SpriteAtari-v0 (84x84x1 frames uploaded as deltas, stacked to 4 on
   the card), 2 env groups, 25-step fragments (1600-row updates), once
   at `sebulba_onchip_steps` 1 and once at 5. Launch counts are set to 0
   before each run and read after the actors have stopped: the
   observation kernel once per group per env step, the k-step sampling
   kernel once per group per selection window, V-trace once per update.
   The frames and stacks rebuilt on the card must equal the envs' own.
5. Anakin trainer: `IMPALATrainer` with `anakin: True` on the
   device-resident SyntheticAtari-v0 at bench.py's shape (4096 envs x
   16-step fragments, 8 updates per call, 65,536-row updates), for 10
   calls: launch counts set to 0 before each call and held to one env
   kernel and one sampling kernel per env step and one V-trace per
   update; one call enqueued under `set_sync_debug_mode("error")` (any
   host sync fails it); the episode accounting at the 1000-step
   boundary; one call profiled. Then one update of a 1,024-row slice of
   the card's own batch on the card against the CPU, and a short
   CartPole Anakin run (32 envs x 20 steps x 10 updates per call) whose
   env steps must all launch K5b through the optimizer's bound step
   (`DeviceCartPole.bind`), none through the generic entry point.

6. The data-parallel trainer: `parallel.distributed.launch` starts a
   world of 2 ranks (NCCL with a card per rank; gloo, staged through
   pinned host memory, when both ranks share one card), each running
   `IMPALATrainer` in local mode at phase 3's configuration with
   `num_gpus_for_learner: 2`: 5 iterations with `allreduce_codec: "q8"`,
   then 3 with "fp32". The launch counts (set to 0 after setup) must be
   one K6a and one K6b (its leaf-table form, which writes the sum in
   `parameters()` order; the packed-order form not at all) per q8
   update per rank, V-trace once per update and the sampling tail once
   per env step, the exchange's decode section one device operation
   (no unpacking gather), both ranks'
   weights must be equal bit for bit after every iteration, the
   residuals finite and nonzero, the q8 payload >= 3.5x smaller
   than fp32, and each rank's `global_timestep` the world's rows (its
   own times 2). Then one q8 update of a seeded batch on the card world is
   held against the same update on a CPU world of 2 (1e-4).
7. PPO on Atari pixels: `PPOTrainer` on SyntheticAtari-v0 with the
   Nature CNN at `tuned_examples/atari-ppo.yaml`'s settings cut to one
   process (16 envs x 128-step fragments, 4096-row train batches, 4
   epochs of 512-row minibatches), 3 iterations: the sampling kernel
   once per env step; the second iteration's `sgd_learn` enqueued under
   `set_sync_debug_mode("error")` (any host sync inside the phase fails
   it); the third profiled. Then two `sgd_learn` phases of the trained
   weights on the card against the same phase on the CPU, with the same
   permutations: the path's own (bf16 trunk, the last train batch, 4
   epochs x 8 minibatches; 1e-2, and `grad_gnorm`, which bf16 rounding
   dominates, within half the CPU's own bf16-to-f32 distance), and an
   f32 one (TF32 off, a synthetic 1,024-row batch, 2 x 2; 1e-4).
8. PPO on Pendulum: `PPOTrainer` on Pendulum-v0 with the [256, 256] FC
   network and `free_log_std`, PPO's default config (8 envs x 200-step
   fragments, 4000-row train batches, 30 epochs of 128-row minibatches),
   3 iterations: the DiagGaussian kernel (K7) once per env step.
9. DQN on Atari pixels: `DQNTrainer` with `dqn.py`'s DEFAULT_CONFIG on
   SyntheticAtari-v0 (one env; the QNetwork's bf16 conv trunk into a
   [256] dueling head, double Q, prioritized replay of 50,000, 1000
   learning-start steps, 32-row batches, 4-step fragments, the target
   synced every 500 trained steps), 3 iterations (1,000, 1,000 and a
   profiled 200 env steps): with every kernel's count set to 0 before, the
   epsilon-greedy kernel (K8) once per env step and no other kernel,
   at least one target sync, epsilon on its schedule. Then one
   `learn_with_td` of the trained online and target weights on the
   last replay batch on the card against the CPU: at the path's bf16
   trunk (`DQN_BF16_TOL`) and with an f32 trunk, TF32 off (1e-4). Then
   a DQN CartPole leg at `tuned_examples/cartpole-dqn.yaml`'s settings,
   3 iterations, for the MLP path (K8 once per env step).
10. SAC on Pendulum-v0: `SACTrainer` at `sac.py`'s DEFAULT_CONFIG (actor
   and twin critics [256, 256] ReLU, f32, 256-row batches, a replay of
   100,000, tau 5e-3, learned alpha from 1, 1,000 pure-exploration and
   1,500 learning-start steps) with `no_done_at_end`, 3 iterations of
   1,000 env steps, one evaluation episode with the third: with every
   kernel's count set to 0 before, the squashed-Gaussian tail (K9f) once
   per acted env step past pure exploration, once per evaluation step
   and twice per update, its backward (K9b) once per update, and no
   other kernel. Then one 200-step iteration profiled, 50 updates split
   into their parts (replay sample, upload, critic, actor and alpha
   steps, the read), and one `learn_with_td` of the trained weights on
   the last replay batch with injected normals on the card against the
   CPU (f32, TF32 off; 1e-4 of 1 + |CPU| on every stat, |td| and
   parameter).
11. Remote rollout workers: `ray_tpu_torch.init(local_mode=True)`, then
   `IMPALATrainer` at phase 3's width (SyntheticAtari-v0, the Nature CNN
   with its bf16 trunk, 50-step fragments, 1600-row updates) sampled by
   2 remote workers x 16 envs, each with its own policy on the card, fed
   `weight_sync_codec: "q8_delta"` syncs, 3 iterations. Launch counts
   set to 0 before the trainer is built: V-trace once per update, the
   sampling kernel once per env step of each worker (the sample tasks
   in flight at the end included: local mode ran them already). At
   least one full and one q8-delta sync, no stale fallback; after a
   version-gated sync each worker's weights are the broadcaster's
   receiver-view base bit for bit and within half a q8 step (max|block|
   / 254) of the learner's at that version; the delta payload at least
   3.5x smaller than the full one. It prints env steps/s, the bytes of
   a full and of a delta sync, the encode and apply (decode) times and
   the learner's `get_weights` time, beside the card's name and power
   limit.

Phase 2 also holds the two env kernels byte for byte against their
plain versions (reset and step, both episode boundaries, CartPole near
its thresholds) at the Anakin shapes and at N=37 (K5b also through the
bound step over 6 steps at 32, 37 and 4096, and timed through it as the
Anakin optimizer calls it, with the episode ends per step), and the q8
exchange's encode (K6a) and gather-sum (K6b) bit for bit against
theirs: K6a at the Nature CNN's packed gradient, the CartPole FC net's
and 64M elements, on live blocks and the codec's edge cases; K6b at D=2
and 8, with and without the division by D, in packed order and with
the Nature CNN's leaf table (timed at D=2; also against the packed sum
indexed by the plan's `unpack_index`); K7, the DiagGaussian
sampling tail, at Pendulum's shape (8 x 1, timed), 256 x 6 and 4096 x
17, exploring and not (1e-6 + 1e-6 relative; the mean itself when not;
the step record's columns bit for bit); and K8, the epsilon-greedy
tail, at the DQN Atari path's 1 x 6 and the CartPole leg's 1 x 2 (both
timed), 32 x 18 and 4096 x 18, each at epsilon 0, 0.3 and 1, with rows
of ties and of NaN (the actions and host actions equal); K9f and
K9b, the squashed-Gaussian tail and its backward, at the SAC path's 1 x 1
and 256 x 1 (both timed), 256 x 6 and 4096 x 17, at low/high = +-2, with
raw log_std beyond both clip bounds and |pre| >= 10, exploring and not;
the backward with both upstream gradients, each absent, g_a a column
slice of a concat gradient and g_logp an expand (read in place), and
through the autograd function (SQUASHED_TOL). K1, V-trace, is held on
the learner's batch-major views (strides (1, T), read in place) and on
dense time-major inputs at 50 x 32, 16 x 4096 and 25 x 64 (the three
timed on the views, with the device operations one call enqueues), 20 x
32, 500 x 4096 (double-buffered chunks) and 50 x 37 (VTRACE_TOL).

The line before the last holds the card's name and power limit as
nvidia-smi reports them, the one before it a JSON object with one entry
per kernel, and the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device, or without the rest of the repository beside
it, the script exits non-zero before printing any result.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor
# core) operations/s. A card set below 700 W runs slower than these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Main-path shapes: 32 envs x 50-step fragments, 6 actions.
NUM_ENVS, FRAGMENT, NUM_ACTIONS = 32, 50, 6
TRAIN_ITERS = 4  # timed iterations; one more runs under the profiler

# The Sebulba path: bench.py's host-env Sebulba legs cut to 2 actors.
SEB_ACTORS, SEB_ENVS, SEB_FRAGMENT, SEB_GROUPS = 2, 64, 25, 2
# bench.py's own Sebulba actors: 384 envs in 2 groups (bench.py:607-612).
BENCH_SEB_GROUP_ENVS = 384 // 2
SEB_ITER_S = 2.0      # min_iter_time_s of each Sebulba iteration
SEB_ITERS = {1: 4, 5: 2}  # iterations per k (the first is warm-up)

SEBULBA_CONFIG = {
    "env": "SpriteAtari-v0",
    "num_workers": 0,
    "num_inline_actors": SEB_ACTORS,
    "num_envs_per_worker": SEB_ENVS,
    "rollout_fragment_length": SEB_FRAGMENT,
    "device_frame_stack": 4,
    "obs_delta": "auto",
    "sebulba_env_groups": SEB_GROUPS,
    "lr": 6e-4,
    "min_iter_time_s": SEB_ITER_S,
    "seed": 0,
    "device": "cuda",
}

# The Anakin path at bench.py's shape (`bench_anakin`, bench.py:243-300).
ANAKIN_ENVS, ANAKIN_FRAGMENT, ANAKIN_UPDATES = 4096, 16, 8
ANAKIN_CALLS = 10  # call 0 warms up, call 1 runs under sync-debug mode,
#                    the last is profiled; 1280 env steps cross the
#                    1000-step episode boundary once
ANAKIN_CONFIG = {
    "env": "SyntheticAtari-v0",
    "anakin": True,
    "num_workers": 0,
    "num_envs_per_worker": ANAKIN_ENVS,
    "rollout_fragment_length": ANAKIN_FRAGMENT,
    "train_batch_size": ANAKIN_ENVS * ANAKIN_FRAGMENT,
    "anakin_updates_per_call": ANAKIN_UPDATES,
    "lr": 6e-4,
    "min_iter_time_s": 0,
    "seed": 0,
    "device": "cuda",
}
# The CartPole Anakin test's config (test_sebulba_anakin.py:359).
CARTPOLE_ANAKIN_CONFIG = {
    "env": "CartPole-v0",
    "anakin": True,
    "num_workers": 0,
    "num_envs_per_worker": 32,
    "rollout_fragment_length": 20,
    "anakin_updates_per_call": 10,
    "lr": 3e-3,
    "min_iter_time_s": 0,
    "seed": 0,
    "device": "cuda",
}
CARTPOLE_CALLS = 3

TRAINER_CONFIG = {
    "env": "SyntheticAtari-v0",
    "num_workers": 0,
    "num_envs_per_worker": NUM_ENVS,
    "rollout_fragment_length": FRAGMENT,
    "train_batch_size": NUM_ENVS * FRAGMENT,
    "lr": 6e-4,
    "grad_clip": 40.0,
    "min_iter_time_s": 0,
    "seed": 0,
    "device": "cuda",
}

# Phase 7: tuned_examples/atari-ppo.yaml (2 workers x 8 envs) cut to one
# process: 16 envs on the local worker. SyntheticAtari-v0 stands in for
# the Pong ROM, which is not in the repository.
PPO_ATARI_ENVS = 16
PPO_ATARI_CONFIG = {
    "env": "SyntheticAtari-v0",
    "num_workers": 0,
    "num_envs_per_worker": PPO_ATARI_ENVS,
    "rollout_fragment_length": 128,
    "train_batch_size": 4096,
    "sgd_minibatch_size": 512,
    "num_sgd_iter": 4,
    "lr": 2.5e-4,
    "lambda": 0.95,
    "vf_clip_param": 10.0,
    "entropy_coeff": 0.01,
    "seed": 0,
    "device": "cuda",
}
PPO_ITERS = 3  # 0 warms up, 1 runs under sync-debug mode, 2 is profiled
# |card - CPU| <= TOL * (1 + |CPU|) on the last minibatch's stats of the
# path's own phase (bf16 trunk, 4 epochs x 8 minibatches of 512). On an
# H100 the stats other than grad_gnorm differed by at most 2.2e-3 (and
# by 1.6e-4 after a single update).
PPO_BF16_PHASE_TOL = 1e-2
# bench.py's count for the Nature CNN (PERF.md): train FLOPs per row.
NATURE_TRAIN_FLOPS_PER_ROW = 50.82e6

# Phase 8: PPO's DEFAULT_CONFIG (ppo.py:23-39) on Pendulum-v0 with the
# default [256, 256] FC network and a state-independent log_std.
PPO_PENDULUM_ENVS = 8
PPO_PENDULUM_CONFIG = {
    "env": "Pendulum-v0",
    "num_workers": 0,
    "num_envs_per_worker": PPO_PENDULUM_ENVS,
    "model": {"fcnet_hiddens": [256, 256], "free_log_std": True},
    "seed": 0,
    "device": "cuda",
}

# Phase 9: DQN's DEFAULT_CONFIG (dqn.py: double Q, the dueling [256]
# head on the conv trunk, prioritized replay of 50,000, learning_starts
# 1000, 32-row batches, 4-step fragments, target sync every 500 trained
# steps, 1,000 steps per iteration) on SyntheticAtari-v0, which stands
# in for the ROM the repository lacks. One env: 6 actions, B=1.
DQN_ATARI_CONFIG = {"env": "SyntheticAtari-v0", "seed": 0, "device": "cuda"}
DQN_ITERS = 3  # 0 fills the replay buffer, 1 is timed, 2 is profiled
# The profiled iteration's window, in env steps: the profiler's own
# processing of a whole 1,000-step iteration's events took 54 s on an
# H100's host.
DQN_PROFILED_STEPS = 200
# Its CartPole leg: ray_tpu/rllib/tuned_examples/cartpole-dqn.yaml.
DQN_CARTPOLE_CONFIG = {
    "env": "CartPole-v0",
    "num_workers": 0,
    "learning_starts": 500,
    "buffer_size": 20000,
    "train_batch_size": 64,
    "rollout_fragment_length": 4,
    "exploration_timesteps": 4000,
    "exploration_final_eps": 0.02,
    "target_network_update_freq": 300,
    "timesteps_per_iteration": 500,
    "lr": 1e-3,
    "hiddens": [64],
    "model": {"fcnet_hiddens": [64]},
    "seed": 0,
    "device": "cuda",
}
# |card - CPU| <= TOL * (1 + |CPU|) on one learn_with_td of the trained
# weights on the last replay batch, the path's own bf16 conv trunk. In
# two H100 runs the |td| differed by up to 1.28e-2 and 1.58e-2 of
# (1 + |CPU|) and the stats by up to 8.3e-4 and 1.07e-2 (`grad_gnorm`):
# bf16 rounds the Q-values, and a TD error is a difference of two.
# Three times the largest reading.
DQN_BF16_TOL = 5e-2

# Phase 10: SAC on Pendulum-v0 at ray_tpu/rllib/agents/sac/sac.py's
# DEFAULT_CONFIG (actor and twin critics [256, 256] ReLU in f32, 256-row
# batches, a replay of 100,000, tau 5e-3, initial alpha 1, target entropy
# -|A|) with tuned_examples/pendulum-sac.yaml's no_done_at_end; one env,
# 1,000 steps per iteration, evaluation of one episode every third.
SAC_CONFIG = {"env": "Pendulum-v0", "no_done_at_end": True, "seed": 0,
              "device": "cuda", "evaluation_interval": 3,
              "evaluation_num_episodes": 1}
SAC_ITERS = 3  # 0 explores purely, 1 and 2 learn (from step 1,500 on)
SAC_PROFILED_STEPS = 200  # one more, shorter iteration, profiled
SAC_SPLIT_UPDATES = 50  # updates timed part by part, synced between parts
# K9f/K9b against their plain versions: |kernel - plain| <= TOL + TOL *
# |plain|. Both run the same f32 steps in the same order; CUDA's expf,
# tanhf and log1pf may differ by an ulp from PyTorch's build of them, and
# the log-det term is a difference of terms up to ~40 (log_std at -20).
SQUASHED_TOL = 1e-5

# Phase 11: phase 3's configuration sampled by 2 remote rollout workers
# of 16 envs each (tests/test_impala.py:198-207 at full width), fed
# q8-delta weight syncs.
WORKERS_NUM, WORKERS_ITERS = 2, 3
WORKERS_CONFIG = dict(TRAINER_CONFIG, num_workers=WORKERS_NUM,
                      num_envs_per_worker=NUM_ENVS // WORKERS_NUM,
                      weight_sync_codec="q8_delta")

# Phase 6: phase 3's configuration on a world of 2 ranks (16 envs each).
DP_RANKS = 2
DP_ITERS = {"q8": 5, "fp32": 3}
DP_CONFIG = dict(TRAINER_CONFIG, num_gpus_for_learner=DP_RANKS)


def log(msg=""):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_call(fn, reps, warmup=10):
    """Milliseconds per call of `fn` on the device timeline: CUDA events
    around `reps` back-to-back calls after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel_symbol, reps=200, cold=False):
    """Device-only milliseconds per launch of the named CUDA kernel over
    `reps` calls of `fn`, from torch.profiler's kernel records ("not
    measured" if the profiler records no such kernel). `cold`: a 128 MB
    write before each call evicts the 50 MB L2, so inputs come from
    device memory (the scrub's own kernel is not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if cold:
        scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        inner = fn

        def fn():
            scrub.fill_(1)
            inner()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel_symbol in e.key]
    if not hits:
        return "not measured"
    return sum(e.self_device_time_total for e in hits) / 1e3 / sum(
        e.count for e in hits)


def device_work_per_call(fn, reps=100):
    """(CUDA kernels and copies, their device milliseconds) that one
    call of `fn` enqueues (torch.profiler, after a warm-up call)."""
    import torch
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
    return (sum(e.count for e in events) / reps,
            sum(e.self_device_time_total for e in events) / 1e3 / reps)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------
# phase 2: kernels vs plain
# ---------------------------------------------------------------------
VTRACE_TOL = 1e-5  # |kernel - plain| <= TOL + TOL * |plain|
LOGP_TOL = 1e-5    # logp; the actions must match exactly


def vtrace_inputs(T, B, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    return dict(
        log_rhos=rand(T, B) * 3.0 - 1.5,
        discounts=0.99 * (rand(T, B) > 0.02).float(),
        rewards=torch.randn(T, B, generator=g, device="cuda"),
        values=torch.randn(T, B, generator=g, device="cuda"),
        bootstrap_value=torch.randn(B, generator=g, device="cuda"))


def vtrace_bytes_ops(T, B):
    """K1's bytes (four [T, B] f32 inputs and the [B] bootstrap read once,
    the two [T, B] f32 outputs written once) and f32 operations (~17 per
    element)."""
    return 4 * (6 * T * B + B), 17 * T * B


def vtrace_layout(inputs, T, layout):
    """K1's inputs as the learner hands them ("batch_major": discounts,
    rewards and values are [B * T] batch-major columns seen through
    `vtrace_policy._time_major`, strides (1, T); log_rhos and the
    bootstrap stay dense, as `from_logits` makes them) or all dense
    ("time_major")."""
    if layout == "time_major":
        return inputs
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import _time_major
    return dict(inputs, **{
        k: _time_major(inputs[k].t().contiguous().reshape(-1), T)
        for k in ("discounts", "rewards", "values")})


def check_vtrace(T, B, timed):
    """K1 against its plain version on the learner's batch-major views
    and on dense time-major inputs (VTRACE_TOL). Timed on the batch-major
    views, the path's layout: per call (CUDA events), the kernel's
    device time (profiler) and the device operations the call enqueues;
    the dense call and the plain version beside them."""
    import torch
    from ray_tpu_torch.rllib.agents.impala import vtrace
    inputs = vtrace_inputs(T, B, seed=T * B)
    want = vtrace._from_importance_weights_plain(
        *inputs.values(), 1.0, 1.0, 1.0)
    err = 0.0
    views = {}
    for layout in ("batch_major", "time_major"):
        views[layout] = vtrace_layout(inputs, T, layout)
        got = vtrace.from_importance_weights(**views[layout])
        torch.cuda.synchronize()
        for g, w in ((got.vs, want.vs), (got.pg_advantages,
                                         want.pg_advantages)):
            bad = (g - w).abs() > VTRACE_TOL + VTRACE_TOL * w.abs()
            if bool(bad.any()) or not bool(torch.isfinite(g).all()):
                raise AssertionError(
                    f"vtrace kernel disagrees with plain at T={T} B={B} "
                    f"({layout}): max err {float((g - w).abs().max())}")
            err = max(err, float((g - w).abs().max()))
    row = {"T": T, "B": B, "max_abs_err": err}
    if timed:
        path = lambda: vtrace.from_importance_weights(  # noqa: E731
            **views["batch_major"])
        row["ms"] = time_call(path, reps=2000)
        row["dense_ms"] = time_call(
            lambda: vtrace.from_importance_weights(**inputs), reps=2000)
        row["plain_ms"] = time_call(
            lambda: vtrace._from_importance_weights_plain(
                *inputs.values(), 1.0, 1.0, 1.0), reps=100, warmup=3)
        row["device_ms"] = device_ms(path, "vtrace_kernel")
        row["device_ops"] = device_work_per_call(path)[0]
        row["bound_ms"], row["bound_by"] = bound_ms(*vtrace_bytes_ops(T, B))
    log(f"  vtrace T={T} B={B}: max_abs_err={err:.3e} "
        f"(tol {VTRACE_TOL} + {VTRACE_TOL}*|plain|; batch-major views "
        f"and dense)"
        + (f" kernel {row['ms']:.5f} ms on the views ({row['dense_ms']:.5f} "
           f"dense) plain {row['plain_ms']:.5f} ms (kernel device-only "
           f"{row['device_ms']} ms, {row['device_ops']} device operations "
           f"per call; bound {row['bound_ms']:.3e} ms, {row['bound_by']})"
           if timed else ""))
    return row


def check_categorical(B, A, timed):
    """K2 against its plain version (actions equal, logp within
    LOGP_TOL), without and with the step record: after the record's
    event its actions and logp equal the device outputs and its logits
    and value columns the device tensors, bit for bit. Timed: `ms` per
    call with the record (the local-mode sampler's form), `bare_ms`
    without it, the device-only time of each, and `tail_ms`, the host
    time of a whole env step's tail (`k2_step_tail`)."""
    import torch
    from ray_tpu_torch.models import distributions
    g = torch.Generator(device="cuda").manual_seed(B * A)
    logits = torch.randn(B, A, generator=g, device="cuda") * 3.0
    u = torch.rand(B, A, generator=g, device="cuda")
    value = torch.randn(B, generator=g, device="cuda")
    record = distributions.StepRecord(B, A, pin=True)
    err = 0.0
    for explore in (True, False):
        want_a, want_logp = distributions._sample_logp_plain(
            logits, u, explore)
        for rec in (None, record):
            actions, logp = distributions.sample_logp(
                logits, u, explore, value=None if rec is None else value,
                record=rec)
            torch.cuda.synchronize()
            if not torch.equal(actions, want_a):
                raise AssertionError(
                    f"categorical kernel picks other actions than plain at "
                    f"B={B} A={A} explore={explore} record={rec is not None}"
                    f": {int((actions != want_a).sum())} rows differ")
            e = float((logp - want_logp).abs().max())
            if not e <= LOGP_TOL:
                raise AssertionError(
                    f"categorical kernel logp err {e} > {LOGP_TOL}")
            err = max(err, e)
        record.record_done(logits.device)
        got = record.columns()
        for name, host, dev in zip(("actions", "logp", "value", "logits"),
                                   got, (actions, logp, value, logits)):
            if host.tobytes() != dev.cpu().numpy().tobytes():
                raise AssertionError(
                    f"categorical step record's {name} differ from the "
                    f"device's at B={B} A={A} explore={explore}")
    row = {"B": B, "A": A, "max_abs_err": err}
    if timed:
        with_record = lambda: distributions.sample_logp(  # noqa: E731
            logits, u, True, value=value, record=record)
        bare = lambda: distributions.sample_logp(logits, u, True)  # noqa
        row["ms"] = time_call(with_record, reps=2000)
        row["bare_ms"] = time_call(bare, reps=2000)
        row["plain_ms"] = time_call(
            lambda: distributions._sample_logp_plain(logits, u, True),
            reps=500)
        row["device_ms"] = device_ms(with_record,
                                     "categorical_sample_kernel")
        row["bare_device_ms"] = device_ms(bare, "categorical_sample_kernel")
        row["tail_ms"] = host_ms(k2_step_tail(logits, value), reps=2000)
        row["bound_ms"], row["bound_by"] = bound_ms(
            *categorical_bytes_ops(B, A, record=True))
    log(f"  categorical B={B} A={A}: actions equal, logp "
        f"max_abs_err={err:.3e} (tol {LOGP_TOL}), step record equal"
        + (f"; kernel {row['ms']:.5f} ms per call with the record "
           f"({row['bare_ms']:.5f} without), plain {row['plain_ms']:.5f} "
           f"ms (device-only {row['device_ms']} ms with the record, "
           f"{row['bare_device_ms']} without; bound {row['bound_ms']:.3e} "
           f"ms); the env step's tail {row['tail_ms']:.5f} ms of host "
           f"time" if timed else ""))
    return row


def categorical_bytes_ops(B, A, record):
    """K2's bytes and f32 operations for one exploring call: logits and
    uniforms read once, int64 actions and f32 logp written once; with
    the step record also the value read once and the record's actions,
    logp, value and logits written once. ~9 operations per element (the
    Gumbel noise, the max and the exp-sum) and 3 per row."""
    nbytes = 4 * 2 * B * A + (8 + 4) * B
    if record:
        nbytes += 4 * B + (8 + 4 + 4 + 4 * A) * B
    return nbytes, 9 * B * A + 3 * B


def host_ms(fn, reps, warmup=10):
    """Host milliseconds per call of `fn`, a call that ends in a wait
    for its own device work (perf_counter around `reps` calls)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def k2_step_tail(logits, value, seed=0):
    """One Categorical env step's tail as `TorchPolicy.compute_actions`
    runs it after the forward: from the logits and value on the card to
    the numpy actions, logp, logits and value in hand (the uniforms, K2
    writing the step record, one wait and the copies: `sample_step`,
    `columns`). Returns a callable."""
    return _step_tail(logits, value, seed, "Categorical")


def _step_tail(inputs, value, seed, dist):
    import torch
    from types import SimpleNamespace
    from ray_tpu_torch.models import distributions as D
    from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy
    dist_class = getattr(D, dist)
    policy = SimpleNamespace(
        generator=torch.Generator(device=inputs.device).manual_seed(seed),
        device=inputs.device, dist_class=dist_class)
    record = dist_class.step_record(*inputs.shape, pin=True)

    def tail():
        TorchPolicy.sample_step(policy, inputs, value, True, record)
        return record.columns()
    return tail


def k9f_act_tail(x, low, high, seed=0):
    """One SAC env step's acting tail as `SACPolicy.compute_actions`
    runs it after the actor: from the actor's output x [B, 2d] on the
    card to the numpy actions in hand (the normals, K9f writing the
    host output, one wait and a copy). Returns a callable."""
    import torch
    from ray_tpu_torch.models import distributions as D
    generator = torch.Generator(device=x.device).manual_seed(seed)
    B, d = x.shape[0], x.shape[1] // 2
    constants = D.SquashedTail(low, high, d)
    host = D.ActionRecord(B, d, pin=True)

    def tail():
        z = torch.randn((B, d), generator=generator, dtype=torch.float32,
                        device=x.device)
        D.squashed_gaussian_sample_logp(x, z, explore=True,
                                        tail=constants, host_actions=host)
        host.record_done(x.device)
        return host.columns()
    return tail


def obs_apply_inputs(n, K, S, mode, seed, hw=84 * 84):
    """K3 inputs on the card for one mode: "delta" (packed delta rows,
    a quarter of the rows replaced whole, a few done rows, pad entries
    and out-of-range indices), or "frame" (an uploaded frame batch and a
    done upload). S=0: no stack."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    side = int(round(hw ** 0.5))
    dev = "cuda"
    args = {"frame_shape": (side, side, 1)}
    frames = rng.integers(0, 256, (n, hw), dtype=np.uint8)
    done = rng.random(n) < 0.1
    if mode == "delta":
        idx = np.stack([rng.permutation(hw)[:K] for _ in range(n)])
        idx[:, ::7] = hw  # pad entries
        idx = idx.astype(np.uint16)
        val = rng.integers(0, 256, (n, K), dtype=np.uint8)
        packed = np.concatenate([idx.view(np.uint8), val,
                                 done.astype(np.uint8)[:, None]], axis=1)
        m = max(1, n // 4)
        b = 1 << (m - 1).bit_length()
        rows = np.full(b, n, np.int32)
        rows[:m] = rng.permutation(n)[:m]
        args.update(
            packed=torch.from_numpy(np.ascontiguousarray(packed)).to(dev),
            rows=torch.from_numpy(rows).to(dev),
            fulls=torch.from_numpy(rng.integers(
                0, 256, (b, hw), dtype=np.uint8)).to(dev))
    else:
        args["done"] = torch.from_numpy(done).to(dev)
    if S:
        args["stack"] = torch.from_numpy(rng.integers(
            0, 256, (n, side, side, S), dtype=np.uint8)).to(dev)
    return torch.from_numpy(frames).to(dev), args


def obs_apply_bytes(frames, args):
    """Bytes K3 must move for these inputs: every input byte it needs
    read once, every output byte it changes written once.

    - packed (delta mode) or done (frame mode), and `rows`, read whole;
    - `fulls`: only the real rows (pad rows of the bucket are not read);
    - frames read except the rows replaced whole; frames written: the
      replaced rows whole plus the in-range delta entries of the others;
    - the old stack read only for rows that are not done, and whole:
      channel-last, every 32-byte sector holds all S channels of its
      pixels, so channels 1..S-1 cannot be read without channel 0;
    - the observation written whole.
    """
    n = frames.shape[0]
    hw = frames.numel() // n
    total = 0
    replaced = 0
    if "rows" in args:
        rows = args["rows"].cpu()
        real = rows[(rows >= 0) & (rows < n)]
        replaced = len(real)
        total += args["rows"].numel() * args["rows"].element_size()
        total += replaced * hw                    # fulls read
    if "packed" in args:
        packed = args["packed"].cpu()
        total += packed.numel()
        K = (packed.shape[1] - 1) // 3
        idx = packed[:, 0:2 * K:2].long() | (packed[:, 1:2 * K:2].long()
                                            << 8)
        keep = idx < hw
        if replaced:
            keep[real.long()] = False
        done = packed[:, -1] != 0
        total += (n - replaced) * hw              # frames read
        total += replaced * hw + int(keep.sum())  # frames written
    else:
        done = args["done"].cpu() != 0
        total += args["done"].numel()
        total += n * hw                           # frames read
    if "stack" in args:
        row_bytes = args["stack"][0].numel()
        total += int((~done).sum()) * row_bytes   # old stack read
        total += n * row_bytes                    # observation written
    else:
        total += n * hw
    return total


def check_obs_apply(n, K, S, mode, timed):
    """K3 against its plain version: the observation and the updated
    frames must be equal bit for bit, through `apply_obs` and through
    the sampler's launch path (`GroupObsApply`). Timed: `ms` per call
    through the sampler's path, `apply_ms` through `apply_obs`."""
    import torch
    from ray_tpu_torch.rllib.evaluation import device_sampler as ds
    frames, args = obs_apply_inputs(n, K, S, mode, seed=n + K + S)
    shape = args.pop("frame_shape")
    f_kernel, f_plain = frames.clone(), frames.clone()
    got = ds.apply_obs(f_kernel, shape, **args)
    want = ds._apply_obs_plain(f_plain, shape, **args)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(f_kernel, f_plain)):
        raise AssertionError(
            f"obs_apply kernel disagrees with plain at n={n} K={K} S={S} "
            f"{mode}: {int((got != want).sum())} obs bytes, "
            f"{int((f_kernel != f_plain).sum())} frame bytes differ")
    stack = args.pop("stack", None)
    f_group = frames.clone()
    group = ds.GroupObsApply(torch.device("cuda"), n, shape, stack,
                             f_group if mode == "delta" else None)
    got = group(f_group, stack, **args)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(f_group, f_plain)):
        raise AssertionError(
            f"obs_apply kernel through GroupObsApply disagrees with plain "
            f"at n={n} K={K} S={S} {mode}")
    if stack is not None:
        args["stack"] = stack
    chunks, chunk_px = ds.obs_apply_plan(n, frames.numel() // n)
    row = {"n": n, "K": K, "S": S, "mode": mode, "max_abs_err": 0,
           "bytes": obs_apply_bytes(frames, args), "blocks": n * chunks,
           "chunk_px": chunk_px}
    if timed:
        row["ms"] = time_call(lambda: group(f_group, stack, **{
            k: v for k, v in args.items() if k != "stack"}), reps=2000)
        row["apply_ms"] = time_call(
            lambda: ds.apply_obs(f_kernel, shape, **args), reps=2000)
        row["plain_ms"] = time_call(
            lambda: ds._apply_obs_plain(f_plain, shape, **args), reps=500)
        row["device_ms"] = device_ms(
            lambda: ds.apply_obs(f_kernel, shape, **args),
            "obs_apply_kernel")
        row["bound_ms"] = bound_ms(row["bytes"], 0)[0]
    log(f"  obs_apply n={n} K={K} S={S} {mode}: equal bit for bit "
        f"({n * chunks} blocks of {chunk_px} pixels)"
        + (f", kernel {row['ms']:.5f} ms per call through the sampler's "
           f"path ({row['apply_ms']:.5f} through apply_obs), plain "
           f"{row['plain_ms']:.5f} ms (kernel device-only "
           f"{row['device_ms']} ms, bound {row['bound_ms']:.3e} ms)"
           if timed else ""))
    return row


def check_categorical_k(k, N, A, timed):
    """K2k against its plain version (actions equal, logp within
    LOGP_TOL), its int32 wire actions in pinned host memory equal to
    its device actions, and at k=1 against K2 (both outputs equal bit
    for bit). Timed: `ms` per call with the wire output (the sampler's
    form), `bare_ms` without it."""
    import torch
    from ray_tpu_torch.models import distributions
    g = torch.Generator(device="cuda").manual_seed(k * N * A)
    logits = torch.randn(N, A, generator=g, device="cuda") * 3.0
    u = torch.rand(k, N, A, generator=g, device="cuda")
    host = torch.full((k, N), -1, dtype=torch.int32, pin_memory=True)
    err = 0.0
    for explore in (True, False):
        uu = u if explore else None
        actions, logp = distributions.sample_logp_k(logits, uu, explore, k,
                                                    host_actions=host)
        event = torch.cuda.Event()
        event.record()
        want_a, want_logp = distributions._sample_logp_k_plain(
            logits, uu, k, explore)
        event.synchronize()
        if not torch.equal(host.long(), actions.cpu()):
            raise AssertionError(
                f"categorical_k wire actions differ from its device "
                f"actions at k={k} N={N} A={A} explore={explore}")
        torch.cuda.synchronize()
        if not torch.equal(actions, want_a):
            raise AssertionError(
                f"categorical_k kernel picks other actions than plain at "
                f"k={k} N={N} A={A} explore={explore}: "
                f"{int((actions != want_a).sum())} differ")
        e = float((logp - want_logp).abs().max())
        if not e <= LOGP_TOL:
            raise AssertionError(
                f"categorical_k kernel logp err {e} > {LOGP_TOL}")
        err = max(err, e)
        if k == 1:
            a1, l1 = distributions.sample_logp(
                logits, u[0] if explore else None, explore)
            if not (torch.equal(a1, actions[0]) and torch.equal(l1,
                                                                logp[0])):
                raise AssertionError(
                    "categorical_k at k=1 differs from categorical")
    row = {"k": k, "N": N, "A": A, "max_abs_err": err}
    if timed:
        row["ms"] = time_call(
            lambda: distributions.sample_logp_k(logits, u, True, k,
                                                host_actions=host),
            reps=2000)
        row["bare_ms"] = time_call(
            lambda: distributions.sample_logp_k(logits, u, True, k),
            reps=2000)
        row["plain_ms"] = time_call(
            lambda: distributions._sample_logp_k_plain(logits, u, k, True),
            reps=500)
        row["device_ms"] = device_ms(
            lambda: distributions.sample_logp_k(logits, u, True, k,
                                                host_actions=host),
            "categorical_sample_k_kernel")
        row["bound_ms"] = bound_ms(*categorical_k_bytes_ops(k, N, A))[0]
    log(f"  categorical_k k={k} N={N} A={A}: actions equal, wire actions "
        f"equal, logp max_abs_err={err:.3e} (tol {LOGP_TOL})"
        + (", equal to categorical at k=1" if k == 1 else "")
        + (f", kernel {row['ms']:.5f} ms per call with the wire output "
           f"({row['bare_ms']:.5f} without), plain {row['plain_ms']:.5f} "
           f"ms (kernel device-only {row['device_ms']} ms, bound "
           f"{row['bound_ms']:.3e} ms)" if timed else ""))
    return row


def categorical_k_bytes_ops(k, N, A):
    """K2k's bytes and f32 operations for one exploring call: logits
    read once, uniforms read once, int64 actions, f32 logp and int32
    wire actions written once; ~9 operations per draw element (the
    Gumbel noise, the max and the exp-sum) and 3 per draw."""
    return (4 * N * A + 4 * k * N * A + (8 + 4 + 4) * k * N,
            9 * k * N * A + 3 * k * N)


GAUSSIAN_TOL = 1e-6  # |kernel - plain| <= TOL + TOL * |plain|


def gaussian_bytes_ops(B, d, explore=True, record=False):
    """K7's bytes (inputs and normals read once; actions and logp written
    once to the device outputs or, with the step record, to the record
    with the value read once and the inputs and value written once
    more) and f32 operations (exp, mul, add, sub, div, square and two
    sums per element; three per row)."""
    nbytes = 4 * (2 * B * d + (B * d if explore else 0) + B * d + B)
    if record:
        nbytes += 4 * (B + 2 * B * d + B)
    return nbytes, 8 * B * d + 3 * B


def gaussian_inputs(B, d, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mean = torch.randn(B, d, generator=g, device="cuda") * 2.0
    log_std = torch.rand(B, d, generator=g, device="cuda") * 3.0 - 2.0
    inputs = torch.cat([mean, log_std], dim=1).contiguous()
    z = torch.randn(B, d, generator=g, device="cuda")
    value = torch.randn(B, generator=g, device="cuda")
    return inputs, z, value


def check_diag_gaussian(B, d, timed):
    """K7 against its plain version, exploring and not: actions and logp
    within GAUSSIAN_TOL, and the mean itself when not exploring; with
    the step record alone (the Box policy's form, no device outputs) its
    columns equal the device outputs of a call without it, the inputs
    and the value bit for bit. Timed: `ms` per call in the
    policy's form (the record, no device outputs), `bare_ms` with the
    device outputs alone, the device-only time of each, and `tail_ms`,
    the host time of a whole env step's tail (`k7_step_tail`)."""
    import torch
    from ray_tpu_torch.models import distributions as D
    inputs, z, value = gaussian_inputs(B, d, seed=B * d)
    mean = inputs[:, :d]
    record = D.StepRecord(B, 2 * d, pin=True, action_dim=d)
    err = 0.0
    for explore in (True, False):
        zz = z if explore else None
        actions, logp = D.gaussian_sample_logp(inputs, zz, explore)
        want_a, want_logp = D._gaussian_sample_logp_plain(inputs, zz,
                                                          explore)
        torch.cuda.synchronize()
        for got, want in ((actions, want_a), (logp, want_logp)):
            bad = (got - want).abs() > GAUSSIAN_TOL + GAUSSIAN_TOL * \
                want.abs()
            if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"diag_gaussian kernel disagrees with plain at B={B} "
                    f"d={d} explore={explore}: max err "
                    f"{float((got - want).abs().max())}")
            err = max(err, float((got - want).abs().max()))
        if not explore and not torch.equal(actions, mean):
            raise AssertionError("diag_gaussian kernel: actions are not "
                                 "the mean when not exploring")
        want_bytes = [t.cpu().numpy().tobytes()
                      for t in (actions, logp, value, inputs)]
        record.buffer.fill_(0xff)
        out = D.gaussian_sample_logp(inputs, zz, explore, value=value,
                                     record=record)
        record.record_done(inputs.device)
        if [c.tobytes() for c in record.columns()] != want_bytes \
                or out is not None:
            raise AssertionError(
                f"diag_gaussian step record differs from the device "
                f"outputs at B={B} d={d} explore={explore}")
    row = {"B": B, "d": d, "max_abs_err": err}
    if timed:
        path = lambda: D.gaussian_sample_logp(  # noqa: E731
            inputs, z, True, value=value, record=record)
        bare = lambda: D.gaussian_sample_logp(inputs, z, True)  # noqa
        row["ms"] = time_call(path, reps=2000)
        row["bare_ms"] = time_call(bare, reps=2000)
        row["plain_ms"] = time_call(
            lambda: D._gaussian_sample_logp_plain(inputs, z, True),
            reps=500)
        row["device_ms"] = device_ms(path, "diag_gaussian_sample_kernel")
        row["bare_device_ms"] = device_ms(bare,
                                          "diag_gaussian_sample_kernel")
        row["tail_ms"] = host_ms(k7_step_tail(inputs, value), reps=2000)
        row["bound_ms"], row["bound_by"] = bound_ms(
            *gaussian_bytes_ops(B, d, record=True))
    log(f"  diag_gaussian B={B} d={d}: max_abs_err={err:.3e} (tol "
        f"{GAUSSIAN_TOL} + {GAUSSIAN_TOL}*|plain|), mean when not "
        f"exploring, step record (alone) equal to the device outputs"
        + (f"; kernel {row['ms']:.5f} ms per call with the record alone "
           f"({row['bare_ms']:.5f} with device outputs alone), plain "
           f"{row['plain_ms']:.5f} ms (device-only {row['device_ms']} ms "
           f"with the record, {row['bare_device_ms']} without; bound "
           f"{row['bound_ms']:.3e} ms); the env step's tail "
           f"{row['tail_ms']:.5f} ms of host time" if timed else ""))
    return row


def k7_step_tail(inputs, value, seed=0):
    """One Box env step's tail as `TorchPolicy.compute_actions` runs it
    after the forward: from the dist inputs and value on the card to the
    numpy actions, logp, dist inputs and value in hand (the normals, K7
    writing the step record alone, one wait and the copies:
    `sample_step`, `columns`). Returns a callable."""
    return _step_tail(inputs, value, seed, "DiagGaussian")


def eps_greedy_bytes_ops(B, A):
    """K8's bytes (Q-values and uniforms read once, the int64 actions
    written once, to the device or to the host output) and f32
    operations (one comparison per Q-value; the multiply, floor and two
    comparisons of the swap per row)."""
    return 4 * B * A + 8 * B + 8 * B, B * A + 4 * B


def check_eps_greedy(B, A, timed):
    """K8 against its plain version at epsilon 0, 0.3 and 1: the
    actions must be equal, and so must the int64 host output's alone
    (the DQN policy's form, no device output). From B=4
    on, row 0 is all ties, row 1 holds a NaN, row 2 is all NaN and row
    3 ties at its maximum. Timed: `ms` per call in the policy's form,
    `bare_ms` with the device output alone, the device-only time of
    each, and `tail_ms`, the host time of a whole env step's tail
    (`k8_step_tail`)."""
    import torch
    from ray_tpu_torch.models import distributions as D
    from ray_tpu_torch.models import eps_greedy as k8
    g = torch.Generator(device="cuda").manual_seed(B * A + 8)
    q = torch.randn(B, A, generator=g, device="cuda")
    if B >= 4:
        q[0] = 0.5
        q[1, A // 2] = float("nan")
        q[2] = float("nan")
        q[3, 1] = q[3, A - 1] = 9.0
    u = torch.rand(B, 2, generator=g, device="cuda")
    host = D.ActionRecord(B, pin=True, dtype=torch.int64)
    swapped = 0
    for eps in (0.0, 0.3, 1.0):
        got = k8.eps_greedy(q, u, eps)
        want = k8._eps_greedy_plain(q, u, eps)
        torch.cuda.synchronize()
        if got.dtype != torch.int64 or not torch.equal(got, want):
            raise AssertionError(
                f"eps_greedy kernel picks other actions than plain at "
                f"B={B} A={A} eps={eps}: "
                f"{int((got != want).sum())} rows differ")
        host.buffer.fill_(0xff)
        out = k8.eps_greedy(q, u, eps, host_actions=host)
        host.record_done(q.device)
        if host.columns().tobytes() != want.cpu().numpy().tobytes() \
                or out is not None:
            raise AssertionError(
                f"eps_greedy host actions differ from plain at B={B} "
                f"A={A} eps={eps}")
        swapped += int((u[:, 0] < eps).sum())
    row = {"B": B, "A": A, "max_abs_err": 0.0}
    if timed:
        path = lambda: k8.eps_greedy(  # noqa: E731
            q, u, 0.3, host_actions=host)
        bare = lambda: k8.eps_greedy(q, u, 0.3)  # noqa: E731
        row["ms"] = time_call(path, reps=2000)
        row["bare_ms"] = time_call(bare, reps=2000)
        row["plain_ms"] = time_call(
            lambda: k8._eps_greedy_plain(q, u, 0.3), reps=500)
        row["device_ms"] = device_ms(path, "eps_greedy_kernel")
        row["bare_device_ms"] = device_ms(bare, "eps_greedy_kernel")
        row["tail_ms"] = host_ms(k8_step_tail(q, 0.3), reps=2000)
        row["bound_ms"], row["bound_by"] = bound_ms(
            *eps_greedy_bytes_ops(B, A))
    log(f"  eps_greedy B={B} A={A}: actions equal at eps 0, 0.3 and 1 "
        f"({swapped} random swaps), host actions (alone) equal"
        + (f"; kernel {row['ms']:.5f} ms per call with the host output "
           f"alone ({row['bare_ms']:.5f} with the device output alone), "
           f"plain {row['plain_ms']:.5f} ms (device-only "
           f"{row['device_ms']} ms with the host output, "
           f"{row['bare_device_ms']} without; bound {row['bound_ms']:.3e} "
           f"ms); the env step's tail {row['tail_ms']:.5f} ms of host "
           f"time" if timed else ""))
    return row


def k8_step_tail(q, eps, seed=0):
    """One DQN env step's tail as `DQNPolicy.compute_actions` runs it
    after the forward: from the Q-values on the card to the numpy
    actions in hand (the uniforms, K8 writing the host output alone, one
    wait and a copy). Returns a callable."""
    import torch
    from ray_tpu_torch.models import distributions as D
    from ray_tpu_torch.models import eps_greedy as k8
    generator = torch.Generator(device=q.device).manual_seed(seed)
    host = D.ActionRecord(q.shape[0], pin=True, dtype=torch.int64)

    def tail():
        u = torch.rand((q.shape[0], 2), generator=generator,
                       dtype=torch.float32, device=q.device)
        k8.eps_greedy(q, u, eps, host_actions=host)
        host.record_done(q.device)
        return host.columns()
    return tail


def squashed_bytes_ops(B, d, explore=True, host=False):
    """K9f's bytes (x and, exploring, z read once; actions and logp
    written once, and with `host` the actions once more to the host
    output) and f32 operations (~30 per element: the clamp, exp,
    sample, tanh, squash, the Gaussian term and the log-det with its
    softplus' exp and log1p, the row sum; one per row)."""
    return 4 * (2 * B * d + (B * d if explore else 0) + B * d + B
                + (B * d if host else 0)), 30 * B * d + B


def squashed_backward_bytes_ops(B, d):
    """K9b's bytes with both upstream gradients (x, z, g_a and g_logp
    read once, g_x written once) and f32 operations (~20 per element:
    the clamp, exp, sample and tanh again, g_pre, the mask and g_raw)."""
    return 4 * (2 * B * d + B * d + B * d + B + 2 * B * d), 20 * B * d


def squashed_inputs(B, d, seed, margin):
    """K9 inputs on the card: x [B, 2d] = [mean, raw log_std] and z [B, d]
    normals. Every third row's mean is scaled up so that |pre| >= 10
    (tanh saturates) and raw log_std spreads over [-25, 5), beyond both
    clip bounds; with `margin`, no raw log_std lies within it of a bound
    (the backward's mask has a kink there)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mean = torch.randn(B, d, generator=g, device="cuda") * 3.0
    mean[::3] *= 6.0
    raw = torch.rand(B, d, generator=g, device="cuda") * 30.0 - 25.0
    if margin:
        near = ((raw + 20.0).abs() < margin) | ((raw - 2.0).abs() < margin)
        raw = torch.where(near, raw + 3 * margin, raw)
    z = torch.randn(B, d, generator=g, device="cuda")
    return torch.cat([mean, raw], dim=1).contiguous(), z


def _close(got, want, what):
    import torch
    bad = (got - want).abs() > SQUASHED_TOL + SQUASHED_TOL * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: max err "
                             f"{float((got - want).abs().max())}")
    return float((got - want).abs().max())


def check_squashed_gaussian(B, d, timed):
    """K9f against its plain version, exploring and not, at low/high =
    +-2; K9b against its plain backward with both upstream gradients and
    with each one absent, and through the autograd function (K9b must
    launch for a gradient to x). Within SQUASHED_TOL."""
    import torch
    from ray_tpu_torch.models import distributions as D
    low, high = -2.0, 2.0
    x, z = squashed_inputs(B, d, seed=B * d + 9, margin=0.0)
    if B >= 256:
        pre = x[:, :d] + torch.exp(x[:, d:].clamp(-20.0, 2.0)) * z
        if not (bool((pre.abs() >= 10).any()) and bool((x[:, d:] < -20).any())
                and bool((x[:, d:] > 2).any())):
            raise AssertionError("K9 inputs miss the saturating or clipped "
                                 "cases")
    err = 0.0
    for explore in (True, False):
        zz = z if explore else None
        got = D.squashed_gaussian_sample_logp(x, zz, low, high, explore)
        want = D._squashed_gaussian_plain(x, zz, low, high, explore)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("actions", "logp")):
            err = max(err, _close(g, w, f"squashed_gaussian {what} at "
                                        f"B={B} d={d} explore={explore}"))
        if bool((got[0] < low).any()) or bool((got[0] > high).any()):
            raise AssertionError("squashed_gaussian: an action out of "
                                 "[low, high]")
        host = D.ActionRecord(B, d, pin=True)
        again = D.squashed_gaussian_sample_logp(x, zz, low, high, explore,
                                                host_actions=host)
        host.record_done(x.device)
        if host.columns().tobytes() != again[0].cpu().numpy().tobytes() \
                or not torch.equal(again[0], got[0]):
            raise AssertionError(f"squashed_gaussian host actions differ "
                                 f"from the device's at B={B} d={d} "
                                 f"explore={explore}")
    xb, zb = squashed_inputs(B, d, seed=B * d + 10, margin=1e-3)
    g = torch.Generator(device="cuda").manual_seed(B + d)
    ga = torch.randn(B, d, generator=g, device="cuda")
    gl = torch.randn(B, generator=g, device="cuda")
    # As autograd hands them to the tail: in SAC's actor step g_a is a
    # column slice of the critics' concat gradient (row stride obs_dim +
    # d; Pendulum's obs_dim is 3); the sum of a logp gives an expand.
    ga_slice = torch.randn(B, 3 + d, generator=g, device="cuda")[:, 3:]
    gl_expand = torch.randn(1, generator=g, device="cuda").expand(B)
    err_b = 0.0
    for g_a, g_l in ((ga, gl), (None, gl), (ga, None), (ga_slice, gl),
                     (ga_slice, gl_expand), (None, gl_expand)):
        got = D._squashed_gaussian_backward_cuda(xb, zb, g_a, g_l, low,
                                                 high, True)
        want = D._squashed_gaussian_backward_plain(
            xb, zb, None if g_a is None else g_a.contiguous(),
            None if g_l is None else g_l.contiguous(), low, high, True)
        torch.cuda.synchronize()
        err_b = max(err_b, _close(got, want, f"squashed_gaussian backward "
                                              f"at B={B} d={d}"))
    xg = xb.clone().requires_grad_(True)
    before = D.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches
    torch.autograd.backward(
        D.squashed_gaussian_sample_logp(xg, zb, low, high), [ga, gl])
    if D.SQUASHED_GAUSSIAN_BACKWARD_KERNEL.launches != before + 1:
        raise AssertionError("the tail's gradient did not launch K9b")
    err_b = max(err_b, _close(xg.grad, D._squashed_gaussian_backward_plain(
        xb, zb, ga, gl, low, high, True), "squashed_gaussian autograd"))
    row = {"B": B, "d": d, "max_abs_err": err, "max_abs_err_backward": err_b}
    if timed:
        row["ms"] = time_call(lambda: D.squashed_gaussian_sample_logp(
            x, z, low, high, True), reps=2000)
        row["plain_ms"] = time_call(lambda: D._squashed_gaussian_plain(
            x, z, low, high, True), reps=500)
        row["device_ms"] = device_ms(lambda: D.squashed_gaussian_sample_logp(
            x, z, low, high, True), "squashed_gaussian_sample_kernel")
        xg = x.clone().requires_grad_(True)
        row["grad_ms"] = time_call(lambda: D.squashed_gaussian_sample_logp(
            xg, z, low, high, True), reps=2000)
        row["tail_ms"] = host_ms(k9f_act_tail(x, low, high), reps=2000)
        strided = lambda: D._squashed_gaussian_backward_cuda(  # noqa: E731
            xb, zb, ga_slice, gl, low, high, True)
        row["b_ms"] = time_call(strided, reps=2000)
        row["b_dense_ms"] = time_call(
            lambda: D._squashed_gaussian_backward_cuda(
                xb, zb, ga, gl, low, high, True), reps=2000)
        row["b_plain_ms"] = time_call(
            lambda: D._squashed_gaussian_backward_plain(
                xb, zb, ga, gl, low, high, True), reps=500)
        row["b_device_ms"] = device_ms(strided,
                                       "squashed_gaussian_backward_kernel")
    log(f"  squashed_gaussian B={B} d={d}: forward max_abs_err={err:.3e}, "
        f"backward {err_b:.3e} (tol {SQUASHED_TOL} + {SQUASHED_TOL}"
        f"*|plain|; backward with g_a, g_logp, each absent, g_a a column "
        f"slice and g_logp an expand, and through autograd), host actions "
        f"equal"
        + (f"; K9f {row['ms']:.5f} ms ({row['grad_ms']:.5f} for an input "
           f"that needs a gradient) plain {row['plain_ms']:.5f} ms "
           f"(device-only {row['device_ms']} ms), the acting tail "
           f"{row['tail_ms']:.5f} ms of host time; K9b {row['b_ms']:.5f} "
           f"ms with g_a a column slice ({row['b_dense_ms']:.5f} dense) "
           f"plain {row['b_plain_ms']:.5f} ms (device-only "
           f"{row['b_device_ms']} ms)" if timed else ""))
    return row


def check_squashed_gaussian_all():
    """K9 at the SAC path's shapes (1 x 1 per env step, 256 x 1 per
    update; both timed) and at 256 x 6 and 4096 x 17. -> (the 256 x 1
    row, its K9f bound, its K9b bound)."""
    check_squashed_gaussian(1, 1, timed=True)
    row = check_squashed_gaussian(256, 1, timed=True)
    check_squashed_gaussian(256, 6, timed=False)
    check_squashed_gaussian(4096, 17, timed=False)
    fwd = bound_ms(*squashed_bytes_ops(256, 1))
    bwd = bound_ms(*squashed_backward_bytes_ops(256, 1))
    log(f"  bound ms at B=256 d=1: squashed_gaussian_sample {fwd[0]:.3e} "
        f"({fwd[1]}), squashed_gaussian_backward {bwd[0]:.3e} ({bwd[1]})")
    return row, fwd, bwd


ENV_TIMED_REPS, ENV_TIMED_WARMUP = 1000, 10


def device_env_bytes(kind, n, ends):
    """Bytes one env step must move: per env the state, the action and the
    running episode's reward and length read once, and the state, the
    observation, the reward, the done flag and the running episode
    written once; the three completed-episode sums read and written only
    for the `ends` envs whose episode the step ends."""
    if kind == "synthetic_atari_step":
        per_env = (4 + 4 + 8 + 8) + (4 + 4 + 84 * 84 * 4 + 4 + 1 + 8)
    else:
        per_env = (16 + 4 + 8 + 8) + (16 + 4 + 16 + 4 + 1 + 8)
    return n * per_env + ends * 2 * 12


BOUND_STEPS = 6  # K5b's bound step: steps held against plain
BOUND_SLOTS = 20  # and slots cycled when timed (CartPole Anakin's T)


def cartpole_bound_timing(n):
    """K5b through the bound step as the Anakin optimizer calls it (one
    slot after another of env-major buffers, the counter advancing):
    per call (CUDA events over back-to-back calls), device-only time, the
    device operations of one call, and the episode ends per timed
    step."""
    from ray_tpu_torch.rllib.env import device_env as de
    from ray_tpu_torch.rllib.env import device_env_check as dec
    env, state, ep, actions, _, slots = dec.bound_case(
        n, BOUND_SLOTS, "cuda", seed=n)
    step = env.bind(state, *slots, seed=dec.SEED, episodes=ep)
    acts = list(actions.unbind(0))
    calls = [0]

    def bound():
        i = calls[0]
        calls[0] = i + 1
        t = i % BOUND_SLOTS
        step(acts[t], t, dec.COUNTER + i)

    generic = de.CARTPOLE_KERNEL.launches
    ends = int(ep.done_cnt.sum())
    row = {"ms": time_call(bound, reps=ENV_TIMED_REPS,
                           warmup=ENV_TIMED_WARMUP)}
    row["ends_per_step"] = (int(ep.done_cnt.sum()) - ends) / calls[0]
    row["device_ms"] = device_ms(bound, "cartpole_kernel")
    row["device_ops"] = device_work_per_call(bound)[0]
    if de.CARTPOLE_KERNEL.launches != generic:
        raise AssertionError("the bound step launched the generic entry "
                             "point")
    return row


def check_device_env(kind, n, timed):
    """K5a or K5b against its plain version (`device_env_check`), reset
    and step (K5b also through the bound step); timed, the step repeated
    on its own output state (K5b: through the bound step, and through
    `DeviceEnv.step` as `generic_ms`), with the bytes of the episodes
    those timed steps ended."""
    import torch
    from ray_tpu_torch.rllib.env import device_env as de
    from ray_tpu_torch.rllib.env import device_env_check as dec
    atari = kind == "synthetic_atari_step"
    env = de.DeviceSyntheticAtari() if atari else de.DeviceCartPole()
    res = [dec.compare_with_plain(env, n, reset, seed=n)
           for reset in (True, False)]
    if not atari:
        res.append(dec.compare_bound_with_plain(n, BOUND_STEPS, seed=n))
    max_ulps = max(r["max_ulps"] for r in res)
    max_err = max(r["max_abs_err"] for r in res)
    row = {"kind": kind, "n": n, "max_abs_err": max_err,
           "max_ulps": max_ulps}
    if timed:
        state, actions, ep = dec.env_case(env, n, "cuda", seed=n)
        obs = env.empty_obs(n, "cuda")
        rew = torch.empty(n, device="cuda")
        done = torch.empty(n, dtype=torch.bool, device="cuda")
        args = (state, actions, obs, rew, done, ep, dec.SEED, dec.COUNTER,
                False)

        def kernel():
            env._launch(*args)

        ends = int(ep.done_cnt.sum())
        generic_ms = time_call(kernel, reps=ENV_TIMED_REPS,
                               warmup=ENV_TIMED_WARMUP)
        row["ends_per_step"] = (int(ep.done_cnt.sum()) - ends) / (
            ENV_TIMED_REPS + ENV_TIMED_WARMUP)
        row["plain_ms"] = time_call(lambda: dec.plain_launch(env, *args),
                                    reps=10 if atari else 200, warmup=2)
        if atari:
            row["ms"] = generic_ms
            row["device_ms"] = device_ms(kernel, "synthetic_atari_kernel")
        else:
            row["generic_ms"] = generic_ms
            row["generic_device_ms"] = device_ms(kernel, "cartpole_kernel")
            row.update(cartpole_bound_timing(n))
        row["bytes"] = device_env_bytes(kind, n, row["ends_per_step"])
    log(f"  {kind} n={n}: reset and step equal to plain"
        + (f" (state within {max_ulps} ulp, max_abs_err {max_err:.3e})"
           if not atari else " byte for byte")
        + ("" if atari else f", {BOUND_STEPS} bound steps too")
        + (f", kernel {row['ms']:.5f} ms plain {row['plain_ms']:.5f} ms "
           f"(kernel device-only {row['device_ms']} ms; "
           f"{row['ends_per_step']:.4f} episode ends per timed step, "
           f"{row['bytes']:.1f} B per step)" if timed else "")
        + (f"; through the bound step: {row['device_ops']:.2f} device "
           f"operations per call; through DeviceEnv.step "
           f"{row['generic_ms']:.5f} ms, device-only "
           f"{row['generic_device_ms']} ms" if timed and not atari
           else ""))
    return row


# ---------------------------------------------------------------------
# phase 3: the trainer
# ---------------------------------------------------------------------
def run_trainer(with_summary=False):
    """Phase 3's local-mode run. -> (the trained weights, the launch
    counts), and its summary with `with_summary`."""
    import torch
    from ray_tpu_torch.models import distributions
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer, vtrace

    t0 = time.perf_counter()
    trainer = IMPALATrainer(config=dict(TRAINER_CONFIG))
    policy = trainer.get_policy()
    log(f"  trainer built in {time.perf_counter() - t0:.2f} s: "
        f"{policy.num_params()} params, trunk "
        f"{policy.model.compute_dtype}, device {policy.device}")
    want = torch.device(TRAINER_CONFIG["device"]).type
    for p in policy.model.parameters():
        if p.device.type != want:
            raise AssertionError(f"parameter on {p.device}, not {want}")

    torch.cuda.reset_peak_memory_stats()
    vtrace.VTRACE_KERNEL.launches = 0
    distributions.CATEGORICAL_KERNEL.launches = 0
    timers = trainer.optimizer.timers
    iters = []
    try:
        for i in range(TRAIN_ITERS + 1):
            # The last iteration runs under the profiler (for the device
            # busy share); the others give the timings.
            profiled = i == TRAIN_ITERS
            sample0, learn0 = timers["sample"].total, timers["learn"].total
            t0 = time.perf_counter()
            if profiled:
                result, prof = profile_iteration(trainer)
            else:
                result = trainer.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = result["timesteps_this_iter"]
            loss = result["info"]["learner"]["total_loss"]
            row = {"s": dt, "steps": steps, "loss": loss,
                   "sample_s": timers["sample"].total - sample0,
                   "learn_s": timers["learn"].total - learn0}
            log(f"  iter {i}{' (profiled)' if profiled else ''}: "
                f"{dt:.3f} s, {steps} env steps, {steps / dt:.1f} env "
                f"steps/s, sample {row['sample_s']:.3f} s, learner grad "
                f"{row['learn_s']:.4f} s, total_loss {loss:.4f}")
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite loss at iter {i}")
            if not profiled:
                iters.append(row)
    finally:
        trainer.stop()
    launches = {"vtrace": vtrace.VTRACE_KERNEL.launches,
                "categorical": distributions.CATEGORICAL_KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    sampled = result["num_steps_sampled"]
    trained = result["num_steps_trained"]
    if trained <= 0:
        raise AssertionError("no steps trained")
    if launches["categorical"] != sampled // NUM_ENVS:
        raise AssertionError(
            f"sampling kernel launched {launches['categorical']} times for "
            f"{sampled // NUM_ENVS} env steps")
    updates = trained // TRAINER_CONFIG["train_batch_size"]
    if launches["vtrace"] != updates or updates <= 0:
        raise AssertionError(
            f"vtrace kernel launched {launches['vtrace']} times for "
            f"{updates} updates")
    steady = iters[1:]  # the first iteration includes cuDNN's warm-up
    steady_s = sum(r["s"] for r in steady)
    summary = {
        "iterations": len(iters) + 1,
        "iter_s": [round(r["s"], 4) for r in iters],
        "env_steps_per_s_steady": sum(r["steps"] for r in steady)
        / steady_s,
        "iter_s_steady_mean": steady_s / len(steady),
        "sample_s_steady_mean": sum(r["sample_s"] for r in steady)
        / len(steady),
        "learner_grad_ms_steady_mean": 1e3 * sum(
            r["learn_s"] for r in steady) / len(steady),
        "num_steps_sampled": sampled,
        "num_steps_trained": trained,
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "profiled_iteration": prof,
    }
    log(f"  trainer summary: {json.dumps(summary)}")
    if with_summary:
        return policy.get_weights(), launches, summary
    return policy.get_weights(), launches


def profile_iteration(trainer):
    """One `train()` under torch.profiler: the device's busy time (sum of
    the kernels' device time) against the iteration's wall time, and the
    kernels that took the most device time. The profiler's own host
    overhead lengthens the wall time, so the idle share is an upper
    bound. User-annotated ranges (the optimizer's
    `Optimizer.step#Adam.step` spans the kernels it launches) are not
    device work of their own and are left out, so no kernel counts
    twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    report = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_kernel_launches": sum(e.count for e in kernels),
        "device_idle_share": 1.0 - busy_ms / wall_ms if kernels
        else "not measured",
        "top_kernels": [[e.key[:60], e.count,
                         e.self_device_time_total / 1e3] for e in top],
    }
    return result, report


def check_update_against_cpu(weights):
    """One V-trace update of the trained weights (f32 trunk, TF32 off)
    on the card — K1 inside the loss — against the same update on the
    CPU with the plain version: stats within rtol/atol 1e-4."""
    import numpy as np
    import torch
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import \
        VTraceTorchPolicy
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    n = 2 * FRAGMENT
    space = Box(0, 255, (84, 84, 4), np.uint8)
    cfg = {"model": {"compute_dtype": "f32"},
           "rollout_fragment_length": FRAGMENT, "seed": 0, "lr": 6e-4,
           "grad_clip": 40.0}
    out = {}
    batch = {
        sb.OBS: rng.integers(0, 256, (n, 84, 84, 4), dtype=np.uint8),
        sb.NEW_OBS: rng.integers(0, 256, (n, 84, 84, 4), dtype=np.uint8),
        sb.ACTIONS: rng.integers(0, NUM_ACTIONS, n),
        sb.REWARDS: rng.random(n).astype(np.float32),
        sb.DONES: rng.random(n) < 0.01,
        sb.ACTION_DIST_INPUTS: rng.standard_normal(
            (n, NUM_ACTIONS)).astype(np.float32)}
    for device in ("cuda", "cpu"):
        policy = VTraceTorchPolicy(space, Discrete(NUM_ACTIONS),
                                   dict(cfg, device=device))
        policy.set_weights(weights)
        out[device] = policy.learn_on_batch(sb.SampleBatch(batch))
    for k, want in out["cpu"].items():
        got = out["cuda"][k]
        if not abs(got - want) <= 1e-4 + 1e-4 * abs(want):
            raise AssertionError(
                f"card update disagrees with CPU on {k}: {got} vs {want}")
    pairs = {k: [out["cuda"][k], v] for k, v in out["cpu"].items()}
    log(f"  card vs CPU update (f32, TF32 off): {json.dumps(pairs)}")


def transfer_shares(d, wall_s, actors):
    """Per-step upload bytes, the share of each actor's wall time spent
    waiting for actions and stepping envs, and the mean selection lag,
    from summed transfer-stat deltas over `wall_s` seconds."""
    return {
        "bytes_h2d_per_step": d["bytes_h2d"] / max(1, d["steps"]),
        "action_fetch_pct": 100 * d["t_fetch_s"] / (wall_s * actors),
        "env_step_pct": 100 * d["t_env_s"] / (wall_s * actors),
        "apply_pct": 100 * d["t_apply_s"] / (wall_s * actors),
        "select_pct": 100 * d["t_select_s"] / (wall_s * actors),
        "policy_lag_mean": d["policy_lag_sum"] / max(1, d["steps"]),
    }


class TimedLock:
    """The policy's update lock with a host clock on the inline actors'
    acquisitions (this script's instrumentation): how long the actors
    wait for the learner to finish enqueueing an update."""

    def __init__(self, lock):
        self._lock = lock
        self.actor_wait_s = 0.0

    def __enter__(self):
        import threading
        t0 = time.perf_counter()
        self._lock.acquire()
        if threading.current_thread().name.startswith("inline-actor"):
            self.actor_wait_s += time.perf_counter() - t0
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def time_sampler_dispatch(sampler):
    """Wrap one sampler's two dispatch methods with host-clock timers
    (this script's instrumentation, not the port's): the time its actor
    spends enqueueing the obs apply (upload + K3) and the selection
    window (forward + K2k, which writes the wire actions to the host).
    Returns the dict the timers add to."""
    acc = {"t_apply_s": 0.0, "t_select_s": 0.0}
    for key, name in (("t_apply_s", "_dispatch_apply"),
                      ("t_select_s", "_dispatch_select")):
        inner = getattr(sampler, name)

        def timed(g, _inner=inner, _key=key):
            t0 = time.perf_counter()
            _inner(g)
            acc[_key] += time.perf_counter() - t0
        setattr(sampler, name, timed)
    return acc


def run_sebulba(k):
    """Phase 4 at one `sebulba_onchip_steps`: the Sebulba trainer with
    every launch count at 0 before it is built and read after its actors
    have stopped. Returns (summary, launches)."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import distributions
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer, vtrace
    from ray_tpu_torch.rllib.evaluation import device_sampler as ds

    kernels = {"vtrace": vtrace.VTRACE_KERNEL,
               "categorical": distributions.CATEGORICAL_KERNEL,
               "categorical_k": distributions.CATEGORICAL_K_KERNEL,
               "obs_apply": ds.OBS_APPLY_KERNEL}
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = IMPALATrainer(config=dict(SEBULBA_CONFIG,
                                        sebulba_onchip_steps=k))
    opt = trainer.optimizer
    samplers = [a.sampler for a in opt._inline_actors]
    log(f"  k={k}: trainer built in {time.perf_counter() - t0:.2f} s: "
        f"{len(samplers)} actors x {len(samplers[0].groups)} groups x "
        f"{samplers[0].groups[0].n} envs, delta {samplers[0].delta}, "
        f"stack {samplers[0].frame_stack}, train batch "
        f"{trainer.config['train_batch_size']}")
    if not all(s.delta and s.frame_stack == 4 and s.k == k
               for s in samplers):
        raise AssertionError("Sebulba samplers are not in delta + stack "
                             f"mode at k={k}")
    host_s = {s: time_sampler_dispatch(s) for s in samplers}
    lock = trainer.get_policy()._update_lock = TimedLock(
        trainer.get_policy()._update_lock)
    learner = opt.learner
    rows, prof = [], None
    try:
        for i in range(SEB_ITERS[k] + (1 if k == 1 else 0)):
            profiled = k == 1 and i == SEB_ITERS[k]
            before = [s.transfer_stats() | host_s[s] for s in samplers]
            wait0 = lock.actor_wait_s
            g0 = (learner.grad_timer.total, learner.grad_timer.count)
            t0 = time.perf_counter()
            if profiled:
                result, prof = profile_iteration(trainer)
            else:
                result = trainer.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = [s.transfer_stats() | host_s[s] for s in samplers]
            steps = result["timesteps_this_iter"]
            loss = result["info"]["learner"]["total_loss"]
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite loss at k={k} iter {i}")
            d = {key: sum(a[key] - b[key] for a, b in zip(after, before))
                 for key in ("bytes_h2d", "t_fetch_s", "t_env_s", "steps",
                             "policy_lag_sum", "t_apply_s", "t_select_s")}
            updates = learner.grad_timer.count - g0[1]
            row = {"s": dt, "steps": steps, "loss": loss,
                   "updates": updates, "deltas": d,
                   "grad_ms": 1e3 * (learner.grad_timer.total - g0[0])
                   / max(1, updates),
                   **transfer_shares(d, dt, len(samplers))}
            d["t_lock_s"] = lock.actor_wait_s - wait0
            row["lock_wait_pct"] = 100 * d["t_lock_s"] / (dt * len(samplers))
            log(f"  k={k} iter {i}{' (profiled)' if profiled else ''}: "
                f"{dt:.3f} s, {steps} env steps, {steps / dt:.1f} env "
                f"steps/s, {updates} updates, learner grad "
                f"{row['grad_ms']:.2f} ms/update, "
                f"{row['bytes_h2d_per_step']:.1f} B/step up, fetch "
                f"{row['action_fetch_pct']:.1f}%, env "
                f"{row['env_step_pct']:.1f}%, apply "
                f"{row['apply_pct']:.1f}%, select "
                f"{row['select_pct']:.1f}% (update-lock wait "
                f"{row['lock_wait_pct']:.1f}%), lag "
                f"{row['policy_lag_mean']:.3f}, total_loss {loss:.4f}")
            if not profiled:
                rows.append(row)
    finally:
        trainer.stop()
    if any(a.is_alive() for a in opt._inline_actors) or learner.is_alive():
        raise AssertionError("Sebulba threads still running after stop()")
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    # Launch counts: each group's pipeline was primed once (one apply,
    # one select) and then ran one apply per env step and one select per
    # window; the actors stop at fragment ends, so every consumed window
    # was followed by the next one's dispatch.
    want_apply = sum(len(s.groups) + s.steps_total // s.groups[0].n
                     for s in samplers)
    want_select = sum(len(s.groups) + s.fetch_waits for s in samplers)
    want_updates = learner.grad_timer.count
    checks = {"obs_apply": want_apply, "categorical_k": want_select,
              "vtrace": want_updates, "categorical": 0}
    for name, want in checks.items():
        if launches[name] != want:
            raise AssertionError(
                f"k={k}: {name} kernel launched {launches[name]} times, "
                f"the path ran it {want} times")
    if min(want_apply, want_select, want_updates) <= 0:
        raise AssertionError(f"k={k}: a kernel of the path never ran")

    # The rebuilt observations: each group's retained frames and its
    # newest stack channel equal the env's canonical frames.
    for s in samplers:
        for g in s.groups:
            canon = torch.from_numpy(np.ascontiguousarray(
                g.env.inner._frames[:, :-1]))
            frames = g.frames_d.cpu()
            newest = g.obs_next[..., -1].reshape(g.n, -1).cpu()
            if not (torch.equal(frames, canon)
                    and torch.equal(newest, canon)):
                raise AssertionError(
                    f"k={k}: device frames differ from the env's own")
    steady = rows[1:]
    steady_s = sum(r["s"] for r in steady)
    summary = {
        "k": k,
        "iterations": len(rows) + (1 if prof else 0),
        "iter_s": [round(r["s"], 4) for r in rows],
        "env_steps_per_s_steady": sum(r["steps"] for r in steady)
        / steady_s,
        "learner_grad_ms_steady_mean": sum(
            r["grad_ms"] * r["updates"] for r in steady) / max(1, sum(
                r["updates"] for r in steady)),
        "updates_steady": sum(r["updates"] for r in steady),
        "transfer_steady": transfer_shares(
            {key: sum(r["deltas"][key] for r in steady)
             for key in steady[0]["deltas"]}, steady_s, len(samplers))
        | {"lock_wait_pct": 100 * sum(r["deltas"]["t_lock_s"]
                                      for r in steady)
           / (steady_s * len(samplers))},
        "transfer_total": opt.stats()["transfer"],
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "profiled_iteration": prof,
    }
    log(f"  sebulba summary k={k}: {json.dumps(summary)}")
    return summary, launches


# ---------------------------------------------------------------------
# phase 5: Anakin
# ---------------------------------------------------------------------
def sync_checked_step(opt):
    """The optimizer's step with its enqueue under sync-debug mode
    "error": a host sync anywhere before the call's one read raises."""
    import torch

    def step():
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = opt.enqueue()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return opt.finish(pending)
    return step


def run_anakin_calls(config, calls, env_kernel, sync_call=None,
                     profile_last=False, absent=()):
    """`calls` trainer iterations (one optimizer call each) of the Anakin
    trainer: every launch count set to 0 before each call and held after
    it to one env kernel and one sampling kernel per env step, one
    V-trace per update and no launch of the `absent` kernels. Returns
    (trainer, per-call rows, launch totals, profile of the last call or
    None)."""
    import torch
    from ray_tpu_torch.models import distributions
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer, vtrace
    kernels = {env_kernel.name: env_kernel,
               "categorical": distributions.CATEGORICAL_KERNEL,
               "vtrace": vtrace.VTRACE_KERNEL}
    kernels.update({k.name: k for k in absent})
    T, M = config["rollout_fragment_length"], \
        config["anakin_updates_per_call"]
    want = {env_kernel.name: T * M, "categorical": T * M, "vtrace": M}
    want.update({k.name: 0 for k in absent})
    totals = dict.fromkeys(kernels, 0)
    t0 = time.perf_counter()
    trainer = IMPALATrainer(config=dict(config))
    opt = trainer.optimizer
    log(f"  trainer built in {time.perf_counter() - t0:.2f} s: "
        f"{trainer.get_policy().num_params()} params, "
        f"{opt.num_envs} envs x {opt.T} steps x {opt.updates_per_call} "
        f"updates per call, obs buffer {opt._obs.nbytes} B")
    step = opt.step
    rows, prof = [], None
    for i in range(calls):
        for k in kernels.values():
            k.launches = 0
        opt.step = sync_checked_step(opt) if i == sync_call else step
        profiled = profile_last and i == calls - 1
        t0 = time.perf_counter()
        if profiled:
            result, prof = profile_iteration(trainer)
        else:
            result = trainer.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        opt.step = step
        got = {name: k.launches for name, k in kernels.items()}
        if got != want:
            raise AssertionError(f"call {i}: launches {got}, the path "
                                 f"ran {want}")
        for name in totals:
            totals[name] += got[name]
        loss = result["info"]["learner"]["total_loss"]
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss at call {i}")
        row = {"s": dt, "steps": result["timesteps_this_iter"],
               "loss": loss, "episodes_total": result["episodes_total"],
               "episode_len_mean": result["episode_len_mean"],
               "episode_reward_mean": result["episode_reward_mean"]}
        rows.append(row)
        tag = (" (sync-debug error mode)" if i == sync_call else
               " (profiled)" if profiled else "")
        log(f"  call {i}{tag}: {dt:.4f} s, {row['steps']} env steps, "
            f"{row['steps'] / dt:.1f} env steps/s, total_loss "
            f"{loss:.4f}, episodes_total {row['episodes_total']}, "
            f"episode_len_mean {row['episode_len_mean']}, "
            f"episode_reward_mean {row['episode_reward_mean']}")
    return trainer, rows, totals, prof


def run_anakin():
    """Phase 5 on SyntheticAtari-v0 at bench.py's shape. Returns the
    trainer (still live, for the update check), summary and launches."""
    import torch
    from ray_tpu_torch.rllib.env import device_env as de
    torch.cuda.reset_peak_memory_stats()
    trainer, rows, launches, prof = run_anakin_calls(
        ANAKIN_CONFIG, ANAKIN_CALLS, de.SYNTHETIC_ATARI_KERNEL,
        sync_call=1, profile_last=True)
    peak = torch.cuda.max_memory_allocated()
    # Episode accounting: all envs start at t=0, so every episode ends at
    # env step 1000 (the episode length), inside call 999 // 128 = 7.
    episode_len = trainer.optimizer.env.episode_len
    boundary = (episode_len - 1) // (ANAKIN_FRAGMENT * ANAKIN_UPDATES)
    for i, row in enumerate(rows):
        want = ANAKIN_ENVS if i >= boundary else 0
        if row["episodes_total"] != want:
            raise AssertionError(f"call {i}: episodes_total "
                                 f"{row['episodes_total']}, want {want}")
    if rows[boundary]["episode_len_mean"] != episode_len:
        raise AssertionError("episode_len_mean at the boundary is "
                             f"{rows[boundary]['episode_len_mean']}")
    if not math.isfinite(rows[boundary]["episode_reward_mean"]):
        raise AssertionError("no episode reward mean at the boundary")
    steady = rows[2:-1]  # not the warm-up, sync-debug or profiled calls
    steady_s = sum(r["s"] for r in steady)
    stats = trainer.optimizer.stats()
    summary = {
        "calls": len(rows),
        "call_s": [round(r["s"], 4) for r in rows],
        "env_steps_per_s_steady": sum(r["steps"] for r in steady)
        / steady_s,
        "call_ms_steady_mean": 1e3 * steady_s / len(steady),
        "anakin_call_time_ms": stats["timing"]["anakin_call_time_ms"],
        "episodes_total": stats["episodes_total"],
        "episode_len_mean": stats["episode_len_mean"],
        "episode_reward_mean": stats["episode_reward_mean"],
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "profiled_call": prof,
    }
    log(f"  anakin summary: {json.dumps(summary)}")
    return trainer, summary, launches


def check_anakin_update_against_cpu(trainer, rows=1024):
    """One V-trace update on the first `rows` rows (whole fragments) of a
    batch the card's Anakin optimizer records, from the trainer's
    weights, with an f32 trunk and TF32 off, on the card (K1 inside the
    loss) and on the CPU (plain): stats and post-update weights within
    rtol/atol 1e-4."""
    import torch
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import \
        VTraceTorchPolicy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    policy, opt = trainer.get_policy(), trainer.optimizer
    fragments = rows // opt.T
    with policy._update_lock:
        batch = opt._rollout()
    cols = {k: (v[:fragments] if k == sb.BOOTSTRAP_OBS else v[:rows]).cpu()
            for k, v in batch.items()}
    weights = policy.get_weights()
    cfg = {"model": dict(policy.config["model"], compute_dtype="f32"),
           "rollout_fragment_length": opt.T, "seed": 0,
           "lr": ANAKIN_CONFIG["lr"], "grad_clip": 40.0}
    out = {}
    for device in ("cuda", "cpu"):
        p = VTraceTorchPolicy(policy.observation_space, policy.action_space,
                              dict(cfg, device=device))
        p.set_weights(weights)
        with p._update_lock:
            stats = p.apply_update({k: v.to(device) for k, v in
                                    cols.items()})
        out[device] = ({k: float(v.detach()) for k, v in stats.items()},
                       p.get_weights())
    (card_stats, card_w), (cpu_stats, cpu_w) = out["cuda"], out["cpu"]
    for k, want in cpu_stats.items():
        if not abs(card_stats[k] - want) <= 1e-4 + 1e-4 * abs(want):
            raise AssertionError(f"card update disagrees with CPU on {k}: "
                                 f"{card_stats[k]} vs {want}")
    worst = 0.0
    for k, want in cpu_w.items():
        excess = (abs(card_w[k] - want) - 1e-4 * abs(want)).max()
        worst = max(worst, float(excess))
        if excess > 1e-4:
            raise AssertionError(f"card update's {k} disagrees with CPU")
    moved = max(float(abs(card_w[k] - weights[k]).max()) for k in cpu_w)
    log(f"  {rows}-row update, card vs CPU (f32, TF32 off): stats "
        f"{json.dumps({k: [card_stats[k], v] for k, v in cpu_stats.items()})}"
        f"; weights within 1e-4 + 1e-4*|w| (worst excess over the "
        f"relative part {worst:.3e}; largest move {moved:.3e})")


def run_anakin_cartpole():
    """The CartPole Anakin config on the card, so K5b runs on a path:
    every env step through the optimizer's bound step."""
    from ray_tpu_torch.rllib.env import device_env as de
    trainer, rows, launches, _ = run_anakin_calls(
        CARTPOLE_ANAKIN_CONFIG, CARTPOLE_CALLS, de.CARTPOLE_BOUND_KERNEL,
        absent=(de.CARTPOLE_KERNEL,))
    trainer.stop()
    steady = rows[1:]
    summary = {"calls": len(rows),
               "env_steps_per_s_steady": sum(r["steps"] for r in steady)
               / sum(r["s"] for r in steady),
               "episode_reward_mean": rows[-1]["episode_reward_mean"],
               "launches": launches}
    log(f"  cartpole anakin summary: {json.dumps(summary)}")
    return launches


# ---------------------------------------------------------------------
# phase 2: the q8 exchange's kernels
# ---------------------------------------------------------------------
def check_q8_encode(nb, edge, timed):
    """K6a against its plain version (codes, scales, residuals bit for
    bit); timed, the encode repeated on its own residual."""
    import torch
    from ray_tpu_torch.parallel import collectives, q8_check
    (g, ef), err = q8_check.check_encode(nb, seed=nb, edge=edge)
    row = {"nb": nb, "edge": edge, "max_abs_err": err}
    if timed:
        wire = torch.empty(collectives.wire_size(nb), dtype=torch.uint8,
                           device="cuda")
        row["ms"] = time_call(
            lambda: collectives.q8_encode_ef(g, ef, wire), reps=2000)
        row["plain_ms"] = time_call(
            lambda: collectives._q8_encode_ef_plain(g, ef, wire), reps=200)
        row["device_ms"], row["device_ms_cold_l2"] = (device_ms(
            lambda: collectives.q8_encode_ef(g, ef, wire),
            "q8_encode_kernel", cold=cold) for cold in (False, True))
    log(f"  q8_encode_ef nb={nb}{' edge cases' if edge else ''}: codes, "
        f"scales and residuals equal bit for bit"
        + (f", kernel {row['ms']:.5f} ms plain {row['plain_ms']:.5f} ms "
           f"(kernel device-only {row['device_ms']} ms; "
           f"{row['device_ms_cold_l2']} ms with L2 evicted)"
           if timed else ""))
    return row


def check_q8_gather_sum(world, nb, mean, timed):
    """K6b against its plain version (the sums bit for bit)."""
    from ray_tpu_torch.parallel import collectives, q8_check
    gathered, err = q8_check.check_gather_sum(world, nb, mean,
                                              seed=world * nb)
    row = {"D": world, "nb": nb, "mean": mean, "max_abs_err": err}
    if timed:
        row["ms"] = time_call(
            lambda: collectives.q8_gather_sum(gathered, nb, mean),
            reps=2000)
        row["plain_ms"] = time_call(
            lambda: collectives._q8_gather_sum_plain(gathered, nb, mean),
            reps=200)
        row["device_ms"], row["device_ms_cold_l2"] = (device_ms(
            lambda: collectives.q8_gather_sum(gathered, nb, mean),
            "q8_gather_sum_kernel", cold=cold) for cold in (False, True))
    log(f"  q8_gather_sum D={world} nb={nb} mean={mean}: equal bit for bit"
        + (f", kernel {row['ms']:.5f} ms plain {row['plain_ms']:.5f} ms "
           f"(kernel device-only {row['device_ms']} ms; "
           f"{row['device_ms_cold_l2']} ms with L2 evicted)"
           if timed else ""))
    return row


def check_q8_gather_sum_unpack(world, mean, timed):
    """K6b with the Nature CNN's leaf table against its plain version and
    against the packed-order K6b indexed by the plan (bit for bit);
    timed, per call through `Q8Decode` as the exchange calls it, device
    time (warm and with the L2 evicted) and the device operations of one
    call."""
    import numpy as np
    from ray_tpu_torch.models import catalog
    from ray_tpu_torch.parallel import collectives, q8_check
    from ray_tpu_torch.rllib.env.spaces import Box
    model = catalog.get_model(Box(0, 255, (84, 84, 4), np.uint8),
                              NUM_ACTIONS, {})
    decode, gathered, err = q8_check.check_gather_sum_unpack(
        model, world, mean, seed=world * 7)
    row = {"D": world, "mean": mean, "max_abs_err": err, "nb": decode.nb,
           "numel": decode.numel, "tiles": decode.num_tiles}
    if timed:
        call = lambda: decode(gathered, mean)  # noqa: E731
        row["ms"] = time_call(call, reps=2000)
        row["plain_ms"] = time_call(
            lambda: collectives._q8_gather_sum_unpack_plain(
                gathered, decode.nb, mean, decode.table), reps=100)
        row["device_ms"], row["device_ms_cold_l2"] = (device_ms(
            call, "q8_gather_sum_unpack_kernel", cold=cold)
            for cold in (False, True))
        row["device_ops"] = device_work_per_call(call)[0]
    log(f"  q8_gather_sum with the leaf table D={world} mean={mean} "
        f"({decode.numel} elements, {decode.num_tiles} tiles): equal bit "
        f"for bit to plain and to the packed sum indexed"
        + (f", kernel {row['ms']:.5f} ms plain {row['plain_ms']:.5f} ms "
           f"(kernel device-only {row['device_ms']} ms; "
           f"{row['device_ms_cold_l2']} ms with L2 evicted; "
           f"{row['device_ops']:.2f} device operations per call)"
           if timed else ""))
    return row


# ---------------------------------------------------------------------
# phase 6: the data-parallel trainer (each rank a spawned process)
# ---------------------------------------------------------------------
def weights_digest(policy):
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for k, v in sorted(policy.get_weights().items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def dp_fixed_update(group, weights, device):
    """One q8 V-trace update of this rank's share of a seeded batch (one
    50-step fragment per rank) from `weights`, f32 trunk, TF32 off: the
    stats."""
    import numpy as np
    import torch
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.agents.impala.vtrace_policy import \
        VTraceTorchPolicy
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    n = group.world_size * FRAGMENT
    cols = {
        sb.OBS: rng.integers(0, 256, (n, 84, 84, 4), dtype=np.uint8),
        sb.NEW_OBS: rng.integers(0, 256, (n, 84, 84, 4), dtype=np.uint8),
        sb.ACTIONS: rng.integers(0, NUM_ACTIONS, n),
        sb.REWARDS: rng.random(n).astype(np.float32),
        sb.DONES: rng.random(n) < 0.01,
        sb.ACTION_DIST_INPUTS: rng.standard_normal(
            (n, NUM_ACTIONS)).astype(np.float32)}
    rows = slice(group.rank * FRAGMENT, (group.rank + 1) * FRAGMENT)
    cfg = {"model": {"compute_dtype": "f32"},
           "rollout_fragment_length": FRAGMENT, "seed": 0, "lr": 6e-4,
           "grad_clip": 40.0, "device": device, "_learner_group": group,
           "allreduce_codec": "q8"}
    policy = VTraceTorchPolicy(Box(0, 255, (84, 84, 4), np.uint8),
                               Discrete(NUM_ACTIONS), cfg)
    policy.set_weights(weights)
    return policy.learn_on_batch(
        sb.SampleBatch({k: v[rows] for k, v in cols.items()}))


def dp_rank(rank, backend):
    """Phase 6 on one rank: the trainer per codec, its checks and numbers,
    then the seeded q8 update from the trained weights."""
    import torch
    from ray_tpu_torch.models import distributions
    from ray_tpu_torch.models.convert import flax_pack_plan
    from ray_tpu_torch.parallel import collectives, q8_check
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer, vtrace
    kernels = {"q8_encode_ef": collectives.Q8_ENCODE_KERNEL,
               "q8_gather_sum": collectives.Q8_GATHER_SUM_KERNEL,
               "q8_gather_sum_unpack": collectives.Q8_GATHER_UNPACK_KERNEL,
               "vtrace": vtrace.VTRACE_KERNEL,
               "categorical": distributions.CATEGORICAL_KERNEL}
    local_envs = DP_CONFIG["num_envs_per_worker"] // DP_RANKS
    out = {"rank": rank}
    for codec, iters in DP_ITERS.items():
        trainer = IMPALATrainer(config=dict(
            DP_CONFIG, allreduce_codec=codec, collective_backend=backend))
        policy, group = trainer.get_policy(), trainer.group
        learner = trainer.optimizer.learner
        torch.cuda.reset_peak_memory_stats(group.device)
        # Setup broadcast the weights and probed the exchange: count the
        # main path from here.
        for kernel in kernels.values():
            kernel.launches = 0
        staging0, rows = group.staging_s, []
        try:
            for i in range(iters):
                g0 = (learner.grad_timer.total, learner.grad_timer.count)
                t0 = time.perf_counter()
                result = trainer.train()
                torch.cuda.synchronize(group.device)
                dt = time.perf_counter() - t0
                digests = group.all_gather_object(weights_digest(policy))
                if len(set(digests)) != 1:
                    raise AssertionError(
                        f"{codec} iter {i}: the ranks' weights differ")
                loss = result["info"]["learner"]["total_loss"]
                if not math.isfinite(loss):
                    raise AssertionError(f"{codec} iter {i}: loss {loss}")
                updates = learner.grad_timer.count - g0[1]
                rows.append({
                    "s": dt, "steps": result["timesteps_this_iter"],
                    "updates": updates, "loss": loss,
                    "grad_ms": 1e3 * (learner.grad_timer.total - g0[0])
                    / max(1, updates)})
        finally:
            trainer.stop()
        updates = learner.grad_timer.count
        launches = {name: k.launches for name, k in kernels.items()}
        q8_updates = updates if codec == "q8" else 0
        want = {"q8_encode_ef": q8_updates, "q8_gather_sum": 0,
                "q8_gather_sum_unpack": q8_updates,
                "vtrace": updates, "categorical":
                trainer.optimizer.num_steps_sampled // local_envs}
        if updates <= 0 or launches != want:
            raise AssertionError(
                f"{codec}: kernel launches {launches} on this rank, the "
                f"path ran {want}")
        trained = trainer.optimizer.num_steps_trained
        if policy.global_timestep != trained * DP_RANKS:
            raise AssertionError(
                f"{codec}: global_timestep {policy.global_timestep}, the "
                f"world trained {trained} rows on each of {DP_RANKS} ranks")
        steady = rows[1:]  # the first includes cuDNN's warm-up
        steady_s = sum(r["s"] for r in steady)
        arm = {
            "iter_s": [round(r["s"], 4) for r in rows],
            "losses": [r["loss"] for r in rows],
            "world_env_steps_per_s_steady":
                sum(r["steps"] for r in steady) / steady_s,
            "learner_grad_ms_steady_mean": sum(
                r["grad_ms"] * r["updates"] for r in steady)
            / max(1, sum(r["updates"] for r in steady)),
            "updates": updates, "launches": launches,
            "staging_ms_per_update":
                1e3 * (group.staging_s - staging0) / updates,
            "payload_bytes": policy.allreduce_payload,
            "wire_bytes": policy.allreduce_wire,
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated(group.device),
        }
        if codec == "q8":
            ef = policy.ef_state
            if not (bool(torch.isfinite(ef).all())
                    and bool((ef != 0).any())):
                raise AssertionError("q8 residuals not finite and nonzero")
            arm["residual_abs_max"] = float(ef.abs().max())
            # The decode section as the exchange runs it (the policy's
            # Q8Decode on gathered images of this world's size): K6b
            # alone, no unpacking gather.
            gathered = q8_check.gathered_case(
                DP_RANKS, policy._q8_decode.nb, seed=rank,
                device=group.device)
            arm["decode_device_ops"] = device_work_per_call(
                lambda: policy._q8_decode(gathered, False))[0]
            if round(arm["decode_device_ops"]) != 1:
                raise AssertionError(
                    f"q8 decode section: {arm['decode_device_ops']} device "
                    "operations per call, want 1")
            sizes = flax_pack_plan(policy.model,
                                   collectives.Q8_BLOCK).leaf_sizes
            arm["exchange_probe_ms"] = {
                c: 1e3 * collectives.allreduce_probe_s(group, sizes, c,
                                                       iters=11)
                for c in collectives.CODECS}
            weights = policy.get_weights()
            out["fixed_update"] = dp_fixed_update(group, weights,
                                                  str(group.device))
            if rank == 0:
                out["weights"] = weights
        out[codec] = arm
    out["backend"], out["device"] = group.backend, str(group.device)
    return out


def dp_cpu_rank(rank, weights):
    """The seeded q8 update on a CPU world of the same size."""
    import torch
    from ray_tpu_torch.parallel.mesh import LearnerGroup
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // DP_RANKS))
    group = LearnerGroup.from_world(DP_RANKS, "gloo", "cpu")
    return dp_fixed_update(group, weights, "cpu")


def run_dp():
    """Phase 6: returns the q8 kernels' launches summed over the ranks."""
    import torch
    from ray_tpu_torch.parallel.distributed import launch
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DP_RANKS else "gloo"
    shared = backend == "gloo"
    log(f"  world of {DP_RANKS} ranks over {backend} on "
        f"{min(cards, DP_RANKS)} card(s)"
        + (": the ranks share one card, so the numbers below describe one "
           "shared card, not scaling" if shared else ""))
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    t0 = time.perf_counter()
    results = launch(dp_rank, DP_RANKS, backend, backend, timeout=900)
    log(f"  world ran in {time.perf_counter() - t0:.1f} s")
    for r in results:
        for codec in DP_ITERS:
            arm = r[codec]
            log(f"  rank {r['rank']} ({r['device']}, {r['backend']}) "
                f"{codec}: {json.dumps(arm)}"
                + (" [ranks share one card]" if shared else ""))
    q8, fp = results[0]["q8"], results[0]["fp32"]
    ratio = fp["payload_bytes"] / q8["payload_bytes"]
    if ratio < 3.5:
        raise AssertionError(f"q8 payload only {ratio:.3f}x below fp32")
    log(f"  payload per update: q8 {q8['payload_bytes']} B (wire "
        f"{q8['wire_bytes']} B with padding), fp32 {fp['payload_bytes']} B:"
        f" {ratio:.4f}x")
    cpu = launch(dp_cpu_rank, DP_RANKS, "gloo", results[0]["weights"],
                 timeout=600)
    for r, want_stats in zip(results, cpu):
        got_stats = r["fixed_update"]
        for k, want in want_stats.items():
            if not abs(got_stats[k] - want) <= 1e-4 + 1e-4 * abs(want):
                raise AssertionError(
                    f"rank {r['rank']}: card world's q8 update disagrees "
                    f"with the CPU world's on {k}: {got_stats[k]} vs "
                    f"{want}")
    pairs = {k: [results[0]["fixed_update"][k], v]
             for k, v in cpu[0].items()}
    log(f"  q8 update, card world vs CPU world of {DP_RANKS} (f32, TF32 "
        f"off): {json.dumps(pairs)}")
    return {name: sum(r[codec]["launches"][name] for r in results
                      for codec in DP_ITERS)
            for name in results[0]["q8"]["launches"]}


# ---------------------------------------------------------------------
# phases 7 and 8: PPO
# ---------------------------------------------------------------------
def sync_checked_sgd(policy):
    """Make the policy's next `sgd_enqueue` run under sync-debug mode
    "error": a host sync anywhere between the phase's first and last
    update raises. The phase's one read (`read_stats`) follows it."""
    import torch
    real = policy.sgd_enqueue
    checked = []

    def enqueue(*args, **kwargs):
        del policy.sgd_enqueue  # once
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked.append(True)
        return out

    policy.sgd_enqueue = enqueue
    return checked


def fc_train_flops_per_row(model):
    """3 x 2 x the multiply-adds of every Linear layer: forward, and the
    two products of the backward."""
    import torch
    macs = sum(m.weight.numel() for m in model.modules()
               if isinstance(m, torch.nn.Linear))
    return 6.0 * macs


def run_ppo(name, config, kernel, num_envs, flops_per_row,
            with_summary=False):
    """`PPO_ITERS` iterations of `PPOTrainer(config)`: iteration 1's
    minibatch phase sync-checked, the last one profiled. `kernel`, the
    sampling tail of the action space, must launch once per env step.
    Returns (trainer, launches, the last train batch as the learner
    got it), and the summary with `with_summary`."""
    import torch
    from ray_tpu_torch.rllib.agents.ppo import PPOTrainer

    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = PPOTrainer(config=dict(config))
    policy = trainer.get_policy()
    log(f"  {name}: trainer built in {time.perf_counter() - t0:.2f} s: "
        f"{policy.num_params()} params, trunk "
        f"{policy.model.compute_dtype}, device {policy.device}")
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    timers = trainer.optimizer.timers
    last_batch = []
    real_learn = trainer.optimizer._learn

    def learn(batch):
        last_batch[:] = [batch]  # standardized in place by `_learn`
        return real_learn(batch)

    trainer.optimizer._learn = learn
    iters, checked = [], []
    for i in range(PPO_ITERS):
        profiled = i == PPO_ITERS - 1
        if i == 1:
            checked = sync_checked_sgd(policy)
        sample0, learn0 = timers["sample"].total, timers["learn"].total
        t0 = time.perf_counter()
        if profiled:
            result, prof = profile_iteration(trainer)
        else:
            result = trainer.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        learner = result["info"]["learner"]
        steps = result["timesteps_this_iter"]
        learn_s = timers["learn"].total - learn0
        rows = (steps // config["sgd_minibatch_size"]) \
            * config["sgd_minibatch_size"] * config["num_sgd_iter"]
        row = {"s": dt, "steps": steps, "sample_s":
               timers["sample"].total - sample0, "learn_s": learn_s,
               "learn_tflops": flops_per_row * rows / learn_s / 1e12,
               "kl_coeff": policy.loss_state_host["kl_coeff"],
               "learner": learner}
        log(f"  {name} iter {i}{' (profiled)' if profiled else ''}"
            f"{' (sgd phase sync-checked)' if i == 1 else ''}: {dt:.3f} s,"
            f" {steps} env steps, {steps / dt:.1f} env steps/s, sample "
            f"{row['sample_s']:.3f} s, learn {learn_s:.4f} s "
            f"({row['learn_tflops']:.3f} TFLOP/s), total_loss "
            f"{learner['total_loss']:.4f}, kl {learner['kl']:.5f}")
        if not all(math.isfinite(v) for v in learner.values()):
            raise AssertionError(f"{name}: non-finite stats at iter {i}")
        iters.append(row)
    if checked != [True]:
        raise AssertionError(f"{name}: the sync-checked phase did not run")
    launches = kernel.launches
    sampled = result["num_steps_sampled"]
    if launches != sampled // num_envs or launches <= 0:
        raise AssertionError(
            f"{name}: {kernel.name} launched {launches} times for "
            f"{sampled // num_envs} env steps")
    steady = iters[1:2]  # iteration 1: warm, and not under the profiler
    summary = {
        "iterations": PPO_ITERS,
        "iter_s": [r["s"] for r in iters],
        "env_steps_per_s_steady": steady[0]["steps"] / steady[0]["s"],
        "sample_s_steady": steady[0]["sample_s"],
        "learn_s_steady": steady[0]["learn_s"],
        "learn_tflops_steady": steady[0]["learn_tflops"],
        "learn_flops_per_row": flops_per_row,
        "num_steps_sampled": sampled,
        "num_steps_trained": result["num_steps_trained"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_before_bytes": held_before,
        "launches": {kernel.name: launches},
        "kl_coeff": [r["kl_coeff"] for r in iters],
        "profiled_iteration": prof,
    }
    log(f"  {name} summary: {json.dumps(summary)}")
    if with_summary:
        return trainer, launches, last_batch[0], summary
    return trainer, launches, last_batch[0]


def ppo_pendulum_config():
    """Phase 8's configuration and its network's training FLOPs per
    row: `PPO_PENDULUM_CONFIG` with PPO's default batch sizes and
    epochs."""
    from ray_tpu_torch.models import catalog
    from ray_tpu_torch.rllib.agents.ppo import DEFAULT_CONFIG as PPO_DEFAULTS
    from ray_tpu_torch.rllib.env.spaces import Box
    fc = catalog.get_model(Box(-8.0, 8.0, (3,)), 2,
                           PPO_PENDULUM_CONFIG["model"])
    config = dict(PPO_PENDULUM_CONFIG, **{
        k: PPO_DEFAULTS[k] for k in ("train_batch_size",
                                     "sgd_minibatch_size", "num_sgd_iter")})
    return config, fc_train_flops_per_row(fc)


def run_ppo_pendulum(with_summary=False):
    """Phase 8: PPO on Pendulum through K7. -> (K7's launches), and the
    summary with `with_summary`."""
    from ray_tpu_torch.models import distributions
    config, flops = ppo_pendulum_config()
    out = run_ppo("ppo_pendulum", config,
                  distributions.DIAG_GAUSSIAN_KERNEL, PPO_PENDULUM_ENVS,
                  flops, with_summary=with_summary)
    out[0].stop()
    gc.collect()
    return (out[1], out[3]) if with_summary else out[1]


def ppo_phase(config, weights, loss_state, batch, epochs, minibatch,
              devices=("cuda", "cpu")):
    """One `sgd_learn` of a `PPOTorchPolicy` built from `config` on each
    of `devices`, from the same weights and loss state, on the same
    batch with the same epoch permutations (drawn on the host and handed
    to `epoch_permutation`). -> {device: the last minibatch's stats}."""
    import numpy as np
    import torch
    from ray_tpu_torch.rllib.agents.ppo import PPOTorchPolicy
    from ray_tpu_torch.rllib.env.spaces import Box, Discrete
    from ray_tpu_torch.rllib.policy import torch_policy
    rng = np.random.default_rng(0)
    rows = batch.count // minibatch * minibatch
    perms = [torch.from_numpy(rng.permutation(rows)) for _ in range(epochs)]
    space = Box(0, 255, (84, 84, 4), np.uint8)
    real = torch_policy.epoch_permutation
    out = {}
    try:
        for device in devices:
            queue = list(perms)
            torch_policy.epoch_permutation = \
                lambda g, n, dev: queue.pop(0).to(dev)
            policy = PPOTorchPolicy(space, Discrete(NUM_ACTIONS),
                                    dict(config, device=device))
            policy.set_weights(weights)
            policy.update_loss_state(**loss_state)
            out[device] = policy.sgd_learn(batch, epochs, minibatch)
    finally:
        torch_policy.epoch_permutation = real
    return out


def check_card_vs_cpu(out, tol, what, slack=None):
    """|card - CPU| <= tol * (1 + |CPU|) on every stat, or, for a stat in
    `slack`, within that stat's own allowance."""
    slack = slack or {}
    pairs = {k: [out["cuda"][k], v] for k, v in out["cpu"].items()}
    log(f"  card vs CPU sgd_learn ({what}; tol {tol}"
        + (f", slack {json.dumps(slack)}" if slack else "")
        + f"): {json.dumps(pairs)}")
    for k, (got, want) in pairs.items():
        allowed = max(tol * (1.0 + abs(want)), slack.get(k, 0.0))
        if not abs(got - want) <= allowed:
            raise AssertionError(
                f"card sgd_learn disagrees with CPU ({what}) on {k}: "
                f"{got} vs {want} (allowed {allowed})")


def check_ppo_against_cpu(trainer, last_batch, rows=1024, minibatch=512,
                          epochs=2):
    """The PPO Atari phase on the card against the same phase on the
    CPU, twice:
    - the path's own phase: its compute dtype (bf16 trunk), the
      trainer's last train batch (standardized, 4,096 rows), its
      minibatch size and epochs, from the trained weights and KL
      coefficient. Every stat within `PPO_BF16_PHASE_TOL` * (1 + |CPU|);
      `grad_gnorm`, which bf16 rounding noise dominates, within half
      the distance between the CPU's bf16 and f32 phases (the card and
      the CPU round differently; neither may stray further from the
      other than bf16 itself moves the norm);
    - f32 trunk, TF32 off, on a synthetic batch (uniform-noise frames,
      random logits) of `rows` rows: within 1e-4 * (1 + |CPU|)."""
    import numpy as np
    import torch
    from ray_tpu_torch.rllib import sample_batch as sb
    policy = trainer.get_policy()
    weights = policy.get_weights()
    loss_state = dict(policy.loss_state_host)
    path_cfg = {k: v for k, v in policy.config.items() if k != "device"}
    dtype = policy.model.compute_dtype
    path = (last_batch, PPO_ATARI_CONFIG["num_sgd_iter"],
            PPO_ATARI_CONFIG["sgd_minibatch_size"])
    out = ppo_phase(path_cfg, weights, loss_state, *path)
    f32_cfg = dict(path_cfg, model=dict(path_cfg.get("model", {}),
                                        compute_dtype="f32"))
    cpu_f32 = ppo_phase(f32_cfg, weights, loss_state, *path,
                        devices=("cpu",))["cpu"]
    gap = abs(out["cpu"]["grad_gnorm"] - cpu_f32["grad_gnorm"])
    log(f"  CPU phase, f32 trunk: {json.dumps(cpu_f32)}")
    check_card_vs_cpu(
        out, PPO_BF16_PHASE_TOL,
        f"the path's phase: trunk {dtype}, {last_batch.count} rows, "
        f"{path[1]} epochs x {last_batch.count // path[2]} minibatches",
        slack={"grad_gnorm": 0.5 * gap})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((rows, NUM_ACTIONS)).astype(np.float32)
    actions = rng.integers(0, NUM_ACTIONS, rows)
    z = logits - logits.max(1, keepdims=True)
    logp = (z - np.log(np.exp(z).sum(1, keepdims=True)))[
        np.arange(rows), actions]
    batch = {
        sb.OBS: rng.integers(0, 256, (rows, 84, 84, 4), dtype=np.uint8),
        sb.ACTIONS: actions, sb.ACTION_DIST_INPUTS: logits,
        sb.ACTION_LOGP: logp.astype(np.float32),
        sb.VF_PREDS: rng.standard_normal(rows).astype(np.float32),
        sb.ADVANTAGES: rng.standard_normal(rows).astype(np.float32),
        sb.VALUE_TARGETS: rng.standard_normal(rows).astype(np.float32)}
    cfg = {k: PPO_ATARI_CONFIG[k] for k in (
        "lr", "lambda", "vf_clip_param", "entropy_coeff", "seed")}
    cfg["model"] = {"compute_dtype": "f32"}
    out = ppo_phase(cfg, weights, {}, sb.SampleBatch(batch), epochs,
                    minibatch)
    check_card_vs_cpu(out, 1e-4, f"synthetic batch, {epochs} epochs x "
                      f"{rows // minibatch} minibatches of {minibatch}, "
                      f"f32, TF32 off")


# ---------------------------------------------------------------------
# phase 9: DQN
# ---------------------------------------------------------------------
def port_kernels():
    """Every hand-written kernel of the port."""
    from ray_tpu_torch.models import distributions, eps_greedy
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.rllib.agents.impala import vtrace
    from ray_tpu_torch.rllib.env import device_env
    from ray_tpu_torch.rllib.evaluation import device_sampler
    return [vtrace.VTRACE_KERNEL, distributions.CATEGORICAL_KERNEL,
            distributions.CATEGORICAL_K_KERNEL,
            device_sampler.OBS_APPLY_KERNEL,
            device_env.SYNTHETIC_ATARI_KERNEL, device_env.CARTPOLE_KERNEL,
            device_env.CARTPOLE_BOUND_KERNEL,
            collectives.Q8_ENCODE_KERNEL, collectives.Q8_GATHER_SUM_KERNEL,
            collectives.Q8_GATHER_UNPACK_KERNEL,
            distributions.DIAG_GAUSSIAN_KERNEL,
            eps_greedy.EPS_GREEDY_KERNEL,
            distributions.SQUASHED_GAUSSIAN_KERNEL,
            distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL]


def run_dqn(name, config, iters, profile_last, with_summary=False):
    """`iters` iterations of `DQNTrainer(config)` (the last one, cut to
    `DQN_PROFILED_STEPS` env steps, profiled when `profile_last`), with
    every kernel's count set to 0 just
    before: K8 must launch once per env step and no other kernel at
    all; the target network must have synced; epsilon must sit on its
    schedule at the sampled steps. Returns (trainer, K8 launches, the
    last replay batch the learner got), and the summary with
    `with_summary`."""
    import torch
    from ray_tpu_torch.models import eps_greedy
    from ray_tpu_torch.rllib.agents.dqn import DQNTrainer
    from ray_tpu_torch.rllib.utils.schedules import LinearSchedule

    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = DQNTrainer(config=dict(config))
    policy = trainer.get_policy()
    cfg = trainer.config
    trunk = policy.model.compute_dtype if policy.model.image else "none"
    log(f"  {name}: trainer built in {time.perf_counter() - t0:.2f} s: "
        f"{policy.num_params()} params (online; the target as many), "
        f"conv trunk {trunk}, device {policy.device}")
    # An update's host time, split: the replay sample, the policy's
    # learn_with_td (upload, update, the one read), and the rest (the
    # priority write-back).
    last_batch = []
    split = {"replay_sample": 0.0, "learn_with_td": 0.0}
    real_learn = policy.learn_with_td
    buffer = trainer.optimizer.replay_buffer
    real_sample = buffer.sample

    def learn_with_td(batch):
        last_batch[:] = [batch]
        t = time.perf_counter()
        out = real_learn(batch)
        split["learn_with_td"] += time.perf_counter() - t
        return out

    def sample(*args, **kwargs):
        t = time.perf_counter()
        out = real_sample(*args, **kwargs)
        split["replay_sample"] += time.perf_counter() - t
        return out

    policy.learn_with_td = learn_with_td
    buffer.sample = sample
    timers = trainer.optimizer.timers
    kernels = port_kernels()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    iters_out, prof = [], None
    for i in range(iters):
        profiled = profile_last and i == iters - 1
        sample0, learn0 = timers["sample"].total, timers["learn"].total
        split0 = dict(split)
        trained0 = trainer.optimizer.num_steps_trained
        t0 = time.perf_counter()
        if profiled:
            trainer.config["timesteps_per_iteration"] = DQN_PROFILED_STEPS
            result, prof = profile_iteration(trainer)
        else:
            result = trainer.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = result["timesteps_this_iter"]
        updates = (result["num_steps_trained"] - trained0) \
            // cfg["train_batch_size"]
        learn_s = timers["learn"].total - learn0
        learner = result["info"]["learner"]
        parts = {k: 1e3 * (split[k] - split0[k]) / updates if updates
                 else None for k in split}
        if updates:
            parts["write_back"] = 1e3 * learn_s / updates \
                - parts["replay_sample"] - parts["learn_with_td"]
        row = {"s": dt, "steps": steps, "updates": updates,
               "sample_s": timers["sample"].total - sample0,
               "learn_s": learn_s,
               "update_ms": 1e3 * learn_s / updates if updates else None,
               "update_parts_ms": parts,
               "epsilon": result["info"]["exploration_epsilon"],
               "target_updates": result["info"]["num_target_updates"],
               "episode_reward_mean": result["episode_reward_mean"],
               "learner": learner}
        log(f"  {name} iter {i}{' (profiled)' if profiled else ''}: "
            f"{dt:.3f} s, {steps} env steps, {steps / dt:.1f} env steps/s,"
            f" {updates} updates ({row['update_ms']} ms each with the "
            f"replay sample and the priority write-back: "
            f"{json.dumps(parts)}), sample "
            f"{row['sample_s']:.3f} s, eps {row['epsilon']:.4f}, target "
            f"syncs {row['target_updates']}, loss "
            f"{learner.get('loss', float('nan')):.5f}, reward mean "
            f"{row['episode_reward_mean']}")
        if not all(math.isfinite(v) for v in learner.values()):
            raise AssertionError(f"{name}: non-finite stats at iter {i}")
        iters_out.append(row)
    launches = {k.name: k.launches for k in kernels}
    sampled = result["num_steps_sampled"]
    env_steps = sampled // cfg["num_envs_per_worker"]
    if launches["eps_greedy"] != env_steps or env_steps <= 0:
        raise AssertionError(
            f"{name}: eps_greedy launched {launches['eps_greedy']} times "
            f"for {env_steps} env steps")
    others = {k: v for k, v in launches.items() if k != "eps_greedy" and v}
    if others:
        raise AssertionError(f"{name}: kernels of other paths launched: "
                             f"{others}")
    if result["info"]["num_target_updates"] < 1:
        raise AssertionError(f"{name}: the target network never synced")
    want_eps = LinearSchedule(
        cfg["exploration_timesteps"], cfg["exploration_final_eps"],
        cfg["exploration_initial_eps"]).value(sampled)
    if abs(policy.cur_epsilon - want_eps) > 1e-12:
        raise AssertionError(f"{name}: epsilon {policy.cur_epsilon} off "
                             f"its schedule ({want_eps} at {sampled})")
    steady = iters_out[1]
    summary = {
        "iterations": iters,
        "iter_s": [r["s"] for r in iters_out],
        "env_steps_per_s_steady": steady["steps"] / steady["s"],
        "sample_s_steady": steady["sample_s"],
        "learn_s_steady": steady["learn_s"],
        "update_ms_steady": steady["update_ms"],
        "update_parts_ms_steady": steady["update_parts_ms"],
        "updates_steady": steady["updates"],
        "num_steps_sampled": sampled,
        "num_steps_trained": result["num_steps_trained"],
        "num_target_updates": result["info"]["num_target_updates"],
        "epsilon": policy.cur_epsilon,
        "replay_buffer": result.get("replay_buffer"),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_before_bytes": held_before,
        "launches": launches,
        "profiled_iteration": prof,
    }
    log(f"  {name} summary: {json.dumps(summary)}")
    if with_summary:
        return trainer, launches["eps_greedy"], last_batch[0], summary
    return trainer, launches["eps_greedy"], last_batch[0]


def dqn_update(policy, config, batch, devices=("cuda", "cpu")):
    """One `learn_with_td` of a `DQNPolicy` built from `config` on each
    of `devices`, from `policy`'s online and target weights, on
    `batch`. -> {device: (stats, |td|)}."""
    from ray_tpu_torch.rllib.agents.dqn import DQNPolicy
    weights = policy.get_weights()
    out = {}
    for device in devices:
        pol = DQNPolicy(policy.observation_space, policy.action_space,
                        dict(config, device=device))
        pol.set_weights(weights)
        out[device] = pol.learn_with_td(batch)
    return out


def check_dqn_against_cpu(trainer, batch):
    """One `learn_with_td` of the trained online and target weights on
    the last replay batch, on the card against the CPU:
    - at the path's own bf16 conv trunk: every stat and |td| within
      `DQN_BF16_TOL` * (1 + |CPU|);
    - with an f32 trunk and TF32 off: within 1e-4 * (1 + |CPU|)."""
    import numpy as np
    import torch
    policy = trainer.get_policy()
    cfg = {k: v for k, v in policy.config.items() if k != "device"}
    f32_cfg = dict(cfg, model=dict(cfg.get("model") or {},
                                   compute_dtype="f32"))
    checks = [("the path's bf16 trunk", cfg, DQN_BF16_TOL)]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    failures = []
    for what, config, tol in checks + [("f32 trunk, TF32 off", f32_cfg,
                                        1e-4)]:
        if config is f32_cfg:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        out = dqn_update(policy, config, batch)
        (card, card_td), (cpu, cpu_td) = out["cuda"], out["cpu"]
        pairs = {k: [card[k], v] for k, v in cpu.items()}
        td_err = np.abs(card_td - cpu_td) / (1.0 + np.abs(cpu_td))
        rel = {k: abs(a - b) / (1.0 + abs(b)) for k, (a, b) in pairs.items()}
        log(f"  card vs CPU learn_with_td ({what}; {batch.count} rows; "
            f"tol {tol} * (1 + |CPU|)): {json.dumps(pairs)}; |td| "
            f"largest scaled difference {float(td_err.max()):.3e}; stats' "
            f"scaled differences {json.dumps(rel)}")
        for k, r in rel.items():
            if not r <= tol:
                failures.append(f"{what}: {k} {pairs[k]}")
        if not float(td_err.max()) <= tol:
            failures.append(f"{what}: |td| {float(td_err.max())}")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved
    if failures:
        raise AssertionError("card learn_with_td disagrees with the CPU: "
                             + "; ".join(failures))


def run_phase9():
    """DQN on Atari pixels, its card-vs-CPU update, and the CartPole
    leg. -> K8's launches on both."""
    import torch
    log("phase 9: DQNTrainer at full width, Atari pixels (QNetwork, "
        "prioritized replay, K8)")
    # PyTorch's default (phase 7's check turned TF32 off for cuDNN).
    torch.backends.cudnn.allow_tf32 = True
    trainer, k8_launches, replay_batch = run_dqn(
        "dqn_atari", DQN_ATARI_CONFIG, DQN_ITERS, profile_last=True)
    check_dqn_against_cpu(trainer, replay_batch)
    trainer.stop()
    del trainer
    gc.collect()
    trainer, cartpole_k8, _ = run_dqn(
        "dqn_cartpole", DQN_CARTPOLE_CONFIG, 3, profile_last=False)
    trainer.stop()
    return k8_launches + cartpole_k8


# ---------------------------------------------------------------------
# phase 10: SAC
# ---------------------------------------------------------------------
def split_sac_update(trainer, n):
    """`n` updates from the trainer's replay, each split into its parts
    on the host clock with the card synced after each: the replay
    sample, the upload, the three steps (critic, with the normal draws;
    actor; alpha with the Polyak average) and the one read. -> ms per
    part."""
    import torch
    from ray_tpu_torch.rllib.agents.sac.sac_policy import sb
    from ray_tpu_torch.rllib.policy.torch_policy import read_stats
    policy = trainer.get_policy()
    buffer = trainer.optimizer.replay_buffer
    rows = trainer.config["train_batch_size"]
    parts = dict.fromkeys(("replay_sample", "upload", "critic_step",
                           "actor_step", "alpha_step", "read"), 0.0)

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[key] += time.perf_counter() - t
        return out

    torch.cuda.synchronize()
    for _ in range(n):
        batch = timed("replay_sample", lambda: buffer.sample(rows))
        dev = timed("upload", lambda: policy._device_batch(batch))
        with policy._update_lock:
            stats = timed("critic_step", lambda: policy.critic_step(
                dev, policy.update_normals(dev[sb.OBS].shape[0])[0]))
            z = policy.update_normals(rows)[1]
            stats.update(timed("actor_step",
                               lambda: policy.actor_step(dev, z)))
            stats.update(timed("alpha_step",
                               lambda: policy.alpha_step(stats["entropy"])))
        td = stats.pop("td_error")
        timed("read", lambda: read_stats(stats, td.abs()))
    return {k: 1e3 * v / n for k, v in parts.items()}


def run_sac(with_summary=False):
    """`SAC_ITERS` iterations of `SACTrainer(SAC_CONFIG)` with every
    kernel's count set to 0 just before: K9f must launch once per acted
    env step (past `pure_exploration_steps`), once per evaluation step
    and twice per update, K9b once per update, and no other kernel at
    all; the third iteration must carry the evaluation, and alpha must
    have moved down from 1. Then one shorter iteration profiled and
    `SAC_SPLIT_UPDATES` updates split into their parts. Returns
    (trainer, K9f launches, K9b launches, the last replay batch), and
    the summary with `with_summary`."""
    import torch
    from ray_tpu_torch.rllib.agents.sac import SACTrainer

    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = SACTrainer(config=dict(SAC_CONFIG))
    policy = trainer.get_policy()
    cfg = trainer.config
    log(f"  sac_pendulum: trainer built in {time.perf_counter() - t0:.2f} "
        f"s: {policy.num_params()} trainable params (the target critic as "
        f"many as the critic), device {policy.device}")
    want = torch.device(SAC_CONFIG["device"]).type
    for p in list(policy.actor.parameters()) \
            + list(policy.critic.parameters()):
        if p.device.type != want:
            raise AssertionError(f"parameter on {p.device}, not {want}")
    last_batch = []
    real_learn = policy.learn_with_td

    def learn_with_td(batch, **kwargs):
        last_batch[:] = [batch]
        return real_learn(batch, **kwargs)

    policy.learn_with_td = learn_with_td
    timers = trainer.optimizer.timers
    kernels = port_kernels()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    rows = []
    for i in range(SAC_ITERS):
        sample0, learn0 = timers["sample"].total, timers["learn"].total
        trained0 = trainer.optimizer.num_steps_trained
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = result["timesteps_this_iter"]
        updates = (result["num_steps_trained"] - trained0) \
            // cfg["train_batch_size"]
        learn_s = timers["learn"].total - learn0
        learner = result["info"]["learner"]
        row = {"s": dt, "steps": steps, "updates": updates,
               "sample_s": timers["sample"].total - sample0,
               "learn_s": learn_s,
               "update_ms": 1e3 * learn_s / updates if updates else None,
               "episode_reward_mean": result["episode_reward_mean"],
               "evaluation": result.get("evaluation"), "learner": learner}
        log(f"  sac_pendulum iter {i}: {dt:.3f} s, {steps} env steps, "
            f"{steps / dt:.1f} env steps/s, {updates} updates "
            f"({row['update_ms']} ms each with the replay sample), sample "
            f"{row['sample_s']:.3f} s, learner {json.dumps(learner)}, "
            f"reward mean {row['episode_reward_mean']}, evaluation "
            f"{json.dumps(row['evaluation'])}")
        if not all(math.isfinite(v) for v in learner.values()):
            raise AssertionError(f"sac_pendulum: non-finite stats at iter "
                                 f"{i}")
        rows.append(row)
    launches = {k.name: k.launches for k in kernels}
    evaluation = result.get("evaluation")
    if evaluation is None or any(r["evaluation"] for r in rows[:-1]):
        raise AssertionError("sac_pendulum: the evaluation must come with "
                             "the third iteration, and only there")
    eval_steps = round(evaluation["episode_len_mean"]
                       * evaluation["episodes_this_iter"])
    acted = result["num_steps_sampled"] - cfg["pure_exploration_steps"]
    updates = result["num_steps_trained"] // cfg["train_batch_size"]
    want = {"squashed_gaussian": acted + eval_steps + 2 * updates,
            "squashed_gaussian_backward": updates}
    if updates <= 0 or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(
            f"sac_pendulum: launches {launches} for {acted} acted env "
            f"steps, {eval_steps} evaluation steps and {updates} updates "
            f"(want {want})")
    others = {k: v for k, v in launches.items() if k not in want and v}
    if others:
        raise AssertionError(f"sac_pendulum: kernels of other paths "
                             f"launched: {others}")
    alpha = result["info"]["learner"]["alpha"]
    if not alpha < 1.0:
        raise AssertionError(f"sac_pendulum: alpha {alpha} did not move "
                             "down from 1")
    peak = torch.cuda.max_memory_allocated()
    trainer.config["timesteps_per_iteration"] = SAC_PROFILED_STEPS
    _, prof = profile_iteration(trainer)
    split = split_sac_update(trainer, SAC_SPLIT_UPDATES)
    steady = rows[-1]
    summary = {
        "iterations": SAC_ITERS,
        "iter_s": [r["s"] for r in rows],
        "env_steps_per_s_learning": steady["steps"] / steady["s"],
        "sample_s_learning": steady["sample_s"],
        "learn_s_learning": steady["learn_s"],
        "update_ms_learning": steady["update_ms"],
        "update_split_ms_synced": split,
        "updates": updates, "acted_env_steps": acted,
        "evaluation_steps": eval_steps,
        "num_steps_sampled": result["num_steps_sampled"],
        "num_steps_trained": result["num_steps_trained"],
        "alpha": alpha,
        "max_memory_allocated_bytes": peak,
        "memory_allocated_before_bytes": held_before,
        "launches": launches,
        "profiled_iteration": prof,
    }
    log(f"  sac_pendulum summary: {json.dumps(summary)}")
    out = (trainer, launches["squashed_gaussian"],
           launches["squashed_gaussian_backward"], last_batch[0])
    return out + (summary,) if with_summary else out


def check_sac_against_cpu(trainer, batch):
    """One `learn_with_td` of the trained weights on the last replay
    batch, with the same injected normals, on the card against the CPU,
    f32 with TF32 off: every stat, |td| and parameter (actor, critic,
    log_alpha, target critic) within 1e-4 * (1 + |CPU|)."""
    import numpy as np
    import torch
    from ray_tpu_torch.rllib.agents.sac import SACPolicy
    policy = trainer.get_policy()
    cfg = {k: v for k, v in policy.config.items() if k != "device"}
    rng = np.random.default_rng(0)
    shape = (batch.count, policy.action_dim)
    normals = (rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32))
    weights = policy.get_weights()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for device in ("cuda", "cpu"):
            pol = SACPolicy(policy.observation_space, policy.action_space,
                            dict(cfg, device=device))
            pol.set_weights(weights)
            stats, td = pol.learn_with_td(batch, _normals=normals)
            out[device] = (stats, td, pol.get_weights())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    (card, card_td, card_w), (cpu, cpu_td, cpu_w) = out["cuda"], out["cpu"]
    rel = {k: abs(card[k] - v) / (1.0 + abs(v)) for k, v in cpu.items()}
    rel["|td|"] = float(np.max(np.abs(card_td - cpu_td)
                               / (1.0 + np.abs(cpu_td))))
    for part in ("online", "target"):
        for net, value in cpu_w[part].items():
            leaves = value.items() if isinstance(value, dict) \
                else [("", value)]
            for k, v in leaves:
                got = card_w[part][net][k] if k else card_w[part][net]
                rel[f"{part}.{net}.{k}".rstrip(".")] = float(np.max(
                    np.abs(got - v) / (1.0 + np.abs(v))))
    worst = max(rel.values())
    pairs = {k: [card[k], v] for k, v in cpu.items()}
    log(f"  card vs CPU learn_with_td (f32, TF32 off, {batch.count} rows, "
        f"injected normals; tol 1e-4 * (1 + |CPU|)): {json.dumps(pairs)}; "
        f"largest scaled difference {worst:.3e} "
        f"({max(rel, key=rel.get)})")
    bad = {k: v for k, v in rel.items() if not v <= 1e-4}
    if bad:
        raise AssertionError(f"card SAC update disagrees with the CPU: "
                             f"{bad}")


def run_phase10():
    """SAC on Pendulum and its card-vs-CPU update. -> (K9f launches, K9b
    launches)."""
    log("phase 10: SACTrainer at full width on Pendulum-v0 (squashed "
        "Gaussian, K9f + K9b)")
    trainer, k9f, k9b, batch = run_sac()
    check_sac_against_cpu(trainer, batch)
    trainer.stop()
    return k9f, k9b


def k9_entries(row, fwd, bwd, k9f, k9b):
    """The kernels line's K9f and K9b entries."""
    return [
        {"name": "squashed_gaussian_sample", "route": "cuda",
         "source": "ray_tpu_torch/csrc/squashed_gaussian.cu",
         "replaces": "ray_tpu/rllib/agents/sac/sac_policy.py:137",
         "launches": k9f, "max_abs_err": row["max_abs_err"],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": fwd[0], "bound_by": fwd[1], "library_ms": None},
        {"name": "squashed_gaussian_backward", "route": "cuda",
         "source": "ray_tpu_torch/csrc/squashed_gaussian.cu",
         "replaces": "ray_tpu/rllib/agents/sac/sac_policy.py:188",
         "launches": k9b, "max_abs_err": row["max_abs_err_backward"],
         "ms": row["b_ms"], "plain_ms": row["b_plain_ms"],
         "bound_ms": bwd[0], "bound_by": bwd[1], "library_ms": None},
    ]


# ---------------------------------------------------------------------
# phase 11: remote rollout workers and the weight plane
# ---------------------------------------------------------------------
def _weights_within_q8_step(got, true, payloads):
    """-> the largest excess of |got - true| over half the q8 step of the
    delta that built the version (max|block| / 254 per element, zero
    after a full sync), with two f32 ulps of |true| for the adds; <= 0
    when the bound holds."""
    import numpy as np
    from ray_tpu_torch._private import serialization
    bound = np.zeros(true.size, np.float32)
    for p in payloads:
        if p.codec == "q8_delta":
            scales = np.repeat(p.scales, serialization.Q8_BLOCK)
            bound[p.start:p.stop] = scales[:p.stop - p.start] / 2
    excess = np.abs(got - true) - bound - 2 * np.spacing(np.abs(true))
    return float(excess.max())


def run_workers(card):
    """Phase 11: `IMPALATrainer` with 2 remote rollout workers x 16 envs
    on `ray_tpu_torch.init(local_mode=True)`, q8-delta weight syncs.
    -> (K1's and K2's launches, the summary)."""
    import ray_tpu_torch
    ray_tpu_torch.init(local_mode=True)
    try:
        return _run_workers(card)
    finally:
        ray_tpu_torch.shutdown()


def _run_workers(card):
    import numpy as np
    import torch
    import ray_tpu_torch
    from ray_tpu_torch._private import metrics, weight_sync
    from ray_tpu_torch.models import distributions
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer, vtrace

    # Every sample of the encode and decode times, in the order set.
    gauges = {"weight_sync_ms": [], "weight_apply_ms": []}
    set_gauge = metrics.set_gauge

    def recording_set_gauge(name, value):
        if name in gauges:
            gauges[name].append(value)
        set_gauge(name, value)

    counters0 = metrics.snapshot()["counters"]
    metrics.set_gauge = recording_set_gauge
    vtrace.VTRACE_KERNEL.launches = 0
    distributions.CATEGORICAL_KERNEL.launches = 0
    trainer = None
    try:
        t0 = time.perf_counter()
        # The optimizer's constructor sends the first (full) sync and
        # each worker's first sample requests.
        trainer = IMPALATrainer(config=dict(WORKERS_CONFIG))
        log(f"  trainer and {WORKERS_NUM} workers built and primed in "
            f"{time.perf_counter() - t0:.2f} s")
        learner = trainer.workers.local_worker
        get_weights = learner.get_weights
        get_weights_s = []

        def timed_get_weights():
            t = time.perf_counter()
            out = get_weights()
            get_weights_s.append(time.perf_counter() - t)
            return out

        # The broadcaster reads the learner's weights through it.
        learner.get_weights = timed_get_weights
        opt = trainer.optimizer
        bc = opt.broadcaster
        iters = []
        for i in range(WORKERS_ITERS):
            t0 = time.perf_counter()
            result = trainer.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = result["timesteps_this_iter"]
            loss = result["info"]["learner"]["total_loss"]
            iters.append({"s": dt, "steps": steps})
            log(f"  iter {i}: {dt:.3f} s, {steps} env steps, "
                f"{steps / dt:.1f} env steps/s, sync version {bc.version}, "
                f"total_loss {loss:.4f}")
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite loss at iter {i}")
        stats = opt.stats()
        counters = metrics.snapshot()["counters"]
        syncs = {codec: counters.get(f"weight_sync_codec.{codec}", 0)
                 - counters0.get(f"weight_sync_codec.{codec}", 0)
                 for codec in ("full", "q8_delta")}
        if syncs["full"] < 1 or syncs["q8_delta"] < 1:
            raise AssertionError(f"weight syncs by codec: {syncs}")
        if stats["num_weight_sync_stale_fallbacks"] != 0:
            raise AssertionError(
                f"{stats['num_weight_sync_stale_fallbacks']} stale "
                "fallbacks")
        # Each worker, after a version-gated sync to the current version:
        # the receiver-view base bit for bit, and within half a q8 step
        # of the learner's weights at that version.
        payloads = bc.payloads()
        true = weight_sync.flatten_f32(bc.encoder.weights)[0]
        for w in trainer.workers.remote_workers:
            bc.sync(w)
            bc.drain_acks()
            held = ray_tpu_torch.get(w.weight_sync_version.remote())
            got = weight_sync.flatten_f32(
                ray_tpu_torch.get(w.get_weights.remote()))[0]
            if held != bc.version or \
                    got.tobytes() != bc.encoder.base.tobytes():
                raise AssertionError(
                    f"worker at version {held} of {bc.version} does not "
                    "hold the receiver-view base")
            excess = _weights_within_q8_step(got, true, payloads)
            if excess > 0:
                raise AssertionError(
                    f"worker weights beyond a q8 step by {excess}")
        full_bytes = bc.encoder.full_payloads()[0].nbytes
        delta_bytes = sum(p.nbytes for p in payloads)
        if payloads[0].codec != "q8_delta" or \
                full_bytes / delta_bytes < 3.5:
            raise AssertionError(
                f"last sync {payloads[0].codec}: {delta_bytes} bytes "
                f"against {full_bytes} for the full blob")
        # The sample tasks in flight ran already (local mode): their
        # env steps launched K2 too.
        in_flight = sum(ray_tpu_torch.get(ref).count
                        for ref in opt.sample_tasks.pending())
    finally:
        metrics.set_gauge = set_gauge
        if trainer is not None:
            trainer.stop()
    policy = trainer.get_policy()
    launches = {"vtrace": vtrace.VTRACE_KERNEL.launches,
                "categorical": distributions.CATEGORICAL_KERNEL.launches}
    env_steps = (result["num_steps_sampled"] + in_flight) \
        // WORKERS_CONFIG["num_envs_per_worker"]
    if launches["categorical"] != env_steps:
        raise AssertionError(
            f"sampling kernel launched {launches['categorical']} times for "
            f"{env_steps} env steps of the workers")
    updates = policy.global_timestep // WORKERS_CONFIG["train_batch_size"]
    if launches["vtrace"] != updates or updates <= 0:
        raise AssertionError(
            f"vtrace kernel launched {launches['vtrace']} times for "
            f"{updates} updates")
    steady = iters[1:]  # the first iteration includes cuDNN's warm-up
    encode_ms = gauges["weight_sync_ms"]
    summary = {
        "card": card,
        "iter_s": [r["s"] for r in iters],
        "env_steps_per_s": sum(r["steps"] for r in iters)
        / sum(r["s"] for r in iters),
        "env_steps_per_s_steady": sum(r["steps"] for r in steady)
        / sum(r["s"] for r in steady),
        "num_steps_sampled": result["num_steps_sampled"],
        "num_steps_trained": result["num_steps_trained"],
        "updates": updates,
        "syncs": syncs,
        "sync_version": bc.version,
        "num_weight_sync_skipped": stats["num_weight_sync_skipped"],
        "bytes_full_sync": full_bytes,
        "bytes_delta_sync": delta_bytes,
        "delta_ratio": full_bytes / delta_bytes,
        "encode_ms_full": encode_ms[0],
        "encode_ms_delta_mean": float(np.mean(encode_ms[1:])),
        "apply_ms_mean": float(np.mean(gauges["weight_apply_ms"])),
        "apply_ms_max": float(np.max(gauges["weight_apply_ms"])),
        "learner_get_weights_ms_mean": 1e3 * float(np.mean(get_weights_s)),
        "launches": launches,
    }
    log(f"  phase 11 on {card}: {summary['env_steps_per_s']:.1f} env "
        f"steps/s ({summary['env_steps_per_s_steady']:.1f} past the "
        f"first iteration); sync bytes full {full_bytes}, delta "
        f"{delta_bytes} ({summary['delta_ratio']:.3f}x); encode ms full "
        f"{encode_ms[0]:.3f}, delta {summary['encode_ms_delta_mean']:.3f}; "
        f"apply (decode) ms {summary['apply_ms_mean']:.3f}; learner "
        f"get_weights ms {summary['learner_get_weights_ms_mean']:.3f}")
    log(f"  workers summary: {json.dumps(summary)}")
    return launches, summary


def log_build(kernels):
    """Build `kernels` (one nvcc per source, all at once) and log ptxas's
    register/spill lines."""
    from ray_tpu_torch._private import cuda_build
    t0 = time.perf_counter()
    reports = cuda_build.build_all(kernels, verbose=True)
    log(f"  built {len(kernels)} kernels from {len(reports)} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "entry function" in line or "Used" in line \
                    or "spill" in line:
                log(f"  {name}: {line.strip()}")


def finish(card, entries):
    """The last three lines: the kernels, the card, the result."""
    import torch
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ray_tpu_torch  # noqa: F401  (fails without the repository)
    from ray_tpu_torch._private import cuda_build
    from ray_tpu_torch.models import distributions
    from ray_tpu_torch.rllib.agents.impala import vtrace
    from ray_tpu_torch.parallel import collectives, q8_check

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    if sys.argv[1:] == ["dp"]:
        # Phase 6 alone: over NCCL when the machine has 2+ cards.
        cuda_build.build_all([vtrace.VTRACE_KERNEL,
                              distributions.CATEGORICAL_KERNEL,
                              collectives.Q8_ENCODE_KERNEL,
                              collectives.Q8_GATHER_SUM_KERNEL,
                              collectives.Q8_GATHER_UNPACK_KERNEL])
        log("phase 6 alone: IMPALATrainer, data-parallel learner")
        log(json.dumps({"launches": run_dp()}))
        return 0
    if sys.argv[1:] == ["sac"]:
        # Phase 10 alone, with K9's checks of phase 2 (K9 built alone).
        log("phase 1: build (K9f, K9b)")
        log_build([distributions.SQUASHED_GAUSSIAN_KERNEL,
                   distributions.SQUASHED_GAUSSIAN_BACKWARD_KERNEL])
        log("phase 2: K9f and K9b vs plain")
        k9 = check_squashed_gaussian_all()
        return finish(card, k9_entries(*k9, *run_phase10()))
    if sys.argv[1:] == ["workers"]:
        # Phase 11 alone (K1 and K2 built alone).
        cuda_build.build_all([vtrace.VTRACE_KERNEL,
                              distributions.CATEGORICAL_KERNEL])
        log("phase 11 alone: IMPALATrainer, remote rollout workers")
        log(json.dumps({"launches": run_workers(card)[0]}))
        return 0
    if sys.argv[1:] == ["dqn"]:
        # Phase 9 alone: its host-bound rates without phases 1-8 before.
        from ray_tpu_torch.models import eps_greedy
        cuda_build.build_all([eps_greedy.EPS_GREEDY_KERNEL])
        log(json.dumps({"eps_greedy_launches": run_phase9()}))
        return 0

    log("phase 1: build")
    log_build(port_kernels())

    log("phase 2: kernels vs plain")
    T, B, A = FRAGMENT, NUM_ENVS, NUM_ACTIONS
    k1 = check_vtrace(T, B, timed=True)
    check_vtrace(500, 4096, timed=False)
    check_vtrace(T, 37, timed=False)  # a ragged tile
    k2 = check_categorical(B, A, timed=True)
    check_categorical(4096, 18, timed=False)
    # K1 and K2 at the shapes the Anakin paths give them: SyntheticAtari
    # (T=16, B=4096; 6 actions) and CartPole (T=20, B=32; 2 actions).
    n_cp = CARTPOLE_ANAKIN_CONFIG["num_envs_per_worker"]
    t_cp = CARTPOLE_ANAKIN_CONFIG["rollout_fragment_length"]
    check_vtrace(ANAKIN_FRAGMENT, ANAKIN_ENVS, timed=True)
    check_vtrace(t_cp, n_cp, timed=False)
    # K1 at Sebulba's update (one 25-step fragment of 64 envs).
    check_vtrace(SEB_FRAGMENT, SEB_ENVS, timed=True)
    check_categorical(ANAKIN_ENVS, NUM_ACTIONS, timed=False)
    check_categorical(n_cp, 2, timed=False)
    # K2 at the shape phase 7's PPO Atari path gives it (16 envs).
    check_categorical(PPO_ATARI_ENVS, NUM_ACTIONS, timed=True)
    k1_bound = (k1["bound_ms"], k1["bound_by"])
    k2_bound = (k2["bound_ms"], k2["bound_by"])
    # K3 at the Sebulba shape (32 envs per group, SpriteAtari's K=128,
    # stack 4) in every mode, then at a larger shape.
    # n=192 is bench.py's 384 envs per actor in 2 groups; n=1 and 7 run
    # the (row, pixel-chunk) grid with 28 chunks per row, the last ragged.
    n_group = SEB_ENVS // SEB_GROUPS
    k3 = check_obs_apply(n_group, 128, 4, "delta", timed=True)
    check_obs_apply(BENCH_SEB_GROUP_ENVS, 128, 4, "delta", timed=True)
    check_obs_apply(n_group, 0, 4, "frame", timed=False)
    check_obs_apply(n_group, 128, 0, "delta", timed=False)
    check_obs_apply(512, 1024, 4, "delta", timed=False)
    check_obs_apply(1, 128, 4, "delta", timed=False)
    check_obs_apply(7, 128, 4, "delta", timed=False)
    # K3 moves bytes and does no arithmetic of a type in the peak table.
    k3_bound = bound_ms(k3["bytes"], 0)
    k2k = check_categorical_k(1, n_group, A, timed=True)
    check_categorical_k(5, n_group, A, timed=True)
    check_categorical_k(8, 4096, 18, timed=False)
    k2k_bound = bound_ms(*categorical_k_bytes_ops(1, n_group, A))
    probe = torch.zeros(1, device="cuda")
    if cuda_build.stream_handle(probe) \
            != torch.cuda.current_stream().cuda_stream:
        raise AssertionError("stream_handle is not PyTorch's current "
                             "stream")
    # K5a at the Anakin shape (4096 envs) and at 37; K5b at the CartPole
    # Anakin shape (32 envs), at 37 and at 4096. K5a moves bytes and does
    # integer work (Philox) of no type in the peak table; K5b's ~40 f32
    # operations and two sincos per env are far below its bytes.
    k5a = check_device_env("synthetic_atari_step", ANAKIN_ENVS, timed=True)
    check_device_env("synthetic_atari_step", 37, timed=False)
    k5a_bound = bound_ms(k5a["bytes"], 0)
    k5b = check_device_env("cartpole_step", n_cp, timed=True)
    check_device_env("cartpole_step", 37, timed=False)
    check_device_env("cartpole_step", 4096, timed=False)
    k5b_bound = bound_ms(k5b["bytes"], 60 * n_cp)
    log(f"  bound ms: synthetic_atari_step {k5a_bound[0]:.6f} "
        f"({k5a_bound[1]}), cartpole_step {k5b_bound[0]:.3e} "
        f"({k5b_bound[1]})")
    # K6a at the Nature CNN's packed gradient (1,654 blocks), live and
    # with the edge cases, at the CartPole FC net's and at 64M elements;
    # K6b at D=2 (timed) and 8, with and without the division by D.
    import numpy as np
    from ray_tpu_torch.models import catalog
    from ray_tpu_torch.models.convert import flax_pack_plan
    from ray_tpu_torch.rllib.env.spaces import Box
    nb_nature = flax_pack_plan(catalog.get_model(
        Box(0, 255, (84, 84, 4), np.uint8), NUM_ACTIONS, {}),
        collectives.Q8_BLOCK).nb
    nb_cartpole = flax_pack_plan(catalog.get_model(
        Box(-1.0, 1.0, (4,)), 2, {}), collectives.Q8_BLOCK).nb
    k6a = check_q8_encode(nb_nature, edge=False, timed=True)
    check_q8_encode(nb_nature, edge=True, timed=False)
    check_q8_encode(nb_cartpole, edge=True, timed=False)
    check_q8_encode(65536, edge=False, timed=False)
    # K6b in packed order (timed), then with the leaf table as the
    # exchange runs it (timed at D=2; its row below).
    k6b_packed = check_q8_gather_sum(DP_RANKS, nb_nature, False, timed=True)
    check_q8_gather_sum(DP_RANKS, nb_nature, True, timed=False)
    check_q8_gather_sum(8, nb_nature, False, timed=False)
    check_q8_gather_sum(8, nb_nature, True, timed=False)
    k6b = check_q8_gather_sum_unpack(DP_RANKS, False, timed=True)
    check_q8_gather_sum_unpack(DP_RANKS, True, timed=False)
    check_q8_gather_sum_unpack(8, False, timed=False)
    check_q8_gather_sum_unpack(8, True, timed=False)
    k6a_bound = bound_ms(q8_check.encode_bytes(nb_nature),
                         q8_check.encode_ops(nb_nature))
    k6b_bound = bound_ms(
        q8_check.gather_sum_unpack_bytes(DP_RANKS, k6b["nb"], k6b["numel"]),
        (3 * DP_RANKS) * k6b["numel"])
    k6b_packed_bound = bound_ms(
        q8_check.gather_sum_bytes(DP_RANKS, nb_nature),
        q8_check.gather_sum_ops(DP_RANKS, nb_nature, False))
    log(f"  bound ms: q8_encode_ef {k6a_bound[0]:.6f} ({k6a_bound[1]}), "
        f"q8_gather_sum D={DP_RANKS} with the leaf table "
        f"{k6b_bound[0]:.6f} ({k6b_bound[1]}), in packed order "
        f"{k6b_packed_bound[0]:.6f} (kernel {k6b_packed['ms']:.5f} ms, "
        f"device-only {k6b_packed['device_ms']} ms), nb {nb_nature} "
        f"(Nature CNN), {nb_cartpole} (CartPole FC)")

    # K7 at Pendulum's shape (8 envs, a 1-dim box; timed, with the step
    # record as the Box policy runs it), at 256 x 6 and at 4096 envs x a
    # 17-dim box.
    k7 = check_diag_gaussian(PPO_PENDULUM_ENVS, 1, timed=True)
    check_diag_gaussian(256, 6, timed=False)
    check_diag_gaussian(4096, 17, timed=False)
    k7_bound = (k7["bound_ms"], k7["bound_by"])
    log(f"  bound ms: diag_gaussian B={PPO_PENDULUM_ENVS} d=1 "
        f"{k7_bound[0]:.3e} ({k7_bound[1]}, with the step record)")

    # K8 at the DQN Atari path's shape (one env, 6 actions) and the
    # CartPole leg's (one env, 2 actions), both timed with the host output
    # as the DQN policy runs it, at 32 x 18 and at 4096 x 18 (the full
    # Atari action set), each at epsilon 0, 0.3 and 1.
    k8 = check_eps_greedy(1, NUM_ACTIONS, timed=True)
    check_eps_greedy(1, 2, timed=True)
    check_eps_greedy(32, 18, timed=False)
    check_eps_greedy(4096, 18, timed=False)
    k8_bound = (k8["bound_ms"], k8["bound_by"])
    log(f"  bound ms: eps_greedy B=1 A={NUM_ACTIONS} {k8_bound[0]:.3e} "
        f"({k8_bound[1]}, the host output alone)")

    # K9f and K9b at the SAC path's shapes and two larger ones.
    k9 = check_squashed_gaussian_all()

    log("phase 3: IMPALATrainer at full width, local mode")
    weights, launches = run_trainer()
    check_update_against_cpu(weights)

    log("phase 4: IMPALATrainer at full width, Sebulba inline actors")
    seb = {k: run_sebulba(k) for k in (1, 5)}
    seb_launches = {name: sum(seb[k][1][name] for k in seb)
                    for name in ("obs_apply", "categorical_k")}

    log("phase 5: IMPALATrainer at full width, Anakin (device-resident "
        "envs)")
    anakin_trainer, _, anakin_launches = run_anakin()
    check_anakin_update_against_cpu(anakin_trainer)
    anakin_trainer.stop()
    del anakin_trainer  # its 1.85 GB frame buffer: not a later phase's
    gc.collect()  # the trainer's reference cycles hold the buffer
    cartpole_launches = run_anakin_cartpole()
    for name in ("vtrace", "categorical"):
        launches[name] += anakin_launches[name] + cartpole_launches[name]

    log("phase 6: IMPALATrainer at full width, data-parallel learner "
        "(q8 and fp32 exchange)")
    dp_launches = run_dp()
    for name in ("vtrace", "categorical"):
        launches[name] += dp_launches[name]

    log("phase 7: PPOTrainer at full width, Atari pixels (Nature CNN)")
    trainer, ppo_k2, last_batch = run_ppo(
        "ppo_atari", PPO_ATARI_CONFIG, distributions.CATEGORICAL_KERNEL,
        PPO_ATARI_ENVS, NATURE_TRAIN_FLOPS_PER_ROW)
    launches["categorical"] += ppo_k2
    check_ppo_against_cpu(trainer, last_batch)
    trainer.stop()

    log("phase 8: PPOTrainer on Pendulum-v0 (DiagGaussian, K7)")
    k7_launches = run_ppo_pendulum()

    k8_launches = run_phase9()
    k9_launches = run_phase10()

    log("phase 11: IMPALATrainer at full width, 2 remote rollout workers "
        "on the local-mode runtime (q8-delta weight syncs)")
    workers_launches, _ = run_workers(card)
    for name in ("vtrace", "categorical"):
        launches[name] += workers_launches[name]

    entries = [
        {"name": "vtrace", "route": "cuda",
         "source": "ray_tpu_torch/csrc/vtrace.cu",
         "replaces": "ray_tpu/rllib/agents/impala/vtrace.py:24",
         "launches": launches["vtrace"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
        {"name": "categorical_sample", "route": "cuda",
         "source": "ray_tpu_torch/csrc/categorical.cu",
         "replaces": "ray_tpu/models/distributions.py:45",
         "launches": launches["categorical"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        {"name": "categorical_sample_k", "route": "cuda",
         "source": "ray_tpu_torch/csrc/categorical.cu",
         "replaces": "ray_tpu/rllib/evaluation/device_sampler.py:257",
         "launches": seb_launches["categorical_k"],
         "max_abs_err": k2k["max_abs_err"],
         "ms": k2k["ms"], "plain_ms": k2k["plain_ms"],
         "bound_ms": k2k_bound[0], "bound_by": k2k_bound[1],
         "library_ms": None},
        {"name": "obs_apply", "route": "cuda",
         "source": "ray_tpu_torch/csrc/obs_apply.cu",
         "replaces": "ray_tpu/rllib/evaluation/device_sampler.py:228",
         "launches": seb_launches["obs_apply"],
         "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": None},
        {"name": "synthetic_atari_step", "route": "cuda",
         "source": "ray_tpu_torch/csrc/device_env.cu",
         "replaces": "ray_tpu/rllib/env/jax_env.py:73",
         "launches": anakin_launches["synthetic_atari_step"],
         "max_abs_err": k5a["max_abs_err"],
         "ms": k5a["ms"], "plain_ms": k5a["plain_ms"],
         "bound_ms": k5a_bound[0], "bound_by": k5a_bound[1],
         "library_ms": None},
        {"name": "cartpole_step", "route": "cuda",
         "source": "ray_tpu_torch/csrc/device_env.cu",
         "replaces": "ray_tpu/rllib/env/jax_env.py:109",
         "launches": cartpole_launches["cartpole_step_bound"]
         + cartpole_launches["cartpole_step"],
         "max_abs_err": k5b["max_abs_err"],
         "ms": k5b["ms"], "plain_ms": k5b["plain_ms"],
         "bound_ms": k5b_bound[0], "bound_by": k5b_bound[1],
         "library_ms": None},
        {"name": "q8_encode_ef", "route": "cuda",
         "source": "ray_tpu_torch/csrc/q8.cu",
         "replaces": "ray_tpu/parallel/collectives.py:98",
         "launches": dp_launches["q8_encode_ef"],
         "max_abs_err": k6a["max_abs_err"],
         "ms": k6a["ms"], "plain_ms": k6a["plain_ms"],
         "bound_ms": k6a_bound[0], "bound_by": k6a_bound[1],
         "library_ms": None},
        {"name": "q8_gather_sum", "route": "cuda",
         "source": "ray_tpu_torch/csrc/q8.cu",
         "replaces": "ray_tpu/parallel/collectives.py:117",
         "launches": dp_launches["q8_gather_sum_unpack"]
         + dp_launches["q8_gather_sum"],
         "max_abs_err": k6b["max_abs_err"],
         "ms": k6b["ms"], "plain_ms": k6b["plain_ms"],
         "bound_ms": k6b_bound[0], "bound_by": k6b_bound[1],
         "library_ms": None},
        {"name": "diag_gaussian_sample", "route": "cuda",
         "source": "ray_tpu_torch/csrc/diag_gaussian.cu",
         "replaces": "ray_tpu/models/distributions.py:78",
         "launches": k7_launches, "max_abs_err": k7["max_abs_err"],
         "ms": k7["ms"], "plain_ms": k7["plain_ms"],
         "bound_ms": k7_bound[0], "bound_by": k7_bound[1],
         "library_ms": None},
        {"name": "eps_greedy", "route": "cuda",
         "source": "ray_tpu_torch/csrc/eps_greedy.cu",
         "replaces": "ray_tpu/rllib/agents/dqn/dqn_policy.py:161",
         "launches": k8_launches, "max_abs_err": k8["max_abs_err"],
         "ms": k8["ms"], "plain_ms": k8["plain_ms"],
         "bound_ms": k8_bound[0], "bound_by": k8_bound[1],
         "library_ms": None},
    ] + k9_entries(*k9, *k9_launches)
    return finish(card, entries)


if __name__ == "__main__":
    sys.exit(main())
