#!/usr/bin/env python3
"""Time the port's small per-step kernels of several trees of this
repository on one card, in turns.

    python3 kernel_ab.py [--out FILE] [--legs LEG,...] OLD NEW NEW OLD

Each TREE (a checkout's root) runs in a process of its own, in the
order given, with its own `ray_tpu_torch` first on the path (its kernels
built from its own `csrc/` into its own `_build/`); the measuring code
is this file's and this directory's `chip_smoke.py`, the same for every
tree. The legs (all by default):

- `k3`: K3 at n=32 (the Sebulba cell's group) and n=192 (bench.py's 384
  envs per actor in 2 groups), K=128, S=4, a quarter of the rows
  replaced, a tenth done: held bit for bit against the tree's plain
  version; the kernel's device time (torch.profiler), the time per call
  (CUDA events over back-to-back calls) through `apply_obs` and through
  the sampler's own launch path (`GroupObsApply` where the tree has it,
  else `apply_obs`), the plain version's, and the bound.
- `k2k`: K2k at k=1 and 5 (N=32, A=6): actions held against the plain
  version; device time, time per call of the bare wrapper, and of the
  window's tail as the tree's sampler runs it (with the pinned wire
  output where the tree has it; else the int32 cast, a pinned buffer
  and the device-to-host copy), with the device operations that tail
  enqueues (profiler kernels and copies per call) and their device
  time, K2k's own device time in that tail, plain and bound.
- `k2`: K2 at 32x6 (local mode) and 16x6 (PPO Atari): actions held
  against the plain version; device time and time per call of the bare
  wrapper, and the env step's tail as the tree's
  `TorchPolicy.compute_actions` runs it after the forward (from the
  logits and value on the card to the four numpy columns, through the
  step record: `chip_smoke.k2_step_tail`, or `categorical_step` where
  the tree's policy has no `sample_step`): its host time per step, the
  device operations it enqueues and their device time, K2's own device
  time in it; plain and bound.
- `k9f`: K9f at 1x1 (SAC's acting step): device time, the acting tail
  (`chip_smoke.k9f_act_tail`, from the actor's output to the numpy
  actions) with its host time, device operations and their device
  time; at 256x1 (an update): time per call through the tree's path
  with no gradient and for an input that needs one (the autograd
  function), device time; plain and bound at both.
- `k8`: K8 at 1x6 (DQN Atari) and 1x2 (DQN CartPole), epsilon 0.3:
  actions held against the plain version; device time and time per
  call of the bare wrapper (the device output), the time per call as
  the policy calls it (`path_ms`, the host output alone, where the tree
  has one), and the env step's tail as the tree's
  `DQNPolicy.compute_actions` runs it after the forward (from the
  Q-values on the card to the numpy actions: `chip_smoke.k8_step_tail`
  where K8 takes a host output, else the uniforms, K8 and a `.cpu()`
  copy): its host time per step, the device operations it enqueues and
  their device time, K8's own device time in it; plain and bound.
- `k7`: K7 at 8x1 (PPO Pendulum), the same figures, its tail from the
  dist inputs and value on the card to the four numpy columns
  (`chip_smoke.k7_step_tail` where `DiagGaussian` has a step record,
  else `DiagGaussian`, the normals, K7 and four `.cpu()` copies).
- `k1`: K1 at 50x32 (local mode), 16x4096 (Anakin) and 25x64 (Sebulba)
  on the learner's batch-major views (`chip_smoke.vtrace_layout`:
  discounts, rewards and values seen through the tree's `_time_major`),
  held against the plain version: the V-trace section of an update
  (`from_importance_weights` from those views to vs and pg on the card)
  with its time per call, the device operations it enqueues and their
  device time, K1's own device time in it; the call on dense inputs;
  plain and bound.
- `k9b`: K9b at 256x1 (SAC Pendulum's update) and 1x1: the actor step's
  backward through the tail (`torch.autograd.grad` from the tail's
  actions and logp to the actor's output, g_a a column slice of the
  critics' [B, 3 + d] concat gradient and g_logp dense, as the actor
  step hands them), held bit for bit against the plain backward on
  dense copies: its time per call, device operations and their device
  time, K9b's device time in it; the autograd function's backward body
  alone (`SquashedGaussianTail.backward` on a context its forward
  filled) with its device operations; the bare wrapper on dense
  gradients; plain and bound.
- `k5b`: K5b at N=32 (CartPole Anakin) and 4096: the env step as the
  tree's `AnakinOptimizer` makes it, into one slot after another of
  env-major [N, 20] buffers with the episode accumulator and the counter
  advancing (the bound step `DeviceCartPole.bind` returns, where the
  tree has one; else `DeviceEnv.step` with the slot's views), held
  against the plain version over 6 steps: its time per call (CUDA
  events over back-to-back calls), host time per call, the device
  operations one call enqueues, K5b's device time, the episode ends per
  timed step; `DeviceEnv.step` per call; plain and bound.
- `k6b`: K6b at D=2 on the Nature CNN's packed gradient (nb 1,654): the
  exchange's decode section as the tree's policy runs it, from the
  gathered wire images to the world's gradient in `parameters()` order
  (the leaf-table form, `Q8Decode`, where the tree has it; else the
  packed-order K6b and the `[unpack_index]` gather), held bit for bit
  against the packed sum indexed: its time per call, device operations
  and their device time, K6b's device time warm and with the L2
  evicted; plain and bound.
- `anakin_cartpole`: phase 5's CartPole Anakin run (32 envs x 20 steps x
  10 updates per call) for 6 calls: env steps/s of the last 5.
- `phase3`: phase 3 of `chip_smoke.py` (local-mode IMPALA): env steps/s.
- `phase4`: phase 4 (the Sebulba trainer at k=1 and k=5): env steps/s
  and the actors' wall split (`apply_pct`, `select_pct`).
- `phase8`: phase 8 (PPO on Pendulum): env steps/s, the SGD phase's
  time per iteration.
- `phase9`: phase 9's two runs (DQN on Atari pixels and on CartPole,
  without the profiled iteration): env steps/s, update time.
- `phase10`: phase 10's run (SAC on Pendulum): env steps/s of the
  learning iteration, update time.

Prints one JSON line per tree run (`{"tree": ..., ...}`), writes them
all to FILE as a JSON list when `--out` is given, then prints the
card's name and power limit. Needs a CUDA device; imports no JAX.
"""

import inspect
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
K3_SHAPES = (32, 192)
K2K_STEPS = (1, 5)
K2_SHAPES = ((32, 6), (16, 6))
K9F_SHAPES = ((1, 1), (256, 1))
K8_SHAPES = ((1, 6), (1, 2))
K7_SHAPES = ((8, 1),)
K1_SHAPES = ((50, 32), (16, 4096), (25, 64))
K9B_SHAPES = ((256, 1), (1, 1))
K8_EPS = 0.3
K5B_SHAPES = (32, 4096)
K5B_SLOTS = 20  # CartPole Anakin's fragment
ANAKIN_CARTPOLE_CALLS = 6  # the first warms up


def k2k_window_tail(distributions, logits, u, k, host):
    """One window's K2k part as the tree's sampler enqueues it; returns a
    callable. `host` is None for a tree without the wire output."""
    import torch
    if host is not None:
        def tail():
            distributions.sample_logp_k(logits, u, True, k,
                                        host_actions=host)
            torch.cuda.Event().record()
    else:
        def tail():
            actions, _ = distributions.sample_logp_k(logits, u, True, k)
            actions = actions.to(torch.int32)
            buf = torch.empty(actions.shape, dtype=torch.int32,
                              pin_memory=True)
            buf.copy_(actions, non_blocking=True)
            torch.cuda.Event().record()
    return tail


def load_chip_smoke():
    """This directory's `chip_smoke.py`, whatever tree is first on the
    path (a tree may hold a `chip_smoke.py` of its own)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LEGS = ("k3", "k2k", "k2", "k9f", "k8", "k7", "k1", "k9b", "k5b", "k6b",
        "anakin_cartpole", "phase3", "phase4", "phase8", "phase9",
        "phase10")


def leg_k3(cs, torch, distributions, ds):
    out = {}
    for n in K3_SHAPES:
        frames, args = cs.obs_apply_inputs(n, 128, 4, "delta", seed=n + 132)
        shape = args.pop("frame_shape")
        f_kernel, f_plain = frames.clone(), frames.clone()
        got = ds.apply_obs(f_kernel, shape, **args)
        want = ds._apply_obs_plain(f_plain, shape, **args)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(f_kernel, f_plain)):
            raise AssertionError(f"K3 differs from plain at n={n}")
        row = {"bytes": cs.obs_apply_bytes(frames, args)}
        row["bound_ms"] = cs.bound_ms(row["bytes"], 0)[0]
        apply = lambda: ds.apply_obs(f_kernel, shape, **args)  # noqa: E731
        path = apply
        if hasattr(ds, "GroupObsApply"):
            stack = args["stack"]
            rest = {k: v for k, v in args.items() if k != "stack"}
            group = ds.GroupObsApply(torch.device("cuda"), n, shape, stack,
                                     f_kernel)
            path = lambda: group(f_kernel, stack, **rest)  # noqa: E731
            row["blocks"] = n * ds.obs_apply_plan(n, frames.numel() // n)[0]
        else:
            row["blocks"] = n
        row["device_ms"] = cs.device_ms(apply, "obs_apply_kernel")
        row["apply_ms"] = cs.time_call(apply, reps=2000)
        row["path_ms"] = cs.time_call(path, reps=2000)
        row["plain_ms"] = cs.time_call(
            lambda: ds._apply_obs_plain(f_plain, shape, **args), reps=500)
        out[n] = row
    return out


def leg_k2k(cs, torch, distributions, ds):
    out = {}
    wire = "host_actions" in inspect.signature(
        distributions.sample_logp_k).parameters
    N, A = 32, 6
    for k in K2K_STEPS:
        g = torch.Generator(device="cuda").manual_seed(k * N * A)
        logits = torch.randn(N, A, generator=g, device="cuda") * 3.0
        u = torch.rand(k, N, A, generator=g, device="cuda")
        actions, _ = distributions.sample_logp_k(logits, u, True, k)
        want, _ = distributions._sample_logp_k_plain(logits, u, k, True)
        torch.cuda.synchronize()
        if not torch.equal(actions, want):
            raise AssertionError(f"K2k differs from plain at k={k}")
        host = torch.empty((k, N), dtype=torch.int32, pin_memory=True) \
            if wire else None
        tail = k2k_window_tail(distributions, logits, u, k, host)
        bare = lambda: distributions.sample_logp_k(  # noqa: E731
            logits, u, True, k)
        nbytes, ops = cs.categorical_k_bytes_ops(k, N, A)
        tail_ops, tail_device_ms = cs.device_work_per_call(tail)
        out[k] = {
            "wire_output": wire,
            "device_ms": cs.device_ms(bare, "categorical_sample_k_kernel"),
            "tail_kernel_device_ms": cs.device_ms(
                tail, "categorical_sample_k_kernel"),
            "bare_ms": cs.time_call(bare, reps=2000),
            "tail_ms": cs.time_call(tail, reps=2000),
            "tail_device_ops": tail_ops,
            "tail_device_ms": tail_device_ms,
            "plain_ms": cs.time_call(
                lambda: distributions._sample_logp_k_plain(
                    logits, u, k, True), reps=500),
            "bound_ms": cs.bound_ms(nbytes, ops)[0],
        }
    return out


def k2_tail(cs, D, logits, value):
    """K2's env-step tail in the tree: chip_smoke's (`sample_step`), or
    `categorical_step` where the tree's policy has that alone."""
    import torch
    from ray_tpu_torch.rllib.policy.torch_policy import TorchPolicy
    if hasattr(TorchPolicy, "sample_step"):
        return cs.k2_step_tail(logits, value)
    policy = SimpleNamespace(
        generator=torch.Generator(device=logits.device).manual_seed(0),
        device=logits.device)
    record = D.StepRecord(*logits.shape, pin=True)

    def tail():
        TorchPolicy.categorical_step(policy, logits, value, True, record)
        return record.columns()
    return tail


def k8_tail(cs, k8, q, eps, host):
    """K8's env-step tail in the tree: chip_smoke's where K8 takes a
    host output, else the uniforms, K8 and a `.cpu()` copy."""
    import torch
    if host:
        return cs.k8_step_tail(q, eps)
    generator = torch.Generator(device=q.device).manual_seed(0)

    def tail():
        u = torch.rand((q.shape[0], 2), generator=generator,
                       dtype=torch.float32, device=q.device)
        return k8.eps_greedy(q.contiguous(), u, eps).cpu().numpy()
    return tail


def k7_tail(cs, D, inputs, value, record):
    """K7's env-step tail in the tree: chip_smoke's where `DiagGaussian`
    has a step record, else `DiagGaussian` (its exp), the normals, K7
    and four `.cpu()` copies."""
    import torch
    if record:
        return cs.k7_step_tail(inputs, value)
    generator = torch.Generator(device=inputs.device).manual_seed(0)

    def tail():
        actions, logp = D.DiagGaussian(inputs).sample_with_logp(
            generator, explore=True)
        return (logp.cpu().numpy(), inputs.cpu().numpy(),
                value.cpu().numpy(), actions.cpu().numpy())
    return tail


def tail_row(cs, tail, kernel_symbol, bare, plain, bound, path=None):
    """The figures of one kernel's env-step tail and its bare wrapper
    (and of `path`, the wrapper as the tree's policy calls it, when that
    differs from the bare call)."""
    ops, tail_device_ms = cs.device_work_per_call(tail)
    extra = {} if path is None else {"path_ms": cs.time_call(path,
                                                             reps=2000)}
    return {
        **extra,
        "device_ms": cs.device_ms(bare, kernel_symbol),
        "tail_kernel_device_ms": cs.device_ms(tail, kernel_symbol),
        "bare_ms": cs.time_call(bare, reps=2000),
        "tail_host_ms": cs.host_ms(tail, reps=2000),
        "tail_device_ops": ops,
        "tail_device_ms": tail_device_ms,
        "plain_ms": cs.time_call(plain, reps=500),
        "bound_ms": bound,
    }


def leg_k2(cs, torch, distributions, ds):
    out = {}
    for B, A in K2_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B * A)
        logits = torch.randn(B, A, generator=g, device="cuda") * 3.0
        value = torch.randn(B, generator=g, device="cuda")
        u = torch.rand(B, A, generator=g, device="cuda")
        actions, _ = distributions.sample_logp(logits, u, True)
        want, _ = distributions._sample_logp_plain(logits, u, True)
        torch.cuda.synchronize()
        if not torch.equal(actions, want):
            raise AssertionError(f"K2 differs from plain at {B}x{A}")
        tail = k2_tail(cs, distributions, logits, value)
        columns = tail()
        if sorted(c.shape for c in columns) != sorted(
                [(B,), (B,), (B,), (B, A)]):
            raise AssertionError(f"K2's tail returned {columns}")
        out[f"{B}x{A}"] = tail_row(
            cs, tail, "categorical_sample_kernel",
            lambda: distributions.sample_logp(logits, u, True),
            lambda: distributions._sample_logp_plain(logits, u, True),
            cs.bound_ms(*cs.categorical_bytes_ops(B, A, record=True))[0])
    return out


def leg_k9f(cs, torch, D, ds):
    out = {}
    low, high = -2.0, 2.0  # Pendulum's action bounds
    for B, d in K9F_SHAPES:
        x, z = cs.squashed_inputs(B, d, seed=B * d + 9, margin=0.0)
        got, _ = D.squashed_gaussian_sample_logp(x, z, low, high, True)
        want, _ = D._squashed_gaussian_plain(x, z, low, high, True)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=cs.SQUASHED_TOL,
                              atol=cs.SQUASHED_TOL):
            raise AssertionError(f"K9f differs from plain at {B}x{d}")
        kw = {"tail": D.SquashedTail(low, high, d)}
        xg = x.clone().requires_grad_(True)
        path = lambda: D.squashed_gaussian_sample_logp(  # noqa: E731
            x, z, low, high, True, **kw)
        row = {
            "device_ms": cs.device_ms(path,
                                      "squashed_gaussian_sample_kernel"),
            "ms": cs.time_call(path, reps=2000),
            "grad_ms": cs.time_call(
                lambda: D.squashed_gaussian_sample_logp(
                    xg, z, low, high, True, **kw), reps=2000),
            "plain_ms": cs.time_call(
                lambda: D._squashed_gaussian_plain(x, z, low, high, True),
                reps=500),
            "bound_ms": cs.bound_ms(*cs.squashed_bytes_ops(B, d))[0],
        }
        if B == 1:
            tail = cs.k9f_act_tail(x, low, high)
            if tail().shape != (B, d):
                raise AssertionError("K9f's acting tail's actions")
            row["tail_ops"], row["tail_device_ms"] = \
                cs.device_work_per_call(tail)
            row["tail_kernel_device_ms"] = cs.device_ms(
                tail, "squashed_gaussian_sample_kernel")
            row["tail_host_ms"] = cs.host_ms(tail, reps=2000)
            row["tail_bound_ms"] = cs.bound_ms(*cs.squashed_bytes_ops(
                B, d, host=True))[0]
        out[f"{B}x{d}"] = row
    return out


def leg_k8(cs, torch, D, ds):
    from ray_tpu_torch.models import eps_greedy as k8
    out = {}
    host = "host_actions" in inspect.signature(k8.eps_greedy).parameters
    for B, A in K8_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B * A + 8)
        q = torch.randn(B, A, generator=g, device="cuda")
        u = torch.rand(B, 2, generator=g, device="cuda")
        got = k8.eps_greedy(q, u, K8_EPS)
        if not torch.equal(got, k8._eps_greedy_plain(q, u, K8_EPS)):
            raise AssertionError(f"K8 differs from plain at {B}x{A}")
        tail = k8_tail(cs, k8, q, K8_EPS, host)
        if tail().shape != (B,):
            raise AssertionError("K8's tail's actions")
        path = None
        if host:
            record = D.ActionRecord(B, pin=True, dtype=torch.int64)
            path = lambda: k8.eps_greedy(  # noqa: E731
                q, u, K8_EPS, host_actions=record)
        out[f"{B}x{A}"] = dict(tail_row(
            cs, tail, "eps_greedy_kernel",
            lambda: k8.eps_greedy(q, u, K8_EPS),
            lambda: k8._eps_greedy_plain(q, u, K8_EPS),
            cs.bound_ms(*cs.eps_greedy_bytes_ops(B, A))[0], path),
            host_output=host)
    return out


def leg_k7(cs, torch, D, ds):
    out = {}
    record = hasattr(D.DiagGaussian, "step_record")
    for B, d in K7_SHAPES:
        inputs, z, value = cs.gaussian_inputs(B, d, seed=B * d)
        got, _ = D.gaussian_sample_logp(inputs, z, True)
        want, _ = D._gaussian_sample_logp_plain(inputs, z, True)
        if not torch.allclose(got, want, rtol=cs.GAUSSIAN_TOL,
                              atol=cs.GAUSSIAN_TOL):
            raise AssertionError(f"K7 differs from plain at {B}x{d}")
        tail = k7_tail(cs, D, inputs, value, record)
        if sorted(c.shape for c in tail()) != sorted(
                [(B, d), (B,), (B,), (B, 2 * d)]):
            raise AssertionError("K7's tail's columns")
        path = None
        if record:
            rec = D.DiagGaussian.step_record(B, 2 * d, pin=True)
            path = lambda: D.gaussian_sample_logp(  # noqa: E731
                inputs, z, True, value=value, record=rec)
        out[f"{B}x{d}"] = dict(tail_row(
            cs, tail, "diag_gaussian_sample_kernel",
            lambda: D.gaussian_sample_logp(inputs, z, True),
            lambda: D._gaussian_sample_logp_plain(inputs, z, True),
            cs.bound_ms(*cs.gaussian_bytes_ops(B, d, record=record))[0],
            path),
            step_record=record)
    return out


def leg_k1(cs, torch, D, ds):
    from ray_tpu_torch.rllib.agents.impala import vtrace
    out = {}
    for T, B in K1_SHAPES:
        inputs = cs.vtrace_inputs(T, B, seed=T * B)
        views = cs.vtrace_layout(inputs, T, "batch_major")
        got = vtrace.from_importance_weights(**views)
        want = vtrace._from_importance_weights_plain(
            *inputs.values(), 1.0, 1.0, 1.0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.allclose(g, w, rtol=cs.VTRACE_TOL,
                                  atol=cs.VTRACE_TOL):
                raise AssertionError(f"K1 differs from plain at {T}x{B}")
        section = lambda: vtrace.from_importance_weights(  # noqa: E731
            **views)
        ops, section_device_ms = cs.device_work_per_call(section)
        out[f"{T}x{B}"] = {
            "section_ms": cs.time_call(section, reps=2000),
            "section_device_ops": ops,
            "section_device_ms": section_device_ms,
            "device_ms": cs.device_ms(section, "vtrace_kernel"),
            "dense_ms": cs.time_call(
                lambda: vtrace.from_importance_weights(**inputs),
                reps=2000),
            "plain_ms": cs.time_call(
                lambda: vtrace._from_importance_weights_plain(
                    *inputs.values(), 1.0, 1.0, 1.0), reps=100, warmup=3),
            "bound_ms": cs.bound_ms(*cs.vtrace_bytes_ops(T, B))[0],
        }
    return out


class _TailContext:
    """What `SquashedGaussianTail.forward` uses of autograd's context."""

    def set_materialize_grads(self, value):
        pass

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


def leg_k9b(cs, torch, D, ds):
    out = {}
    low, high = -2.0, 2.0  # Pendulum's action bounds
    for B, d in K9B_SHAPES:
        x, z = cs.squashed_inputs(B, d, seed=B * d + 10, margin=1e-3)
        g = torch.Generator(device="cuda").manual_seed(B + d)
        g_a = torch.randn(B, 3 + d, generator=g, device="cuda")[:, 3:]
        g_logp = torch.randn(B, generator=g, device="cuda")
        dense = g_a.contiguous()
        want = D._squashed_gaussian_backward_plain(x, z, dense, g_logp, low,
                                                   high, True)
        xg = x.clone().requires_grad_(True)
        actions, logp = D.squashed_gaussian_sample_logp(xg, z, low, high)
        backward = lambda: torch.autograd.grad(  # noqa: E731
            (actions, logp), [xg], (g_a, g_logp), retain_graph=True)
        (got,) = backward()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K9b differs from plain at {B}x{d}")
        ops, backward_device_ms = cs.device_work_per_call(backward)
        # The autograd function's backward body alone, as the engine calls
        # it (without the engine), on a context its forward filled.
        ctx = _TailContext()
        D.SquashedGaussianTail.forward(ctx, x, z, D.SquashedTail(low, high, d),
                                       True, None)
        body = lambda: D.SquashedGaussianTail.backward(  # noqa: E731
            ctx, g_a, g_logp)
        body_ops, _ = cs.device_work_per_call(body)
        out[f"{B}x{d}"] = {
            "body_ms": cs.time_call(body, reps=2000),
            "body_device_ops": body_ops,
            "backward_ms": cs.time_call(backward, reps=2000),
            "backward_device_ops": ops,
            "backward_device_ms": backward_device_ms,
            "device_ms": cs.device_ms(backward,
                                      "squashed_gaussian_backward_kernel"),
            "bare_ms": cs.time_call(
                lambda: D._squashed_gaussian_backward_cuda(
                    x, z, dense, g_logp, low, high, True), reps=2000),
            "plain_ms": cs.time_call(
                lambda: D._squashed_gaussian_backward_plain(
                    x, z, dense, g_logp, low, high, True), reps=500),
            "bound_ms": cs.bound_ms(*cs.squashed_backward_bytes_ops(B, d))[0],
        }
    return out


def k5b_path(de, dec, torch, n, seed):
    """(env step as the tree's Anakin optimizer makes it, callable as
    (actions, slot, counter); the episode accumulator; actions [T, n];
    the buffers) for `n` envs of a `device_env_check` case."""
    env = de.DeviceCartPole()
    state, _, ep = dec.env_case(env, n, "cuda", seed)
    actions = torch.randint(0, 2, (K5B_SLOTS, n), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(seed))
    obs = torch.zeros(n, K5B_SLOTS + 1, 4, device="cuda")
    rew = torch.zeros(n, K5B_SLOTS, device="cuda")
    done = torch.zeros(n, K5B_SLOTS, dtype=torch.bool, device="cuda")
    slots = ([obs[:, t + 1] for t in range(K5B_SLOTS)], rew.unbind(1),
             done.unbind(1))
    if hasattr(env, "bind"):
        step = env.bind(state, *slots, seed=dec.SEED, episodes=ep)
    else:
        def step(a, t, counter):
            env.step(state, a, dec.SEED, counter, obs_out=slots[0][t],
                     reward_out=slots[1][t], done_out=slots[2][t],
                     episodes=ep)
    return env, state, step, ep, actions, (obs, rew, done), slots


def leg_k5b(cs, torch, D, ds):
    from ray_tpu_torch.rllib.env import device_env as de
    from ray_tpu_torch.rllib.env import device_env_check as dec
    out = {}
    for n in K5B_SHAPES:
        # Six steps against the plain version on a copy of the case.
        runs = []
        for use_path in (True, False):
            env, state, step, ep, actions, bufs, slots = k5b_path(
                de, dec, torch, n, seed=n)
            for t in range(6):
                if use_path:
                    step(actions[t], t, dec.COUNTER + t)
                else:
                    de._cartpole_step_plain(
                        state["s"], state["t"], actions[t], slots[0][t],
                        slots[1][t], slots[2][t], ep, env.max_steps,
                        dec.SEED, dec.COUNTER + t, False)
            torch.cuda.synchronize()
            runs.append([state["s"], state["t"], *bufs, *ep.tensors()])
        for a, b in zip(*runs):
            if not torch.equal(a, b):
                raise AssertionError(f"K5b's path differs from plain at "
                                     f"n={n}")
        env, state, step, ep, actions, bufs, slots = k5b_path(
            de, dec, torch, n, seed=n)
        acts = list(actions.unbind(0))
        calls = [0]

        def path():
            i = calls[0]
            calls[0] = i + 1
            t = i % K5B_SLOTS
            step(acts[t], t, dec.COUNTER + i)

        ends = int(ep.done_cnt.sum())
        row = {"bound_step": hasattr(env, "bind"),
               "path_ms": cs.time_call(path, reps=2000)}
        row["ends_per_step"] = (int(ep.done_cnt.sum()) - ends) / calls[0]
        row["path_host_ms"] = cs.host_ms(path, reps=2000)
        row["path_device_ops"], row["path_device_ms"] = \
            cs.device_work_per_call(path)
        row["device_ms"] = cs.device_ms(path, "cartpole_kernel")
        generic = (state, acts[0], slots[0][0], slots[1][0], slots[2][0],
                   ep, dec.SEED, dec.COUNTER, False)
        row["generic_ms"] = cs.time_call(lambda: env._launch(*generic),
                                         reps=2000)
        row["plain_ms"] = cs.time_call(
            lambda: dec.plain_launch(env, *generic), reps=200)
        row["bound_ms"] = cs.bound_ms(cs.device_env_bytes(
            "cartpole_step", n, row["ends_per_step"]), 60 * n)[0]
        out[n] = row
    return out


def leg_k6b(cs, torch, D, ds):
    import numpy as np
    from ray_tpu_torch.models import catalog
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.parallel import collectives, q8_check
    from ray_tpu_torch.rllib.env.spaces import Box
    model = catalog.get_model(Box(0, 255, (84, 84, 4), np.uint8),
                              cs.NUM_ACTIONS, {})
    plan = convert.flax_pack_plan(model, collectives.Q8_BLOCK)
    unpack = plan.unpack_index.to("cuda")
    world, mean = cs.DP_RANKS, False
    gathered = q8_check.gathered_case(world, plan.nb, seed=11,
                                      device="cuda")
    want = collectives.q8_gather_sum(gathered, plan.nb, mean)[unpack]
    fused = hasattr(collectives, "Q8Decode")
    if fused:
        decode = collectives.Q8Decode(
            convert.flax_leaf_table(model, collectives.Q8_BLOCK), plan.nb,
            "cuda")
        section = lambda: decode(gathered, mean)  # noqa: E731
        symbol = "q8_gather_sum_unpack_kernel"
        plain = lambda: collectives._q8_gather_sum_unpack_plain(  # noqa
            gathered, plan.nb, mean, decode.table)
    else:
        section = lambda: collectives.q8_gather_sum(  # noqa: E731
            gathered, plan.nb, mean)[unpack]
        symbol = "q8_gather_sum_kernel"
        plain = lambda: collectives._q8_gather_sum_plain(  # noqa: E731
            gathered, plan.nb, mean)[plan.unpack_index.to("cuda")]
    got = section()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K6b's decode section differs from the packed "
                             "sum indexed")
    ops, section_device_ms = cs.device_work_per_call(section)
    numel = plan.unpack_index.numel()
    return {
        "leaf_table": fused,
        "section_ms": cs.time_call(section, reps=2000),
        "section_host_ms": cs.host_ms(section, reps=2000),
        "section_device_ops": ops,
        "section_device_ms": section_device_ms,
        "device_ms": cs.device_ms(section, symbol),
        "device_ms_cold_l2": cs.device_ms(section, symbol, cold=True),
        "plain_ms": cs.time_call(plain, reps=100),
        "bound_ms": cs.bound_ms(
            world * (numel + 4 * plan.nb) + 4 * numel,
            3 * world * numel)[0],
    }


def leg_anakin_cartpole(cs):
    from ray_tpu_torch.rllib.env import device_env as de
    bound = getattr(de, "CARTPOLE_BOUND_KERNEL", None)
    kernel, absent = (de.CARTPOLE_KERNEL, ()) if bound is None else (
        bound, (de.CARTPOLE_KERNEL,))
    trainer, rows, launches, _ = cs.run_anakin_calls(
        cs.CARTPOLE_ANAKIN_CONFIG, ANAKIN_CARTPOLE_CALLS, kernel,
        absent=absent)
    trainer.stop()
    steady = rows[1:]
    return {"bound_step": bound is not None,
            "env_steps_per_s_steady": sum(r["steps"] for r in steady)
            / sum(r["s"] for r in steady),
            "call_s": [r["s"] for r in rows], "launches": launches}


def leg_phase3(cs):
    _, _, summary = cs.run_trainer(with_summary=True)
    summary.pop("profiled_iteration", None)
    return {k: summary[k] for k in ("env_steps_per_s_steady", "iter_s",
                                    "sample_s_steady_mean",
                                    "learner_grad_ms_steady_mean")}


def leg_phase4(cs):
    out = {}
    for k in (1, 5):
        summary, _ = cs.run_sebulba(k)
        summary.pop("profiled_iteration", None)
        out[k] = {
            "env_steps_per_s_steady": summary["env_steps_per_s_steady"],
            "iter_s": summary["iter_s"],
            **summary["transfer_steady"]}
    return out


def leg_phase8(cs):
    _, summary = cs.run_ppo_pendulum(with_summary=True)
    return {k: summary[k] for k in ("env_steps_per_s_steady", "iter_s",
                                    "sample_s_steady", "learn_s_steady")}


def leg_phase9(cs):
    out = {}
    for name, config in (("dqn_atari", cs.DQN_ATARI_CONFIG),
                         ("dqn_cartpole", cs.DQN_CARTPOLE_CONFIG)):
        trainer, _, _, summary = cs.run_dqn(name, config, cs.DQN_ITERS,
                                            profile_last=False,
                                            with_summary=True)
        trainer.stop()
        out[name] = {k: summary[k] for k in (
            "env_steps_per_s_steady", "iter_s", "sample_s_steady",
            "update_ms_steady", "update_parts_ms_steady")}
    return out


def leg_phase10(cs):
    trainer, _, _, _, summary = cs.run_sac(with_summary=True)
    trainer.stop()
    keys = ("env_steps_per_s_learning", "iter_s", "update_ms_learning",
            "sample_s_learning", "update_split_ms_synced")
    return {k: summary[k] for k in keys}


def tree_kernels():
    """Every `CudaKernel` the tree's kernel modules define (a tree older
    than this file's `chip_smoke.port_kernels` lacks some of its)."""
    import importlib
    from ray_tpu_torch._private.cuda_build import CudaKernel
    modules = ("ray_tpu_torch.models.distributions",
               "ray_tpu_torch.models.eps_greedy",
               "ray_tpu_torch.parallel.collectives",
               "ray_tpu_torch.rllib.agents.impala.vtrace",
               "ray_tpu_torch.rllib.env.device_env",
               "ray_tpu_torch.rllib.evaluation.device_sampler")
    return [v for m in modules for v in vars(
        importlib.import_module(m)).values() if isinstance(v, CudaKernel)]


def measure(tree, legs):
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    import ray_tpu_torch
    pkg = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(tree):
        raise AssertionError(f"imported {pkg}, not the tree {tree}")
    cs = load_chip_smoke()
    from ray_tpu_torch._private import cuda_build
    from ray_tpu_torch.models import distributions
    from ray_tpu_torch.rllib.evaluation import device_sampler as ds

    t0 = time.perf_counter()
    cuda_build.build_all(tree_kernels())
    out = {"tree": tree, "package": pkg,
           "build_s": time.perf_counter() - t0}
    for leg in legs:
        t0 = time.perf_counter()
        if leg.startswith("phase") or leg == "anakin_cartpole":
            out[leg] = globals()[f"leg_{leg}"](cs)
        else:
            out[leg] = globals()[f"leg_{leg}"](cs, torch, distributions, ds)
        out[f"{leg}_s"] = time.perf_counter() - t0
    return out


def main(argv):
    if argv[:1] == ["--one"]:
        import torch
        if not torch.cuda.is_available():
            print("kernel_ab: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(measure(argv[1], argv[2].split(","))), flush=True)
        return 0
    out_path, legs = None, ",".join(LEGS)
    while argv[:1] in (["--out"], ["--legs"]):
        if argv[0] == "--out":
            out_path = argv[1]
        else:
            legs = argv[1]
        argv = argv[2:]
    unknown = set(legs.split(",")) - set(LEGS)
    if not argv or unknown:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree, legs],
            capture_output=True, text=True, cwd=HERE, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            raise SystemExit(f"kernel_ab: {tree} failed "
                             f"(exit {proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["wall_s"] = time.perf_counter() - t0
        runs.append(run)
        print(json.dumps(run), flush=True)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(runs, f, indent=1)
    print(load_chip_smoke().card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
