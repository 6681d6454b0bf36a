"""The device envs' kernels (K5a, K5b) held against their plain versions
on one input, on the card: the case builder and the comparison that
`chip_smoke.py` phase 2 and the `gpu` tests of
`tests/test_torch_kernels.py` share.

A case has envs at and next to both episode boundaries, CartPole states
near its x and theta thresholds (stepping over them and staying inside)
and random ones, and random running and completed episode sums. The
comparison launches the kernel and the plain version from two copies of
the case, each writing into the middle slot of a 3-slot env-major
buffer, and requires every output byte for byte (CartPole's f32 state
and observation within 1 ulp) with the neighbouring slots untouched.
`compare_bound_with_plain` does the same for CartPole's bound step
(K5b as the Anakin optimizer launches it) over several steps into the
slots of env-major buffers.
"""

from typing import Dict, Tuple

import numpy as np
import torch

from . import device_env as de

SEED, COUNTER = 5, 17  # the Philox key and launch counter of a case


def random_episodes(n: int, device, rng) -> de.EpisodeAccumulator:
    """An EpisodeAccumulator holding random running and completed sums."""
    ep = de.EpisodeAccumulator(n, device)
    for name, x in zip(ep.FIELDS, ep.tensors()):
        x.copy_(torch.from_numpy(rng.integers(0, 900, n).astype(
            np.float32 if name.endswith("rew") else np.int32)))
    return ep


def env_case(env: de.DeviceEnv, n: int, device, seed: int
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                        de.EpisodeAccumulator]:
    """(state, actions, episodes) on `device` for `n` envs of `env`."""
    rng = np.random.default_rng(seed)
    if isinstance(env, de.DeviceSyntheticAtari):
        A, L = env.num_actions, env.episode_len
        arrays = {"t": rng.integers(0, L, n),
                  "target": rng.integers(0, A, n)}
        arrays["t"][::5], arrays["t"][1::7] = L - 1, 0
        actions = rng.integers(0, A, n)
        actions[::2] = arrays["target"][::2]
    else:
        s = rng.uniform(-0.05, 0.05, (n, 4))
        s[::6, 0] = 2.3995 * np.sign(rng.standard_normal(n))[::6]
        s[::6, 1] = rng.uniform(-0.1, 0.1, len(s[::6]))
        s[3::6, 2] = 0.2089 * np.sign(rng.standard_normal(n))[3::6]
        s[3::6, 3] = rng.uniform(-0.1, 0.1, len(s[3::6]))
        arrays = {"s": s, "t": rng.integers(0, env.max_steps, n)}
        arrays["t"][::5] = env.max_steps - 1
        actions = rng.integers(0, 2, n)
    state = env.state_from_numpy(arrays, device)
    return state, torch.from_numpy(actions).to(device), random_episodes(
        n, device, rng)


def kernel_of(env: de.DeviceEnv) -> de.CudaKernel:
    return de.SYNTHETIC_ATARI_KERNEL \
        if isinstance(env, de.DeviceSyntheticAtari) else de.CARTPOLE_KERNEL


def plain_launch(env: de.DeviceEnv, state, actions, obs, reward, done,
                 episodes, seed, counter, reset) -> None:
    """`env._launch` through the plain version, on any device."""
    if isinstance(env, de.DeviceSyntheticAtari):
        de._synthetic_atari_step_plain(
            state["t"], state["target"], actions, obs, reward, done,
            episodes, env.num_actions, env.episode_len, seed, counter,
            reset)
    else:
        de._cartpole_step_plain(
            state["s"], state["t"], actions, obs, reward, done, episodes,
            env.max_steps, seed, counter, reset)


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two f32 tensors in units in the last
    place."""
    d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return torch.where(a == b, 0, d)


def compare_with_plain(env: de.DeviceEnv, n: int, reset: bool,
                       seed: int, device="cuda") -> dict:
    """One reset or step of `n` envs through the kernel and through the
    plain version; raises AssertionError where they differ. Returns the
    largest f32 distance (`max_ulps`, `max_abs_err`) and the number of
    envs whose episode the step ended (`ends`)."""
    kernel = kernel_of(env)
    shape = tuple(env.observation_space.shape)
    runs = []
    for use_kernel in (True, False):
        state, actions, ep = env_case(env, n, device, seed)
        obs = torch.full((n, 3) + shape, 7, dtype=env.obs_dtype,
                         device=device)
        rew = torch.full((n, 3), -1.0, device=device)
        done = torch.zeros(n, 3, dtype=torch.bool, device=device)
        args = (state, actions, obs[:, 1], rew[:, 1], done[:, 1], ep,
                SEED, COUNTER, reset)
        before = kernel.launches
        if use_kernel:
            env._launch(*args)
        else:
            plain_launch(env, *args)
        torch.cuda.synchronize()
        if kernel.launches != before + int(use_kernel):
            raise AssertionError(
                f"{kernel.name}: {kernel.launches - before} launches for "
                f"{'the kernel' if use_kernel else 'the plain version'}")
        runs.append((state, obs, rew, done, ep.tensors()))
    (ks, kobs, krew, kdone, kep), (ps, pobs, prew, pdone, pep) = runs
    where = f"{kernel.name} at n={n} reset={reset}"
    max_ulps, max_err = 0, 0.0
    for name, a, b in [(k, ks[k], ps[k]) for k in ks] + [("obs", kobs,
                                                           pobs)]:
        if a.dtype == torch.float32:
            max_ulps = max(max_ulps, int(ulps(a, b).max()))
            max_err = max(max_err, float((a - b).abs().max()))
        elif not torch.equal(a, b):
            raise AssertionError(f"{where}: {name} differs from plain in "
                                 f"{int((a != b).sum())} elements")
    if max_ulps > 1:
        raise AssertionError(f"{where}: f32 outputs {max_ulps} ulp apart")
    if not (torch.equal(krew, prew) and torch.equal(kdone, pdone)):
        raise AssertionError(f"{where}: reward or done differs from plain")
    for name, a, b in zip(de.EpisodeAccumulator.FIELDS, kep, pep):
        if not torch.equal(a, b):
            raise AssertionError(f"{where}: {name} differs from plain")
    if not ((kobs[:, 0] == 7).all() and (kobs[:, 2] == 7).all()
            and (krew[:, [0, 2]] == -1).all()):
        raise AssertionError(f"{where}: wrote outside its slot")
    ends = int(kdone[:, 1].sum())
    if not reset and n >= 5 and not ends:
        raise AssertionError(f"{where}: no episode ended")
    return {"max_ulps": max_ulps, "max_abs_err": max_err, "ends": ends}


def bound_case(n: int, steps: int, device, seed: int):
    """CartPole's (env, state, episodes, actions [steps, n], buffers,
    slots) for a bound run: env-major obs [n, steps + 1, 4] (slot 0
    left alone), reward and done [n, steps], all outside the written
    slots filled with markers."""
    env = de.DeviceCartPole()
    state, _, ep = env_case(env, n, device, seed)
    actions = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 2, (steps, n))).to(device)
    obs = torch.full((n, steps + 1, 4), 7.0, device=device)
    rew = torch.full((n, steps), -1.0, device=device)
    done = torch.zeros(n, steps, dtype=torch.bool, device=device)
    slots = ([obs[:, t + 1] for t in range(steps)], rew.unbind(1),
             done.unbind(1))
    return env, state, ep, actions, (obs, rew, done), slots


def compare_bound_with_plain(n: int, steps: int, seed: int,
                             device="cuda") -> dict:
    """`steps` CartPole steps through the bound step (`BoundCartPoleStep`:
    K5b on a CUDA device) and through the plain version, from two copies
    of one case, into per-slot views of env-major buffers; raises
    AssertionError where they differ (the f32 state and obs within 1
    ulp, everything else byte for byte, slot 0 untouched). Returns
    `max_ulps`, `max_abs_err` and the episode ends (`ends`)."""
    runs = []
    for use_bound in (True, False):
        env, state, ep, actions, bufs, slots = bound_case(n, steps, device,
                                                          seed)
        before = de.CARTPOLE_BOUND_KERNEL.launches
        if use_bound:
            step = env.bind(state, *slots, seed=SEED, episodes=ep)
            for t in range(steps):
                step(actions[t], t, COUNTER + t)
        else:
            for t in range(steps):
                de._cartpole_step_plain(
                    state["s"], state["t"], actions[t], slots[0][t],
                    slots[1][t], slots[2][t], ep, env.max_steps, SEED,
                    COUNTER + t, False)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        launched = de.CARTPOLE_BOUND_KERNEL.launches - before
        want = steps if use_bound and state["s"].is_cuda else 0
        if launched != want:
            raise AssertionError(f"cartpole_step_bound: {launched} launches "
                                 f"for {steps} steps, want {want}")
        runs.append((state, bufs, ep.tensors()))
    (ks, kbufs, kep), (ps, pbufs, pep) = runs
    where = f"cartpole bound step at n={n}, {steps} steps"
    max_ulps, max_err = 0, 0.0
    for name, a, b in [("s", ks["s"], ps["s"]), ("obs", kbufs[0],
                                                 pbufs[0])]:
        max_ulps = max(max_ulps, int(ulps(a, b).max()))
        max_err = max(max_err, float((a - b).abs().max()))
    if max_ulps > 1:
        raise AssertionError(f"{where}: f32 outputs {max_ulps} ulp apart")
    for name, a, b in [("t", ks["t"], ps["t"]), ("reward", kbufs[1],
                                                 pbufs[1]),
                       ("done", kbufs[2], pbufs[2])] + list(zip(
                           de.EpisodeAccumulator.FIELDS, kep, pep)):
        if not torch.equal(a, b):
            raise AssertionError(f"{where}: {name} differs from plain")
    if not (kbufs[0][:, 0] == 7).all():
        raise AssertionError(f"{where}: wrote outside its slots")
    ends = int(kbufs[2].sum())
    if n >= 5 and not ends:
        raise AssertionError(f"{where}: no episode ended")
    return {"max_ulps": max_ulps, "max_abs_err": max_err, "ends": ends}
