"""Learning curves of the Sebulba inline-actor IMPALA config on CartPole,
for the JAX package and for its PyTorch port, on the CPU.

The config is that of `test_inline_sebulba_impala_learns_cartpole`
(1 inline actor x 16 envs, 20-step fragments, 320-row updates, lr 3e-3)
and its bar: the 100-episode mean reward passes 60 within 25
iterations. Two modes:

- `threaded`: the trainer as a user runs it (the inline actor and the
  learner on their own threads, so the point where an update lands
  inside a fragment depends on timing); `--repeats` runs per seed.
- `serial`: the same trainer with its threads left unstarted, and the
  actor's sampler and the learner's update stepped in turn on the
  calling thread: one update per fragment, deterministic per seed.

Run from the repository root, e.g.

    JAX_PLATFORMS=cpu python tests/cartpole_learning_witness.py \\
        --impl torch --mode serial --seeds 0-7,10-33

Prints one line per run (best mean reward, the first iteration past
60, every third point of the curve) and a summary line.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BAR, ITERS = 60.0, 25


def config(seed):
    return dict(env="CartPole-v0", num_workers=0, num_inline_actors=1,
                num_envs_per_worker=16, rollout_fragment_length=20,
                train_batch_size=320, lr=3e-3, min_iter_time_s=0,
                seed=seed)


def seeds_arg(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def trainer_parts(impl):
    """(trainer class, async_samples_optimizer module, extra config)."""
    if impl == "jax":
        import ray_tpu
        from ray_tpu.rllib.agents.registry import get_trainer_class
        from ray_tpu.rllib.optimizers import async_samples_optimizer
        ray_tpu.init(num_cpus=2)
        return get_trainer_class("IMPALA"), async_samples_optimizer, {}
    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
    from ray_tpu_torch.rllib.optimizers import async_samples_optimizer
    return IMPALATrainer, async_samples_optimizer, {"device": "cpu"}


def run_threaded(cls, cfg):
    t = cls(config=cfg)
    curve = []
    try:
        for _ in range(ITERS):
            rew = t.train().get("episode_reward_mean")
            curve.append(rew if rew == rew else 0.0)
    finally:
        t.stop()
    return curve


def run_serial(cls, aso, cfg):
    starts = (aso.LearnerThread.start, aso.InlineActorThread.start)
    aso.LearnerThread.start = aso.InlineActorThread.start = \
        lambda self: None
    try:
        t = cls(config=cfg)
    finally:
        aso.LearnerThread.start, aso.InlineActorThread.start = starts
    sampler = t.optimizer._inline_actors[0].sampler
    policy = t.optimizer.learner.local_worker.policy
    window, curve = [], []
    for _ in range(ITERS):
        policy.learn_on_batch(sampler.sample())
        window = (window + [m.episode_reward
                            for m in sampler.get_metrics()])[-100:]
        curve.append(statistics.mean(window) if window else 0.0)
    return curve


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--impl", choices=("torch", "jax"), required=True)
    p.add_argument("--mode", choices=("serial", "threaded"),
                   default="serial")
    p.add_argument("--seeds", type=seeds_arg, default=[0])
    p.add_argument("--repeats", type=int, default=1)
    args = p.parse_args()
    cls, aso, extra = trainer_parts(args.impl)
    bests, firsts = [], []
    for seed in args.seeds:
        for rep in range(args.repeats):
            t0 = time.perf_counter()
            cfg = dict(config(seed), **extra)
            curve = (run_serial(cls, aso, cfg) if args.mode == "serial"
                     else run_threaded(cls, cfg))
            first = next((i + 1 for i, r in enumerate(curve) if r > BAR),
                         None)
            bests.append(max(curve))
            firsts.append(first)
            print(f"{args.impl} {args.mode} seed {seed} run {rep}: best "
                  f"{max(curve):.1f} first>{BAR:g} {first} "
                  f"({time.perf_counter() - t0:.1f} s) curve[::3] "
                  f"{[round(r, 1) for r in curve[::3]]}", flush=True)
    passed = [f for f in firsts if f is not None]
    print(f"{args.impl} {args.mode} SUMMARY runs {len(bests)} passed "
          f"{len(passed)} mean best {statistics.mean(bests):.1f} sd "
          f"{statistics.stdev(bests) if len(bests) > 1 else 0.0:.1f} "
          f"median first>{BAR:g} "
          f"{statistics.median(passed) if passed else None}", flush=True)


if __name__ == "__main__":
    main()
