"""Episode metric aggregation.

Counterpart of `ray_tpu/rllib/evaluation/metrics.py` (parity:
`rllib/evaluation/metrics.py:39` `collect_metrics`): the local
worker's and the remote workers' episodes, on one rank or on every
rank of a data-parallel learner (`world_totals`).
"""

from __future__ import annotations

from typing import List

import numpy as np

import ray_tpu_torch


def collect_episodes(workers, timeout: float = 60) -> List:
    episodes = list(workers.local_worker.get_metrics())
    if workers.remote_workers:
        refs = [w.get_metrics.remote() for w in workers.remote_workers]
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                      timeout=timeout)
        for r in ready:
            episodes.extend(ray_tpu_torch.get(r))
    return episodes


def world_totals(group, episodes, steps_sampled: int, steps_trained: int):
    """Every rank's episodes and step counts -> the world's (episodes in
    rank order, counts summed), the same on every rank: one collective
    (`LearnerGroup.all_gather_object`)."""
    parts = group.all_gather_object(
        (list(episodes), steps_sampled, steps_trained))
    return ([e for part in parts for e in part[0]],
            sum(part[1] for part in parts), sum(part[2] for part in parts))


def summarize_episodes(episodes, smoothed: List = None) -> dict:
    pool = list(episodes)
    if smoothed:
        pool = (list(smoothed) + pool)[-100:]
    rewards = [e.episode_reward for e in pool]
    lengths = [e.episode_length for e in pool]
    return {
        "episode_reward_mean": float(np.mean(rewards)) if rewards else np.nan,
        "episode_reward_min": float(np.min(rewards)) if rewards else np.nan,
        "episode_reward_max": float(np.max(rewards)) if rewards else np.nan,
        "episode_len_mean": float(np.mean(lengths)) if lengths else np.nan,
        "episodes_this_iter": len(episodes),
    }
