"""Episode metric aggregation.

Counterpart of `ray_tpu/rllib/evaluation/metrics.py` (parity:
`rllib/evaluation/metrics.py:39` `collect_metrics`), for the local
worker, on one rank or on every rank of a data-parallel learner
(`world_totals`): remote workers wait for the runtime port.
"""

from __future__ import annotations

from typing import List

import numpy as np


def collect_episodes(workers) -> List:
    return list(workers.local_worker.get_metrics())


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
