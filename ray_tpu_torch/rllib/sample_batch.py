"""SampleBatch: columnar trajectory data.

The port's own copy of `ray_tpu/rllib/sample_batch.py` (numpy only),
trimmed to what the port's paths use. Parity:
`rllib/policy/sample_batch.py` — a dict of equal-length columns. Host
columns are contiguous numpy arrays, so host→device feeding is a single
copy per column (the learner converts whole columns, never per-row
objects); the Sebulba sampler's big columns are `torch.Tensor`s already
on the learner's device, and every method here takes both.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

# Canonical column names (same vocabulary as the reference).
OBS = "obs"
NEW_OBS = "new_obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
EPS_ID = "eps_id"
AGENT_INDEX = "agent_index"
T = "t"
ACTION_LOGP = "action_logp"
ACTION_DIST_INPUTS = "action_dist_inputs"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
PREV_ACTIONS = "prev_actions"
PREV_REWARDS = "prev_rewards"
# Per-fragment bootstrap observation, shape [num_fragments, ...] — one
# row per rollout fragment rather than per step.
BOOTSTRAP_OBS = "bootstrap_obs"
# Selection lag of each transition in steps (Sebulba k-step windows: the
# action of sub-step j was chosen from the window-head observation).
POLICY_LAG = "policy_lag"

# Columns whose leading dimension is NOT the per-step row count.
_NON_ROW_COLUMNS = (BOOTSTRAP_OBS,)


class SampleBatch(dict):
    """A dict of columns; all columns share leading dimension `count`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        lens = {k: len(v) for k, v in self.items()
                if k not in _NON_ROW_COLUMNS}
        if lens and len(set(lens.values())) > 1:
            raise ValueError(f"column lengths differ: {lens}")

    @property
    def count(self) -> int:
        for k, v in self.items():
            if k not in _NON_ROW_COLUMNS:
                return len(v)
        return 0

    def slice(self, start: int, end: int) -> "SampleBatch":
        """Rows [start, end). Fragment-indexed columns (BOOTSTRAP_OBS)
        are dropped: they no longer align once rows are cut."""
        return SampleBatch({k: v[start:end] for k, v in self.items()
                            if k not in _NON_ROW_COLUMNS})

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if len(batches) == 1:
            return batches[0]
        keys = batches[0].keys()
        out = {}
        for k in keys:
            vals = [b[k] for b in batches]
            if isinstance(vals[0], torch.Tensor):
                out[k] = torch.cat(vals, dim=0)
            elif isinstance(vals[0], np.ndarray):
                out[k] = np.concatenate(vals, axis=0)
            else:
                out[k] = [x for v in vals for x in v]
        return SampleBatch(out)

    def __repr__(self):
        return f"SampleBatch({self.count}: {list(self.keys())})"
