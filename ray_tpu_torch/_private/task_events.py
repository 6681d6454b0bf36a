"""Task-lifecycle records: states and a bounded log.

The port's own copy of `ray_tpu/_private/task_events.py`, trimmed to
`TaskStateLog`, which the local-mode runtime fills with one terminal
record per task and actor call (`ray_tpu_torch.tasks()` in the JAX
package's vocabulary). The per-process flush buffer, the data-plane
annotations and the head's histograms belong to the multi-process
runtime.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

SUBMITTED = "SUBMITTED"
QUEUED = "QUEUED"
LEASED = "LEASED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"

# Canonical ordering; late or out-of-order events never regress a
# record's headline state.
STATES = (SUBMITTED, QUEUED, LEASED, RUNNING, FINISHED, FAILED)
_RANK = {s: i for i, s in enumerate(STATES)}
_RANK[FAILED] = _RANK[FINISHED]  # both terminal, equal precedence
TERMINAL = (FINISHED, FAILED)


class TaskStateLog:
    """Bounded log of task records. Insertion-ordered; the oldest
    records evict first."""

    def __init__(self, max_tasks: int = 4096):
        self._max = max(1, int(max_tasks))
        self._records: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def apply(self, ev: dict) -> None:
        tid = ev.get("task_id")
        state = ev.get("state")
        if not tid or state not in _RANK:
            return
        with self._lock:
            rec = self._records.get(tid)
            if rec is None:
                rec = {"task_id": tid, "name": "", "kind": "task",
                       "state": state, "node": None, "worker_pid": None,
                       "caller": None, "parent_task_id": None,
                       "error": None, "events": []}
                self._records[tid] = rec
                while len(self._records) > self._max:
                    self._records.popitem(last=False)
            rec["events"].append((state, float(ev.get("ts") or time.time())))
            if _RANK[state] >= _RANK[rec["state"]]:
                rec["state"] = state
            for src, dst in (("name", "name"), ("kind", "kind"),
                             ("node", "node"), ("pid", "worker_pid"),
                             ("caller", "caller"),
                             ("parent", "parent_task_id"),
                             ("error", "error")):
                if ev.get(src) is not None:
                    rec[dst] = ev[src]

    @staticmethod
    def _view(rec: dict) -> dict:
        events = sorted(rec["events"], key=lambda e: e[1])
        durations: Dict[str, float] = {}
        for (state, ts), (_nstate, nts) in zip(events, events[1:]):
            durations[state] = durations.get(state, 0.0) \
                + max(0.0, nts - ts)
        out = {k: rec[k] for k in ("task_id", "name", "kind", "state",
                                   "node", "worker_pid", "caller",
                                   "parent_task_id", "error")}
        out["start"] = events[0][1] if events else None
        out["end"] = events[-1][1] \
            if events and rec["state"] in TERMINAL else None
        out["durations"] = durations
        out["events"] = events
        return out

    def list(self, state: Optional[str] = None, name: Optional[str] = None,
             limit: int = 100) -> List[dict]:
        """Newest-first record views, optionally filtered (built under
        the lock, so no view is torn)."""
        out = []
        with self._lock:
            for rec in reversed(list(self._records.values())):
                if state is not None and rec["state"] != state:
                    continue
                if name is not None and rec["name"] != name:
                    continue
                out.append(self._view(rec))
                if limit and len(out) >= limit:
                    break
        return out

    def summary(self) -> Dict[str, Dict[str, int]]:
        """Per-state counts grouped by function or method name."""
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for rec in self._records.values():
                per = out.setdefault(
                    rec["name"] or rec["task_id"][:12], {})
                per[rec["state"]] = per.get(rec["state"], 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
