"""In-process metrics: counters and gauges.

The port's own copy of `ray_tpu/_private/metrics.py`, trimmed to the
in-process registry that the weight plane writes: counters
`weight_sync_bytes`, `weight_sync_codec.<full|q8_delta>`,
`weight_sync_skipped`, `weight_sync_stale_fallbacks` and
`weight_sync_stale_received`; gauges `weight_sync_ms` (the last
encode), `weight_sync_payload_bytes` (the last sync's payloads) and
`weight_apply_ms` (the last decode on a receiver). The histograms and
the cluster aggregation belong to the multi-process runtime.

    from ray_tpu_torch._private import metrics
    metrics.inc("weight_sync_bytes", n)
    metrics.set_gauge("weight_sync_ms", ms)
    metrics.snapshot()["counters"]
"""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}


def inc(name: str, value: float = 1.0) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def set_gauge(name: str, value: float) -> None:
    with _lock:
        _gauges[name] = float(value)


def snapshot() -> Dict[str, dict]:
    """This process's counters and gauges (copies)."""
    with _lock:
        return {"counters": dict(_counters), "gauges": dict(_gauges)}
