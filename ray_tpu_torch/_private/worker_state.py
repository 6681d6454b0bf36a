"""Process-global runtime handle.

The port's own copy of `ray_tpu/_private/worker_state.py`: the runtime
that `ray_tpu_torch.init` installed (the driver's, `SCRIPT_MODE`), that
a worker process runs (`WORKER_MODE`), or the local-mode runtime
(`LOCAL_MODE`), and its mode.
"""

from __future__ import annotations

from typing import Optional

SCRIPT_MODE = "driver"
WORKER_MODE = "worker"
LOCAL_MODE = "local"

_runtime = None
_mode: Optional[str] = None


def set_runtime(rt, mode: str) -> None:
    global _runtime, _mode
    _runtime = rt
    _mode = mode


def get_runtime():
    if _runtime is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call "
            "ray_tpu_torch.init() (or init(local_mode=True)) first")
    return _runtime


def get_runtime_or_none():
    return _runtime


def mode() -> Optional[str]:
    return _mode


def clear() -> None:
    global _runtime, _mode
    _runtime = None
    _mode = None
