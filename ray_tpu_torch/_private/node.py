"""Session and node bring-up: the backend of `ray_tpu_torch.init()`.

The port's own copy of `ray_tpu/_private/node.py:47-164`, on one node.
`Node` makes the session directory (the workers' logs), starts the head
(`head.py`) as threads of the driver's process and connects the
driver's `Runtime`; the head starts worker processes on demand.
`shutdown` stops the driver's runtime and the head (every worker process
exits or is killed), unlinks the session's shared-memory files and
removes the session directory.

The reference's `detect_tpus` becomes `detect_gpus`: the `"GPU"`
resource is `torch.cuda.device_count()` unless `init(num_gpus=)` or
`init(resources={"GPU": n})` says otherwise. The attached-driver mode
and the TCP plane of the multi-node reference are not copied.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from typing import Dict, Optional

from . import worker_state
from .head import HeadServer
from .runtime import Runtime

_lock = threading.Lock()
_node: Optional["Node"] = None


def default_resources() -> Dict[str, float]:
    # Scheduling gates process concurrency: allow a sane minimum of
    # parallelism even on a small host.
    return {"CPU": float(max(os.cpu_count() or 1, 4))}


def detect_gpus() -> float:
    """The CUDA devices this process sees (0 without a card)."""
    import torch
    return float(torch.cuda.device_count())


class Node:
    def __init__(self, resources: Dict[str, float]):
        self.session_name = f"torch-{os.getpid()}-{os.urandom(3).hex()}"
        root = os.path.join(tempfile.gettempdir(), "ray-tpu-torch-sessions")
        self.session_dir = os.path.join(root, f"session_{self.session_name}")
        os.makedirs(self.session_dir, exist_ok=True)
        self.head = HeadServer(self.session_dir, self.session_name,
                               resources)
        try:
            self.runtime = Runtime(self.session_dir, self.session_name,
                                   self.head.sock_path, role="driver")
        except BaseException:
            self.head.shutdown()
            shutil.rmtree(self.session_dir, ignore_errors=True)
            raise

    def shutdown(self):
        try:
            self.runtime.shutdown()
        finally:
            self.head.shutdown()
            self.runtime.shm.cleanup_session()
            shutil.rmtree(self.session_dir, ignore_errors=True)


def init(resources: Optional[Dict[str, float]] = None,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None) -> Node:
    global _node
    with _lock:
        if _node is not None:
            raise RuntimeError("ray_tpu_torch.init() called twice; call "
                               "ray_tpu_torch.shutdown() first")
        res = default_resources()
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        gpus = num_gpus if num_gpus is not None else detect_gpus()
        if gpus:
            res["GPU"] = float(gpus)
        if resources:
            res.update({k: float(v) for k, v in resources.items()})
        node = Node(res)
        _node = node
        worker_state.set_runtime(node.runtime, worker_state.SCRIPT_MODE)
        atexit.register(_atexit_shutdown)
        return node


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:  # noqa: BLE001 — interpreter exit
        pass


def shutdown():
    global _node
    with _lock:
        node, _node = _node, None
    if node is not None:
        node.shutdown()


def current_node() -> Optional[Node]:
    return _node
