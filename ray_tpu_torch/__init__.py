"""ray_tpu_torch: the PyTorch/CUDA port of `ray_tpu`'s training path.

A second package beside `ray_tpu`, with the same layout and module
names, so each module's counterpart is found at the same relative path
(`ray_tpu/rllib/agents/impala/vtrace.py` ->
`ray_tpu_torch/rllib/agents/impala/vtrace.py`). It imports torch and
numpy only: never jax, flax or optax, and nothing from `ray_tpu`. The
numpy-only modules it needs are kept as its own trimmed copies.

Device compute is PyTorch on an NVIDIA Hopper card. The custom device
computations that the JAX package left to XLA's fusion are kernels
written by hand in CUDA C++ (`csrc/`), built with nvcc at first use
(`_private/cuda_build.py`); each kernel's wrapper sits beside a plain
PyTorch version of the same function, which runs for CPU tensors only.

Entry points run on the card unless the caller passes
``"device": "cpu"``; asking for ``"cuda"`` without a card raises.

    from ray_tpu_torch.rllib.agents.impala import IMPALATrainer
    trainer = IMPALATrainer(config={"env": "SyntheticAtari-v0"})
    result = trainer.train()

The runtime API (`init`, `remote`, `get`, `put`, `wait`, `kill`):
`init()` starts the multi-process runtime (`_private/node.py`): the
head runs as threads of the driver, tasks and actors run in worker
processes of their own, and values move through the node's shared-memory
object store. Functions and classes travel by reference (plain
`pickle`), so a remote function or class must be importable: defined at
module level in a module on `sys.path`. `init(local_mode=True)` runs
every task and actor call inline in the driver's process instead
(`_private/local_mode.py`). IMPALA's remote rollout workers run on
either, fed versioned weight syncs (q8 deltas on the multi-process
runtime):

    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    trainer = IMPALATrainer(config={"env": "SyntheticAtari-v0",
                                    "num_workers": 2})
    trainer.train()
    trainer.stop()
    ray_tpu_torch.shutdown()
"""

from __future__ import annotations

import inspect as _inspect
from typing import Optional as _Optional

from . import exceptions
from ._private import worker_state as _ws
from ._private.object_ref import ObjectRef
from .actor import ActorClass, ActorHandle, get_actor
from .exceptions import (ActorDiedError, GetTimeoutError, ObjectLostError,
                         RayError, TaskError, WorkerCrashedError)
from .remote_function import RemoteFunction

__version__ = "0.1.0"


def resolve_device(spec=None):
    """Config value -> `torch.device` (`device.resolve_device`; imported
    on call, so a worker process that runs no torch code imports no
    torch)."""
    from .device import resolve_device as _resolve
    return _resolve(spec)


def init(num_cpus: _Optional[float] = None,
         num_gpus: _Optional[float] = None,
         resources: _Optional[dict] = None,
         local_mode: bool = False):
    """Start the runtime (parity: `ray_tpu.init`): the multi-process
    runtime, with `num_cpus` (default: the host's cores, at least 4),
    `num_gpus` (default: the CUDA devices) and custom `resources`; or,
    with `local_mode=True`, the local-mode runtime, which runs every task
    and actor call inline in this process."""
    if _ws.get_runtime_or_none() is not None:
        raise RuntimeError("ray_tpu_torch.init() called twice; call "
                           "ray_tpu_torch.shutdown() first")
    if local_mode:
        from ._private.local_mode import LocalRuntime
        rt = LocalRuntime()
        _ws.set_runtime(rt, _ws.LOCAL_MODE)
        return rt
    from ._private import node
    return node.init(resources=resources, num_cpus=num_cpus,
                     num_gpus=num_gpus)


def shutdown():
    """Stop the runtime. Local mode drops its objects, actors and task
    records; the multi-process runtime also stops every worker process
    and leaves no shared-memory file and no session directory behind."""
    rt = _ws.get_runtime_or_none()
    if _ws.mode() == _ws.SCRIPT_MODE:
        from ._private import node
        _ws.clear()
        node.shutdown()
        return
    if rt is not None:
        rt.shutdown()
    _ws.clear()


def is_initialized() -> bool:
    return _ws.get_runtime_or_none() is not None


def cluster_resources() -> dict:
    """The node's total resources (multi-process runtime)."""
    return _ws.get_runtime().cluster_info()["nodes"][0]["total_resources"]


def free(refs):
    """Free objects this process owns now, whoever holds a ref (parity:
    `ray.internal.free`; multi-process runtime)."""
    if isinstance(refs, ObjectRef):
        refs = [refs]
    _ws.get_runtime().free(refs)


def put(value) -> ObjectRef:
    """Store a value in the object store (parity: `ray.put`)."""
    return _ws.get_runtime().put(value)


def get(refs, timeout: _Optional[float] = None):
    """Fetch object values (parity: `ray.get`). Accepts one ref or a
    list; a failed task's `TaskError` is raised here."""
    if isinstance(refs, list):
        bad = [r for r in refs if not isinstance(r, ObjectRef)]
        if bad:
            raise TypeError(
                f"ray_tpu_torch.get expects ObjectRefs, got {type(bad[0])}")
    elif not isinstance(refs, ObjectRef):
        raise TypeError(f"ray_tpu_torch.get expects an ObjectRef or a list "
                        f"of them, got {type(refs)}")
    return _ws.get_runtime().get(refs, timeout=timeout)


def wait(refs, num_returns: int = 1, timeout: _Optional[float] = None):
    """Return (ready, not_ready) (parity: `ray.wait`)."""
    if isinstance(refs, ObjectRef):
        refs = [refs]
    return _ws.get_runtime().wait(refs, num_returns=num_returns,
                                  timeout=timeout)


def kill(actor: ActorHandle, no_restart: bool = True):
    """Terminate an actor (parity: `ray.kill`); later calls on it raise
    `ActorDiedError`."""
    _ws.get_runtime().kill_actor(actor._actor_id, no_restart=no_restart)


def tasks(state: _Optional[str] = None, name: _Optional[str] = None,
          limit: int = 100):
    """Task records, newest first (parity: `ray_tpu.tasks`)."""
    return _ws.get_runtime().list_tasks(state=state, name=name, limit=limit)


def task_summary():
    """Per-state task counts grouped by name (parity:
    `ray_tpu.task_summary`)."""
    return _ws.get_runtime().task_summary()


def remote(*args, **kwargs):
    """The `@ray_tpu_torch.remote` decorator for functions and classes.

    Options: num_returns, num_cpus, num_gpus, resources, max_retries,
    name (functions); num_cpus, num_gpus, resources, max_restarts,
    max_concurrency, name (classes).
    """
    fn_opts = {"num_returns", "num_cpus", "num_gpus", "resources",
               "max_retries", "name"}
    cls_opts = {"num_cpus", "num_gpus", "resources", "max_restarts",
                "max_concurrency", "name"}

    def make(target):
        is_class = _inspect.isclass(target)
        unknown = set(kwargs) - (cls_opts if is_class else fn_opts)
        if unknown:
            raise TypeError(
                f"unknown @ray_tpu_torch.remote option(s) for a "
                f"{'class' if is_class else 'function'}: {sorted(unknown)}")
        if is_class:
            return ActorClass(
                target,
                num_cpus=kwargs.get("num_cpus"),
                num_gpus=kwargs.get("num_gpus"),
                resources=kwargs.get("resources"),
                max_restarts=kwargs.get("max_restarts", 0),
                max_concurrency=kwargs.get("max_concurrency"),
                name=kwargs.get("name"))
        return RemoteFunction(
            target,
            num_returns=kwargs.get("num_returns", 1),
            num_cpus=kwargs.get("num_cpus"),
            num_gpus=kwargs.get("num_gpus"),
            resources=kwargs.get("resources"),
            max_retries=kwargs.get("max_retries", 3),
            name=kwargs.get("name"))

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("@ray_tpu_torch.remote takes keyword options only")
    return make


__all__ = [
    "ActorClass", "ActorDiedError", "ActorHandle", "GetTimeoutError",
    "ObjectLostError", "ObjectRef", "RayError", "RemoteFunction",
    "TaskError", "WorkerCrashedError", "cluster_resources", "exceptions",
    "free", "get", "get_actor", "init", "is_initialized", "kill",
    "put", "remote", "resolve_device", "shutdown", "task_summary", "tasks",
    "wait",
]
