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

The runtime API (`init`, `remote`, `get`, `put`, `wait`, `kill`) runs
in local mode only: tasks and actor calls run inline in the driver's
process (`_private/local_mode.py`). IMPALA's remote rollout workers run
on it, fed versioned weight syncs:

    import ray_tpu_torch
    ray_tpu_torch.init(local_mode=True)
    trainer = IMPALATrainer(config={"env": "SyntheticAtari-v0",
                                    "num_workers": 2})
    trainer.train()
    ray_tpu_torch.shutdown()
"""

from __future__ import annotations

import inspect as _inspect
from typing import Optional as _Optional

from . import exceptions
from ._private import worker_state as _ws
from ._private.object_ref import ObjectRef
from .actor import ActorClass, ActorHandle, get_actor
from .device import resolve_device  # noqa: F401
from .exceptions import (ActorDiedError, GetTimeoutError, RayError,
                         TaskError)
from .remote_function import RemoteFunction

__version__ = "0.1.0"


def init(num_cpus: _Optional[float] = None,
         num_gpus: _Optional[float] = None,
         resources: _Optional[dict] = None,
         local_mode: bool = False):
    """Start the runtime (parity: `ray_tpu.init`). Only local mode is
    ported: every task and actor call runs inline in this process."""
    if not local_mode:
        raise NotImplementedError(
            "ray_tpu_torch.init() runs in local mode only "
            "(init(local_mode=True)); the multi-process runtime is "
            "ROADMAP Queue A item A6b")
    if _ws.get_runtime_or_none() is not None:
        raise RuntimeError("ray_tpu_torch.init() called twice; call "
                           "ray_tpu_torch.shutdown() first")
    from ._private.local_mode import LocalRuntime
    rt = LocalRuntime()
    _ws.set_runtime(rt, _ws.LOCAL_MODE)
    return rt


def shutdown():
    """Stop the runtime: its objects, actors and task records go."""
    rt = _ws.get_runtime_or_none()
    if rt is not None:
        rt.shutdown()
    _ws.clear()


def is_initialized() -> bool:
    return _ws.get_runtime_or_none() is not None


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

    Options: num_returns, num_cpus, num_gpus, resources, max_retries
    (functions); num_cpus, num_gpus, resources, max_restarts,
    max_concurrency (classes).
    """
    fn_opts = {"num_returns", "num_cpus", "num_gpus", "resources",
               "max_retries"}
    cls_opts = {"num_cpus", "num_gpus", "resources", "max_restarts",
                "max_concurrency"}

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
                max_concurrency=kwargs.get("max_concurrency"))
        return RemoteFunction(
            target,
            num_returns=kwargs.get("num_returns", 1),
            num_cpus=kwargs.get("num_cpus"),
            num_gpus=kwargs.get("num_gpus"),
            resources=kwargs.get("resources"),
            max_retries=kwargs.get("max_retries", 3))

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("@ray_tpu_torch.remote takes keyword options only")
    return make


__all__ = [
    "ActorClass", "ActorDiedError", "ActorHandle", "GetTimeoutError",
    "ObjectRef", "RayError", "RemoteFunction", "TaskError", "exceptions",
    "get", "get_actor", "init", "is_initialized", "kill",
    "put", "remote", "resolve_device", "shutdown", "task_summary", "tasks",
    "wait",
]
