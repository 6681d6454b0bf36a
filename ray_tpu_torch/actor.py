"""Actor API: `@ray_tpu_torch.remote` classes.

The port's own copy of `ray_tpu/actor.py`, for both of the port's
runtimes: `ActorClass` with `.remote()` and `.options()`, `ActorMethod`,
`ActorHandle` and named actors (`get_actor`). The class is exported to
the runtime's function table: as the object itself in local mode, by
reference (plain pickle) on the multi-process runtime, where each actor
runs in a worker process of its own. Per-method return counts,
checkpoints and asyncio actors are not ported.
"""

from __future__ import annotations

from typing import Optional

from ._private import worker_state
from ._private.ids import ActorID


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        return self._handle._actor_method_call(self._name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._name}' cannot be called directly; use "
            f"'.{self._name}.remote()'.")


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._class_name = class_name

    def _actor_method_call(self, name, args, kwargs):
        rt = worker_state.get_runtime()
        return rt.submit_actor_task(self._actor_id, name, args, kwargs,
                                    name=self._class_name)[0]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:16]})"

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and \
            other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, num_cpus=None, num_gpus=None, resources=None,
                 max_restarts=0, max_concurrency=None, name=None):
        self._cls = cls
        self._class_name = cls.__name__
        # Actors hold 0 CPU while alive unless asked (reference
        # semantics); explicit num_cpus pins.
        self._resources = {}
        if num_cpus is not None:
            self._resources["CPU"] = float(num_cpus)
        if num_gpus:
            self._resources["GPU"] = float(num_gpus)
        if resources:
            self._resources.update(
                {k: float(v) for k, v in resources.items()})
        self._max_restarts = max_restarts
        self._max_concurrency = max_concurrency
        self._name = name or ""  # the default actor name
        self._key: Optional[str] = None
        self.__doc__ = getattr(cls, "__doc__", None)

    def _ensure_exported(self, rt):
        if self._key is None:
            self._key = f"cls:{self._class_name}:{id(self._cls):x}"
        rt.export_function(self._key, self._cls)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs)

    def _remote(self, args, kwargs, name="", max_concurrency=None,
                max_restarts=None, num_cpus=None, num_gpus=None,
                resources=None, env_vars=None) -> ActorHandle:
        rt = worker_state.get_runtime()
        self._ensure_exported(rt)
        res = dict(self._resources)
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        if num_gpus is not None:
            res["GPU"] = float(num_gpus)
        if resources:
            res.update({k: float(v) for k, v in resources.items()})
        actor_id = rt.create_actor(
            self._key, args, kwargs, resources=res,
            max_restarts=max_restarts if max_restarts is not None
            else self._max_restarts,
            max_concurrency=max_concurrency or self._max_concurrency or 1,
            name=name or self._name, env_vars=env_vars)
        return ActorHandle(actor_id, self._class_name)

    def options(self, name=None, max_concurrency=None, max_restarts=None,
                num_cpus=None, num_gpus=None, resources=None,
                env_vars=None):
        outer = self

        class _Options:
            def remote(self, *args, **kwargs):
                return outer._remote(
                    args, kwargs, name=name or "",
                    max_concurrency=max_concurrency,
                    max_restarts=max_restarts, num_cpus=num_cpus,
                    num_gpus=num_gpus, resources=resources,
                    env_vars=env_vars)

        return _Options()

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._class_name}' cannot be instantiated "
            f"directly; use '{self._class_name}.remote()'.")


def get_actor(name: str) -> ActorHandle:
    """Look up a named actor (reference: `ray.util.get_actor`)."""
    rt = worker_state.get_runtime()
    info = rt.get_named_actor(name)
    if info is None:
        raise ValueError(f"no live actor named {name!r}")
    return ActorHandle(info["actor_id"], class_name=name)
