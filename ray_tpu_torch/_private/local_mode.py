"""Local-mode runtime: runs every task and actor call inline, in the
driver's process.

The port's own copy of `ray_tpu/_private/local_mode.py` (parity:
`ray.init(local_mode=True)`). The reference exports each function and
class as cloudpickle bytes and loads them back; the port keeps the
objects themselves and pickles nothing, so it needs no `cloudpickle`.
Task arguments and results are passed by reference, as the reference's
local mode passes them. A call runs to its end inside `.remote()`, so
every ref is ready when it is returned. A value lives until its one
`ObjectRef` is collected or `shutdown`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from ..exceptions import ActorDiedError, TaskError
from . import object_ref, task_events
from .ids import ActorID, ObjectID, TaskID
from .object_ref import ObjectRef

logger = logging.getLogger(__name__)


class LocalRuntime:
    def __init__(self):
        self._objects: Dict[ObjectID, object] = {}
        self._errors: Dict[ObjectID, BaseException] = {}
        self._functions: Dict[str, object] = {}
        self._actors: Dict[ActorID, object] = {}
        self._named_actors: Dict[str, ActorID] = {}
        self._task_log = task_events.TaskStateLog()
        object_ref.set_release_hook(self._release)

    # -- task state API (one terminal record per call) -------------------
    def _record_task(self, name: str, kind: str, error):
        state = task_events.FAILED if error is not None \
            else task_events.FINISHED
        self._task_log.apply({
            "task_id": TaskID.generate().hex(), "state": state,
            "ts": time.time(), "name": name, "kind": kind,
            "node": "local", "pid": os.getpid(),
            "error": str(error)[:300] if error is not None else None})

    def list_tasks(self, state=None, name=None, limit=100) -> list:
        return self._task_log.list(state=state, name=name, limit=limit)

    def task_summary(self) -> dict:
        return self._task_log.summary()

    # -- objects ---------------------------------------------------------
    def put(self, value) -> ObjectRef:
        oid = ObjectID.generate()
        self._objects[oid] = value
        return ObjectRef(oid)

    def get(self, refs, timeout=None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        out = []
        for r in refs:
            if r.id in self._errors:
                raise self._errors[r.id]
            out.append(self._objects[r.id])
        return out[0] if single else out

    def wait(self, refs, num_returns=1, timeout=None) -> Tuple[list, list]:
        # Every call has run by the time its ref exists.
        return refs[:num_returns], refs[num_returns:]

    def free(self, refs) -> None:
        for r in refs:
            self._release(r.id)

    def _release(self, oid: ObjectID) -> None:
        self._objects.pop(oid, None)
        self._errors.pop(oid, None)

    # -- functions -------------------------------------------------------
    def export_function(self, key: str, target) -> None:
        self._functions.setdefault(key, target)

    def _resolve(self, args, kwargs):
        def one(v):
            return self.get(v) if isinstance(v, ObjectRef) else v
        return [one(a) for a in args], {k: one(v) for k, v in kwargs.items()}

    def _store_result(self, task_id: TaskID, num_returns: int, result,
                      error: Optional[BaseException]) -> List[ObjectRef]:
        refs = [ObjectRef(task_id.object_id(i))
                for i in range(num_returns)]
        if error is not None:
            for r in refs:
                self._errors[r.id] = error
            return refs
        values = [result] if num_returns == 1 else list(result)
        for r, v in zip(refs, values):
            self._objects[r.id] = v
        return refs

    # -- tasks -----------------------------------------------------------
    def submit_task(self, function_key, args, kwargs, num_returns=1,
                    resources=None, max_retries=0, name="") -> List[ObjectRef]:
        fn = self._functions[function_key]
        a, kw = self._resolve(args, kwargs)
        try:
            result, error = fn(*a, **kw), None
        except Exception as e:  # noqa: BLE001 — re-raised by get()
            result, error = None, TaskError.from_exception(
                e, name or function_key)
        self._record_task(name or function_key, "task", error)
        return self._store_result(TaskID.generate(), num_returns, result,
                                  error)

    # -- actors ----------------------------------------------------------
    def create_actor(self, class_key, args, kwargs, resources=None,
                     max_restarts=0, max_concurrency=1, name="",
                     env_vars=None) -> ActorID:
        if env_vars:
            logger.warning(
                "local_mode ignores env_vars=%s (no worker process is "
                "spawned); behavior may differ from cluster mode",
                sorted(env_vars))
        cls = self._functions[class_key]
        a, kw = self._resolve(args, kwargs)
        actor_id = ActorID.generate()
        self._actors[actor_id] = cls(*a, **kw)
        if name:
            self._named_actors[name] = actor_id
        return actor_id

    def submit_actor_task(self, actor_id, method_name, args, kwargs,
                          name="") -> List[ObjectRef]:
        inst = self._actors.get(actor_id)
        if inst is None:
            raise ActorDiedError(actor_id.hex(), "actor killed (local mode)")
        a, kw = self._resolve(args, kwargs)
        try:
            result, error = getattr(inst, method_name)(*a, **kw), None
        except Exception as e:  # noqa: BLE001 — re-raised by get()
            result, error = None, TaskError.from_exception(e, method_name)
        self._record_task(name or method_name, "actor_task", error)
        return self._store_result(TaskID.generate(), 1, result, error)

    def kill_actor(self, actor_id, no_restart=True):
        self._actors.pop(actor_id, None)

    def get_named_actor(self, name):
        actor_id = self._named_actors.get(name)
        if actor_id is None or actor_id not in self._actors:
            return None
        return {"actor_id": actor_id, "state": "ALIVE", "name": name}

    def shutdown(self):
        """Drop every object, error, exported function, actor and task
        record: nothing of this session outlives it."""
        object_ref.set_release_hook(None)
        self._objects.clear()
        self._errors.clear()
        self._functions.clear()
        self._actors.clear()
        self._named_actors.clear()
        self._task_log.clear()
