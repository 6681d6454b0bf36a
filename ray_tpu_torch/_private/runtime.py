"""The runtime of the driver and of each worker process.

The port's own copy of `ray_tpu/_private/runtime.py`, trimmed to one
node and to what the multi-process path runs. One `Runtime` per process
(`role` "driver" or "worker"):

- objects: `put`, `get`/`_get_one`, `wait` and `free`. A value under
  `INLINE_OBJECT_MAX` lives in its owner's memory store as serialized
  bytes and travels inline over a socket (`_on_get_object`); a larger
  one is a sealed `/dev/shm` file that every process of the node maps.
  The process that submits a task OWNS its results: the worker writes
  a large result into the shared store and pushes a pointer
  (`_push_value`, `_on_push_result`).
- ownership (`_RefTracker`): every live `ObjectRef` counts; a borrower
  tells the owner when it starts and stops holding a ref (`add_borrow`,
  `remove_borrow`), and the owner frees an object once no process holds
  one. A task's by-reference arguments are pinned by their submitter
  until the task's result arrives; a ref pickled inside a value keeps
  its object for `EXPORT_GRACE_S` while the receiver registers.
- functions: `export_function`/`load_function` through the head's
  function table, by reference (plain pickle).
- tasks: `submit_task` through the head's scheduler; `create_actor`
  through the head, and `submit_actor_task` straight to the actor's
  worker, in per-caller order.
- execution (worker role): `_task_loop`, `_execute_one`,
  `_execute_actor_creation` and `_run_actor_task`.

Each process keeps the records of the tasks it submitted
(`list_tasks`, `task_summary`): submitted, then finished or failed when
the result arrives. The reference's transfer pool, reconstruction,
routed fetch, leases, chaos, profiler and metrics push are not copied.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set, Tuple

from ..exceptions import (ActorDiedError, GetTimeoutError, ObjectLostError,
                          ObjectStoreFullError, TaskError)
from . import object_ref as object_ref_mod
from . import object_store, protocol, serialization, task_events
from .ids import ActorID, ObjectID, TaskID
from .object_ref import ObjectRef
from .object_store import INLINE_OBJECT_MAX, MemoryStore, SharedObjectStore
from .task_spec import (ACTOR_CREATION_TASK, ACTOR_TASK, NORMAL_TASK,
                        ArgSpec, TaskSpec)

logger = logging.getLogger(__name__)

# How long an object whose ref was pickled inside a value outlives its
# last local ref, while the receiver deserializes it and registers its
# borrow (the reference's RAY_TPU_EVICTION_GRACE_S).
EXPORT_GRACE_S = 10.0


class _Cell:
    """Memory-store slot: serialized bytes, a decoded value, a pointer
    into the shared store, or an error."""

    __slots__ = ("kind", "payload")

    def __init__(self, kind: str, payload=None):
        self.kind = kind  # 'raw' | 'value' | 'shm' | 'error'
        self.payload = payload


def _cell_of(msg: dict) -> _Cell:
    if msg.get("error") is not None:
        return _Cell("error", msg["error"])
    if msg.get("in_shm"):
        return _Cell("shm")
    return _Cell("raw", msg["data"])


class _RefTracker:
    """This process's ObjectRef counts and its borrow notifications.

    `decref` runs from `ObjectRef.__del__`, so possibly inside garbage
    collection on any thread: it never sends or frees inline. Both
    directions go through one queue, served in order by one thread, so a
    borrower's `add_borrow` and `remove_borrow` for an object reach the
    owner in the order the refs came and went.
    """

    def __init__(self, runtime: "Runtime"):
        self._rt = runtime
        self._counts: Dict[ObjectID, int] = {}
        self._lock = threading.RLock()
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._notify_loop, daemon=True, name="borrow-notify")
        self._thread.start()

    def incref(self, oid: ObjectID, owner_addr: str):
        with self._lock:
            n = self._counts.get(oid, 0) + 1
            self._counts[oid] = n
        if n == 1 and owner_addr and owner_addr != self._rt.addr:
            self._q.put(("add_borrow", owner_addr, oid))

    def decref(self, oid: ObjectID, owner_addr: str):
        with self._lock:
            n = self._counts.get(oid, 1) - 1
            if n <= 0:
                self._counts.pop(oid, None)
            else:
                self._counts[oid] = n
        if n <= 0:
            self._q.put(("release", owner_addr, oid))

    def count(self, oid: ObjectID) -> int:
        with self._lock:
            return self._counts.get(oid, 0)

    def note_export(self, oid: ObjectID, owner_addr: str):
        """A ref is being pickled inside a value: its owner keeps the
        object for the export grace."""
        if not owner_addr or owner_addr == self._rt.addr:
            self._rt._note_export(oid)
        else:
            self._q.put(("note_export", owner_addr, oid))

    def flush(self):
        """Block until every queued notification has been delivered (a
        worker calls it before pushing a result, so the owner hears of
        the worker's borrows before it releases the task's pins)."""
        self._q.join()

    def stop(self, timeout: float = 2.0):
        self._q.put(None)
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)

    def _notify_loop(self):
        while True:
            try:
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                self._rt._sweep_exported()
                continue
            try:
                if item is None:
                    return
                kind, owner, oid = item
                if kind == "release":
                    self._rt._on_last_ref(oid, owner)
                else:
                    try:
                        self._rt._get_conn(owner).send(
                            {"kind": kind, "object_id": oid})
                    except (protocol.ConnectionClosed, OSError):
                        pass  # the owner is gone, and its objects too
            except Exception:  # noqa: BLE001 — keep the thread alive
                logger.exception("borrow notification failed")
            finally:
                self._q.task_done()


class ActorState:
    def __init__(self, spec: TaskSpec, instance):
        self.spec = spec
        self.instance = instance
        self.streams: Dict[str, dict] = {}  # caller addr -> next/buffer
        self.lock = threading.Lock()
        self.executor = ThreadPoolExecutor(
            max_workers=max(1, spec.max_concurrency),
            thread_name_prefix="actor-exec")

    def stop(self):
        self.executor.shutdown(wait=False)


class Runtime:
    """One per process. `role` is "driver" or "worker"."""

    def __init__(self, session_dir: str, session_name: str, head_sock: str,
                 role: str):
        self.role = role
        self.session_dir = session_dir
        self.session_name = session_name
        # Abstract-namespace socket: no path to outgrow AF_UNIX's limit,
        # nothing to unlink.
        self.addr = (f"\0ray_tpu_torch/{session_name}/"
                     f"{role}-{os.getpid()}-{os.urandom(3).hex()}")
        self.memory = MemoryStore()
        self.shm = SharedObjectStore(session_name)
        self.store_capacity = object_store.store_capacity()

        # Owner state: objects this process owns (oid -> blob bytes),
        # which of them are shared-store files, registered borrows per
        # peer, and export times of refs pickled inside values.
        self._owned: Dict[ObjectID, int] = {}
        self._owned_shm: Set[ObjectID] = set()
        self._borrows: Dict[ObjectID, Dict[str, int]] = {}
        self._exported_at: Dict[ObjectID, float] = {}
        self._owned_lock = threading.RLock()
        # Tasks this process submitted whose results have not all
        # arrived (task id -> returns outstanding), and the by-reference
        # arguments pinned for them.
        self._inflight_tasks: Dict[TaskID, int] = {}
        self._task_arg_pins: Dict[TaskID, list] = {}
        self._task_log = task_events.TaskStateLog()
        self.ref_tracker = _RefTracker(self)

        self._conns: Dict[str, protocol.Connection] = {}
        self._conns_lock = threading.Lock()
        self._fn_cache: Dict[str, object] = {}
        self._exported: Set[str] = set()
        self._export_lock = threading.Lock()

        # Actor-client state.
        self._actor_cache: Dict[ActorID, dict] = {}
        self._actor_events: Dict[ActorID, threading.Event] = {}
        self._actor_seqs: Dict[Tuple[ActorID, str], int] = {}
        self._seq_lock = threading.Lock()
        self._pending_to_addr: Dict[str, Dict[TaskID, TaskSpec]] = {}
        self._pending_lock = threading.Lock()
        self._actor_creation_tasks: Dict[ActorID, TaskID] = {}

        # Borrowers that asked for an object before its result arrived.
        self._object_waiters: Dict[ObjectID, Set[str]] = {}
        self._waiters_lock = threading.Lock()
        self._requested: Set[ObjectID] = set()

        # Worker-side execution state.
        self._task_queue: "queue.Queue[TaskSpec]" = queue.Queue()
        self._task_thread: Optional[threading.Thread] = None
        self._actor: Optional[ActorState] = None
        self._pre_actor_tasks: List[TaskSpec] = []
        self._pre_actor_lock = threading.Lock()
        self._shutdown_event = threading.Event()

        # The tracker is live before the first message can arrive: a ref
        # unpickled with no tracker would never be counted.
        object_ref_mod.set_ref_tracker(self.ref_tracker)
        self.server = protocol.Server(self.addr, self._handle,
                                      on_close=self._on_peer_close)
        self.head = protocol.connect(
            head_sock, self.addr, self._handle,
            hello_extra={"role": role, "pid": os.getpid(),
                         "token": os.environ.get("RAY_TPU_WORKER_TOKEN",
                                                 "")},
            on_close=self._on_head_close)

    # ==================================================================
    # objects
    # ==================================================================
    def put(self, value) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() of an ObjectRef is not allowed")
        oid = ObjectID.generate()
        meta, buffers, total = serialization.serialize(value)
        self._store_owned(oid, meta, buffers, total)
        return ObjectRef(oid, self.addr, total)

    def _store_owned(self, oid: ObjectID, meta, buffers, total: int):
        if total <= INLINE_OBJECT_MAX:
            out = bytearray(total)
            serialization.write_blob(memoryview(out), meta, buffers)
            cell = _Cell("raw", bytes(out))
        else:
            self._make_room(total)
            self.shm.create_and_seal(oid, meta, buffers, total)
            cell = _Cell("shm")
        with self._owned_lock:
            self._owned[oid] = total
            if cell.kind == "shm":
                self._owned_shm.add(oid)
        self.memory.put(oid, cell)

    def _make_room(self, incoming: int):
        """Refuse a shared-store object that does not fit beside the
        node's live objects. Unreferenced objects are freed as their last
        ref goes, so there is nothing to evict here."""
        used = self.shm.used_bytes()
        if used + incoming > self.store_capacity:
            raise ObjectStoreFullError(
                f"object store over capacity: {incoming} bytes do not fit "
                f"beside {used} bytes of live objects (capacity "
                f"{self.store_capacity} bytes, {object_store.STORE_FRACTION}"
                f" of {object_store.shm_size()} bytes in "
                f"{object_store.SHM_DIR}; set RAY_TPU_SHM_DIR for a larger "
                "filesystem)")

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        values = [self._get_one(r, deadline) for r in refs]
        return values[0] if single else values

    def _remaining(self, deadline) -> Optional[float]:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise GetTimeoutError("ray_tpu_torch.get timed out")
        return rem

    def _decode_cell(self, oid: ObjectID, cell: _Cell):
        if cell.kind == "error":
            raise cell.payload
        if cell.kind == "value":
            return cell.payload
        if cell.kind == "raw":
            value = serialization.loads(cell.payload, zero_copy=False)
        else:
            entry = self.shm.get(oid)
            if entry is None:
                raise ObjectLostError(
                    f"object {oid.hex()[:16]} is missing from the store")
            value = entry.value
        self.memory.put(oid, _Cell("value", value))
        return value

    def _owns(self, ref: ObjectRef) -> bool:
        return not ref.owner_addr or ref.owner_addr == self.addr

    def _get_one(self, ref: ObjectRef, deadline):
        oid = ref.id
        owner_is_self = self._owns(ref)
        requested = False
        while True:
            entry = self.memory.get_if_exists(oid)
            if entry is not None:
                return self._decode_cell(oid, entry.value)
            if not owner_is_self:
                # A large object is its owner's sealed file on this node.
                shm_entry = self.shm.get(oid)
                if shm_entry is not None:
                    self.memory.put(oid, _Cell("value", shm_entry.value))
                    return shm_entry.value
                if not requested:
                    self._request_from_owner(
                        ref, self._rpc_timeout(deadline))
                    requested = True
                    continue
            # A result lands in the store before its task stops counting
            # as in flight: neither means it is gone.
            elif not self._object_still_expected(oid) \
                    and not self.memory.contains(oid):
                raise ObjectLostError(
                    f"object {oid.hex()[:16]} is not in the store and no "
                    "task is producing it (it was freed)")
            rem = self._remaining(deadline)
            step = 5.0 if rem is None else min(rem, 5.0)
            if self.memory.wait_threshold(
                    [oid], 1, step,
                    extra_ready=None if owner_is_self
                    else self.shm.contains):
                continue
            requested = False  # re-ask the owner: errors out a dead one

    @staticmethod
    def _rpc_timeout(deadline) -> float:
        if deadline is None:
            return 60.0
        return max(0.05, min(60.0, deadline - time.monotonic()))

    def _object_still_expected(self, oid: ObjectID) -> bool:
        with self._owned_lock:
            return oid.task_id() in self._inflight_tasks

    def _request_from_owner(self, ref: ObjectRef, timeout: float = 60.0):
        """Ask the owner for a foreign object; the answer (or a promise to
        push it) lands in the memory store."""
        oid = ref.id
        with self._waiters_lock:
            self._requested.add(oid)
        try:
            reply = self._get_conn(ref.owner_addr).request(
                {"kind": "get_object", "object_id": oid}, timeout=timeout)
        except (protocol.ConnectionClosed, OSError, TimeoutError) as e:
            self.memory.put(oid, _Cell("error", ObjectLostError(
                f"owner of object {oid.hex()[:16]} is unreachable: {e}")))
            return
        status = reply["status"]
        if status == "inline":
            self.memory.put(oid, _Cell("raw", reply["data"]))
        elif status == "shm":
            self.memory.put(oid, _Cell("shm"))
        elif status == "error":
            self.memory.put(oid, _Cell("error", reply["value_error"]))
        elif status == "lost":
            self.memory.put(oid, _Cell("error", ObjectLostError(
                f"object {oid.hex()[:16]} was freed by its owner")))
        # "pending": the owner pushes the result when it arrives.

    def _on_get_object(self, conn: protocol.Connection, msg: dict):
        oid: ObjectID = msg["object_id"]
        with self._waiters_lock:
            entry = self.memory.get_if_exists(oid)
            if entry is None and self._object_still_expected(oid):
                self._object_waiters.setdefault(oid, set()).add(
                    conn.peer_addr)
                pending = True
            else:
                pending = False
        if pending:
            conn.reply(msg, status="pending")
            return
        with self._owned_lock:
            in_shm = oid in self._owned_shm
        if in_shm and self.shm.contains(oid):
            conn.reply(msg, status="shm")
        elif entry is None or entry.value.kind == "shm":
            conn.reply(msg, status="lost")
        elif entry.value.kind == "raw":
            conn.reply(msg, status="inline", data=entry.value.payload)
        elif entry.value.kind == "error":
            conn.reply(msg, status="error", value_error=entry.value.payload)
        else:
            conn.reply(msg, status="inline",
                       data=serialization.dumps(entry.value.payload))

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[list, list]:
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds the number of refs")
        for r in refs:
            if not self._owns(r) and not self.memory.contains(r.id) \
                    and r.id not in self._requested \
                    and not self.shm.contains(r.id):
                self._request_from_owner(r)
        ready_ids = set(self.memory.wait_threshold(
            [r.id for r in refs], num_returns, timeout,
            extra_ready=self.shm.contains))
        ready, not_ready = [], []
        for r in refs:
            if r.id in ready_ids and len(ready) < num_returns:
                ready.append(r)
            else:
                not_ready.append(r)
        return ready, not_ready

    def free(self, refs: List[ObjectRef]):
        """Free owned objects now, whoever still holds a ref (parity:
        `ray.internal.free`)."""
        for r in refs:
            self._free_now(r.id)

    # -- ownership -------------------------------------------------------
    def _note_export(self, oid: ObjectID):
        # Also for a result still on its way: it is kept when it lands.
        with self._owned_lock:
            self._exported_at[oid] = time.monotonic()

    def _on_last_ref(self, oid: ObjectID, owner_addr: str):
        """The tracker's queue: this process's last ref to `oid` went."""
        if not owner_addr or owner_addr == self.addr:
            self._try_free(oid)
            return
        if self.ref_tracker.count(oid) == 0:
            # Drop the cached copy; a value that aliases the mapped file
            # keeps the mapping alive by itself.
            self.memory.delete(oid)
            self.shm.release(oid)
            with self._waiters_lock:
                self._requested.discard(oid)
        try:
            self._get_conn(owner_addr).send(
                {"kind": "remove_borrow", "object_id": oid})
        except (protocol.ConnectionClosed, OSError):
            pass

    def _try_free(self, oid: ObjectID):
        with self._owned_lock:
            if oid not in self._owned or self.ref_tracker.count(oid) > 0 \
                    or self._borrows.get(oid):
                return
            exported = self._exported_at.get(oid)
            if exported is not None and \
                    time.monotonic() - exported < EXPORT_GRACE_S:
                return  # `_sweep_exported` frees it later
        self._free_now(oid)

    def _free_now(self, oid: ObjectID):
        with self._owned_lock:
            self._owned.pop(oid, None)
            in_shm = oid in self._owned_shm
            self._owned_shm.discard(oid)
            self._exported_at.pop(oid, None)
            self._borrows.pop(oid, None)
        self.memory.delete(oid)
        if in_shm:
            self.shm.delete(oid)

    def _sweep_exported(self):
        now = time.monotonic()
        with self._owned_lock:
            due = [oid for oid, t in self._exported_at.items()
                   if now - t >= EXPORT_GRACE_S]
            for oid in due:
                del self._exported_at[oid]
        for oid in due:
            self._try_free(oid)

    def owned_bytes(self) -> Tuple[int, int]:
        """(objects owned here, their bytes)."""
        with self._owned_lock:
            return len(self._owned), sum(self._owned.values())

    # ==================================================================
    # functions
    # ==================================================================
    def export_function(self, key: str, target) -> None:
        with self._export_lock:
            if key in self._exported:
                return
        data = serialization._dumps(target)  # fails here for a lambda
        with self._export_lock:
            self._exported.add(key)
        # Ordered ahead of any submit on the same head connection.
        self.head.send({"kind": "kv_put", "key": key, "value": data})

    def load_function(self, key: str):
        fn = self._fn_cache.get(key)
        if fn is not None:
            return fn
        deadline = time.monotonic() + 15.0
        delay = 0.01
        while True:
            reply = self.head.request({"kind": "kv_get", "key": key},
                                      timeout=30)
            if reply["value"] is not None:
                fn = pickle.loads(reply["value"])
                self._fn_cache[key] = fn
                return fn
            if time.monotonic() > deadline:
                raise KeyError(f"function {key} not found on the head")
            time.sleep(delay)
            delay = min(0.5, delay * 2)

    # ==================================================================
    # task submission
    # ==================================================================
    def _prepare_args(self, args, kwargs
                      ) -> Tuple[List[ArgSpec], Dict[str, ArgSpec]]:
        def one(v) -> ArgSpec:
            if isinstance(v, ObjectRef):
                return ArgSpec(ref=v)
            meta, buffers, total = serialization.serialize(v)
            if total > INLINE_OBJECT_MAX:
                # A large argument goes through the shared store.
                oid = ObjectID.generate()
                self._store_owned(oid, meta, buffers, total)
                return ArgSpec(ref=ObjectRef(oid, self.addr, total))
            out = bytearray(total)
            serialization.write_blob(memoryview(out), meta, buffers)
            return ArgSpec(data=bytes(out))
        return [one(a) for a in args], {k: one(v) for k, v in kwargs.items()}

    def _pin_task_args(self, spec: TaskSpec):
        pinned = []
        for arg in list(spec.args) + list(spec.kwargs.values()):
            if arg.ref is not None:
                self.ref_tracker.incref(arg.ref.id, arg.ref.owner_addr)
                pinned.append((arg.ref.id, arg.ref.owner_addr))
        if pinned:
            with self._pending_lock:
                self._task_arg_pins[spec.task_id] = pinned

    def _unpin_task_args(self, task_id: TaskID):
        with self._pending_lock:
            pinned = self._task_arg_pins.pop(task_id, ())
        for oid, owner in pinned:
            self.ref_tracker.decref(oid, owner)

    def _note_submitted(self, spec: TaskSpec, kind: str):
        self._pin_task_args(spec)
        if spec.num_returns:
            with self._owned_lock:
                self._inflight_tasks[spec.task_id] = spec.num_returns
        self._task_log.apply({
            "task_id": spec.task_id.hex(), "state": task_events.SUBMITTED,
            "ts": time.time(), "name": spec.describe(), "kind": kind,
            "node": "node0", "caller": self.addr})

    def _record_task_end(self, task_id: TaskID, error, pid):
        self._task_log.apply({
            "task_id": task_id.hex(), "ts": time.time(), "pid": pid,
            "state": task_events.FAILED if error is not None
            else task_events.FINISHED,
            "error": str(error)[:300] if error is not None else None})

    def submit_task(self, function_key: str, args, kwargs, num_returns=1,
                    resources=None, max_retries=3, name="") -> List[ObjectRef]:
        a, kw = self._prepare_args(args, kwargs)
        spec = TaskSpec(
            task_id=TaskID.generate(), kind=NORMAL_TASK,
            function_key=function_key, args=a, kwargs=kw,
            num_returns=num_returns,
            resources=resources if resources is not None else {"CPU": 1.0},
            caller_addr=self.addr, max_retries=max_retries, name=name)
        self._note_submitted(spec, "task")
        refs = [ObjectRef(oid, self.addr) for oid in spec.return_ids()]
        self.head.send({"kind": "submit_task", "spec": spec})
        return refs

    def create_actor(self, class_key: str, args, kwargs, resources=None,
                     max_restarts=0, max_concurrency=1, name="",
                     env_vars=None) -> ActorID:
        a, kw = self._prepare_args(args, kwargs)
        actor_id = ActorID.generate()
        spec = TaskSpec(
            task_id=TaskID.generate(),
            kind=ACTOR_CREATION_TASK, function_key=class_key, args=a,
            kwargs=kw, num_returns=0,
            resources=resources if resources is not None else {},
            caller_addr=self.addr, actor_id=actor_id,
            max_restarts=max_restarts, max_concurrency=max_concurrency,
            name=name,
            env_vars={str(k): str(v) for k, v in (env_vars or {}).items()})
        # The constructor's arguments stay pinned until the actor is up.
        self._pin_task_args(spec)
        self._actor_creation_tasks[actor_id] = spec.task_id
        try:
            self.head.request({"kind": "create_actor", "spec": spec},
                              timeout=60)
        except BaseException:
            self._actor_creation_tasks.pop(actor_id, None)
            self._unpin_task_args(spec.task_id)
            raise
        return actor_id

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args,
                          kwargs, num_returns=1, name="") -> List[ObjectRef]:
        addr = self.resolve_actor(actor_id)
        a, kw = self._prepare_args(args, kwargs)
        # Per (actor incarnation, caller) sequence numbers: the actor runs
        # each caller's calls in submission order.
        with self._seq_lock:
            key = (actor_id, addr)
            seq = self._actor_seqs.get(key, 0)
            self._actor_seqs[key] = seq + 1
        spec = TaskSpec(
            task_id=TaskID.generate(), kind=ACTOR_TASK,
            method_name=method_name, args=a, kwargs=kw,
            num_returns=num_returns, caller_addr=self.addr,
            actor_id=actor_id, actor_seq=seq, name=name)
        self._note_submitted(spec, "actor_task")
        refs = [ObjectRef(oid, self.addr) for oid in spec.return_ids()]
        with self._pending_lock:
            self._pending_to_addr.setdefault(addr, {})[spec.task_id] = spec
        try:
            self._get_conn(addr).send({"kind": "push_task", "spec": spec})
        except (protocol.ConnectionClosed, OSError):
            self._fail_pending_for_addr(addr)
        return refs

    def resolve_actor(self, actor_id: ActorID,
                      timeout: Optional[float] = 120) -> str:
        """The actor's worker address, once it is up; raises
        `ActorDiedError` for a dead actor."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            info = self._actor_cache.get(actor_id)
            if info is None or info["state"] not in ("ALIVE", "DEAD"):
                ev = self._actor_events.setdefault(actor_id,
                                                   threading.Event())
                ev.clear()
                info = self.head.request(
                    {"kind": "resolve_actor", "actor_id": actor_id},
                    timeout=30)["info"]
                if info is not None:
                    self._actor_cache[actor_id] = info
            if info is not None and info["state"] == "ALIVE":
                return info["addr"]
            if info is not None and info["state"] == "DEAD":
                raise ActorDiedError(actor_id.hex(),
                                     info.get("death_reason", ""))
            rem = 1.0 if deadline is None \
                else min(1.0, deadline - time.monotonic())
            if rem <= 0:
                raise GetTimeoutError(
                    f"actor {actor_id.hex()[:16]} not up within {timeout} s")
            self._actor_events[actor_id].wait(rem)

    def kill_actor(self, actor_id: ActorID, no_restart=True):
        self.head.request({"kind": "kill_actor", "actor_id": actor_id,
                           "no_restart": no_restart}, timeout=30)

    def get_named_actor(self, name: str) -> Optional[dict]:
        return self.head.request({"kind": "get_named_actor", "name": name},
                                 timeout=30)["info"]

    def cluster_info(self) -> dict:
        return self.head.request({"kind": "cluster_info"},
                                 timeout=30)["info"]

    def list_tasks(self, state=None, name=None, limit=100) -> list:
        return self._task_log.list(state=state, name=name, limit=limit)

    def task_summary(self) -> dict:
        return self._task_log.summary()

    # ==================================================================
    # connections
    # ==================================================================
    def _get_conn(self, addr: str) -> protocol.Connection:
        inbound = self.server.connections.get(addr)
        if inbound is not None and not inbound.closed:
            return inbound
        with self._conns_lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
            conn = protocol.connect(addr, self.addr, self._handle,
                                    on_close=self._on_peer_close)
            self._conns[addr] = conn
            return conn

    def _on_peer_close(self, conn: protocol.Connection):
        addr = conn.peer_addr
        with self._conns_lock:
            if self._conns.get(addr) is conn:
                del self._conns[addr]
        # A dead peer holds no borrows.
        with self._owned_lock:
            released = [oid for oid, per in self._borrows.items()
                        if per.pop(addr, None) is not None and not per]
        for oid in released:
            self._try_free(oid)
        self._fail_pending_for_addr(addr)

    def _fail_pending_for_addr(self, addr: str):
        with self._pending_lock:
            pending = self._pending_to_addr.pop(addr, {})
        for aid, info in list(self._actor_cache.items()):
            if info.get("addr") == addr and info.get("state") == "ALIVE":
                self._actor_cache.pop(aid, None)
        for spec in pending.values():
            err = ActorDiedError(
                spec.actor_id.hex() if spec.actor_id else "",
                f"connection to the actor lost while {spec.describe()} "
                "was in flight")
            for oid in spec.return_ids():
                self._on_push_result({"object_id": oid, "error": err})

    def _on_head_close(self, conn):
        if self.role == "worker" and not self._shutdown_event.is_set():
            os._exit(0)  # the driver (and its head) is gone

    # ==================================================================
    # message handling
    # ==================================================================
    def _handle(self, conn: protocol.Connection, msg: dict):
        kind = msg["kind"]
        if kind == "push_result":
            self._on_push_result(msg)
        elif kind == "get_object":
            self._on_get_object(conn, msg)
        elif kind == "execute_task":
            self._task_queue.put(msg["spec"])
        elif kind == "push_task":
            self._on_push_task(msg["spec"])
        elif kind == "task_finished":
            self._unpin_task_args(msg["task_id"])
            self._record_task_end(msg["task_id"], msg.get("error"),
                                  msg.get("pid"))
        elif kind == "add_borrow":
            with self._owned_lock:
                per = self._borrows.setdefault(msg["object_id"], {})
                per[conn.peer_addr] = per.get(conn.peer_addr, 0) + 1
        elif kind == "remove_borrow":
            oid = msg["object_id"]
            with self._owned_lock:
                per = self._borrows.get(oid)
                if per is not None:
                    n = per.get(conn.peer_addr, 0) - 1
                    if n <= 0:
                        per.pop(conn.peer_addr, None)
                    else:
                        per[conn.peer_addr] = n
                    if not per:
                        del self._borrows[oid]
            self._try_free(oid)
        elif kind == "note_export":
            self._note_export(msg["object_id"])
        elif kind == "publish":
            self._on_publish(msg)
        elif kind == "shutdown":
            self._shutdown_event.set()
            os._exit(0)
        else:
            logger.warning("runtime: unknown message %s", kind)

    def _on_push_result(self, msg: dict):
        oid: ObjectID = msg["object_id"]
        tid = oid.task_id()
        with self._owned_lock:
            mine = tid in self._inflight_tasks
        if not mine:
            # A borrowed object's value forwarded by its owner (or a
            # duplicate): cache it while a ref here wants it.
            with self._waiters_lock:
                self._requested.discard(oid)
            if self.ref_tracker.count(oid) > 0 \
                    and not self.memory.contains(oid):
                self.memory.put(oid, _cell_of(msg))
            return
        cell = _cell_of(msg)
        with self._owned_lock:
            self._owned[oid] = msg.get("size", 0)
            if cell.kind == "shm":
                self._owned_shm.add(oid)
        # The value lands before the task stops counting as in flight, so
        # `_on_get_object` sees one or the other.
        with self._waiters_lock:
            self.memory.put(oid, cell)
            waiters = self._object_waiters.pop(oid, ())
        with self._owned_lock:
            left = self._inflight_tasks.get(tid, 1)
            if left <= 1:
                self._inflight_tasks.pop(tid, None)
            else:
                self._inflight_tasks[tid] = left - 1
        with self._pending_lock:
            for pend in self._pending_to_addr.values():
                pend.pop(tid, None)
        self._unpin_task_args(tid)
        if msg.get("first", True):
            self._record_task_end(tid, msg.get("error"), msg.get("pid"))
        for addr in waiters:
            try:
                self._get_conn(addr).send(msg)
            except (protocol.ConnectionClosed, OSError):
                pass
        if self.ref_tracker.count(oid) == 0:
            self._try_free(oid)  # nobody kept the ref

    def _on_publish(self, msg: dict):
        channel = msg["channel"]
        if not channel.startswith("actor:"):
            return
        info = msg["data"]
        aid = info["actor_id"]
        self._actor_cache[aid] = info
        if info["state"] in ("ALIVE", "DEAD"):
            tid = self._actor_creation_tasks.pop(aid, None)
            if tid is not None:
                self._unpin_task_args(tid)
        if info["state"] in ("RESTARTING", "DEAD"):
            self._fail_inflight_actor_calls(aid, info)
        ev = self._actor_events.get(aid)
        if ev is not None:
            ev.set()

    def _fail_inflight_actor_calls(self, aid: ActorID, info: dict):
        specs = []
        with self._pending_lock:
            for pend in self._pending_to_addr.values():
                for tid, spec in list(pend.items()):
                    if spec.actor_id == aid:
                        del pend[tid]
                        specs.append(spec)
        err = ActorDiedError(aid.hex(), info.get("death_reason", "")
                             or "the actor died with calls in flight")
        for spec in specs:
            for oid in spec.return_ids():
                self._on_push_result({"object_id": oid, "error": err})

    # ==================================================================
    # execution (worker role)
    # ==================================================================
    def _task_loop(self):
        while not self._shutdown_event.is_set():
            try:
                spec = self._task_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if spec.kind == ACTOR_CREATION_TASK:
                self._execute_actor_creation(spec)
            else:
                self._execute_normal(spec)
            del spec  # its argument refs: the borrows end with the task

    def _resolve_args(self, spec: TaskSpec):
        def one(a: ArgSpec):
            if a.ref is not None:
                return self._get_one(a.ref, None)
            return serialization.loads(a.data, zero_copy=False)
        return ([one(a) for a in spec.args],
                {k: one(v) for k, v in spec.kwargs.items()})

    def _push_value(self, addr: str, oid: ObjectID, value=None, error=None,
                    first: bool = True):
        msg = {"kind": "push_result", "object_id": oid, "pid": os.getpid(),
               "first": first}
        if error is None:
            try:
                meta, buffers, total = serialization.serialize(value)
                if total > INLINE_OBJECT_MAX:
                    self._make_room(total)
                    self.shm.create_and_seal(oid, meta, buffers, total)
                    msg["in_shm"] = True
                else:
                    out = bytearray(total)
                    serialization.write_blob(memoryview(out), meta, buffers)
                    msg["data"] = bytes(out)
                msg["size"] = total
            except Exception as e:  # noqa: BLE001 — the caller's error
                error = TaskError.from_exception(e, "storing the result")
        if error is not None:
            try:
                pickle.dumps(error)
            except Exception:  # noqa: BLE001 — an unpicklable exception
                error = TaskError(None, getattr(error, "remote_tb", ""),
                                  getattr(error, "task_desc", str(error)))
            msg["error"] = error
        # The owner hears of this process's borrows before the result
        # releases the task's argument pins.
        self.ref_tracker.flush()
        if addr == self.addr:
            self._on_push_result(msg)
            return
        try:
            self._get_conn(addr).send(msg)
        except (protocol.ConnectionClosed, OSError):
            logger.warning("could not deliver result %s to its owner", oid)

    def _finish(self, spec: TaskSpec, result=None, error=None):
        """Deliver a task's results, or its error to every return."""
        if spec.num_returns == 0:
            if spec.kind != ACTOR_CREATION_TASK:
                self.ref_tracker.flush()
                try:
                    self._get_conn(spec.caller_addr).send(
                        {"kind": "task_finished", "task_id": spec.task_id,
                         "error": error, "pid": os.getpid()})
                except (protocol.ConnectionClosed, OSError):
                    pass
            return
        if error is None and spec.num_returns > 1:
            values = list(result)
            if len(values) != spec.num_returns:
                error = TaskError(ValueError(
                    f"task declared num_returns={spec.num_returns} but "
                    f"returned {len(values)} values"), "", spec.describe())
        else:
            values = [result]
        for i, oid in enumerate(spec.return_ids()):
            if error is not None:
                self._push_value(spec.caller_addr, oid, error=error,
                                 first=i == 0)
            else:
                self._push_value(spec.caller_addr, oid, value=values[i],
                                 first=i == 0)

    def _execute_one(self, spec: TaskSpec, fn) -> None:
        try:
            args, kwargs = self._resolve_args(spec)
            result = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — the caller's error
            err = e if isinstance(e, TaskError) else \
                TaskError.from_exception(e, spec.describe())
            self._finish(spec, error=err)
            return
        self._finish(spec, result=result)

    def _execute_normal(self, spec: TaskSpec):
        try:
            fn = self.load_function(spec.function_key)
        except Exception as e:  # noqa: BLE001 — the caller's error
            self._finish(spec, error=TaskError.from_exception(
                e, "loading the function"))
        else:
            self._execute_one(spec, fn)
        try:
            self.head.send({"kind": "task_done", "task_id": spec.task_id})
        except protocol.ConnectionClosed:
            pass

    def _execute_actor_creation(self, spec: TaskSpec):
        try:
            cls = self.load_function(spec.function_key)
            args, kwargs = self._resolve_args(spec)
            instance = cls(*args, **kwargs)
        except BaseException:  # noqa: BLE001 — the actor dies with it
            import traceback
            self.head.send({"kind": "actor_creation_failed",
                            "actor_id": spec.actor_id,
                            "error": traceback.format_exc()})
            time.sleep(0.2)
            os._exit(1)
        with self._pre_actor_lock:
            self._actor = ActorState(spec, instance)
            parked, self._pre_actor_tasks = self._pre_actor_tasks, []
        for s in parked:
            self._on_push_task(s)
        self.head.send({"kind": "actor_ready", "actor_id": spec.actor_id,
                        "addr": self.addr})

    def _on_push_task(self, spec: TaskSpec):
        actor = self._actor
        if actor is None:
            # The constructor is still running: park the call.
            with self._pre_actor_lock:
                if self._actor is None:
                    self._pre_actor_tasks.append(spec)
                    return
            actor = self._actor
        with actor.lock:
            stream = actor.streams.setdefault(
                spec.caller_addr, {"next": 0, "buffer": {}})
            stream["buffer"][spec.actor_seq] = spec
            runnable = []
            while stream["next"] in stream["buffer"]:
                runnable.append(stream["buffer"].pop(stream["next"]))
                stream["next"] += 1
        for s in runnable:
            actor.executor.submit(self._run_actor_task, actor, s)

    def _run_actor_task(self, actor: ActorState, spec: TaskSpec):
        try:
            method = getattr(actor.instance, spec.method_name)
        except AttributeError as e:
            self._finish(spec, error=TaskError.from_exception(
                e, spec.describe()))
            return
        self._execute_one(spec, method)

    # ==================================================================
    def start_task_loop(self):
        self._task_thread = threading.Thread(
            target=self._task_loop, daemon=True, name="task-exec")
        self._task_thread.start()

    def run_worker_loop(self):
        """Block until shutdown (worker main)."""
        self._shutdown_event.wait()

    def shutdown(self):
        self._shutdown_event.set()
        if object_ref_mod._tracker is self.ref_tracker:
            object_ref_mod.set_ref_tracker(None)
        self.ref_tracker.stop()
        if self._actor is not None:
            self._actor.stop()
        try:
            self.head.close()
        except Exception:  # noqa: BLE001
            pass
        self.server.close()
        with self._conns_lock:
            conns = list(self._conns.values())
        for c in conns:
            c.close()
        if self._task_thread is not None \
                and self._task_thread is not threading.current_thread():
            self._task_thread.join(timeout=2.0)
        self.memory.clear()
