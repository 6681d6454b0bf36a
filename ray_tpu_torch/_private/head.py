"""Head server: the scheduler, the function table and the actor table.

The port's own copy of `ray_tpu/_private/head.py`, trimmed to one node.
It runs as threads in the driver's process and speaks `protocol.py`:

- `HeadServer` keeps the node's resources (`NodeInfo`), the spawned
  worker processes (`WorkerInfo`), the function table (`kv_put`/
  `kv_get`: a function or class pickled by reference), the actor table
  (`ActorInfo`) and the queue of tasks and actor creations waiting for
  resources.
- `_schedule_locked` places each queued task on an idle pool worker
  (starting one when the node's resources allow), and each actor
  creation on a dedicated worker process of its own.
  `_spawn_local_worker` starts a fresh interpreter with
  `subprocess.Popen` (never a fork: the driver may hold a CUDA context),
  running `python -m ray_tpu_torch._private.default_worker` with the
  driver's `sys.path`.
- `_monitor_loop` polls the worker processes; `_handle_worker_death`
  fails the task a dead pool worker was running with
  `WorkerCrashedError` (after its retries), and publishes a dead
  actor's worker as `DEAD` to every process that resolved the actor,
  whose calls then raise `ActorDiedError`.

The head shards, leases, node agents, metrics HTTP, profiling capture
and actor checkpoints of the reference are not copied.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set

from ..exceptions import WorkerCrashedError
from . import cuda_build, protocol
from .ids import ActorID, TaskID
from .task_spec import ACTOR_CREATION_TASK, TaskSpec

logger = logging.getLogger(__name__)

# Actor states (the reference's ActorTableData states).
PENDING, ALIVE, RESTARTING, DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"


class ActorInfo:
    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.state = PENDING
        self.addr: Optional[str] = None
        self.restarts_left = spec.max_restarts
        self.death_reason = ""

    def view(self) -> dict:
        return {"actor_id": self.spec.actor_id, "state": self.state,
                "addr": self.addr, "name": self.spec.name,
                "death_reason": self.death_reason}


class WorkerInfo:
    def __init__(self, token: str, proc: subprocess.Popen):
        self.token = token
        self.proc = proc
        self.pid = proc.pid
        self.returncode: Optional[int] = None
        self.addr: Optional[str] = None
        self.conn: Optional[protocol.Connection] = None
        self.registered = threading.Event()
        self.current_task: Optional[TaskSpec] = None
        self.actor_id: Optional[ActorID] = None  # dedicated actor worker
        self.dedicated = False
        self._reaped = False


class NodeInfo:
    """The node's resource vector and its pool of idle workers."""

    def __init__(self, node_id: str, resources: Dict[str, float]):
        self.node_id = node_id
        self.total = dict(resources)
        self.available = dict(resources)
        self.idle: deque = deque()  # addrs of idle pool workers
        self.spawning_pool = 0  # pool workers started, not registered

    def acquire(self, resources: Dict[str, float]):
        for k, v in resources.items():
            self.available[k] = self.available.get(k, 0.0) - v

    def release(self, resources: Dict[str, float]):
        for k, v in resources.items():
            self.available[k] = self.available.get(k, 0.0) + v

    def view(self) -> dict:
        return {"node_id": self.node_id,
                "total_resources": dict(self.total),
                "available_resources": dict(self.available)}


class HeadServer:
    def __init__(self, session_dir: str, session_name: str,
                 resources: Dict[str, float]):
        self.session_dir = session_dir
        self.session_name = session_name
        self.sock_path = f"\0ray_tpu_torch/{session_name}/head"
        self._lock = threading.RLock()
        self._kv: Dict[str, object] = {}
        self._subs: Dict[str, Set[protocol.Connection]] = {}
        self.node = NodeInfo("node0", resources)
        self._workers: Dict[str, WorkerInfo] = {}  # by addr, registered
        self._spawned: Dict[str, WorkerInfo] = {}  # by token
        self._pending: deque = deque()  # TaskSpecs waiting for resources
        self._actors: Dict[ActorID, ActorInfo] = {}
        self._named: Dict[str, ActorID] = {}
        self._conns_by_addr: Dict[str, protocol.Connection] = {}
        self._shutdown = False
        self._token_counter = 0
        self._unregistered_deaths = 0
        self.server = protocol.Server(
            self.sock_path, self._handle, on_connect=self._on_connect,
            on_close=self._on_conn_close)
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="head-monitor")
        self._monitor_thread.start()

    # ------------------------------------------------------------------
    # connection lifecycle
    # ------------------------------------------------------------------
    def _on_connect(self, conn: protocol.Connection, hello: dict):
        with self._lock:
            self._conns_by_addr[conn.peer_addr] = conn
            if hello.get("role") != "worker":
                return
            w = self._spawned.get(hello.get("token", ""))
            if w is None:
                logger.warning("unknown worker registered pid=%s",
                               hello.get("pid"))
                return
            w.addr = conn.peer_addr
            w.conn = conn
            self._workers[conn.peer_addr] = w
            if not w.dedicated:
                self.node.spawning_pool -= 1
                self.node.idle.append(conn.peer_addr)
            w.registered.set()
            self._schedule_locked()

    def _on_conn_close(self, conn: protocol.Connection):
        with self._lock:
            self._conns_by_addr.pop(conn.peer_addr, None)
            for subs in self._subs.values():
                subs.discard(conn)

    def _handle(self, conn: protocol.Connection, msg: dict):
        fn = getattr(self, "_h_" + msg["kind"], None)
        if fn is None:
            logger.warning("head: unknown message %s", msg["kind"])
            return
        fn(conn, msg)

    # -- function table --------------------------------------------------
    def _h_kv_put(self, conn, msg):
        with self._lock:
            self._kv.setdefault(msg["key"], msg["value"])

    def _h_kv_get(self, conn, msg):
        with self._lock:
            value = self._kv.get(msg["key"])
        conn.reply(msg, value=value)

    def _publish(self, channel: str, data):
        with self._lock:
            subs = list(self._subs.get(channel, ()))
        for c in subs:
            try:
                c.send({"kind": "publish", "channel": channel, "data": data})
            except protocol.ConnectionClosed:
                pass

    def _h_cluster_info(self, conn, msg):
        with self._lock:
            info = {"nodes": [self.node.view()]}
        conn.reply(msg, info=info)

    # -- tasks -----------------------------------------------------------
    def _h_submit_task(self, conn, msg):
        with self._lock:
            self._pending.append(msg["spec"])
            self._schedule_locked()

    def _h_task_done(self, conn, msg):
        task_id: TaskID = msg["task_id"]
        with self._lock:
            w = self._workers.get(conn.peer_addr)
            if w is None or w.current_task is None \
                    or w.current_task.task_id != task_id:
                return
            self.node.release(w.current_task.resources)
            w.current_task = None
            self.node.idle.append(w.addr)
            self._schedule_locked()

    # -- actors ----------------------------------------------------------
    def _h_create_actor(self, conn, msg):
        spec: TaskSpec = msg["spec"]
        with self._lock:
            if spec.name:
                if spec.name in self._named:
                    err = ValueError(
                        f"actor name {spec.name!r} already taken")
                else:
                    self._named[spec.name] = spec.actor_id
                    err = None
            else:
                err = None
            if err is None:
                self._actors[spec.actor_id] = ActorInfo(spec)
                self._pending.append(spec)
                self._schedule_locked()
        if err is not None:
            conn.reply(msg, error=err)
        else:
            conn.reply(msg, ok=True)

    def _h_actor_ready(self, conn, msg):
        actor_id: ActorID = msg["actor_id"]
        with self._lock:
            info = self._actors.get(actor_id)
            w = self._workers.get(msg["addr"])
            # A stale ready from an incarnation whose worker already died.
            if info is None or w is None or w._reaped \
                    or w.actor_id != actor_id:
                return
            info.state = ALIVE
            info.addr = msg["addr"]
            # The creation's resources are held while it runs (the
            # reference's creation lease), then returned.
            if w.current_task is info.spec:
                self.node.release(info.spec.resources)
                w.current_task = None
            view = info.view()
        self._publish("actor:" + actor_id.hex(), view)

    def _h_actor_creation_failed(self, conn, msg):
        actor_id: ActorID = msg["actor_id"]
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                return
            info.restarts_left = 0
            info.death_reason = f"creation failed: {msg.get('error')}"
        # The worker exits next; its death publishes the actor DEAD.

    def _h_resolve_actor(self, conn, msg):
        actor_id: ActorID = msg["actor_id"]
        with self._lock:
            info = self._actors.get(actor_id)
            # The caller hears of every later state change.
            self._subs.setdefault("actor:" + actor_id.hex(), set()).add(conn)
            view = info.view() if info else None
        conn.reply(msg, info=view)

    def _h_get_named_actor(self, conn, msg):
        with self._lock:
            aid = self._named.get(msg["name"])
            info = self._actors.get(aid) if aid is not None else None
            view = info.view() if info is not None \
                and info.state != DEAD else None
        conn.reply(msg, info=view)

    def _h_kill_actor(self, conn, msg):
        with self._lock:
            info = self._actors.get(msg["actor_id"])
            w = None
            if info is not None and info.state != DEAD:
                if msg.get("no_restart", True):
                    info.restarts_left = 0
                w = next((x for x in self._spawned.values()
                          if x.actor_id == info.spec.actor_id
                          and not x._reaped), None)
        if w is not None:
            try:
                w.proc.kill()
            except OSError:
                pass
        conn.reply(msg, ok=True)

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _schedule_locked(self):
        if self._shutdown:
            return
        remaining: deque = deque()
        # Resources tentatively committed to queued tasks that wait for
        # a new pool worker: a fan-out of 100 tasks on 4 CPUs starts 4.
        planned: Dict[str, float] = {}
        need_worker = 0
        node = self.node
        while self._pending:
            spec = self._pending.popleft()
            if not all(node.available.get(k, 0.0) - planned.get(k, 0.0)
                       + 1e-9 >= v for k, v in spec.resources.items()):
                remaining.append(spec)
                continue
            if spec.kind == ACTOR_CREATION_TASK:
                info = self._actors.get(spec.actor_id)
                if info is None:
                    continue
                try:
                    w = self._spawn_worker_locked(
                        dedicated=True, extra_env=spec.env_vars)
                except Exception as e:  # noqa: BLE001
                    logger.exception("failed to start an actor worker")
                    info.state = DEAD
                    info.death_reason = f"worker start failed: {e}"
                    self._release_actor_name_locked(info)
                    self._publish("actor:" + spec.actor_id.hex(),
                                  info.view())
                    continue
                w.actor_id = spec.actor_id
                w.current_task = spec
                node.acquire(spec.resources)
                threading.Thread(
                    target=self._dispatch_when_registered, args=(w, spec),
                    daemon=True).start()
                continue
            w = None
            while node.idle:
                w = self._workers.get(node.idle.popleft())
                if w is not None:
                    break
            if w is None:
                remaining.append(spec)
                for k, v in spec.resources.items():
                    planned[k] = planned.get(k, 0.0) + v
                need_worker += 1
                continue
            w.current_task = spec
            node.acquire(spec.resources)
            try:
                w.conn.send({"kind": "execute_task", "spec": spec})
            except protocol.ConnectionClosed:
                pass  # its death fails or retries the task
        self._pending = remaining
        for _ in range(max(0, need_worker - node.spawning_pool)):
            try:
                self._spawn_worker_locked(dedicated=False)
            except Exception:  # noqa: BLE001
                logger.exception("failed to grow the worker pool")
                break

    def _dispatch_when_registered(self, w: WorkerInfo, spec: TaskSpec):
        if not w.registered.wait(timeout=120):
            logger.error("worker pid=%s never registered", w.pid)
            return
        with self._lock:
            if w.current_task is not spec:
                return
            try:
                w.conn.send({"kind": "execute_task", "spec": spec})
            except protocol.ConnectionClosed:
                pass

    def _spawn_worker_locked(self, dedicated: bool,
                             extra_env: Optional[dict] = None) -> WorkerInfo:
        self._token_counter += 1
        token = f"w{self._token_counter}-{os.urandom(3).hex()}"
        w = self._spawn_local_worker(token, extra_env)
        w.dedicated = dedicated
        self._spawned[token] = w
        if not dedicated:
            self.node.spawning_pool += 1
        return w

    def _spawn_local_worker(self, token: str,
                            extra_env: Optional[dict]) -> WorkerInfo:
        env = dict(os.environ)
        env.update(extra_env or {})
        env["RAY_TPU_WORKER_TOKEN"] = token
        # A worker sees the driver's import universe: functions and
        # classes travel by reference.
        env["PYTHONPATH"] = os.pathsep.join(
            [p for p in sys.path if p]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        # Kernels are built by the driver; a worker only loads them.
        env[cuda_build.WORKER_ENV] = "1"
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, f"worker-{token}.out"), "ab") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.default_worker",
                 "--head-sock", self.sock_path.replace("\0", "\\0"),
                 "--session-dir", self.session_dir,
                 "--session-name", self.session_name],
                env=env, stdout=out, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, close_fds=True)
        return WorkerInfo(token, proc)

    # ------------------------------------------------------------------
    # failure detection
    # ------------------------------------------------------------------
    def _monitor_loop(self):
        while not self._shutdown:
            time.sleep(0.05)
            dead: List[WorkerInfo] = []
            with self._lock:
                for w in self._spawned.values():
                    if not w._reaped and w.proc.poll() is not None:
                        w._reaped = True
                        w.returncode = w.proc.returncode
                        dead.append(w)
            for w in dead:
                if not self._shutdown:
                    self._handle_worker_death(w)

    def _handle_worker_death(self, w: WorkerInfo):
        failed_boot = False
        with self._lock:
            if w.addr is not None:
                self._unregistered_deaths = 0
                self._workers.pop(w.addr, None)
                try:
                    self.node.idle.remove(w.addr)
                except ValueError:
                    pass
            else:
                if not w.dedicated:
                    self.node.spawning_pool -= 1
                # Died before registering: almost always an import
                # failure. Three in a row stop the respawn loop.
                self._unregistered_deaths += 1
                failed_boot = self._unregistered_deaths >= 3
            spec, w.current_task = w.current_task, None
            if spec is not None:
                self.node.release(spec.resources)
            retry = (spec is not None and w.actor_id is None
                     and spec.retries_used < spec.max_retries
                     and not failed_boot)
            if retry:
                spec.retries_used += 1
                self._pending.append(spec)
            if failed_boot:
                pending = [s for s in self._pending
                           if s.kind != ACTOR_CREATION_TASK]
                self._pending = deque(s for s in self._pending
                                      if s.kind == ACTOR_CREATION_TASK)
                self._unregistered_deaths = 0
            self._schedule_locked()
        if w.addr is None:
            logger.error("worker pid=%s exited (code %s) before "
                         "registering; see %s/logs/", w.pid, w.returncode,
                         self.session_dir)
        if failed_boot:
            for s in pending:
                self._fail_task_to_caller(s, WorkerCrashedError(
                    "worker processes repeatedly failed to start; see "
                    f"{self.session_dir}/logs/"))
        if w.actor_id is not None:
            self._handle_actor_death(w.actor_id, w)
        elif spec is not None and not retry:
            self._fail_task_to_caller(spec, WorkerCrashedError(
                f"worker pid={w.pid} died while running "
                f"{spec.describe()} (exit code {w.returncode})"))

    def _handle_actor_death(self, actor_id: ActorID, w: WorkerInfo):
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None or info.state == DEAD:
                return
            if info.restarts_left != 0:
                if info.restarts_left > 0:
                    info.restarts_left -= 1
                info.state = RESTARTING
                info.addr = None
                # A restart re-runs the creation task.
                self._pending.append(info.spec)
                self._schedule_locked()
            else:
                info.state = DEAD
                info.death_reason = info.death_reason \
                    or f"worker pid={w.pid} exited (code {w.returncode})"
                info.addr = None
                self._release_actor_name_locked(info)
            view = info.view()
        self._publish("actor:" + actor_id.hex(), view)

    def _release_actor_name_locked(self, info: ActorInfo):
        name = info.spec.name
        if name and self._named.get(name) == info.spec.actor_id:
            del self._named[name]

    def _fail_task_to_caller(self, spec: TaskSpec, error: Exception):
        with self._lock:
            conn = self._conns_by_addr.get(spec.caller_addr)
        if conn is None:
            return
        try:
            for oid in spec.return_ids():
                conn.send({"kind": "push_result", "object_id": oid,
                           "error": error})
        except protocol.ConnectionClosed:
            pass

    # ------------------------------------------------------------------
    def worker_pids(self) -> List[int]:
        """The pids of the worker processes still running."""
        with self._lock:
            return [w.pid for w in self._spawned.values()
                    if w.proc.poll() is None]

    def shutdown(self):
        with self._lock:
            self._shutdown = True
            workers = list(self._spawned.values())
        for w in workers:
            if w.conn is not None:
                try:
                    w.conn.send({"kind": "shutdown"})
                except protocol.ConnectionClosed:
                    pass
        deadline = time.monotonic() + 2.0
        for w in workers:
            try:
                w.proc.wait(timeout=max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait(timeout=10)
        self.server.close()
        if self._monitor_thread is not threading.current_thread():
            self._monitor_thread.join(timeout=2.0)
