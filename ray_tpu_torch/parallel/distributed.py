"""The multi-process world: a `torch.distributed` process group.

Counterpart of `ray_tpu/parallel/distributed.py`, where every process
joined one `jax.distributed` runtime and contributed the rows of its own
devices. PyTorch's idiom for several GPUs is the same shape: one process
per device, all in one world, each learning on its own batch shard and
exchanging gradients by collectives (`parallel/collectives.py`).

- `initialize` joins this process to a world with an explicit backend,
  size, rank and rendezvous address, and always a finite timeout (a
  rank that never arrives, or a collective that one rank never issues,
  fails instead of hanging).
- `launch` starts a world of ranks on this host (`spawn` start method),
  runs `fn(rank, *args)` in each, joins them with a deadline, kills the
  rest when one fails and re-raises that rank's exception.

Backends: "nccl" puts one rank on each card (`cuda:<rank>`); "gloo"
runs the CPU worlds of the tests, and several ranks that share one card.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List

logger = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")
RENDEZVOUS_TIMEOUT_S = 120.0
LAUNCH_TIMEOUT_S = 900.0


def reserve_coordinator_port(host: str = "127.0.0.1") -> str:
    """A free port for rank 0's rendezvous store, as an `init_method`
    URL. Bind-then-release: a small race window, as in the reference."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return f"tcp://{host}:{port}"


def initialize(backend: str, world_size: int, rank: int,
               init_method: str,
               timeout: float = RENDEZVOUS_TIMEOUT_S) -> None:
    """Join this process to a world. `timeout` (seconds, finite) bounds
    the rendezvous and every later collective of the world."""
    import torch
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"unknown collective backend {backend!r}; "
                         f"known: {BACKENDS}")
    if timeout is None or not math.isfinite(timeout) or timeout <= 0:
        raise ValueError(f"timeout must be a finite number of seconds, "
                         f"got {timeout!r}")
    if backend == "nccl":
        # One rank per card: NCCL refuses two ranks on one device.
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    logger.info("torch.distributed world joined: rank %d/%d, %s, %s",
                rank, world_size, backend, init_method)


def shutdown() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, world_size, backend, init_method, timeout, args,
               results) -> None:
    """A rank's process: join the world, run `fn`, report (rank, ok,
    value or exception, traceback) as pickled bytes. The report is in
    the launcher's pipe before the rank leaves the world: a failing
    rank's exit fails the collectives the others wait in, and their
    reports must not reach the launcher ahead of the cause."""
    if backend == "gloo":
        # `launch` worlds live on one host: keep gloo's pair connections
        # on the loopback device instead of the hostname's address.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        initialize(backend, world_size, rank, init_method, timeout)
        msg = (rank, True, fn(rank, *args), None)
        payload = pickle.dumps(msg)
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps((rank, False, e, tb))
        except Exception:  # noqa: BLE001 — an unpicklable exception
            payload = pickle.dumps(
                (rank, False, RuntimeError(repr(e)), tb))
    try:
        results.put(payload)
        results.close()
        results.join_thread()  # the bytes are in the pipe
    finally:
        shutdown()


def launch(fn: Callable, world_size: int, backend: str, *args: Any,
           timeout: float = LAUNCH_TIMEOUT_S,
           rendezvous_timeout: float = RENDEZVOUS_TIMEOUT_S) -> List[Any]:
    """Run `fn(rank, *args)` on `world_size` spawned ranks of one world
    and return their results in rank order.

    `fn` and `args` are pickled (a module-level function). The ranks
    must finish within `timeout` seconds; when one fails, or the
    deadline passes, every rank is killed and the first failure is
    re-raised with the rank's traceback attached."""
    import multiprocessing as mp
    if not math.isfinite(timeout) or timeout <= 0:
        raise ValueError(f"timeout must be finite, got {timeout!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = reserve_coordinator_port()
    procs = [ctx.Process(
        target=_rank_main, name=f"rank-{rank}", daemon=True,
        args=(fn, rank, world_size, backend, init_method,
              rendezvous_timeout, args, results))
        for rank in range(world_size)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world_size
    done = set()
    failure = None
    deadline = time.monotonic() + timeout
    def take(payload) -> None:
        nonlocal failure
        rank, ok, value, tb = pickle.loads(payload)
        done.add(rank)
        if ok:
            out[rank] = value
        elif failure is None:
            value.add_note(f"raised on rank {rank} of {world_size}:\n{tb}")
            failure = value

    try:
        # Read results while the ranks run: a large result blocks its
        # rank's exit until it has been read.
        while len(done) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = TimeoutError(
                    f"world of {world_size} ranks did not finish within "
                    f"{timeout} s (ranks done: {sorted(done)})")
                break
            try:
                take(results.get(timeout=min(left, 1.0)))
                continue
            except queue_mod.Empty:
                pass
            exited = [rank for rank, p in enumerate(procs)
                      if rank not in done and p.exitcode is not None]
            if not exited:
                continue
            # A small result does not hold its rank back: it may have
            # been written, and the rank gone, since the wait above
            # timed out. Read what is there before calling a rank lost.
            while True:
                try:
                    take(results.get_nowait())
                except queue_mod.Empty:
                    break
            for rank in exited:
                if rank not in done and failure is None:
                    failure = RuntimeError(
                        f"rank {rank} exited with code "
                        f"{procs[rank].exitcode} without a result")
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    if failure is not None:
        raise failure
    return out
