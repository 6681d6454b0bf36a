"""Port parity: the multi-process runtime.

The runtime program (`torch_runtime_program.program`: remote functions,
an actor with state, `put`/`get`/`wait`, refs as arguments and inside
values, a task's error re-raised by `get`, `kill` then `ActorDiedError`,
a named actor, multiple returns) runs through `ray_tpu.init(num_cpus=4)`
and through `ray_tpu_torch.init(num_cpus=4)`: the two give equal
results. On the port's runtime, tasks and actors run in processes of
their own, a numpy value over 100 KiB comes back bit for bit through
`/dev/shm`, an object is freed once no process holds a ref, a
`SIGKILL`ed actor and a task whose worker dies give the error classes
the JAX runtime gives, an object that does not fit the store raises, a
lambda fails at submission, no worker holds `jax`, `cloudpickle` or
`ray_tpu`, and `shutdown` leaves no process, no shared-memory file and
no session directory behind. One runtime of each package serves the
whole module.
"""

import glob
import os
import signal
import time

import jax  # noqa: F401  (the JAX package's tests share this process)
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
import torch_runtime_program as program
from ray_tpu_torch._private import node as port_node
from ray_tpu_torch._private import object_store, worker_state
from ray_tpu_torch.exceptions import ObjectStoreFullError

BANNED = ("jax", "jaxlib", "flax", "optax", "ray_tpu", "cloudpickle", "lz4")


def _sigkill_error(rt) -> str:
    """SIGKILL an actor's process, then call it: the error's class."""
    c = rt.remote(program.Counter).remote(0)
    os.kill(rt.get(c.pid.remote()), signal.SIGKILL)
    time.sleep(0.5)
    try:
        rt.get(c.inc.remote(), timeout=60)
    except rt.RayError as e:
        return type(e).__name__
    return "no error"


def _crash_error(rt) -> str:
    """A task whose worker dies under it, with no retry: the error's
    class."""
    try:
        rt.get(rt.remote(max_retries=0)(program.die).remote(), timeout=60)
    except rt.RayError as e:
        return type(e).__name__
    return "no error"


@pytest.fixture(scope="module")
def jax_results():
    ray_tpu.init(num_cpus=4)
    try:
        return (program.program(ray_tpu), _sigkill_error(ray_tpu),
                _crash_error(ray_tpu))
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(jax_results):
    """The port's runtime (after the JAX one has shut down)."""
    ray_tpu_torch.init(num_cpus=4)
    yield port_node.current_node()
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


def _until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def test_program_matches_jax_package(jax_results, port):
    want = jax_results[0]
    got = program.program(ray_tpu_torch)
    assert got == want
    assert worker_state.mode() == worker_state.SCRIPT_MODE
    # The caller's task records: every call it made, each finished or
    # failed with its result.
    summary = ray_tpu_torch.task_summary()
    assert summary["square"] == {"FINISHED": 11}
    assert summary["fail"] == {"FAILED": 1}
    assert summary["Counter.broken"] == {"FAILED": 1}
    failed = ray_tpu_torch.tasks(state="FAILED", name="fail")
    assert failed[0]["worker_pid"] not in (None, os.getpid())


def test_tasks_and_actors_run_in_other_pids(port):
    where = ray_tpu_torch.remote(program.where)
    pids = set(ray_tpu_torch.get([where.remote() for _ in range(8)]))
    c = ray_tpu_torch.remote(program.Counter).remote(0)
    actor_pid = ray_tpu_torch.get(c.pid.remote())
    assert os.getpid() not in pids | {actor_pid}
    assert actor_pid not in pids  # an actor has a process of its own
    assert set(port.head.worker_pids()) >= pids | {actor_pid}
    ray_tpu_torch.kill(c)


def test_large_value_through_shm(port):
    rt = port.runtime
    big = np.random.default_rng(0).standard_normal(30_000)  # 240 KB
    assert big.nbytes > object_store.INLINE_OBJECT_MAX
    ref = ray_tpu_torch.put(big)
    assert os.path.exists(rt.shm.prefix + ref.hex())
    echo = ray_tpu_torch.remote(program.echo)
    # By reference, by value (spilled to the store), and a large result.
    for arg in (ref, big):
        out = ray_tpu_torch.get(echo.remote(arg))
        assert out.tobytes() == big.tobytes() and out.dtype == big.dtype
    assert ray_tpu_torch.get(ref).tobytes() == big.tobytes()
    # An object that does not fit the store raises; nothing else carries
    # it.
    capacity, rt.store_capacity = rt.store_capacity, big.nbytes
    try:
        with pytest.raises(ObjectStoreFullError, match="over capacity"):
            ray_tpu_torch.put(big)
    finally:
        rt.store_capacity = capacity


def test_objects_freed_when_unreferenced(port):
    rt = port.runtime
    ref = ray_tpu_torch.put(np.ones(50_000))
    path = rt.shm.prefix + ref.hex()
    out = ray_tpu_torch.remote(program.echo).remote(ref)
    result_path = rt.shm.prefix + out.hex()
    assert ray_tpu_torch.get(out).sum() == 50_000
    assert os.path.exists(path) and os.path.exists(result_path)
    del ref, out
    assert _until(lambda: not os.path.exists(path)
                  and not os.path.exists(result_path))
    # A result nobody kept is freed as it lands.
    ray_tpu_torch.remote(program.echo).remote(np.zeros(50_000))
    assert _until(lambda: rt.owned_bytes()[1] < object_store.INLINE_OBJECT_MAX)
    # `free` frees an object whoever still holds a ref.
    held = ray_tpu_torch.put(np.zeros(50_000))
    ray_tpu_torch.free(held)
    assert not os.path.exists(rt.shm.prefix + held.hex())
    with pytest.raises(ray_tpu_torch.ObjectLostError, match="freed"):
        ray_tpu_torch.get(held)


def test_sigkilled_actor_error_matches_jax(jax_results, port):
    _, actor_error, task_error = jax_results
    assert actor_error == "ActorDiedError"
    assert _sigkill_error(ray_tpu_torch) == actor_error
    # A pool worker that dies under its task.
    assert task_error == "WorkerCrashedError"
    assert _crash_error(ray_tpu_torch) == task_error


def test_lambda_fails_at_submission(port):
    with pytest.raises(TypeError, match="<lambda>"):
        ray_tpu_torch.remote(lambda x: x).remote(1)

    def local_fn():
        return 1

    with pytest.raises(TypeError, match="local_fn"):
        ray_tpu_torch.remote(local_fn).remote()
    with pytest.raises(TypeError, match="<lambda>"):
        ray_tpu_torch.remote(program.echo).remote(lambda: 0)


def test_workers_hold_no_jax(port):
    names = list(BANNED)
    modules = ray_tpu_torch.remote(program.loaded_modules)
    assert ray_tpu_torch.get(modules.remote(names)) == []
    c = ray_tpu_torch.remote(program.Counter).remote(0)
    assert ray_tpu_torch.get(c.inc.remote()) == 1
    assert ray_tpu_torch.get(
        ray_tpu_torch.remote(program.where).remote()) != os.getpid()
    ray_tpu_torch.kill(c)


def test_shutdown_leaves_nothing(port):
    rt = port.runtime
    c = ray_tpu_torch.remote(program.Counter).options(name="last").remote(0)
    keep = ray_tpu_torch.put(np.zeros(50_000))
    ray_tpu_torch.get(c.inc.remote())
    pids = port.head.worker_pids()
    assert pids and glob.glob(rt.shm.prefix + "*") \
        and os.path.isdir(port.session_dir)
    with pytest.raises(RuntimeError, match="called twice"):
        ray_tpu_torch.init(num_cpus=1)
    ray_tpu_torch.shutdown()
    assert not ray_tpu_torch.is_initialized()

    def gone(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        return False

    assert all(gone(pid) for pid in pids)
    assert glob.glob(rt.shm.prefix + "*") == []
    assert not os.path.exists(port.session_dir)
    with pytest.raises(RuntimeError, match="not been initialized"):
        ray_tpu_torch.get(keep)
