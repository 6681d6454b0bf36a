"""Port parity: the local-mode runtime.

One program (remote functions, an actor with state, `put`/`get`/`wait`,
a task's error re-raised by `get`, `kill` then `ActorDiedError`, a
named actor, multiple returns and the task records) runs through
`ray_tpu.init(local_mode=True)` and through
`ray_tpu_torch.init(local_mode=True)`: the two give equal results. The
port's runtime needs no `cloudpickle` and leaves nothing behind at
`shutdown`; `init()` without `local_mode` starts the multi-process
runtime instead (`test_torch_runtime_procs.py` runs the program on it).
"""

import sys

import jax  # noqa: F401  (the JAX package's tests share this process)
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch


def _program(rt):
    """The same calls through either package's module `rt`; returns
    what each call gave."""
    out = {}

    @rt.remote
    def square(x):
        return x * x

    @rt.remote(num_returns=2)
    def split(x):
        return x, x + 1

    @rt.remote
    def fail(key):
        raise KeyError(key)

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def broken(self):
            raise ValueError("broken method")

    out["squares"] = rt.get([square.remote(i) for i in range(5)])
    out["split"] = rt.get(list(split.remote(3)))
    ref = rt.put(np.arange(6, dtype=np.int64).reshape(2, 3))
    out["put"] = rt.get(ref).tolist()
    # A ref as an argument resolves to its value.
    out["ref_arg"] = rt.get(square.remote(ref)).tolist()
    refs = [square.remote(i) for i in range(4)]
    ready, not_ready = rt.wait(refs, num_returns=2)
    out["wait"] = [len(ready), len(not_ready), rt.get(ready)]

    c = Counter.remote(10)
    out["counts"] = [rt.get(c.inc.remote()) for _ in range(3)] \
        + [rt.get(c.inc.remote(k=5))]
    for err_ref in (fail.remote("missing"), c.broken.remote()):
        with pytest.raises(rt.TaskError) as err:
            rt.get(err_ref)
        out.setdefault("errors", []).append(
            [type(err.value.cause).__name__, str(err.value.cause)])
    # The failed call left the actor's state alone.
    out["after_error"] = rt.get(c.inc.remote())
    rt.kill(c)
    with pytest.raises(rt.ActorDiedError):
        c.inc.remote()

    named = Counter.options(name="shared").remote(100)
    rt.get(named.inc.remote())
    out["named"] = rt.get(rt.get_actor("shared").inc.remote(2))
    with pytest.raises(ValueError, match="no live actor"):
        rt.get_actor("nobody")
    out["summary"] = rt.task_summary()
    out["failed"] = [(r["name"], r["kind"], r["state"], r["error"][:40])
                     for r in rt.tasks(state="FAILED")]
    out["newest"] = [(r["name"], r["kind"], r["state"])
                     for r in rt.tasks(limit=3)]
    return out


@pytest.fixture
def port_local(monkeypatch):
    # The port's runtime pickles nothing: it runs with cloudpickle
    # unimportable.
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    ray_tpu_torch.init(local_mode=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_program_matches_jax_package(monkeypatch):
    ray_tpu.init(local_mode=True)
    try:
        want = _program(ray_tpu)
    finally:
        ray_tpu.shutdown()
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cloudpickle", None)
        ray_tpu_torch.init(local_mode=True)
        try:
            got = _program(ray_tpu_torch)
        finally:
            ray_tpu_torch.shutdown()
    assert got == want
    # Five calls of `c` and one of `named` finished, `c.broken` failed;
    # a handle from `get_actor` records under the actor's name.
    assert got["summary"]["Counter"] == {"FINISHED": 6, "FAILED": 1}
    assert got["summary"]["shared"] == {"FINISHED": 1}


def test_shutdown_leaves_nothing(port_local):
    rt = ray_tpu_torch._private.worker_state.get_runtime()

    @ray_tpu_torch.remote
    class Box:
        def value(self):
            return 1

    keep = [ray_tpu_torch.put(np.zeros(3)), Box.options(name="b").remote()]
    ray_tpu_torch.get(keep[1].value.remote())
    assert rt._objects and rt._actors and rt.task_summary()
    ray_tpu_torch.shutdown()
    assert not ray_tpu_torch.is_initialized()
    assert not (rt._objects or rt._errors or rt._functions or rt._actors
                or rt._named_actors or rt.task_summary())
    with pytest.raises(RuntimeError, match="not been initialized"):
        ray_tpu_torch.put(1)
    # A new session knows nothing of the old one.
    ray_tpu_torch.init(local_mode=True)
    with pytest.raises(ValueError, match="no live actor"):
        ray_tpu_torch.get_actor("b")


def test_values_live_as_long_as_their_ref(port_local):
    rt = ray_tpu_torch._private.worker_state.get_runtime()
    ref = ray_tpu_torch.put(np.ones(4))
    oid = ref.id
    assert oid in rt._objects
    del ref
    assert oid not in rt._objects


def test_init_refuses_the_multi_process_runtime():
    """`init()` without `local_mode` is no longer refused: it starts the
    multi-process runtime (the head in this process; workers start on
    demand), with the resources asked for. Either runtime refuses a
    second `init`."""
    from ray_tpu_torch._private import worker_state
    ray_tpu_torch.init(num_cpus=2, resources={"GPU": 3, "custom": 1})
    try:
        assert worker_state.mode() == worker_state.SCRIPT_MODE
        assert ray_tpu_torch.cluster_resources() == {
            "CPU": 2.0, "GPU": 3.0, "custom": 1.0}
        with pytest.raises(RuntimeError, match="called twice"):
            ray_tpu_torch.init(local_mode=True)
    finally:
        ray_tpu_torch.shutdown()
    assert not ray_tpu_torch.is_initialized()
    with pytest.raises(RuntimeError, match="called twice"):
        ray_tpu_torch.init(local_mode=True)
        try:
            ray_tpu_torch.init(local_mode=True)
        finally:
            ray_tpu_torch.shutdown()
