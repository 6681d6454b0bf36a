"""Functions and classes that the runtime tests send to worker processes.

The port's multi-process runtime pickles functions and classes by
reference with plain `pickle`, so a worker must be able to import them:
they live here, at module level, in a module that imports no JAX (a
worker of the port starts with numpy, torch and `ray_tpu_torch` alone).
`program(rt)` is the runtime program of `test_torch_runtime.py`, the
same calls through either package's module `rt`.
"""

import os
import signal
import sys

import numpy as np


def square(x):
    return x * x


def split(x):
    return x, x + 1


def fail(key):
    raise KeyError(key)


def where():
    """The pid of the process that runs a task."""
    return os.getpid()


def loaded_modules(names):
    """Which of `names` this process has imported."""
    return sorted(n for n in names if n in sys.modules)


def echo(value):
    return value


def rollout_worker_process(worker, names):
    """Through `RolloutWorker.apply`: the worker's pid, its policy's
    device and which of `names` its process has imported."""
    return {"pid": os.getpid(), "device": str(worker.policy.device),
            "modules": loaded_modules(names)}


def nested_sum(refs, rt_name):
    """A task that gets the values of refs passed inside a list."""
    import importlib
    rt = importlib.import_module(rt_name)
    return float(sum(np.sum(v) for v in rt.get(refs)))


class Counter:
    def __init__(self, start):
        self.n = start

    def inc(self, k=1):
        self.n += k
        return self.n

    def broken(self):
        raise ValueError("broken method")

    def pid(self):
        return os.getpid()


def _error(rt, ref):
    try:
        rt.get(ref)
    except rt.TaskError as e:
        return [type(e.cause).__name__, str(e.cause)]
    raise AssertionError("the call did not fail")


def program(rt):
    """The same calls through either package's module `rt`; returns
    what each call gave."""
    out = {}
    r_square = rt.remote(square)
    r_split = rt.remote(num_returns=2)(split)
    r_fail = rt.remote(fail)
    r_counter = rt.remote(Counter)

    out["squares"] = rt.get([r_square.remote(i) for i in range(5)])
    out["split"] = rt.get(list(r_split.remote(3)))
    ref = rt.put(np.arange(6, dtype=np.int64).reshape(2, 3))
    out["put"] = rt.get(ref).tolist()
    # A ref as an argument resolves to its value.
    out["ref_arg"] = rt.get(r_square.remote(ref)).tolist()
    # Refs inside a value: the task gets them itself.
    out["nested"] = rt.get(rt.remote(nested_sum).remote(
        [ref, r_square.remote(ref)], rt.__name__))
    refs = [r_square.remote(i) for i in range(4)]
    ready, not_ready = rt.wait(refs, num_returns=2, timeout=60)
    out["wait"] = [len(ready), len(not_ready),
                   all(v in (0, 1, 4, 9) for v in rt.get(ready))]

    c = r_counter.remote(10)
    out["counts"] = [rt.get(c.inc.remote()) for _ in range(3)] \
        + [rt.get(c.inc.remote(k=5))]
    out["errors"] = [_error(rt, r_fail.remote("missing")),
                     _error(rt, c.broken.remote())]
    # The failed call left the actor's state alone.
    out["after_error"] = rt.get(c.inc.remote())
    rt.kill(c)
    try:
        rt.get(c.inc.remote(), timeout=60)
        out["after_kill"] = "no error"
    except rt.RayError as e:
        out["after_kill"] = type(e).__name__

    named = r_counter.options(name="shared").remote(100)
    rt.get(named.inc.remote())
    out["named"] = rt.get(rt.get_actor("shared").inc.remote(2))
    try:
        rt.get_actor("nobody")
        out["unknown_name"] = "found"
    except ValueError:
        out["unknown_name"] = "ValueError"
    return out


def die():
    """A task whose worker process dies under it."""
    os.kill(os.getpid(), signal.SIGKILL)
