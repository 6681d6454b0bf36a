"""`@ray_tpu_torch.remote` functions.

The port's own copy of `ray_tpu/remote_function.py` for the local-mode
runtime: the function object itself is exported under a key made from
its name and identity (the reference hashes its cloudpickle bytes),
with `.remote()` and `.options()`.
"""

from __future__ import annotations

from typing import Optional

from ._private import worker_state


def _resource_spec(num_cpus, num_gpus, resources) -> dict:
    spec = {"CPU": float(num_cpus) if num_cpus is not None else 1.0}
    if num_gpus:
        spec["GPU"] = float(num_gpus)
    if resources:
        spec.update({k: float(v) for k, v in resources.items()})
    return spec


class RemoteFunction:
    def __init__(self, fn, num_returns=1, num_cpus=None, num_gpus=None,
                 resources=None, max_retries=3, name=None):
        self._function = fn
        self._num_returns = num_returns
        self._resources = _resource_spec(num_cpus, num_gpus, resources)
        self._max_retries = max_retries
        self._name = name or getattr(fn, "__name__", "fn")
        self._key: Optional[str] = None
        self.__doc__ = getattr(fn, "__doc__", None)

    def _ensure_exported(self, rt):
        if self._key is None:
            self._key = f"fn:{self._name}:{id(self._function):x}"
        rt.export_function(self._key, self._function)

    def remote(self, *args, **kwargs):
        rt = worker_state.get_runtime()
        self._ensure_exported(rt)
        refs = rt.submit_task(
            self._key, args, kwargs, num_returns=self._num_returns,
            resources=self._resources, max_retries=self._max_retries,
            name=self._name)
        if self._num_returns == 0:
            return None
        return refs[0] if self._num_returns == 1 else refs

    def options(self, num_returns=None, num_cpus=None, num_gpus=None,
                resources=None, max_retries=None, name=None):
        """A copy with overridden submit options."""
        clone = RemoteFunction(
            self._function,
            num_returns=self._num_returns if num_returns is None
            else num_returns,
            max_retries=self._max_retries if max_retries is None
            else max_retries,
            name=name or self._name)
        clone._resources = dict(self._resources)
        if num_cpus is not None:
            clone._resources["CPU"] = float(num_cpus)
        if num_gpus is not None:
            clone._resources["GPU"] = float(num_gpus)
        if resources:
            clone._resources.update(
                {k: float(v) for k, v in resources.items()})
        return clone

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._name}' cannot be called directly; use "
            f"'{self._name}.remote()'.")
