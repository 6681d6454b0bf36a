"""In-flight task tracking over actor fleets.

The port's own copy of `ray_tpu/rllib/utils/actors.py` (parity:
`rllib/utils/actors.py:8` `TaskPool`): tracks pending `sample.remote()`
calls so async optimizers can pull completed batches as they arrive
and keep every worker busy.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import ray_tpu_torch


class TaskPool:
    def __init__(self):
        self._tasks: Dict = {}   # ObjectRef -> actor handle

    def add(self, worker, obj_ref) -> None:
        self._tasks[obj_ref] = worker

    def completed(self, blocking_wait: bool = False
                  ) -> Iterator[Tuple[object, object]]:
        """Yield (worker, ref) for finished tasks; removes them. In
        local mode every task has finished by the time it is added, so
        the first `wait` returns them all and nothing blocks."""
        pending = list(self._tasks)
        if not pending:
            return
        ready, _ = ray_tpu_torch.wait(
            pending, num_returns=len(pending), timeout=0)
        if not ready and blocking_wait:
            ready, _ = ray_tpu_torch.wait(pending, num_returns=1,
                                          timeout=10.0)
        for ref in ready:
            worker = self._tasks.pop(ref)
            yield worker, ref

    def pending(self) -> list:
        """The refs still in flight (their worker's next batches)."""
        return list(self._tasks)

    @property
    def count(self) -> int:
        return len(self._tasks)
