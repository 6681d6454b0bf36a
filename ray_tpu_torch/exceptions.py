"""Public exception types of the port's runtime.

The port's own copy of `ray_tpu/exceptions.py`, trimmed to what the
local-mode runtime raises: `TaskError` (a task's exception, re-raised
by `get`), `ActorDiedError` (a call on a killed actor) and
`GetTimeoutError`.
"""

from __future__ import annotations

import traceback


class RayError(Exception):
    """Base class for all framework errors."""


class TaskError(RayError):
    """A task raised an exception during execution.

    Wraps the user exception; re-raised on `ray_tpu_torch.get` of the
    task's result, with the task's traceback embedded in the message.
    """

    def __init__(self, cause: BaseException = None, remote_tb: str = "",
                 task_desc: str = ""):
        self.cause = cause
        self.remote_tb = remote_tb
        self.task_desc = task_desc
        msg = f"task {task_desc} failed"
        if cause is not None:
            msg += f": {type(cause).__name__}: {cause}"
        if remote_tb:
            msg += "\n\n--- remote traceback ---\n" + remote_tb
        super().__init__(msg)

    @classmethod
    def from_exception(cls, e: BaseException, task_desc: str = ""):
        return cls(e, traceback.format_exc(), task_desc)


class ActorDiedError(RayError):
    """The actor is dead: it was killed (or its creation failed)."""

    def __init__(self, actor_id_hex: str = "", reason: str = ""):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(
            f"actor {actor_id_hex[:16]} died"
            + (f": {reason}" if reason else ""))


class GetTimeoutError(RayError, TimeoutError):
    """`ray_tpu_torch.get(..., timeout=)` expired."""
