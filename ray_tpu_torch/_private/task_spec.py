"""Task specifications.

The port's own copy of `ray_tpu/_private/task_spec.py`: a plain
picklable dataclass carried over the socket transport, with the
function descriptor, the arguments by value or by reference, the
resource demand and the normal / actor-creation / actor-task variants.
The job id, leases and trace context are left out with the parts of
the runtime that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .ids import ActorID, ObjectID, TaskID


@dataclass
class ArgSpec:
    """One task argument: either an inline serialized value or an
    ObjectRef (by reference). A ref argument is pinned by its submitter
    until the task's result arrives (`Runtime._pin_task_args`), so it
    is pickled without the export grace of a ref inside a value."""
    data: Optional[bytes] = None  # serialized inline value
    ref: Optional[object] = None  # ObjectRef (by reference)

    def __reduce__(self):
        if self.ref is None:
            return (ArgSpec, (self.data,))
        from .object_ref import _deserialize_arg_ref
        r = self.ref
        return (_deserialize_arg_ref, (r.id, r.owner_addr, r.size_hint))


NORMAL_TASK = 0
ACTOR_CREATION_TASK = 1
ACTOR_TASK = 2


@dataclass
class TaskSpec:
    task_id: TaskID
    kind: int = NORMAL_TASK
    # Key into the head's function table (normal and creation tasks);
    # actor tasks name a method on the instance instead.
    function_key: Optional[str] = None
    method_name: Optional[str] = None
    args: List[ArgSpec] = field(default_factory=list)
    kwargs: Dict[str, ArgSpec] = field(default_factory=dict)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    # Server address of the submitting process: it OWNS the results.
    caller_addr: str = ""
    actor_id: Optional[ActorID] = None
    # Per (caller, actor) sequence number: an actor runs each caller's
    # calls in submission order.
    actor_seq: int = 0
    max_retries: int = 0
    retries_used: int = 0
    # Actor-creation options.
    max_restarts: int = 0
    max_concurrency: int = 1
    name: str = ""  # debugging / named actor
    # Extra environment variables for the (dedicated) worker process.
    env_vars: Dict[str, str] = field(default_factory=dict)

    def return_ids(self) -> List[ObjectID]:
        return [self.task_id.object_id(i) for i in range(self.num_returns)]

    def describe(self) -> str:
        if self.kind == ACTOR_TASK:
            return f"{self.name or 'actor'}.{self.method_name}"
        return self.name or (self.function_key or "?")[:24]
