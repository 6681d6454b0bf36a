"""Binary identifiers for tasks, objects and actors.

The port's own copy of `ray_tpu/_private/ids.py`, trimmed to the ids
the local-mode runtime makes: a 16-byte random unique part, and an
object id that is its task's id plus a 4-byte return index.
"""

from __future__ import annotations

import os

_UNIQUE_LEN = 16  # random bytes per unique id
_INDEX_LEN = 4  # big-endian object index appended to a TaskID


class BaseID:
    __slots__ = ("_bytes", "_hash")

    def __init__(self, raw: bytes):
        if not isinstance(raw, bytes):
            raise TypeError(f"id must be bytes, got {type(raw)}")
        self._bytes = raw
        self._hash = hash(raw)

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"


class ActorID(BaseID):
    @classmethod
    def generate(cls) -> "ActorID":
        return cls(os.urandom(_UNIQUE_LEN))


class TaskID(BaseID):
    @classmethod
    def generate(cls) -> "TaskID":
        return cls(os.urandom(_UNIQUE_LEN))

    def object_id(self, index: int) -> "ObjectID":
        """The id of this task's `index`-th return value."""
        return ObjectID(self._bytes + index.to_bytes(_INDEX_LEN, "big"))


class ObjectID(BaseID):
    @classmethod
    def generate(cls) -> "ObjectID":
        """A put() object: random task part + index 0."""
        return TaskID.generate().object_id(0)
