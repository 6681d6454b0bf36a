"""ObjectRef: a handle to a (possibly not yet computed) object's value.

The port's own copy of `ray_tpu/_private/object_ref.py`. A ref carries
its owner's server address, so any process holding it can ask the owner
for the value. Every live ref in a process counts toward that process's
reference count of the object (`Runtime.ref_tracker`, installed by the
multi-process runtime): the owner frees an object once no process holds
a ref to it. Pickling a ref inside a value (a ref in a list, in a
result) tells its owner to keep the object for an export grace while
the receiver deserializes it and registers its borrow; a ref passed as
a task's argument is pinned by its submitter instead
(`task_spec.ArgSpec`).

In local mode no ref is ever pickled, so each object has exactly one
`ObjectRef`, and the local-mode runtime drops the value when that ref
is collected (its release hook).
"""

from __future__ import annotations

from .ids import ObjectID

# The multi-process runtime's reference tracker (incref/decref/
# note_export), or None.
_tracker = None
# Installed by the local-mode runtime: called with an object's id when
# its ref is collected.
_on_release = None


def set_ref_tracker(tracker) -> None:
    global _tracker
    _tracker = tracker


def set_release_hook(hook) -> None:
    global _on_release
    _on_release = hook


class ObjectRef:
    __slots__ = ("id", "owner_addr", "size_hint")

    def __init__(self, oid: ObjectID, owner_addr: str = "",
                 size_hint: int = 0):
        self.id = oid
        self.owner_addr = owner_addr
        self.size_hint = size_hint
        if _tracker is not None:
            _tracker.incref(oid, owner_addr)

    def __del__(self):
        try:
            if _tracker is not None:
                _tracker.decref(self.id, self.owner_addr)
            elif _on_release is not None:
                _on_release(self.id)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def hex(self) -> str:
        return self.id.hex()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:16]})"

    def __reduce__(self):
        if _tracker is not None:
            _tracker.note_export(self.id, self.owner_addr)
        return (ObjectRef, (self.id, self.owner_addr, self.size_hint))

    # Keep users from iterating a ref thinking it's the value.
    def __iter__(self):
        raise TypeError(
            "ObjectRef is not iterable; call ray_tpu_torch.get(ref) first.")


def _deserialize_arg_ref(oid: ObjectID, owner_addr: str, size_hint: int):
    """Unpickle entry point of a by-reference task argument
    (`task_spec.ArgSpec.__reduce__`)."""
    from .task_spec import ArgSpec
    return ArgSpec(ref=ObjectRef(oid, owner_addr, size_hint))
