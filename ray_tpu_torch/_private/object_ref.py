"""ObjectRef: a handle to an object's value.

The port's own copy of `ray_tpu/_private/object_ref.py`, without the
borrower bookkeeping of the multi-process runtime. In local mode no ref
is ever pickled, so each object has exactly one `ObjectRef`, and the
runtime drops the value when that ref is collected (`_on_release`, set
by `LocalRuntime`): a long local-mode run does not keep every sample
batch and weight payload it ever made.
"""

from __future__ import annotations

from .ids import ObjectID

# Installed by the local-mode runtime: called with an object's id when
# its ref is collected.
_on_release = None


def set_release_hook(hook) -> None:
    global _on_release
    _on_release = hook


class ObjectRef:
    __slots__ = ("id",)

    def __init__(self, oid: ObjectID):
        self.id = oid

    def __del__(self):
        hook = _on_release
        if hook is not None:
            try:
                hook(self.id)
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

    # Keep users from iterating a ref thinking it's the value.
    def __iter__(self):
        raise TypeError(
            "ObjectRef is not iterable; call ray_tpu_torch.get(ref) first.")
