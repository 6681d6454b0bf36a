"""The node's shared-memory object store and the per-process memory store.

The port's own copy of `ray_tpu/_private/object_store.py`:

- `MemoryStore`: this process's cells (small values as their serialized
  bytes, decoded values, pointers into the shared store, errors) with
  blocking waits, woken by every `put`.
- `SharedObjectStore`: values of `INLINE_OBJECT_MAX` bytes and more live
  as files under `SHM_DIR` (`/dev/shm`), one per object, named
  `raytpu_<session>_<object hex>`. The creating process writes the blob
  into a `.tmp` file and seals it with an atomic rename; readers `mmap`
  it read-only, so numpy values come back as zero-copy views.

The store is sized at `STORE_FRACTION` of the shared-memory filesystem
(the reference's default); an object that does not fit raises `ObjectStoreFullError`
(`Runtime._make_room`), it never falls back to a socket. The
reference's striped receive and per-node fetch claims belong to its
multi-node data plane and are not copied.
"""

from __future__ import annotations

import glob
import mmap
import os
import threading
import time
from typing import Dict, Optional

from . import serialization
from .ids import ObjectID

SHM_DIR = os.environ.get("RAY_TPU_SHM_DIR", "/dev/shm")
# Values smaller than this are pushed inline over sockets rather than
# through the shared store (the reference's `max_direct_call_object_size`).
INLINE_OBJECT_MAX = 100 * 1024
STORE_FRACTION = 0.3


def store_capacity() -> int:
    """The store's size in bytes: 30% of the shared-memory filesystem's
    size (its total, so every process of the node derives the same
    capacity)."""
    return int(shm_size() * STORE_FRACTION)


def shm_size() -> int:
    """The shared-memory filesystem's total size in bytes."""
    st = os.statvfs(SHM_DIR)
    return st.f_blocks * st.f_frsize


class ObjectEntry:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class MemoryStore:
    """In-process store of cells with blocking waits."""

    def __init__(self):
        self._objects: Dict[ObjectID, ObjectEntry] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def put(self, oid: ObjectID, value) -> None:
        with self._cv:
            self._objects[oid] = ObjectEntry(value)
            self._cv.notify_all()

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._objects

    def get_if_exists(self, oid: ObjectID) -> Optional[ObjectEntry]:
        with self._lock:
            return self._objects.get(oid)

    def wait_threshold(self, oids, num: int, timeout: Optional[float],
                       extra_ready=None) -> list:
        """Block until >= `num` of `oids` are ready: here, or
        `extra_ready(oid)` (sealed in the shared store by another
        process, which does not wake this store: re-checked every
        50 ms). Returns the ready ones (fewer than `num` on timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                ready = [o for o in oids if o in self._objects
                         or (extra_ready is not None and extra_ready(o))]
                if len(ready) >= num:
                    return ready
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return ready
                if extra_ready is not None:
                    remaining = 0.05 if remaining is None \
                        else min(remaining, 0.05)
                self._cv.wait(remaining)

    def delete(self, oid: ObjectID) -> None:
        with self._cv:
            self._objects.pop(oid, None)

    def clear(self) -> None:
        with self._cv:
            self._objects.clear()


class SharedObjectStore:
    """Shared-memory object store over `SHM_DIR` files."""

    def __init__(self, session_name: str):
        self.session_name = session_name
        self.prefix = os.path.join(SHM_DIR, f"raytpu_{session_name}_")
        # mmaps that deserialized values alias, kept open until the
        # object is deleted here.
        self._pins: Dict[ObjectID, mmap.mmap] = {}
        self._lock = threading.Lock()

    def _path(self, oid: ObjectID) -> str:
        return self.prefix + oid.hex()

    # -- writer side -----------------------------------------------------
    def create_and_seal(self, oid: ObjectID, meta: bytes, buffers,
                        total: int) -> None:
        path = self._path(oid)
        tmp = f"{path}.tmp{os.getpid()}"
        fd = os.open(tmp, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, max(total, 1))
            with mmap.mmap(fd, max(total, 1)) as mm:
                serialization.write_blob(memoryview(mm), meta, buffers)
        except BaseException:
            os.close(fd)
            os.unlink(tmp)
            raise
        os.close(fd)
        os.rename(tmp, path)  # atomic seal

    # -- reader side -----------------------------------------------------
    def contains(self, oid: ObjectID) -> bool:
        return os.path.exists(self._path(oid))

    def get(self, oid: ObjectID) -> Optional[ObjectEntry]:
        """Zero-copy read; None if the object is not sealed here. The
        mmap stays pinned until `delete`, and after that for as long as
        a value aliases it."""
        try:
            fd = os.open(self._path(oid), os.O_RDONLY)
        except FileNotFoundError:
            return None
        try:
            mm = mmap.mmap(fd, os.fstat(fd).st_size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        value = serialization.loads(memoryview(mm), zero_copy=True)
        with self._lock:
            self._pins[oid] = mm
        return ObjectEntry(value)

    def release(self, oid: ObjectID) -> None:
        """Drop this process's pin of an object (a borrower letting go of
        a value it read); the file stays for its owner to delete."""
        with self._lock:
            self._pins.pop(oid, None)

    def delete(self, oid: ObjectID) -> None:
        self.release(oid)
        try:
            os.unlink(self._path(oid))
        except FileNotFoundError:
            pass

    def cleanup_session(self) -> None:
        """Unlink every object file of this session."""
        with self._lock:
            self._pins.clear()
        for path in glob.glob(self.prefix + "*"):
            try:
                os.unlink(path)
            except OSError:
                pass

    def used_bytes(self) -> int:
        total = 0
        for path in glob.glob(self.prefix + "*"):
            try:
                total += os.stat(path).st_size
            except OSError:
                pass
        return total
