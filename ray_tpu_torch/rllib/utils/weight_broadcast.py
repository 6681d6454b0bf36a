"""Sender-side weight-sync state machine for the optimizer broadcast
paths.

The port's own copy of `ray_tpu/rllib/utils/weight_broadcast.py`. It
wraps `_private/weight_sync.WeightSyncEncoder` with:

- one encode + one `ray_tpu_torch.put` per learner update, never per
  worker. A new version drops the refs of the one it supersedes, and
  the object store frees each old payload as soon as no `set_weights`
  call in flight holds it (its submitter pins it until the call
  returns), so the store holds about one version's bytes;
- per-worker last-shipped versions, so a worker that already holds the
  current broadcast is never re-sent it;
- delta-vs-full routing per worker: a worker whose last-shipped version
  matches the delta's base gets the (~4x smaller) delta payload; anyone
  else (new workers, workers that missed a sync) gets the full blob at
  the same version;
- the stale-base handshake: `set_weights` acks flow back through a
  `TaskPool`; a ``stale`` ack (receiver base mismatch) forgets that
  worker's version and re-ships the full payload at once.

The fleet's join and removal paths and the chaos hooks are not ported.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict

import ray_tpu_torch

from ..._private import metrics, weight_sync
from .actors import TaskPool

logger = logging.getLogger(__name__)


def _is_stale(status) -> bool:
    return isinstance(status, dict) and status.get("status") == "stale"


class WeightBroadcaster:
    def __init__(self, get_weights: Callable, codec: str = "auto"):
        self._get_weights = get_weights
        # One shard: the port's runtime runs on one node, with no wire
        # for shards to stripe over.
        self.encoder = weight_sync.WeightSyncEncoder(codec=codec)
        self._worker_versions: Dict = {}
        self._payload_refs = None
        self._base_version = None
        self._full_refs_cache = None
        self._acks = TaskPool()
        self.num_broadcasts = 0
        self.num_skipped = 0
        self.num_stale_fallbacks = 0

    # ------------------------------------------------------------------
    @property
    def version(self) -> int:
        return self.encoder.version

    def payloads(self) -> list:
        """The current version's payloads (deltas or the full blob)."""
        return ray_tpu_torch.get(list(self._payload_refs or []))

    def broadcast(self) -> None:
        """Encode the current learner weights as a new sync version (ONE
        put per update, shared by every worker)."""
        payloads = self.encoder.encode(self._get_weights())
        self._payload_refs = [ray_tpu_torch.put(p) for p in payloads]
        self._base_version = payloads[0].base_version
        self._full_refs_cache = (
            self._payload_refs if payloads[0].base_version is None
            else None)
        self.num_broadcasts += 1

    def sync(self, worker) -> bool:
        """Ship the current version to ``worker`` unless it already
        holds it. Returns True iff payloads were sent."""
        self.drain_acks()
        return self._send(worker)

    def _refs_for(self, worker):
        """The current version's delta for a worker on its base, else
        the full blob, or None when the worker already holds it."""
        v = self.encoder.version
        last = self._worker_versions.get(worker)
        if last == v:
            self.num_skipped += 1
            metrics.inc("weight_sync_skipped")
            return None
        if self._base_version is not None and last == self._base_version:
            return self._payload_refs
        return self._full_refs()

    def _send(self, worker) -> bool:
        if self.encoder.version == 0:
            return False
        refs = self._refs_for(worker)
        if refs is None:
            return False
        for ref in refs:
            self._acks.add(worker, worker.set_weights.remote(ref))
        self._worker_versions[worker] = self.encoder.version
        return True

    def _full_refs(self):
        if self._full_refs_cache is None:
            self._full_refs_cache = [
                ray_tpu_torch.put(p) for p in self.encoder.full_payloads()]
        return self._full_refs_cache

    def _note_stale(self, worker) -> None:
        self.num_stale_fallbacks += 1
        metrics.inc("weight_sync_stale_fallbacks")
        self._worker_versions.pop(worker, None)

    def drain_acks(self) -> None:
        """Process completed set_weights acks; stale receivers get an
        immediate full resync."""
        for worker, ref in self._acks.completed():
            try:
                status = ray_tpu_torch.get(ref)
            except ray_tpu_torch.RayError:
                # A dead worker: forget its version so a successor
                # starts from a full sync.
                logger.warning("weight sync to %r failed", worker,
                               exc_info=True)
                self._worker_versions.pop(worker, None)
                continue
            if _is_stale(status):
                self._note_stale(worker)
                self._send(worker)

    def sync_all_blocking(self, workers) -> None:
        """Synchronous fan-out (`WorkerSet.sync_weights`): broadcast the
        current weights, ship to every worker, wait for the acks, and
        resolve any stale handshake before returning."""
        self.broadcast()
        v = self.encoder.version
        pending: Dict = {}
        for worker in workers:
            refs = self._refs_for(worker)
            if refs is None:
                continue
            pending[worker] = [worker.set_weights.remote(r) for r in refs]
            self._worker_versions[worker] = v
        for worker, wrefs in pending.items():
            for status in ray_tpu_torch.get(wrefs):
                if _is_stale(status):
                    self._note_stale(worker)
                    ray_tpu_torch.get([worker.set_weights.remote(r)
                                       for r in self._full_refs()])
                    self._worker_versions[worker] = v

    def stats(self) -> dict:
        return {
            "weight_sync_version": self.encoder.version,
            "weight_sync_codec": self.encoder.codec,
            "num_weight_sync_skipped": self.num_skipped,
            "num_weight_sync_stale_fallbacks": self.num_stale_fallbacks,
            "num_weight_sync_tracked_workers": len(self._worker_versions),
        }
