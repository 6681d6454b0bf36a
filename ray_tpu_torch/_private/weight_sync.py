"""The weight-sync delta plane: versioned, quantized, shard-aware.

The port's own copy of `ray_tpu/_private/weight_sync.py`. A weight
broadcast is a protocol, not a blob copy:

- **Versioned payloads.** Each sync carries ``(version, base_version)``.
  A receiver applies a delta only if its held base matches
  ``base_version``; otherwise it reports ``stale`` and the sender falls
  back to a full payload (the weight-version handshake).
- **q8 deltas with error feedback.** Delta payloads are int8
  block-quantized (`serialization.q8_quantize`) against the
  *receiver-view* base, so the quantization error of one sync is
  carried into the next: receivers track the true weights to within
  one sync's quantization step.
- **Entropy coding on top.** The int8 plane runs through the wire codec
  (zlib) when that shrinks it (counted in ``nbytes``).
- **Sharding.** With ``shard_count=S`` the flattened f32 parameter
  vector splits into S equal element ranges (`spec_layout.shard_bounds`)
  that encode and apply independently.

Sender and receiver reconstruct with identical f32 arithmetic
(`serialization.q8_dequantize`), so the sender's mirror of every
receiver's base is bit-exact.

The reference flattens a weights pytree with `jax.tree`; the port walks
nested dicts (and lists and tuples) of numpy arrays in the order
`jax.tree.leaves` walks them: dict keys sorted, `None` holding no leaf.
The same dict gives the same vector, aux leaves and payloads in both
packages. A policy's weights here are its flat
``{state_dict key: array}`` (`TorchPolicy.get_weights`).

Metrics (per sync, sender side; `_private/metrics.py`):
``weight_sync_bytes``, ``weight_sync_codec.<full|q8_delta>``,
``weight_sync_ms`` and ``weight_sync_payload_bytes``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import metrics, serialization
from .spec_layout import shard_bounds

CODEC_FULL = "full"
CODEC_Q8_DELTA = "q8_delta"


def resolve_codec(codec: Optional[str]) -> str:
    """Map a config value ("auto" / None / explicit) to a codec name.

    The port's only runtime is local mode, which hands payloads over by
    reference: no byte crosses a wire, so a q8 delta saves nothing and
    costs a host encode and exact weights. "auto" is therefore the full
    codec until the port has a multi-process runtime; q8_delta is an
    explicit choice."""
    if codec in (None, "auto"):
        codec = CODEC_FULL
    if codec not in (CODEC_FULL, CODEC_Q8_DELTA):
        raise ValueError(
            f"unknown weight codec {codec!r}; known: "
            f"{CODEC_FULL!r}, {CODEC_Q8_DELTA!r}")
    return codec


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple in `jax.tree.leaves`'
    order: dict keys sorted, sequences in order, `None` empty."""
    out: list = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(tree)
    return out


def _rebuild(template, leaves):
    """`template`'s structure with its leaves taken, in `tree_leaves`'
    order, from the iterator `leaves`."""
    if template is None:
        return None
    if isinstance(template, dict):
        values = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: values[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _flatten(tree) -> Tuple[np.ndarray, list, list]:
    """tree -> (f32 concat vec, aux [(leaf_idx, ndarray)], leaves).

    f32 leaves pack into the vector (the quantizable plane); every other
    leaf (int steps, f64 oddballs) rides in ``aux`` verbatim.
    """
    leaves = tree_leaves(tree)
    packs, aux = [], []
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        if arr.dtype == np.float32:
            packs.append(arr.reshape(-1))
        else:
            aux.append((i, arr))
    vec = np.concatenate(packs) if packs else np.zeros(0, np.float32)
    return vec, aux, leaves


def _unflatten(template, vec: np.ndarray, aux) -> object:
    """Rebuild a tree shaped like ``template`` from the f32 vector and
    the aux leaves."""
    aux_map = dict(aux)
    out, pos = [], 0
    for i, leaf in enumerate(tree_leaves(template)):
        arr = np.asarray(leaf)
        if arr.dtype == np.float32:
            n = arr.size
            out.append(vec[pos:pos + n].reshape(arr.shape).copy())
            pos += n
        else:
            out.append(aux_map.get(i, arr))
    return _rebuild(template, iter(out))


def flatten_f32(tree) -> Tuple[np.ndarray, list]:
    vec, aux, _ = _flatten(tree)
    return vec, aux


def unflatten_f32(template, vec: np.ndarray, aux) -> object:
    return _unflatten(template, vec, aux)


def _maybe_compress(raw: bytes) -> Tuple[int, bytes]:
    """Entropy-code the int8 plane when it shrinks by more than rounding
    noise (error-fed deltas concentrate near zero)."""
    comp = serialization._codec_compress(raw)
    if len(comp) < 0.98 * len(raw):
        return serialization.WIRE_CODEC_ID, comp
    return serialization.WIRE_RAW, bytes(raw)


class WeightSyncPayload:
    """One sync message. ``codec=full`` carries the whole tree;
    ``codec=q8_delta`` carries one shard's quantized delta against
    ``base_version``."""

    __slots__ = ("version", "base_version", "codec", "shard_index",
                 "shard_count", "tree", "start", "stop", "scales",
                 "q_codec", "q", "aux", "nbytes")

    def __init__(self, version: int, base_version: Optional[int],
                 codec: str, shard_index: int = 0, shard_count: int = 1,
                 tree=None, start: int = 0, stop: int = 0, scales=None,
                 q_codec: int = 0, q=None, aux=None, nbytes: int = 0):
        self.version = version
        self.base_version = base_version
        self.codec = codec
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.tree = tree            # full payloads only
        self.start = start          # delta payloads: vec slice bounds
        self.stop = stop
        self.scales = scales
        self.q_codec = q_codec
        self.q = q                  # int8 bytes (possibly compressed)
        self.aux = aux or []
        self.nbytes = nbytes

    def __repr__(self):
        return (f"WeightSyncPayload(v{self.version}"
                f"<-{self.base_version} {self.codec} "
                f"shard {self.shard_index}/{self.shard_count} "
                f"{self.nbytes}B)")


def _tree_nbytes(tree) -> int:
    return int(sum(np.asarray(leaf).nbytes for leaf in tree_leaves(tree)))


class WeightSyncEncoder:
    """Sender side. Owns the version counter, the canonical receiver-view
    base vector, and the error-feedback residual."""

    def __init__(self, codec: str = "auto", shard_count: int = 1):
        self.codec = resolve_codec(codec)
        self.shard_count = max(1, int(shard_count))
        self.version = 0
        self._base: Optional[np.ndarray] = None   # receiver-view vec
        self._residual: Optional[np.ndarray] = None
        self._template = None                     # last weights tree
        self._full_cache: Optional[List[WeightSyncPayload]] = None

    @property
    def base(self) -> Optional[np.ndarray]:
        """The receiver-view vector at the current version: what every
        receiver that applied this version holds (bit for bit)."""
        return self._base

    @property
    def weights(self):
        """The weights tree the current version encoded."""
        return self._template

    # ------------------------------------------------------------------
    def encode(self, weights) -> List[WeightSyncPayload]:
        """One sync: bumps the version and returns `shard_count`
        payloads (deltas when a base exists and the codec allows,
        otherwise full). Records per-sync metrics."""
        t0 = time.perf_counter()
        self.version += 1
        self._full_cache = None
        vec, aux, _ = _flatten(weights)
        self._template = weights
        if (self.codec != CODEC_Q8_DELTA or self._base is None
                or self._base.size != vec.size):
            out = self._encode_full(weights, vec)
        else:
            out = self._encode_delta(vec, aux)
        self._note_metrics(out, time.perf_counter() - t0)
        return out

    def _encode_full(self, weights, vec) -> List[WeightSyncPayload]:
        self._base = vec.copy()
        self._residual = np.zeros_like(vec)
        # Full payloads are not sharded: every receiver needs the whole
        # tree to (re)establish a base.
        return [WeightSyncPayload(
            self.version, None, CODEC_FULL, shard_index=0,
            shard_count=1, tree=weights, nbytes=_tree_nbytes(weights))]

    def _encode_delta(self, vec, aux) -> List[WeightSyncPayload]:
        # Error feedback in receiver-view parameterization: the base IS
        # the receiver's reconstruction, so (vec - base) already carries
        # every previously unshipped quantization residual.
        adj = vec - self._base
        out = []
        recon = self._base.copy()
        for s, (start, stop) in enumerate(
                shard_bounds(vec.size, self.shard_count)):
            q, scales = serialization.q8_quantize(adj[start:stop])
            recon[start:stop] += serialization.q8_dequantize(q, scales)
            q_codec, q_bytes = _maybe_compress(q.tobytes())
            nbytes = (len(q_bytes) + scales.nbytes
                      + sum(a.nbytes for _, a in aux) + 64)
            out.append(WeightSyncPayload(
                self.version, self.version - 1, CODEC_Q8_DELTA,
                shard_index=s, shard_count=self.shard_count,
                start=start, stop=stop, scales=scales,
                q_codec=q_codec, q=q_bytes,
                aux=aux if s == 0 else [], nbytes=nbytes))
        self._residual = vec - recon
        self._base = recon
        return out

    def full_payloads(self) -> List[WeightSyncPayload]:
        """The fallback: the CANONICAL weights at the current version
        (the receiver-view base, so a stale receiver rejoins the exact
        stream every delta receiver is on). Cached per version."""
        if self.version == 0 or self._template is None:
            raise RuntimeError("no sync encoded yet")
        if self._full_cache is None:
            _, aux, _ = _flatten(self._template)
            tree = _unflatten(self._template, self._base, aux)
            self._full_cache = [WeightSyncPayload(
                self.version, None, CODEC_FULL, tree=tree,
                nbytes=_tree_nbytes(tree))]
        return self._full_cache

    @staticmethod
    def _note_metrics(payloads, dt: float) -> None:
        total = sum(p.nbytes for p in payloads)
        metrics.inc("weight_sync_bytes", total)
        metrics.inc(f"weight_sync_codec.{payloads[0].codec}")
        metrics.set_gauge("weight_sync_ms", 1e3 * dt)
        metrics.set_gauge("weight_sync_payload_bytes", total)


class WeightSyncDecoder:
    """Receiver side. Holds the base (vector + tree template) and the
    applied version; rejects deltas whose base_version mismatches."""

    def __init__(self):
        self.version = 0
        self._vec: Optional[np.ndarray] = None
        self._template = None
        self._pending: Dict[int, set] = {}
        self._pending_aux: list = []

    def apply(self, payload: WeightSyncPayload):
        """Returns (weights_or_None, status). Status is "ok" (weights
        returned), "partial" (shard applied, more shards outstanding),
        "dup" (already applied), or "stale" (base mismatch: the caller
        should request a full sync)."""
        if payload.codec == CODEC_FULL:
            vec, _, _ = _flatten(payload.tree)
            self._vec = vec
            self._template = payload.tree
            self.version = payload.version
            self._pending.clear()
            return payload.tree, "ok"
        if self._vec is None or payload.base_version != self.version:
            return None, "stale"
        shards = self._pending.setdefault(payload.version, set())
        if payload.shard_index in shards:
            return None, "dup"
        q = np.frombuffer(
            serialization.wire_decode(payload.q_codec, payload.q), np.int8)
        self._vec[payload.start:payload.stop] += \
            serialization.q8_dequantize(q, payload.scales)
        shards.add(payload.shard_index)
        if payload.aux:
            self._pending_aux = payload.aux
        if len(shards) < payload.shard_count:
            return None, "partial"
        self.version = payload.version
        self._pending.clear()  # incl. any abandoned partial versions
        tree = _unflatten(self._template, self._vec, self._pending_aux)
        self._template = tree
        self._pending_aux = []
        return tree, "ok"

    def reset(self) -> None:
        """Forget the base (a raw-dict set_weights leaves the versioned
        stream)."""
        self.version = 0
        self._vec = None
        self._template = None
        self._pending.clear()
