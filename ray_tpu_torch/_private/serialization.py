"""The port's own copy of three parts of
`ray_tpu/_private/serialization.py` (numpy and zlib only):

- the value serializer (`serialize`, `write_blob`, `loads`,
  `serialization.py:44-82, :357`): pickle protocol 5 with out-of-band
  buffers, so a numpy array is written into a blob (a `/dev/shm` file
  of the object store) and read back as a zero-copy view of the blob.
  The reference pickles with cloudpickle; the port uses plain `pickle`,
  which pickles functions and classes BY REFERENCE: a worker process
  imports them by module and name (it starts with the driver's
  `sys.path`). A lambda, a closure, a nested function or anything
  defined in `__main__` cannot be imported by a worker, and fails to
  serialize at submission with an error that names it;

- the wire codec's ids, `_codec_compress` and `wire_decode`
  (`serialization.py:150-190`). The reference compresses with lz4 where
  it is importable and with zlib at level 1 otherwise; the port never
  imports lz4 and always takes the zlib branch, so the weight plane's
  compressed int8 bytes equal the JAX package's wherever that finds no
  lz4 either;
- the q8 block codec: the quantizer and its inverse, the reference
  arithmetic that the weight plane's deltas use and that the gradient
  exchange's encode (`parallel/collectives.py`, kernel K6a) reproduces
  bit for bit. One f32 scale per `Q8_BLOCK` elements bounds the
  per-element error at max|block| / 254.

The wire codecs' stream encoder is not copied: the port's runtime runs
on one node, so no object crosses a wire between nodes.
"""

from __future__ import annotations

import io
import pickle
import struct
import types
import zlib
from typing import List, Tuple

import numpy as np

# ---------------------------------------------------------------------
# Value blobs.
#   u32 version | u64 meta_len | meta (pickle bytes)
#   | u32 nbuf | nbuf * (u64 offset, u64 len) | padding | buffer data...
# Buffer offsets are 64-byte aligned.
# ---------------------------------------------------------------------
_VERSION = 1
_HDR = struct.Struct("<IQ")
_BUFHDR = struct.Struct("<I")
_BUFENT = struct.Struct("<QQ")
_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class _ByReferencePickler(pickle.Pickler):
    """Plain pickle that refuses, by name, a function or class that a
    worker process could not import: one defined in `__main__` (the
    worker's `__main__` is its own entry point). Lambdas and local
    objects already fail in `pickle` itself."""

    def reducer_override(self, obj):
        if isinstance(obj, (types.FunctionType, type)) and \
                getattr(obj, "__module__", None) == "__main__":
            raise pickle.PicklingError(
                f"{obj.__qualname__!r} is defined in __main__, which a "
                "worker process cannot import")
        return NotImplemented


def _dumps(value, buffer_callback=None) -> bytes:
    out = io.BytesIO()
    try:
        _ByReferencePickler(out, protocol=5,
                            buffer_callback=buffer_callback).dump(value)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"cannot send {type(value).__name__} value to a worker "
            f"process: {e}. The port pickles functions and classes by "
            "reference (plain pickle): define them at module level in a "
            "module on sys.path, not as a lambda, a closure or in "
            "__main__") from e
    return out.getvalue()


def serialize(value) -> Tuple[bytes, List[pickle.PickleBuffer], int]:
    """Returns (meta, buffers, total_blob_size)."""
    buffers: List[pickle.PickleBuffer] = []
    meta = _dumps(value, buffer_callback=buffers.append)
    total = _HDR.size + len(meta) + _BUFHDR.size \
        + _BUFENT.size * len(buffers)
    for buf in buffers:
        total = _align(total) + buf.raw().nbytes
    return meta, buffers, total


def write_blob(dst: memoryview, meta: bytes,
               buffers: List[pickle.PickleBuffer]) -> int:
    """Write the blob into `dst` (a writable buffer). Returns bytes
    written."""
    pos = 0
    _HDR.pack_into(dst, pos, _VERSION, len(meta))
    pos += _HDR.size
    dst[pos:pos + len(meta)] = meta
    pos += len(meta)
    _BUFHDR.pack_into(dst, pos, len(buffers))
    pos += _BUFHDR.size
    entry_pos = pos
    pos += _BUFENT.size * len(buffers)
    for buf in buffers:
        mv = buf.raw()
        pos = _align(pos)
        _BUFENT.pack_into(dst, entry_pos, pos, mv.nbytes)
        entry_pos += _BUFENT.size
        if mv.nbytes:
            dst[pos:pos + mv.nbytes] = mv.cast("B")
        pos += mv.nbytes
    return pos


def dumps(value) -> bytes:
    """One standalone blob (the inline path of small values)."""
    meta, buffers, total = serialize(value)
    out = bytearray(total)
    write_blob(memoryview(out), meta, buffers)
    return bytes(out)


def loads(blob, zero_copy: bool = True):
    """Deserialize a blob (bytes or memoryview). With zero_copy=True the
    returned numpy arrays may alias `blob`'s memory; the caller keeps
    the backing storage alive (the object store pins its mmaps)."""
    mv = memoryview(blob)
    version, meta_len = _HDR.unpack_from(mv, 0)
    if version != _VERSION:
        raise ValueError(f"bad blob version {version}")
    pos = _HDR.size
    meta = mv[pos:pos + meta_len]
    pos += meta_len
    (nbuf,) = _BUFHDR.unpack_from(mv, pos)
    pos += _BUFHDR.size
    bufs = []
    for i in range(nbuf):
        off, ln = _BUFENT.unpack_from(mv, pos + i * _BUFENT.size)
        view = mv[off:off + ln]
        if not zero_copy:
            view = bytes(view)
        bufs.append(pickle.PickleBuffer(view))
    return pickle.loads(meta, buffers=bufs)

# ---------------------------------------------------------------------
# Wire codec: every compressed buffer carries its codec id.
# ---------------------------------------------------------------------
WIRE_RAW = 0
WIRE_ZLIB = 1
WIRE_LZ4 = 2

WIRE_CODEC_ID = WIRE_ZLIB


def _codec_compress(data) -> bytes:
    return zlib.compress(data, 1)


def wire_decode(codec: int, payload):
    """Inverse of the encode; dispatches on the codec id the buffer
    carries. RAW payloads pass through unchanged."""
    if codec == WIRE_RAW:
        return payload
    if codec == WIRE_ZLIB:
        return zlib.decompress(payload)
    if codec == WIRE_LZ4:
        raise ValueError("an lz4 payload: the port decodes zlib only "
                         "(it does not use the lz4 package)")
    raise ValueError(f"unknown wire codec {codec}")


# ---------------------------------------------------------------------
# q8 block quantization.
# ---------------------------------------------------------------------

Q8_BLOCK = 1024
# Positive floor for per-block scales: an all-zero block has amax 0, and
# a zero scale would turn 0/0 into NaN. Zero blocks still reconstruct to
# exactly 0.0 (q == 0 either way).
Q8_SCALE_EPS = 1e-30


def q8_quantize(vec):
    """f32[n] -> (q int8[n], scales f32[ceil(n/Q8_BLOCK)])."""
    vec = np.ascontiguousarray(vec, dtype=np.float32)
    n = vec.size
    nb = max(1, -(-n // Q8_BLOCK))
    padded = np.zeros(nb * Q8_BLOCK, np.float32)
    padded[:n] = vec
    blocks = padded.reshape(nb, Q8_BLOCK)
    scales = np.maximum(np.abs(blocks).max(axis=1) / 127.0,
                        Q8_SCALE_EPS).astype(np.float32)
    q = np.clip(np.rint(blocks / scales[:, None]), -127, 127) \
        .astype(np.int8)
    return q.reshape(-1)[:n].copy(), scales


def q8_dequantize(q, scales):
    """Inverse of q8_quantize: one f32 multiply per element, the same
    reconstruction every receiver uses."""
    q = np.asarray(q, np.int8)
    n = q.size
    out = q.astype(np.float32)
    out *= np.repeat(np.asarray(scales, np.float32), Q8_BLOCK)[:n]
    return out
