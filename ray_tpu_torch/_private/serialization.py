"""The port's own copy of two parts of
`ray_tpu/_private/serialization.py` (numpy and zlib only):

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

Values cross no process boundary in the local-mode runtime, so the
blob serializer of the reference is not copied.
"""

from __future__ import annotations

import zlib

import numpy as np

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
