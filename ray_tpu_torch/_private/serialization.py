"""The port's own copy of the q8 block codec of
`ray_tpu/_private/serialization.py` (numpy only), trimmed to the
quantizer and its inverse: the reference arithmetic that the gradient
exchange's encode (`parallel/collectives.py`, kernel K6a) reproduces
bit for bit.

One f32 scale per `Q8_BLOCK` elements bounds the per-element error at
max|block| / 254.
"""

from __future__ import annotations

import numpy as np

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
