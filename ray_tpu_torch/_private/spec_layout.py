"""Host-side shard slicing for the weight plane.

The port's own copy of `shard_bounds` from
`ray_tpu/_private/spec_layout.py:215`: the weight-sync delta plane
partitions the flattened f32 parameter vector into equal element
ranges, so shard payloads stay balanced whatever the leaves' sizes (the
Nature CNN's fc weight is ~93% of its parameters).
"""

from __future__ import annotations

from typing import List, Tuple


def shard_bounds(n: int, shard_count: int) -> List[Tuple[int, int]]:
    """Equal [start, stop) element ranges covering [0, n)."""
    shard_count = max(1, int(shard_count))
    return [(s * n // shard_count, (s + 1) * n // shard_count)
            for s in range(shard_count)]
