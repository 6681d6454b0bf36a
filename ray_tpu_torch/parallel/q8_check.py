"""K6a and K6b against their plain versions on a card.

The comparison that `chip_smoke.py` phase 2 and the `gpu` tests of
`tests/test_torch_kernels.py` share: the same inputs through the kernel
wrapper and through the plain version on the same device, held equal
bit for bit (codes, scales, residuals, sums; K6b with a model's leaf
table also against the packed sum indexed by the plan). Inputs are made with
numpy from a seed, block by block, so one buffer covers the edge cases
of `tests/test_collectives.py:30-96` (all-zero blocks, zero blocks next
to live ones, single-element tails, values near and below the float32
normal floor) beside exactly-halfway values and live blocks of
different magnitudes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.convert import flax_leaf_table, flax_pack_plan
from . import collectives
from .collectives import Q8_BLOCK

KINDS = ("live", "zero", "tail", "tiny", "half")


def packed_case(nb: int, seed: int, edge: bool = True):
    """(gradient, residual) f32 numpy [nb * Q8_BLOCK]. With `edge`, block
    b is of kind KINDS[b % 5]; without, every block is live."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((nb, Q8_BLOCK))
         * np.exp2(rng.integers(-12, 4, (nb, 1)))).astype(np.float32)
    ef = (rng.standard_normal((nb, Q8_BLOCK)) * 1e-3).astype(np.float32)
    if edge:
        for b in range(nb):
            kind = KINDS[b % len(KINDS)]
            if kind == "zero":
                g[b] = 0.0
                ef[b] = 0.0
            elif kind == "tail":  # a leaf's last, padded block
                keep = 1 + (b * 37) % Q8_BLOCK
                g[b, keep:] = 0.0
                ef[b, keep:] = 0.0
            elif kind == "tiny":
                g[b] = rng.choice(np.asarray(
                    [1e-38, -1e-40, 1e-37, 0.0], np.float32), Q8_BLOCK)
                ef[b] = 0.0
            elif kind == "half":  # scale 1: v / scale lands on .5
                g[b] = (rng.integers(-127, 127, Q8_BLOCK)
                        + 0.5).astype(np.float32)
                g[b, 0] = 127.0
                ef[b] = 0.0
    return g.reshape(-1), ef.reshape(-1)


def check_encode(nb: int, seed: int, device="cuda", edge: bool = True):
    """K6a vs `_q8_encode_ef_plain` on one packed buffer: the wire images
    and the new residuals equal. Returns (inputs on the device, the max
    absolute difference of the residuals, 0 when they pass)."""
    g_np, ef_np = packed_case(nb, seed, edge)
    g = torch.from_numpy(g_np).to(device)
    ef_kernel = torch.from_numpy(ef_np).to(device)
    ef_plain = ef_kernel.clone()
    wire_kernel = collectives.q8_encode_ef(g, ef_kernel)
    wire_plain = torch.empty_like(wire_kernel)
    collectives._q8_encode_ef_plain(g, ef_plain, wire_plain)
    if g.is_cuda:
        torch.cuda.synchronize()
    if not (torch.equal(wire_kernel, wire_plain)
            and torch.equal(ef_kernel, ef_plain)):
        codes_k, scales_k = collectives.wire_views(wire_kernel, nb)
        codes_p, scales_p = collectives.wire_views(wire_plain, nb)
        raise AssertionError(
            f"q8_encode_ef differs from plain at nb={nb} seed={seed}: "
            f"{int((codes_k != codes_p).sum())} codes, "
            f"{int((scales_k != scales_p).sum())} scales, "
            f"{int((ef_kernel != ef_plain).sum())} residuals")
    err = float((ef_kernel - ef_plain).abs().max())
    return (g, torch.from_numpy(ef_np).to(device)), err


def gathered_case(world: int, nb: int, seed: int, device="cuda"):
    """`world` senders' wire images [world, wire_size(nb)] on the
    device, each the plain encode of its own edge-case buffer."""
    images = []
    for s in range(world):
        g_np, ef_np = packed_case(nb, seed + s)
        wire = torch.empty(collectives.wire_size(nb), dtype=torch.uint8,
                           device=device)
        collectives._q8_encode_ef_plain(
            torch.from_numpy(g_np).to(device),
            torch.from_numpy(ef_np).to(device), wire)
        images.append(wire)
    return torch.stack(images)


def check_gather_sum(world: int, nb: int, mean: bool, seed: int,
                     device="cuda"):
    """K6b vs `_q8_gather_sum_plain` on `world` senders' images: the
    sums equal bit for bit. Returns (the gathered images, 0.0)."""
    gathered = gathered_case(world, nb, seed, device)
    got = collectives.q8_gather_sum(gathered, nb, mean)
    want = collectives._q8_gather_sum_plain(gathered, nb, mean)
    if gathered.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"q8_gather_sum differs from plain at D={world} nb={nb} "
            f"mean={mean}: {int((got != want).sum())} elements, max "
            f"{float((got - want).abs().max())}")
    return gathered, float((got - want).abs().max())


def check_gather_sum_unpack(model, world: int, mean: bool, seed: int,
                            device="cuda"):
    """K6b with `model`'s leaf table (`Q8Decode`) vs its plain version
    (`_q8_gather_sum_unpack_plain`) and vs the packed-order K6b indexed
    by the plan's `unpack_index`, on `world` senders' images: equal bit
    for bit. Returns (the decode, the gathered images, 0.0)."""
    plan = flax_pack_plan(model, Q8_BLOCK)
    table = flax_leaf_table(model, Q8_BLOCK)
    gathered = gathered_case(world, plan.nb, seed, device)
    decode = collectives.Q8Decode(table, plan.nb, device)
    got = decode(gathered, mean).clone()
    want = collectives._q8_gather_sum_unpack_plain(gathered, plan.nb, mean,
                                                   table)
    indexed = collectives.q8_gather_sum(gathered, plan.nb, mean)[
        plan.unpack_index.to(gathered.device)]
    if gathered.is_cuda:
        torch.cuda.synchronize()
    for name, other in (("plain", want), ("the packed sum indexed", indexed)):
        if not torch.equal(got, other):
            raise AssertionError(
                f"q8_gather_sum_unpack differs from {name} at D={world} "
                f"nb={plan.nb} mean={mean}: {int((got != other).sum())} "
                f"elements, max {float((got - other).abs().max())}")
    return decode, gathered, float((got - want).abs().max())


def gather_sum_unpack_bytes(world: int, nb: int, numel: int) -> int:
    """What K6b with the leaf table must move: every sender's codes of the
    `numel` real elements and its scales read, the sum written."""
    return world * (numel + 4 * nb) + 4 * numel


def encode_bytes(nb: int) -> int:
    """What K6a must move: the gradient and the residual read, the codes,
    the residual and the scales written."""
    n = nb * Q8_BLOCK
    return 4 * n + 4 * n + n + 4 * n + 4 * nb


def encode_ops(nb: int) -> int:
    """f32 operations of K6a: per element add, abs, max, divide, round,
    two clamps, multiply, subtract; per block one divide and a clamp."""
    return 9 * nb * Q8_BLOCK + 2 * nb


def gather_sum_bytes(world: int, nb: int) -> int:
    """What K6b must move: every sender's codes and scales read, the sum
    written."""
    return world * (nb * Q8_BLOCK + 4 * nb) + 4 * nb * Q8_BLOCK


def gather_sum_ops(world: int, nb: int, mean: bool) -> int:
    """A convert, a multiply and an add per sender per element, and a
    divide per element for a mean."""
    return (3 * world + int(mean)) * nb * Q8_BLOCK
