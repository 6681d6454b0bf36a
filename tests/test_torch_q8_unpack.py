"""K6b with the leaf table (the exchange's sum in `parameters()` order)
on the CPU.

- `flax_leaf_table` reproduces `flax_pack_plan(...).unpack_index`
  exactly for the Nature CNN, the CartPole FC net, PPO Pendulum's FC
  net (with `free_log_std`) and SAC's actor and twin critics; the
  kernel's grid (`q8_unpack_tiles`), emulated in numpy with the kernel's
  index arithmetic, writes every output exactly once, from its packed
  position.
- The plain fused gather-sum equals `_q8_gather_sum_plain(...)
  [unpack_index]` bit for bit at D = 1, 2 and 4, with and without the
  mean, and `Q8Decode` (the policy's decode) returns it on the CPU.
- Leaf by leaf it equals the JAX package's `q8_decode` summed over the
  senders in rank order (numpy-seeded gradients), bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import collectives as jax_collectives
from ray_tpu_torch.models import catalog
from ray_tpu_torch.models.convert import (flax_leaf_table, flax_leaves,
                                          flax_pack_plan, unpack_leaves)
from ray_tpu_torch.models.networks import (ContinuousQNetwork,
                                           StochasticActor)
from ray_tpu_torch.parallel import collectives, q8_check
from ray_tpu_torch.rllib.env.spaces import Box

B = collectives.Q8_BLOCK


def _model(name):
    if name == "nature_cnn":
        return catalog.get_model(Box(0, 255, (84, 84, 4), np.uint8), 6, {})
    if name == "small_cnn":
        return catalog.get_model(Box(0, 255, (42, 42, 4), np.uint8), 6,
                                 {"conv_filters": [[8, 8, 4], [16, 4, 2]]})
    if name == "cartpole_fc":
        return catalog.get_model(Box(-1.0, 1.0, (4,)), 2, {})
    if name == "pendulum_fc":
        return catalog.get_model(Box(-1.0, 1.0, (3,)), 2,
                                 {"free_log_std": True})
    if name == "sac_actor":
        return StochasticActor(3, 1)
    if name == "sac_critic":
        return ContinuousQNetwork(3, 1, twin=True)
    raise ValueError(name)


MODELS = ["nature_cnn", "cartpole_fc", "pendulum_fc", "sac_actor",
          "sac_critic"]


@pytest.mark.parametrize("name", MODELS)
def test_leaf_table_reproduces_unpack_index(name):
    model = _model(name)
    plan = flax_pack_plan(model, B)
    table = flax_leaf_table(model, B)
    assert [leaf.numel for leaf in table] == [p.numel() for p in
                                               model.parameters()]
    got = unpack_leaves(torch.arange(plan.nb * B), table)
    assert torch.equal(got, plan.unpack_index)


THREADS = 256  # the unpacking kernel's block


def _emulate_tiles(tiles):
    """The unpacking kernel's index arithmetic (csrc/q8.cu), per block and
    per path (char4 or single-code loads, float4 or scalar stores):
    {output index: [packed positions it was written from]}."""
    written = {}
    k = np.arange(THREADS)[:, None] + THREADS * np.arange(
        collectives.UNPACK_TILE // THREADS)[None, :]
    k = k.T.reshape(-1)  # every (thread, step) once
    for rec in tiles.tolist():
        (out0, row_len, p0, rows, log_tp, log_tr, n_rows, n_cols, r0, d23,
         d3, s1, s2, s3, flags, _) = rec
        tp, tr = 1 << log_tp, 1 << log_tr
        assert tp * tr == collectives.UNPACK_TILE
        assert 1 <= n_rows <= tp and 1 <= n_cols <= tr
        r = r0 + np.arange(n_cols)
        i1, rem = r // d23, r % d23
        prow = p0 + (i1 * s1 + (rem // d3) * s2 + (rem % d3) * s3) * rows
        tile = {}
        if flags & collectives.UNPACK_VEC_IN:
            assert rows % 4 == 0 and n_rows % 4 == 0
            kq = k[k < collectives.UNPACK_TILE // 4]
            o, j = (kq & (tp // 4 - 1)) * 4, kq >> (log_tp - 2)
            live = (o < n_rows) & (j < n_cols)
            for a, b in zip(o[live], j[live]):
                pos = prow[b] + a
                assert pos % 4 == 0 and pos // B == (pos + 3) // B
                for c in range(4):
                    assert (a + c, b) not in tile
                    tile[(a + c, b)] = pos + c
        else:
            o, j = k & (tp - 1), k >> log_tp
            live = (o < n_rows) & (j < n_cols)
            for a, b in zip(o[live], j[live]):
                assert (a, b) not in tile
                tile[(a, b)] = prow[b] + a
        assert len(tile) == n_rows * n_cols
        if flags & collectives.UNPACK_VEC_OUT:
            assert out0 % 4 == 0 and row_len % 4 == 0 and n_cols % 4 == 0
            kq = k[k < collectives.UNPACK_TILE // 4]
            j, o = (kq & (tr // 4 - 1)) * 4, kq >> (log_tr - 2)
            live = (o < n_rows) & (j < n_cols)
            cells = [(a, b + c) for a, b in zip(o[live], j[live])
                     for c in range(4)]
        else:
            j, o = k & (tr - 1), k >> log_tr
            live = (o < n_rows) & (j < n_cols)
            cells = list(zip(o[live], j[live]))
        for a, b in cells:
            written.setdefault(out0 + a * row_len + b, []).append(
                tile[(a, b)])
    return written


@pytest.mark.parametrize("name", ["small_cnn", "cartpole_fc",
                                  "pendulum_fc", "sac_critic",
                                  "nature_cnn"])
def test_unpack_tiles_write_each_output_once(name):
    model = _model(name)
    plan = flax_pack_plan(model, B)
    tiles = collectives.q8_unpack_tiles(flax_leaf_table(model, B))
    assert tiles.dtype == np.int32 and tiles.shape[1] == 16
    written = _emulate_tiles(tiles)
    n = plan.unpack_index.numel()
    assert sorted(written) == list(range(n))
    assert all(len(v) == 1 for v in written.values())
    got = np.array([written[i][0] for i in range(n)])
    np.testing.assert_array_equal(got, plan.unpack_index.numpy())


def test_unpack_tiles_of_the_nature_cnn():
    """The Nature CNN's grid: 420 tiles (one wave of 256-thread blocks on
    an H100), the dense and conv kernels in tiles of 64 rows x 64
    columns with char4 loads and float4 stores, every element counted
    once."""
    table = flax_leaf_table(_model("nature_cnn"), B)
    tiles = collectives.q8_unpack_tiles(table)
    elems = (tiles[:, 6].astype(np.int64) * tiles[:, 7]).sum()
    assert elems == sum(leaf.numel for leaf in table) == 1_687_719
    big = tiles[tiles[:, 3] >= 64]
    assert (big[:, 4] == 6).all() and (big[:, 5] == 6).all()
    assert (big[:, 14] == collectives.UNPACK_VEC_IN
            | collectives.UNPACK_VEC_OUT).all()
    assert len(tiles) == 420


def _gathered(model, world, seed):
    """`world` senders' wire images of numpy-seeded packed gradients of
    `model` (padding zero), each the plain encode with a seeded
    residual."""
    plan = flax_pack_plan(model, B)
    n = plan.unpack_index.numel()
    images = []
    rng = np.random.default_rng(seed)
    for _ in range(world):
        flat = (rng.standard_normal(n) * np.exp2(rng.integers(-8, 4))
                ).astype(np.float32)
        flat = torch.from_numpy(flat)
        packed = torch.cat([flat, flat.new_zeros(1)])[plan.pack_index]
        ef = torch.from_numpy((rng.standard_normal(plan.nb * B) * 1e-3)
                              .astype(np.float32)) * (packed != 0)
        wire = torch.empty(collectives.wire_size(plan.nb), dtype=torch.uint8)
        collectives._q8_encode_ef_plain(packed, ef, wire)
        images.append(wire)
    return plan, torch.stack(images)


@pytest.mark.parametrize("name", ["nature_cnn", "cartpole_fc"])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("mean", [False, True])
def test_fused_plain_equals_plain_then_index(name, world, mean):
    model = _model(name)
    plan, gathered = _gathered(model, world, seed=world + 7)
    table = flax_leaf_table(model, B)
    want = collectives._q8_gather_sum_plain(gathered, plan.nb,
                                            mean)[plan.unpack_index]
    got = collectives._q8_gather_sum_unpack_plain(gathered, plan.nb, mean,
                                                  table)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    decode = collectives.Q8Decode(table, plan.nb, "cpu")
    assert torch.equal(decode(gathered, mean), want)


def test_fused_gather_sum_equals_the_jax_decode():
    """Leaf by leaf: the JAX package's `q8_decode` of every sender's
    codes and scales, summed in rank order in f32 (then / D, exact at
    D = 2), against the fused sum's view of the same leaf."""
    model = _model("small_cnn")
    world = 2
    plan, gathered = _gathered(model, world, seed=3)
    codes, scales = collectives.wire_views(gathered, plan.nb)
    table = flax_leaf_table(model, B)
    for mean in (False, True):
        fused = collectives._q8_gather_sum_unpack_plain(
            gathered, plan.nb, mean, table)
        params = list(model.named_parameters())
        got = dict(zip([k for k, _ in params], fused.split(
            [p.numel() for _, p in params])))
        got = {k: v.view_as(p) for (k, p), v in zip(params, got.values())}
        slot = 0
        for layer, kind, leaf in flax_leaves(got):
            nb_leaf = -(-leaf.numel() // B)
            total = None
            for s in range(world):
                q = jnp.asarray(codes[s, slot * B:(slot + nb_leaf) * B]
                                .numpy().reshape(nb_leaf, B))
                sc = jnp.asarray(scales[s, slot:slot + nb_leaf].numpy())
                part = jax_collectives.q8_decode(q, sc, tuple(leaf.shape))
                total = part if total is None else total + part
            if mean:
                total = total / world
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(total),
                err_msg=f"{layer}.{kind} mean={mean}")
            slot += nb_leaf
        assert slot == plan.nb


def test_decode_refuses_wrong_images():
    model = _model("cartpole_fc")
    plan, gathered = _gathered(model, 2, seed=0)
    decode = collectives.Q8Decode(flax_leaf_table(model, B), plan.nb, "cpu")
    for bad in (gathered.float(), gathered[:, :-4], gathered[0],
                gathered[:0], gathered.t().contiguous().t(),
                gathered.to("meta")):
        with pytest.raises(ValueError, match="gathered wire images"):
            decode(bad, False)
    with pytest.raises(ValueError, match="no q8 gather-sum kernel"):
        collectives.Q8Decode(flax_leaf_table(model, B), plan.nb, "meta")
    with pytest.raises(ValueError, match="does not fit"):
        collectives.Q8Decode(flax_leaf_table(model, B), plan.nb - 1, "cpu")


def test_q8_check_edge_cases_through_the_fused_plain():
    """q8_check's edge-case images (zero blocks, tails, values near the
    f32 floor, exact halves) through the fused plain: each leaf equals
    the packed plain's slot, bit for bit."""
    model = _model("cartpole_fc")
    plan = flax_pack_plan(model, B)
    gathered = q8_check.gathered_case(2, plan.nb, seed=5, device="cpu")
    table = flax_leaf_table(model, B)
    for mean in (False, True):
        want = collectives._q8_gather_sum_plain(gathered, plan.nb, mean)
        got = collectives._q8_gather_sum_unpack_plain(gathered, plan.nb,
                                                      mean, table)
        assert torch.equal(got, want[plan.unpack_index])
