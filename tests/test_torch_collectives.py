"""Port parity: the q8 gradient exchange (`ray_tpu_torch/parallel/`).

- The encode's plain version (the CPU side of kernel K6a) against the
  JAX package's numpy `q8_quantize`, bit for bit, on the JAX test's edge
  cases (`tests/test_collectives.py:30-96`) and on seeded vectors.
- The exchange of a 4-rank gloo world against `psum_quantized` inside a
  `shard_map` over a 4-device JAX mesh on identical per-replica inputs:
  codes, scales and residuals equal, sums within D ulps of the largest
  term; the fp32 psum likewise; the 100-step error-feedback drift; the
  byte accounting; the wrappers' refusals.

One world is spawned for all the exchange checks (a module fixture):
each spawn costs seconds.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dp_ranks
from ray_tpu._private import serialization
from ray_tpu.parallel import collectives as jax_collectives
from ray_tpu.parallel import mesh as mesh_lib
from ray_tpu_torch._private import serialization as port_serialization
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.distributed import launch

B = serialization.Q8_BLOCK
D = 4
# Leaves of the exchanged tree in flax (sorted-key) order: a ragged
# tail, a whole block, a single element, an all-zero leaf, values near
# the float32 floor.
LEAVES = {"a": (3000,), "b": (2, 1024), "c": (1,), "d": (1500,),
          "e": (5,)}
EF_STEPS = 100


def _packed(v):
    """Pad a flat f32 vector to whole blocks (zeros)."""
    v = np.asarray(v, np.float32).reshape(-1)
    out = np.zeros(-(-v.size // B) * B, np.float32)
    out[:v.size] = v
    return out


def _encode(v, ef=None):
    """The port's plain encode of a flat vector: (codes[:n], scales,
    residual[:n], decoded[:n], wire)."""
    g = torch.from_numpy(_packed(v))
    e = torch.zeros_like(g) if ef is None else torch.from_numpy(_packed(ef))
    wire = collectives.q8_encode_ef(g, e)
    codes, scales = collectives.wire_views(wire, g.numel() // B)
    decoded = collectives.q8_decode(codes, scales)
    n = np.asarray(v).size
    return (codes.numpy()[:n], scales.numpy(), e.numpy()[:n],
            decoded.numpy()[:n], wire)


def _edge_vectors():
    rng = np.random.default_rng(3)
    vecs = [np.zeros(n, np.float32) for n in (1, 7, B, 3 * B + 5)]
    mixed = np.zeros(2 * B, np.float32)
    mixed[B:] = np.linspace(-1.0, 1.0, B, dtype=np.float32)
    vecs.append(mixed)
    vecs += [rng.standard_normal(n).astype(np.float32)
             for n in (1, 2, B + 1, 2 * B + 17)]
    vecs.append(np.full(5, 1e-38, np.float32))  # denormal-sized
    # Values exactly halfway between codes: round half to even.
    half = np.arange(-127, 128, dtype=np.float32) + 0.5
    half[-1] = 127.0
    vecs.append(half)
    return vecs


@pytest.mark.parametrize("case", range(11))
def test_plain_encode_matches_numpy_q8_quantize(case):
    vec = _edge_vectors()[case]
    codes, scales, residual, decoded, _ = _encode(vec)
    want_q, want_s = serialization.q8_quantize(vec)
    np.testing.assert_array_equal(codes, want_q)
    np.testing.assert_array_equal(scales, want_s)
    assert np.all(scales > 0) and np.all(np.isfinite(scales))
    # Decode is one f32 multiply: the numpy reconstruction exactly, and
    # the residual is v - decode(q) exactly.
    np.testing.assert_array_equal(
        decoded, serialization.q8_dequantize(want_q, want_s))
    np.testing.assert_array_equal(residual, vec - decoded)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_encode_adds_the_residual(seed):
    """v = g + err, then the codec: as numpy quantizing the f32 sum."""
    rng = np.random.default_rng(seed)
    n = 5000
    g = rng.standard_normal(n).astype(np.float32)
    err = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    codes, scales, residual, _, _ = _encode(g, err)
    v = g + err
    want_q, want_s = serialization.q8_quantize(v)
    np.testing.assert_array_equal(codes, want_q)
    np.testing.assert_array_equal(scales, want_s)
    np.testing.assert_array_equal(
        residual, v - serialization.q8_dequantize(want_q, want_s))


def test_port_codec_copy_is_the_reference():
    vec = np.random.default_rng(9).standard_normal(3 * B + 7).astype(
        np.float32)
    for got, want in zip(port_serialization.q8_quantize(vec),
                         serialization.q8_quantize(vec)):
        np.testing.assert_array_equal(got, want)
    assert port_serialization.Q8_BLOCK == serialization.Q8_BLOCK
    assert port_serialization.Q8_SCALE_EPS == serialization.Q8_SCALE_EPS


def test_gather_sum_plain_sums_senders_in_order():
    rng = np.random.default_rng(4)
    nb, senders = 3, 5
    wires = []
    for _ in range(senders):
        *_, wire = _encode(rng.standard_normal(nb * B).astype(
            np.float32))
        wires.append(wire)
    gathered = torch.stack(wires)
    want = np.zeros(nb * B, np.float32)
    for wire in wires:
        codes, scales = collectives.wire_views(wire, nb)
        want = want + serialization.q8_dequantize(codes.numpy(),
                                                  scales.numpy())
    np.testing.assert_array_equal(
        collectives.q8_gather_sum(gathered, nb).numpy(), want)
    np.testing.assert_array_equal(
        collectives.q8_gather_sum(gathered, nb, mean=True).numpy(),
        want / np.float32(senders))


def test_wrappers_refuse_bad_arguments():
    g = torch.zeros(2 * B)
    with pytest.raises(ValueError, match="whole"):
        collectives.q8_encode_ef(torch.zeros(B + 1), torch.zeros(B + 1))
    with pytest.raises(ValueError, match="float32"):
        collectives.q8_encode_ef(g.double(), g.double())
    with pytest.raises(ValueError, match="residual is"):
        collectives.q8_encode_ef(g, torch.zeros(B))
    with pytest.raises(ValueError, match="contiguous"):
        collectives.q8_encode_ef(g, torch.zeros(4 * B)[::2])
    with pytest.raises(ValueError, match="aligned"):
        collectives.q8_encode_ef(torch.zeros(2 * B + 1)[1:], g)
    with pytest.raises(ValueError, match="no q8 encode kernel"):
        collectives.q8_encode_ef(g.to("meta"), g.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        collectives.q8_gather_sum(torch.zeros(2, 100, dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="uint8"):
        collectives.q8_gather_sum(
            torch.zeros(2, collectives.wire_size(2)), 2)


def test_payload_bytes_match_jax():
    tree = {k: np.zeros(s, np.float32) for k, s in LEAVES.items()}
    sizes = [int(np.prod(s)) for s in LEAVES.values()]
    for codec in ("fp32", "q8"):
        assert collectives.payload_bytes(sizes, codec) == \
            jax_collectives.payload_bytes(tree, codec)
    nb = sum(-(-n // B) for n in sizes)
    assert collectives.wire_bytes(sizes, "q8") == nb * B + 4 * nb
    assert collectives.wire_bytes(sizes, "fp32") == 4 * sum(sizes)


def test_launch_reraises_a_rank_failure_and_kills_the_rest():
    """A failing rank's exception comes back with its traceback while the
    other ranks wait in a barrier; a world past its deadline is killed
    and raises TimeoutError. Neither hangs."""
    import time
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="fails on purpose") as info:
        launch(torch_dp_ranks.failing_rank, 3, "gloo", 1, timeout=120)
    assert any("raised on rank 1 of 3" in n
               for n in getattr(info.value, "__notes__", []))
    with pytest.raises(TimeoutError, match="did not finish"):
        launch(torch_dp_ranks.sleeping_rank, 2, "gloo", 600, timeout=5)
    assert time.monotonic() - t0 < 100


def test_launch_reraises_the_cause_before_the_others_failures():
    """The failing rank's report reaches the launcher before the
    failures its exit causes on the other ranks (their barrier fails
    once its connections close), however long it takes to leave."""
    with pytest.raises(ValueError, match="fails on purpose") as info:
        launch(torch_dp_ranks.failing_rank_slow_to_leave, 3, "gloo", 1,
               timeout=120)
    assert any("raised on rank 1 of 3" in n
               for n in getattr(info.value, "__notes__", []))


def test_launch_reads_a_result_written_just_before_exit(monkeypatch):
    """A rank that writes a small result and exits at once while the
    launcher's wait is timing out is a finished rank, not a lost one:
    the queue is read before any rank is called lost. The first wait of
    each launch here returns nothing until a result has landed and its
    rank has exited (`LateResults`), three launches in a row."""
    import multiprocessing as mp
    real_get_context = mp.get_context

    class Context:
        def __init__(self, method):
            self._ctx = real_get_context(method)
            self.Process = self._ctx.Process

        def Queue(self):
            return torch_dp_ranks.LateResults(self._ctx)

    monkeypatch.setattr(mp, "get_context", Context)
    for _ in range(3):
        assert launch(torch_dp_ranks.quick_rank, 2, "gloo",
                      timeout=120) == [0, 1]


def test_pad_to_multiple():
    from ray_tpu_torch.parallel.mesh import pad_to_multiple
    assert [pad_to_multiple(n, 4) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]


def test_resolve_codec(monkeypatch):
    monkeypatch.delenv(collectives.CODEC_ENV, raising=False)
    assert collectives.resolve_codec("auto") == "fp32"
    monkeypatch.setenv(collectives.CODEC_ENV, "q8")
    assert collectives.resolve_codec("auto") == "q8"
    assert collectives.resolve_codec("fp32") == "fp32"
    with pytest.raises(ValueError):
        collectives.resolve_codec("int4")


# ---------------------------------------------------------------------
# a 4-rank gloo world against a 4-device JAX mesh
# ---------------------------------------------------------------------
def _inputs():
    rng = np.random.default_rng(11)
    grads, efs = {}, {}
    for k, shape in LEAVES.items():
        g = rng.standard_normal((D,) + shape).astype(np.float32)
        if k == "d":
            g[:] = 0.0
        if k == "e":
            g *= np.float32(1e-37)
        grads[k] = g
        efs[k] = (rng.standard_normal((D,) + shape) * 1e-3).astype(
            np.float32)
        if k in ("d", "e"):
            efs[k][:] = 0.0
    return grads, efs


def _pack_replicas(tree):
    return np.stack([np.concatenate([_packed(tree[k][r]) for k in LEAVES])
                     for r in range(D)])


def _slots():
    """(leaf, offset into the packed buffer, element count)."""
    out, off = [], 0
    for k, shape in LEAVES.items():
        n = int(np.prod(shape))
        out.append((k, off, n))
        off += -(-n // B) * B
    return out


@pytest.fixture(scope="module")
def world():
    grads, efs = _inputs()
    rng = np.random.default_rng(2)
    const = rng.standard_normal((D, B)).astype(np.float32)
    results = launch(torch_dp_ranks.exchange_rank, D, "gloo",
                     _pack_replicas(grads), _pack_replicas(efs), const,
                     EF_STEPS, timeout=300)
    return grads, efs, const, results


@pytest.fixture(scope="module")
def jax_exchange():
    grads, efs = _inputs()
    devices = jax.devices()[:D]
    if len(devices) < D:
        pytest.skip(f"need {D} JAX devices")
    mesh = mesh_lib.make_mesh(devices=devices, axis_names=("dp",))

    def per_replica(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        out, ne = jax_collectives.psum_quantized(g, e, "dp")
        fp = jax.lax.psum(g, "dp")
        return (jax.tree.map(lambda x: x[None], out),
                jax.tree.map(lambda x: x[None], ne),
                jax.tree.map(lambda x: x[None], fp))

    fn = jax.jit(shard_map(per_replica, mesh=mesh,
                           in_specs=(P("dp"), P("dp")),
                           out_specs=(P("dp"), P("dp"), P("dp")),
                           check_rep=False))
    sh = NamedSharding(mesh, P("dp"))
    out, ne, fp = fn(jax.device_put(grads, sh), jax.device_put(efs, sh))
    return (jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, ne),
            jax.tree.map(np.asarray, fp))


def test_codes_scales_and_residuals_equal_jax(world):
    """Codes, scales and residuals equal the JAX exchange's arithmetic as
    written (`q8_encode`, then v - `q8_decode`, run op by op) and
    numpy's `q8_quantize`/`q8_dequantize`, bit for bit."""
    grads, efs, _, results = world
    for r, res in enumerate(results):
        codes, scales = collectives.wire_views(
            torch.from_numpy(res["wire"]), res["nb"])
        codes, scales = codes.numpy(), scales.numpy()
        for k, off, n in _slots():
            v = (grads[k][r] + efs[k][r]).reshape(-1)
            jq, js = jax_collectives.q8_encode(v)
            nb = -(-n // B)
            blocks = slice(off // B, off // B + nb)
            np.testing.assert_array_equal(
                codes[off:off + nb * B], np.asarray(jq).reshape(-1),
                err_msg=f"rank {r} leaf {k}")
            np.testing.assert_array_equal(scales[blocks], np.asarray(js))
            nq, ns = serialization.q8_quantize(v)
            np.testing.assert_array_equal(codes[off:off + n], nq)
            np.testing.assert_array_equal(scales[blocks], ns)
            residual = res["ef"][off:off + n]
            np.testing.assert_array_equal(residual, v - np.asarray(
                jax_collectives.q8_decode(jq, js, v.shape)))
            np.testing.assert_array_equal(
                residual, v - serialization.q8_dequantize(nq, ns))
            # Padding is exchanged as zero codes and keeps no residual.
            assert not codes[off + n:off + nb * B].any()
            assert not res["ef"][off + n:off + nb * B].any()


def _amax_ulps(results):
    """Per packed element, Σ over senders of one ulp of the sender's
    block amax (127 * scale): what one ulp of each sender's scale can
    move the element's sum by."""
    out = 0.0
    for res in results:
        _, scales = collectives.wire_views(torch.from_numpy(res["wire"]),
                                           res["nb"])
        amax = scales.numpy() * np.float32(127.0)
        out = out + np.repeat(np.spacing(amax), B)
    return out


def _term_magnitudes(results, grads):
    """Per packed element, Σ |term| over the terms each sum adds (the
    dequantized codes for q8, the values for fp32): D additions and
    roundings of such terms, in any order, stay within D ulps of it."""
    q8_terms = np.sum(np.abs(np.stack([
        collectives.q8_decode(*collectives.wire_views(
            torch.from_numpy(res["wire"]), res["nb"])).numpy()
        for res in results])), axis=0)
    fp_terms = np.sum(np.abs(_pack_replicas(grads)), axis=0)
    return q8_terms, fp_terms


# The jitted JAX exchange is not JAX's written arithmetic bit for bit:
# XLA:CPU rewrites amax / 127 into amax * (1 / 127) (the scale moves by
# an ulp in ~6% of blocks), contracts v - q * scale into one fused
# multiply-add, and flushes denormal partial sums to zero. Its results
# are held within what those rewrites can move.
TINY = np.finfo(np.float32).tiny


def test_residuals_within_jitted_jax_rewrites(world, jax_exchange):
    grads, efs, _, results = world
    _, jax_ef, _ = jax_exchange
    for r, res in enumerate(results):
        codes, scales = collectives.wire_views(
            torch.from_numpy(res["wire"]), res["nb"])
        sent = collectives.q8_decode(codes, scales).numpy()
        amax_ulp = np.repeat(np.spacing(scales.numpy() * np.float32(127)),
                             B)
        for k, off, n in _slots():
            sl = slice(off, off + n)
            bound = amax_ulp[sl] + np.spacing(np.abs(sent[sl])) + TINY
            diff = np.abs(res["ef"][sl] - jax_ef[k][r].reshape(-1))
            assert (diff <= bound).all(), (r, k, diff.max())


def test_sums_within_d_ulps_of_jax(world, jax_exchange):
    """Every rank gets the same sums; they are within D ulps of the
    summed terms' magnitude (at most D times the largest term) of the
    jitted JAX psums (XLA's reduction order is not pinned), plus the
    rewrites above."""
    grads, efs, _, results = world
    jax_sum, _, jax_fp = jax_exchange
    q8_terms, fp_terms = _term_magnitudes(results, grads)
    amax_ulps = _amax_ulps(results)
    for res in results[1:]:
        np.testing.assert_array_equal(res["q8_sum"], results[0]["q8_sum"])
        np.testing.assert_array_equal(res["fp32_sum"],
                                      results[0]["fp32_sum"])
    res = results[0]
    for k, off, n in _slots():
        sl = slice(off, off + n)
        for got, want, bound in (
                (res["q8_sum"][sl], jax_sum[k][0].reshape(-1),
                 D * np.spacing(q8_terms[sl]) + amax_ulps[sl] + D * TINY),
                (res["fp32_sum"][sl], jax_fp[k][0].reshape(-1),
                 D * np.spacing(fp_terms[sl]) + D * TINY)):
            diff = np.abs(got - want)
            assert (diff <= bound).all(), (k, diff.max())
    # The mean is the sum divided by D (exact for D = 4).
    np.testing.assert_array_equal(res["q8_mean"],
                                  res["q8_sum"] / np.float32(D))


def test_q8_sum_within_block_bound_of_exact(world):
    grads, efs, _, results = world
    v = _pack_replicas(grads) + _pack_replicas(efs)
    exact = v.astype(np.float64).sum(axis=0)
    amax = np.abs(v.reshape(D, -1, B)).max(axis=2)
    bound = np.repeat((amax / 254.0).sum(axis=0), B) + 1e-6
    assert (np.abs(results[0]["q8_sum"] - exact) <= bound).all()


def test_error_feedback_telescopes_no_drift(world):
    """100 steps of a constant gradient: the accumulated exchanged sum
    tracks the accumulated true sum within one step's bound, and the
    residuals stay within one block scale (the JAX test's criteria)."""
    _, _, const, results = world
    exact_total = EF_STEPS * const.sum(axis=0, dtype=np.float64)
    one_step_bound = (np.abs(const).max(axis=1) / 254.0).sum() + 1e-4
    for res in results:
        drift = np.abs(res["ef_total"] - exact_total).max()
        assert drift <= 2 * one_step_bound, (drift, one_step_bound)
        assert np.abs(res["ef_residual"]).max() <= \
            (np.abs(const).max() / 254.0) * 1.01 + 1e-6
    np.testing.assert_array_equal(results[0]["ef_total"],
                                  results[-1]["ef_total"])


def test_probe_returns_positive_seconds(world):
    for res in world[3]:
        assert set(res["probe_s"]) == set(collectives.CODECS)
        assert all(s > 0 for s in res["probe_s"].values())
