"""Port parity: the weight-sync delta plane.

Seeded dicts of numpy arrays (nested dicts, integer aux leaves) go
through the JAX package's `WeightSyncEncoder`/`WeightSyncDecoder` and
the port's: a 5-sync sequence at shard_count 1 and 3 under the q8-delta
codec, and under the full codec. The payloads are equal field for
field (`q`, `scales` and `nbytes` byte for byte) and both decoders
return bit-equal trees. Then the counterparts of
`tests/test_weight_sync.py:244-367` on the port's full-width Nature CNN
(`catalog.get_model`): first sync full then delta, the decode tracking
the true weights, no residual growth, the stale-base fallback, sharding
and duplicate detection, full passthrough, decoder reset, and the
default codec.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu._private import serialization as jax_serialization
from ray_tpu._private import weight_sync as jax_ws
from ray_tpu._private.spec_layout import shard_bounds as jax_shard_bounds
from ray_tpu_torch._private import metrics, serialization, weight_sync
from ray_tpu_torch._private.spec_layout import shard_bounds
from ray_tpu_torch._private.weight_sync import (WeightSyncDecoder,
                                                WeightSyncEncoder)
from ray_tpu_torch.models import catalog
from ray_tpu_torch.rllib.env.spaces import Box
from ray_tpu_torch.rllib.policy.torch_policy import host_state_dict

PAYLOAD_FIELDS = ("version", "base_version", "codec", "shard_index",
                  "shard_count", "start", "stop", "q_codec", "nbytes")


def _tree(seed):
    """Nested dicts whose keys sort differently from their insertion
    order, f32 leaves over several q8 blocks, and integer, f64 and
    scalar aux leaves."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "params": {
            "fc_1": {"kernel": f32(64, 48), "bias": f32(48)},
            "conv_0": {"kernel": f32(3, 3, 4, 16), "bias": f32(16)},
            "value": {"kernel": f32(48, 1), "bias": f32(1)},
        },
        "step": np.asarray(seed, np.int64),
        "counts": np.arange(7, dtype=np.int32) + seed,
        "log_std": f32(5),
        "scale_f64": np.asarray([0.5, 0.25]),
    }


def _walk(tree, seed, scale=1e-3):
    """The next weights on a random walk: every f32 leaf moves, the
    integer leaves count on."""
    rng = np.random.default_rng(seed)

    def step(x):
        x = np.asarray(x)
        if x.dtype == np.float32:
            return x + (scale * rng.standard_normal(x.shape)).astype(
                np.float32)
        if x.dtype.kind == "i":
            return x + 1
        return x
    return jax.tree.map(step, tree)


def _same_leaves(got, want):
    got_leaves = weight_sync.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _same_payload(got, want):
    for field in PAYLOAD_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    if want.codec == "full":
        _same_leaves(got.tree, want.tree)
        return
    assert bytes(got.q) == bytes(want.q)
    assert got.scales.dtype == want.scales.dtype
    assert got.scales.tobytes() == want.scales.tobytes()
    assert len(got.aux) == len(want.aux)
    for (gi, ga), (wi, wa) in zip(got.aux, want.aux):
        assert gi == wi and ga.dtype == wa.dtype
        assert ga.tobytes() == wa.tobytes()


@pytest.mark.parametrize("codec,shards", [("q8_delta", 1), ("q8_delta", 3),
                                          ("full", 1)])
def test_sync_sequence_matches_jax_package(codec, shards):
    jax_enc = jax_ws.WeightSyncEncoder(codec=codec, shard_count=shards)
    enc = WeightSyncEncoder(codec=codec, shard_count=shards)
    jax_dec, dec = jax_ws.WeightSyncDecoder(), WeightSyncDecoder()
    tree = _tree(0)
    for i in range(5):
        if i:
            tree = _walk(tree, seed=100 + i)
        want = jax_enc.encode(tree)
        got = enc.encode(tree)
        assert len(got) == len(want)
        want_codec = "full" if codec == "full" or i == 0 else "q8_delta"
        assert [p.codec for p in got] == [want_codec] * len(got)
        for g, w in zip(got, want):
            _same_payload(g, w)
        # Shards apply in reverse order; only the last returns weights.
        for k, (g, w) in enumerate(zip(got[::-1], want[::-1])):
            want_out, want_status = jax_dec.apply(w)
            got_out, got_status = dec.apply(g)
            assert got_status == want_status
            assert got_status == ("ok" if k == len(got) - 1 else "partial")
        _same_leaves(got_out, want_out)
        assert dec.version == jax_dec.version == i + 1
        assert enc.base.tobytes() == jax_enc._base.tobytes()
    # The fallback payload is the canonical base at the same version.
    _same_payload(enc.full_payloads()[0], jax_enc.full_payloads()[0])


def test_flatten_order_is_jax_tree_order():
    tree = _tree(3)
    vec, aux = weight_sync.flatten_f32(tree)
    want_vec, want_aux = jax_ws.flatten_f32(tree)
    assert vec.tobytes() == want_vec.tobytes()
    assert [i for i, _ in aux] == [i for i, _ in want_aux]
    rebuilt = weight_sync.unflatten_f32(tree, vec * 2, aux)
    _same_leaves(rebuilt, jax_ws.unflatten_f32(tree, want_vec * 2,
                                               want_aux))
    # Structure and key order of the template survive the round trip.
    assert list(rebuilt) == list(tree)
    assert list(rebuilt["params"]) == list(tree["params"])


def test_helpers_match_jax_package():
    for n, s in ((10, 1), (10, 3), (1_687_719, 4), (5, 8)):
        assert shard_bounds(n, s) == jax_shard_bounds(n, s)
    raw = np.random.default_rng(0).integers(-3, 4, 50_000) \
        .astype(np.int8).tobytes()
    assert serialization.WIRE_CODEC_ID == jax_serialization.WIRE_CODEC_ID
    assert serialization._codec_compress(raw) \
        == jax_serialization._codec_compress(raw)
    comp = serialization._codec_compress(raw)
    assert serialization.wire_decode(serialization.WIRE_CODEC_ID,
                                     comp) == raw


# ======================================================================
# The counterparts of tests/test_weight_sync.py:244-367, on the port's
# full-width Nature CNN.
# ======================================================================
@pytest.fixture(scope="module")
def nature_weights():
    model = catalog.get_model(Box(0, 255, (84, 84, 4), np.uint8), 6, {},
                              generator=torch.Generator().manual_seed(0))
    return host_state_dict(model)


def _perturb(tree, scale, seed):
    rng = np.random.default_rng(seed)
    return {k: v + (scale * rng.standard_normal(v.shape)).astype(v.dtype)
            for k, v in tree.items()}


def _vec(tree):
    return weight_sync.flatten_f32(tree)[0]


class TestWeightSyncCodec:
    def test_first_sync_is_full_then_delta(self, nature_weights):
        w = nature_weights
        enc = WeightSyncEncoder(codec="q8_delta")
        p1 = enc.encode(w)
        assert len(p1) == 1 and p1[0].codec == "full"
        p2 = enc.encode(_perturb(w, 1e-3, seed=1))
        assert p2[0].codec == "q8_delta"
        assert p2[0].base_version == 1 and p2[0].version == 2
        # >= 4x fewer bytes than the full blob.
        assert p1[0].nbytes / p2[0].nbytes >= 4.0

    def test_decode_tracks_true_weights(self, nature_weights):
        w = nature_weights
        enc = WeightSyncEncoder(codec="q8_delta")
        dec = WeightSyncDecoder()
        dec.apply(enc.encode(w)[0])
        w2 = _perturb(w, 1e-3, seed=2)
        out, status = dec.apply(enc.encode(w2)[0])
        assert status == "ok" and dec.version == 2
        assert np.abs(_vec(out) - _vec(w2)).max() < 1e-4

    def test_error_feedback_residual_does_not_accumulate(
            self, nature_weights):
        """30 quantized syncs along a random weight walk: the decoded
        copy's error stays at one quantization step instead of growing
        with the sync count."""
        w = nature_weights
        enc = WeightSyncEncoder(codec="q8_delta")
        dec = WeightSyncDecoder()
        dec.apply(enc.encode(w)[0])
        errs = []
        for i in range(30):
            w = _perturb(w, 5e-4, seed=10 + i)
            out, status = dec.apply(enc.encode(w)[0])
            assert status == "ok"
            errs.append(float(np.abs(_vec(out) - _vec(w)).max()))
        assert max(errs) < 1e-4
        assert np.mean(errs[-5:]) < 3 * np.mean(errs[:5]) + 1e-6
        # The sender's receiver-view mirror is exact.
        assert np.abs(enc.base - _vec(out)).max() == 0.0

    def test_stale_base_full_fallback_is_canonical(self, nature_weights):
        w = nature_weights
        enc = WeightSyncEncoder(codec="q8_delta")
        dec_live = WeightSyncDecoder()
        dec_live.apply(enc.encode(w)[0])
        delta = enc.encode(_perturb(w, 1e-3, seed=3))[0]
        live, _ = dec_live.apply(delta)
        dec_new = WeightSyncDecoder()
        out, status = dec_new.apply(delta)
        assert out is None and status == "stale"
        full = enc.full_payloads()[0]
        assert full.codec == "full" and full.version == delta.version
        rejoined, status = dec_new.apply(full)
        assert status == "ok"
        assert np.abs(_vec(rejoined) - _vec(live)).max() == 0.0

    def test_sharded_payloads_and_dup_detection(self, nature_weights):
        w = nature_weights
        enc = WeightSyncEncoder(codec="q8_delta", shard_count=4)
        dec = WeightSyncDecoder()
        dec.apply(enc.encode(w)[0])
        w2 = _perturb(w, 1e-3, seed=4)
        shards = enc.encode(w2)
        assert len(shards) == 4
        blob = sum(v.nbytes for v in w.values())
        assert blob / sum(p.nbytes for p in shards) >= 4.0
        for i, s in enumerate([2, 0, 3, 1]):
            out, status = dec.apply(shards[s])
            assert status == ("partial" if i < 3 else "ok")
        assert dec.version == 2
        assert np.abs(_vec(out) - _vec(w2)).max() < 1e-4
        out, status = dec.apply(shards[0])
        assert out is None and status in ("dup", "stale")

    def test_full_codec_passthrough(self, nature_weights):
        w = nature_weights
        enc = WeightSyncEncoder(codec="full")
        dec = WeightSyncDecoder()
        for seed in (5, 6):
            w = _perturb(w, 1e-3, seed=seed)
            out, status = dec.apply(enc.encode(w)[0])
            assert status == "ok"
            assert np.abs(_vec(out) - _vec(w)).max() == 0.0

    def test_decoder_reset_forgets_base(self, nature_weights):
        w = nature_weights
        enc = WeightSyncEncoder(codec="q8_delta")
        dec = WeightSyncDecoder()
        dec.apply(enc.encode(w)[0])
        dec.reset()
        out, status = dec.apply(enc.encode(w)[0])  # v2 delta
        assert out is None and status == "stale"

    def test_resolve_codec_default(self, monkeypatch):
        # Local mode passes payloads by reference: "auto" is the full
        # codec, and no environment variable chooses otherwise.
        monkeypatch.setenv("RAY_TPU_WEIGHT_CODEC", "q8_delta")
        assert weight_sync.resolve_codec("auto") == "full"
        assert weight_sync.resolve_codec(None) == "full"
        assert WeightSyncEncoder().codec == "full"
        assert weight_sync.resolve_codec("full") == "full"
        assert weight_sync.resolve_codec("q8_delta") == "q8_delta"
        with pytest.raises(ValueError):
            weight_sync.resolve_codec("zstd-9000")

    def test_sync_metrics(self, nature_weights):
        before = metrics.snapshot()["counters"]
        enc = WeightSyncEncoder(codec="q8_delta")
        full = enc.encode(nature_weights)[0]
        delta = enc.encode(_perturb(nature_weights, 1e-3, seed=7))[0]
        after = metrics.snapshot()

        def grew(key):
            return after["counters"].get(key, 0) - before.get(key, 0)
        assert grew("weight_sync_bytes") == full.nbytes + delta.nbytes
        assert grew("weight_sync_codec.full") == 1
        assert grew("weight_sync_codec.q8_delta") == 1
        assert after["gauges"]["weight_sync_payload_bytes"] == delta.nbytes
        assert after["gauges"]["weight_sync_ms"] > 0
