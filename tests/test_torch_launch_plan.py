"""K3's launch plan and the sampler's K3/K2k launch paths, on the CPU.

`obs_apply_plan` decides the (row, pixel-chunk) grid of the observation
kernel (`csrc/obs_apply.cu`). The kernel runs only on a card; its plan
is pure Python, so the properties the kernel relies on are held here:
the chunks of a row cover [0, HW) exactly once, their edges sit on
16-pixel lines wherever the 16-byte paths can be taken, and the grid
fills an H100 at the Sebulba shape. The rest holds the CPU side of the
launch paths: `GroupObsApply` against `apply_obs`, and the int32 wire
actions that `sample_logp_k` / `TorchPolicy.select` write into a host
buffer (the plain path copies them in).
"""

import math

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import distributions
from ray_tpu_torch.rllib.agents.impala.vtrace_policy import VTraceTorchPolicy
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.evaluation import device_sampler
from ray_tpu_torch.rllib.evaluation.device_sampler import obs_apply_plan

H100_SMS = 132
PLAN_SHAPES = [(n, hw) for n in (1, 2, 3, 7, 16, 32, 33, 64, 128, 192, 263,
                                 264, 512, 4096)
               for hw in (1, 15, 16, 36, 49, 64, 255, 256, 257, 1000, 4096,
                          7056, 84 * 84 * 3, 65536)]


def _chunks(n, hw):
    chunks, chunk = obs_apply_plan(n, hw)
    return [(c * chunk, min((c + 1) * chunk, hw)) for c in range(chunks)]


@pytest.mark.parametrize("n,hw", PLAN_SHAPES)
def test_plan_covers_every_pixel_of_a_row_once(n, hw):
    spans = _chunks(n, hw)
    covered = np.zeros(hw, np.int64)
    for c0, c1 in spans:
        assert 0 <= c0 < c1 <= hw  # no empty chunk: every block has work
        covered[c0:c1] += 1
    assert (covered == 1).all()
    # The grid the C entry launches: n * ceil(hw / chunk_px) blocks.
    chunks, chunk = obs_apply_plan(n, hw)
    assert chunks == math.ceil(hw / chunk) and len(spans) == chunks


@pytest.mark.parametrize("n,hw", PLAN_SHAPES)
def test_plan_edges_sit_on_16_pixel_lines(n, hw):
    """The uint4 paths (HW a multiple of 16) read chunk c from pixel
    c * chunk_px: every inner edge is a multiple of 16 pixels, so each
    chunk starts on a 16-byte frame vector and a 64-byte stack line."""
    chunks, chunk = obs_apply_plan(n, hw)
    # A block holds at most 1024 pixels (the kernel's kMaxChunk).
    assert chunk <= device_sampler.OBS_APPLY_MAX_CHUNK_PX == 1024
    if chunks > 1:
        assert chunk % device_sampler.OBS_APPLY_ALIGN_PX == 0
        assert chunk >= device_sampler.OBS_APPLY_MIN_CHUNK_PX
    if hw % 16 == 0:
        assert all(c0 % 16 == 0 and c1 % 16 == 0 for c0, c1 in
                   _chunks(n, hw))


def test_plan_fills_an_h100_at_the_sebulba_shapes():
    # n=32 (2 groups of 64 envs per actor): 9 chunks of 784 pixels.
    chunks, chunk = obs_apply_plan(32, 84 * 84)
    assert 32 * chunks >= 2 * H100_SMS
    assert (chunks, chunk) == (9, 784)
    # bench.py's 384 envs per actor in 2 groups: n=192, 7 chunks of the
    # largest size a block holds; so too once the rows alone fill the
    # card.
    assert obs_apply_plan(192, 84 * 84) == (7, 1008)
    assert obs_apply_plan(264, 84 * 84) == (7, 1008)
    assert obs_apply_plan(512, 84 * 84) == (7, 1008)
    # One env: as many chunks as the minimum chunk size allows.
    assert obs_apply_plan(1, 84 * 84) == (28, 256)
    # A row that fits in one block is one chunk.
    assert obs_apply_plan(512, 1000) == (1, 1000)


def test_plan_grows_the_grid_as_rows_shrink():
    """The grid reaches about two blocks per SM from 16 rows on; fewer
    rows stop at the 256-pixel minimum chunk."""
    blocks = [n * obs_apply_plan(n, 7056)[0] for n in (1, 2, 4, 8, 16, 32,
                                                       64, 128, 256)]
    assert blocks[:4] == [28, 56, 112, 224]
    assert all(b >= 2 * H100_SMS for b in blocks[4:])


# ---------------------------------------------------------------------
# The CPU side of the launch paths
# ---------------------------------------------------------------------
def _k3_inputs(n, K, hw, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(hw + 8)[:K] for _ in range(n)])
    idx = idx.astype(np.uint16)
    done = rng.random(n) < 0.3
    packed = np.concatenate([idx.view(np.uint8),
                             rng.integers(0, 256, (n, K), dtype=np.uint8),
                             done.astype(np.uint8)[:, None]], axis=1)
    rows = np.array([1, n, n, n], np.int32)
    fulls = rng.integers(0, 256, (4, hw), dtype=np.uint8)
    frames = rng.integers(0, 256, (n, hw), dtype=np.uint8)
    stack = rng.integers(0, 256, (n, 8, 8, 4), dtype=np.uint8)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in dict(
        packed=packed, rows=rows, fulls=fulls, frames=frames,
        stack=stack, done=done).items()}


@pytest.mark.parametrize("mode", ["delta", "frame"])
def test_group_obs_apply_is_apply_obs_on_the_cpu(mode):
    """Three steps through the group's launch path equal three calls of
    `apply_obs`: the frames and every observation, byte for byte."""
    x = _k3_inputs(4, 10, 64, seed=1)
    shape = (8, 8, 1)
    f_group, f_apply = x["frames"].clone(), x["frames"].clone()
    apply = device_sampler.GroupObsApply(torch.device("cpu"), 4, shape,
                                         x["stack"], f_group)
    s_group = s_apply = x["stack"]
    for _ in range(3):
        if mode == "delta":
            kw = dict(packed=x["packed"], rows=x["rows"], fulls=x["fulls"])
        else:
            kw = dict(done=x["done"])
        s_group = apply(f_group, s_group, **kw)
        s_apply = device_sampler.apply_obs(f_apply, shape, stack=s_apply,
                                           **kw)
        assert torch.equal(s_group, s_apply)
    assert torch.equal(f_group, f_apply)


def test_sample_logp_k_copies_the_wire_actions_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(7, 6, generator=gen) * 3.0
    u = torch.rand(5, 7, 6, generator=gen)
    host = torch.full((5, 7), -1, dtype=torch.int32)
    before = distributions.CATEGORICAL_K_KERNEL.launches
    actions, logp = distributions.sample_logp_k(logits, u, True, 5,
                                                host_actions=host)
    want_a, want_logp = distributions.sample_logp_k(logits, u, True, 5)
    assert torch.equal(actions, want_a) and torch.equal(logp, want_logp)
    assert host.dtype == torch.int32
    assert torch.equal(host.long(), actions)
    assert distributions.CATEGORICAL_K_KERNEL.launches == before


@pytest.mark.parametrize("bad", [
    torch.zeros((5, 7), dtype=torch.int64),
    torch.zeros((4, 7), dtype=torch.int32),
    torch.zeros((7, 5), dtype=torch.int32).t(),
])
def test_sample_logp_k_refuses_a_wrong_host_buffer(bad):
    logits = torch.zeros(7, 6)
    with pytest.raises(ValueError, match="host_actions"):
        distributions.sample_logp_k(logits, None, False, 5,
                                    host_actions=bad)


def test_select_fills_the_host_buffer_and_keeps_its_return():
    """`TorchPolicy.select` with and without the host buffer: the same
    draws from the same generator state, the same four outputs, and the
    buffer holds the actions as int32."""
    cfg = {"model": {"fcnet_hiddens": [8], "conv_filters": ((4, 2, 1),),
                     "compute_dtype": "f32"},
           "seed": 0, "device": "cpu", "rollout_fragment_length": 4}
    policy = VTraceTorchPolicy(Box(0, 255, (4, 4, 1), np.uint8),
                               Discrete(3), cfg)
    obs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (6, 4, 4, 1), dtype=np.uint8))
    host = torch.empty((5, 6), dtype=torch.int32)
    got = policy.select(obs, 5, torch.Generator().manual_seed(4),
                        host_actions=host)
    want = policy.select(obs, 5, torch.Generator().manual_seed(4))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == torch.int64 and got[0].shape == (5, 6)
    assert torch.equal(host.long(), got[0])
