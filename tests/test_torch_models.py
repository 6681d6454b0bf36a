"""Port parity: networks and the flax -> torch weight converter.

The same numpy inputs go through the JAX package's flax networks and
the port's `nn.Module`s, with the port's weights converted from the
flax params (`ray_tpu_torch/models/convert.py`). Compared in float32 on
the CPU; the bf16 Vision trunk is checked separately at a bf16
tolerance. The Vision test is the one that catches a wrong `fc`
row permutation (flax flattens NHWC in (H, W, C) order, the port
flattens NCHW in (C, H, W) order).
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import catalog as jax_catalog
from ray_tpu.rllib.env.spaces import Box as JaxBox
from ray_tpu_torch.models import catalog
from ray_tpu_torch.models.convert import (flax_leaves, flax_pack_plan,
                                          flax_to_state_dict)
from ray_tpu_torch.rllib.env.spaces import Box

# f32 on the CPU: both frameworks sum convolutions and matmuls in f32 in
# different orders; 1e-5 is ~100 f32 ulps at the outputs' scale.
F32_TOL = 1e-5
FRAME = (84, 84, 4)


def _vision_pair(compute_dtype, seed=0):
    jax_model = jax_catalog.get_model(
        JaxBox(0, 255, FRAME, np.uint8), 6,
        {"compute_dtype": compute_dtype})
    obs = np.random.default_rng(seed).integers(
        0, 256, (4,) + FRAME, dtype=np.uint8)
    params = jax_model.init(jax.random.PRNGKey(seed), obs[:1])
    model = catalog.get_model(Box(0, 255, FRAME, np.uint8), 6,
                              {"compute_dtype": compute_dtype})
    model.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    return jax_model, params, model, obs


def _port_forward(model, obs):
    with torch.no_grad():
        logits, value = model(torch.from_numpy(obs))
    return logits.numpy(), value.numpy()


class TestVisionNetwork:
    def test_f32_matches_flax(self):
        jax_model, params, model, obs = _vision_pair("f32")
        assert model.compute_dtype == torch.float32
        want_logits, want_value = jax_model.apply(params, obs)
        logits, value = _port_forward(model, obs)
        assert logits.shape == (4, 6) and value.shape == (4,)
        np.testing.assert_allclose(logits, want_logits, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(value, want_value, rtol=F32_TOL,
                                   atol=F32_TOL)

    def test_bf16_trunk_matches_flax(self):
        """Default compute dtype: bf16 trunk, f32 heads, in both
        packages. bf16 rounds at other points in the two frameworks, so
        the bound is one bf16 ulp (2^-8) of the outputs' scale."""
        jax_model, params, model, obs = _vision_pair("auto")
        assert model.compute_dtype == torch.bfloat16
        want_logits, want_value = jax_model.apply(params, obs)
        logits, value = _port_forward(model, obs)
        assert logits.dtype == np.float32 and value.dtype == np.float32
        for got, want in ((logits, want_logits), (value, want_value)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=2.0 ** -8 * np.abs(want).max())

    def test_unpermuted_fc_rows_disagree(self):
        """Control: loading the flax fc kernel without the (H, W, C) ->
        (C, H, W) row permutation gives different outputs, so the f32
        test above really checks the permutation."""
        jax_model, params, model, obs = _vision_pair("f32")
        kernel = np.asarray(params["params"]["fc"]["kernel"])
        with torch.no_grad():
            model.fc.weight.copy_(torch.from_numpy(kernel.T.copy()))
        want_logits, _ = jax_model.apply(params, obs)
        logits, _ = _port_forward(model, obs)
        assert np.abs(logits - np.asarray(want_logits)).max() > 100 * F32_TOL

    def test_state_dict_keys_and_param_count(self):
        _, params, model, _ = _vision_pair("f32")
        converted = flax_to_state_dict(jax.tree.map(np.asarray, params))
        assert set(converted) == set(model.state_dict())
        n_flax = sum(int(np.prod(x.shape))
                     for x in jax.tree.leaves(params))
        assert sum(p.numel() for p in model.parameters()) == n_flax
        assert model.conv_out_hw == (7, 7)


class TestFullyConnectedNetwork:
    @pytest.mark.parametrize("vf_share_layers", [False, True])
    def test_f32_matches_flax(self, vf_share_layers):
        cfg = {"fcnet_hiddens": [32, 16],
               "vf_share_layers": vf_share_layers}
        jax_model = jax_catalog.get_model(JaxBox(-1.0, 1.0, (4,)), 2, cfg)
        obs = np.random.default_rng(3).standard_normal(
            (5, 4)).astype(np.float32)
        params = jax_model.init(jax.random.PRNGKey(1), obs[:1])
        model = catalog.get_model(Box(-1.0, 1.0, (4,)), 2, cfg)
        model.load_state_dict(flax_to_state_dict(
            jax.tree.map(np.asarray, params)))
        want_logits, want_value = jax_model.apply(params, obs)
        logits, value = _port_forward(model, obs)
        np.testing.assert_allclose(logits, want_logits, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(value, want_value, rtol=F32_TOL,
                                   atol=F32_TOL)

    def test_init_is_seeded(self):
        def build(seed):
            return catalog.get_model(
                Box(-1.0, 1.0, (4,)), 2, {"fcnet_hiddens": [8]},
                generator=torch.Generator().manual_seed(seed))
        a, b, c = build(0), build(0), build(1)
        for (k, va), vb, vc in zip(a.state_dict().items(),
                                   b.state_dict().values(),
                                   c.state_dict().values()):
            assert torch.equal(va, vb), k
            if k.endswith("weight"):
                assert not torch.equal(va, vc), k


def test_compute_dtype_resolution(monkeypatch):
    monkeypatch.delenv("RAY_TPU_COMPUTE_DTYPE", raising=False)
    assert catalog._resolve_model_dtype({"compute_dtype": "auto"}) is None
    assert catalog._resolve_model_dtype(
        {"compute_dtype": "f32"}) == torch.float32
    monkeypatch.setenv("RAY_TPU_COMPUTE_DTYPE", "bf16")
    assert catalog._resolve_model_dtype(
        {"compute_dtype": "auto"}) == torch.bfloat16
    with pytest.raises(ValueError, match="unknown compute dtype"):
        catalog.resolve_compute_dtype("fp8")


def _q_pair(image, dueling, hiddens=(16,)):
    """A JAX `QNetwork` (flax params, seed 2) and the port's of the same
    architecture with the converted weights: Nature filters on 84x84x4
    frames, or an 8-wide flat observation."""
    from ray_tpu.models.networks import QNetwork as JaxQNetwork
    from ray_tpu_torch.models.networks import QNetwork
    shape = FRAME if image else (8,)
    dtype = np.uint8 if image else np.float32
    jax_model = JaxQNetwork(num_actions=5, hiddens=hiddens,
                            dueling=dueling)
    params = jax.tree.map(np.asarray, jax_model.init(
        jax.random.PRNGKey(2), np.zeros((1,) + shape, dtype)))
    model = QNetwork(shape, 5, hiddens=hiddens, dueling=dueling)
    model.load_state_dict(flax_to_state_dict(params))
    return params, model


@pytest.mark.parametrize("kind", ["vision", "fc", "fc_free_log_std",
                                  "q_image_dueling", "q_image",
                                  "q_flat_dueling", "q_flat",
                                  "q_image_no_hidden"])
def test_flax_leaves_invert_the_converter(kind):
    """The way back for gradients: `flax_leaves` of a converted
    state_dict gives the flax leaves themselves, in jax's tree-flatten
    order and each in its own element order; the exchange's pack plan
    puts them, so flattened, in block-aligned slots and back. With
    `free_log_std` the bare `log_std` leaf (set away from its zero init
    here) is one of them. The Q networks (dueling or not, on frames or
    flat observations; on frames with no hidden layer the heads read
    the conv output) take the same way back."""
    if kind == "vision":
        _, params, model, _ = _vision_pair("f32")
    elif kind.startswith("q_"):
        params, model = _q_pair(
            "image" in kind, "dueling" in kind,
            () if "no_hidden" in kind else (16,))
    else:
        space = (8,)
        free = kind == "fc_free_log_std"
        mcfg = {"fcnet_hiddens": [16, 16], "free_log_std": free}
        outputs = 6 if free else 3
        jax_model = jax_catalog.get_model(
            JaxBox(-1.0, 1.0, space, np.float32), outputs, mcfg)
        params = jax_model.init(jax.random.PRNGKey(1),
                                np.zeros((1,) + space, np.float32))
        if free:
            params = jax.tree.map(np.asarray, params)
            params["params"]["log_std"] = np.array([0.5, -1.0, 2.0],
                                                   np.float32)
        model = catalog.get_model(Box(-1.0, 1.0, space), outputs, mcfg)
        model.load_state_dict(flax_to_state_dict(
            jax.tree.map(np.asarray, params)))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    got = flax_leaves(dict(model.named_parameters()),
                      getattr(model, "conv_out_hw", None))
    assert len(got) == len(want)
    for (_, _, leaf), ref in zip(got, want):
        np.testing.assert_array_equal(leaf.detach().numpy(), ref)
    block = 1024
    plan = flax_pack_plan(model, block)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    packed = torch.cat([flat, flat.new_zeros(1)])[plan.pack_index]
    slots = [np.concatenate([ref.reshape(-1), np.zeros(
        -(-ref.size // block) * block - ref.size, np.float32)])
        for ref in want]
    np.testing.assert_array_equal(packed.numpy(), np.concatenate(slots))
    assert plan.leaf_sizes == [ref.size for ref in want]
    assert plan.nb * block == packed.numel()
    assert torch.equal(packed[plan.unpack_index], flat)


# ---------------------------------------------------------------------
# SAC's actor and critic
# ---------------------------------------------------------------------
def _sac_networks(twin):
    """The JAX package's `StochasticActor` and `ContinuousQNetwork` (flax
    params, seeds 4 and 5) and the port's with the converted weights:
    a 5-wide observation, a 2-dim action, [32, 16] towers."""
    from ray_tpu.models.networks import ContinuousQNetwork as JaxQ
    from ray_tpu.models.networks import StochasticActor as JaxActor
    from ray_tpu_torch.models.networks import (ContinuousQNetwork,
                                               StochasticActor)
    obs = np.random.default_rng(6).standard_normal((7, 5)).astype(np.float32)
    act = np.random.default_rng(7).uniform(-1, 1, (7, 2)).astype(np.float32)
    jax_actor = JaxActor(action_dim=2, hiddens=(32, 16))
    jax_critic = JaxQ(hiddens=(32, 16), twin=twin)
    actor_params = jax.tree.map(np.asarray, jax_actor.init(
        jax.random.PRNGKey(4), obs[:1]))
    critic_params = jax.tree.map(np.asarray, jax_critic.init(
        jax.random.PRNGKey(5), obs[:1], act[:1]))
    actor = StochasticActor(5, 2, hiddens=(32, 16))
    critic = ContinuousQNetwork(5, 2, hiddens=(32, 16), twin=twin)
    actor.load_state_dict(flax_to_state_dict(actor_params))
    critic.load_state_dict(flax_to_state_dict(critic_params))
    return ((jax_actor, actor_params, actor),
            (jax_critic, critic_params, critic), obs, act)


@pytest.mark.parametrize("twin", [True, False], ids=["twin", "single"])
def test_sac_networks_match_flax(twin):
    """The actor's [mean, log_std] outputs and the critic's (q1, q2) on
    converted weights, f32, within F32_TOL; without `twin` the critic
    has one tower and returns it twice."""
    (jax_actor, a_params, actor), (jax_critic, c_params, critic), obs, act \
        = _sac_networks(twin)
    with torch.no_grad():
        out = actor(torch.from_numpy(obs)).numpy()
        q1, q2 = (q.numpy() for q in critic(torch.from_numpy(obs),
                                             torch.from_numpy(act)))
    assert out.shape == (7, 4) and q1.shape == (7,)
    np.testing.assert_allclose(out, jax_actor.apply(a_params, obs),
                               rtol=F32_TOL, atol=F32_TOL)
    want_q1, want_q2 = jax_critic.apply(c_params, obs, act)
    np.testing.assert_allclose(q1, want_q1, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(q2, want_q2, rtol=F32_TOL, atol=F32_TOL)
    towers = {n.split("_")[0] for n, _ in critic.named_children()}
    assert towers == ({"q1", "q2"} if twin else {"q1"})
    if not twin:
        np.testing.assert_array_equal(q1, q2)


@pytest.mark.parametrize("twin", [True, False], ids=["twin", "single"])
def test_sac_converter_round_trip(twin):
    """flax -> port -> flax gives the flax trees back exactly (the
    `Linear` transpose only), for the networks and for the SAC policy's
    weights layout with `log_alpha` and the target critic."""
    from ray_tpu_torch.models.convert import (sac_weights_from_flax,
                                              sac_weights_to_flax,
                                              state_dict_to_flax)
    (_, a_params, actor), (_, c_params, critic), _, _ = _sac_networks(twin)
    for params, model in ((a_params, actor), (c_params, critic)):
        back = state_dict_to_flax(model.state_dict())
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(x, y)
    weights = {"online": {"actor": a_params, "critic": c_params,
                          "log_alpha": np.float32(-0.25)},
               "target": {"critic": c_params}}
    port = sac_weights_from_flax(weights)
    assert set(port["online"]["critic"]) == set(critic.state_dict())
    back = sac_weights_to_flax(port)
    assert jax.tree.structure(back) == jax.tree.structure(weights)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(weights)):
        np.testing.assert_array_equal(x, y)
