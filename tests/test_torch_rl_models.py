"""The port's MLP, conv family and RL modules held against the JAX
package's (ray_tpu/models/mlp.py, models/conv.py, rl/core/rl_module.py).

Each case builds the JAX function's parameters from a PRNGKey, moves
them into the port through `rl.core.convert` (conv kernels HWIO ->
OIHW), feeds both packages the same seeded numpy inputs on the CPU and
compares. Tolerance: f32, rtol 1e-5 with an absolute floor of 1e-5 times
the reference's largest magnitude (outputs that pass through relu and
long sums have entries near zero, where a relative bound alone means
nothing); gradients likewise, leaf by leaf.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import conv as jconv
from ray_tpu.models import mlp as jmlp
from ray_tpu.rl.core import rl_module as jrl
from ray_tpu_torch.models import conv as tconv
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.rl.core import convert
from ray_tpu_torch.rl.core import rl_module as trl

torch.set_num_threads(1)

RTOL = 1e-5


def close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def close_trees(ours, theirs, rtol=RTOL):
    """`ours` a port tree (torch layout), `theirs` a JAX tree."""
    a = convert.flatten(ours)
    b = convert.flatten(convert.tree_from_jax(np_tree(theirs)))
    assert set(a) == set(b)
    for k in a:
        close(a[k], b[k], rtol, what=k)


# -- models/mlp.py ----------------------------------------------------------

def test_mlp_forward_loss_and_gradients_match_jax():
    jp = jmlp.init_mlp(jax.random.PRNGKey(0), [6, 32, 16, 4])
    tp = convert.tree_from_jax(np_tree(jp))
    for layer in tp:
        for t in layer.values():
            t.requires_grad_(True)
    x = rand((9, 6))
    y = np.random.default_rng(1).integers(0, 4, 9).astype(np.int32)
    close(tmlp.mlp_forward(tp, torch.from_numpy(x)), jmlp.mlp_forward(jp, x))
    (jl, jm), jg = jax.value_and_grad(jmlp.mlp_classifier_loss,
                                      has_aux=True)(jp, {"x": x, "y": y})
    tl, tm = tmlp.mlp_classifier_loss(tp, {"x": torch.from_numpy(x),
                                           "y": torch.from_numpy(y)})
    close(tl, jl)
    close(tm["accuracy"], jm["accuracy"])
    leaves = [t for layer in tp for t in layer.values()]
    grads = torch.autograd.grad(tl, leaves)
    it = iter(grads)
    close_trees([{k: next(it) for k in layer} for layer in tp], jg)


def test_init_mlp_is_he_initialized_from_its_seed():
    a = tmlp.init_mlp(3, [4, 8, 2])
    b = tmlp.init_mlp(torch.Generator().manual_seed(3), [4, 8, 2])
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a, b))
    assert a[0]["w"].shape == (4, 8) and float(a[0]["b"].abs().sum()) == 0.0


# -- models/conv.py ---------------------------------------------------------

@pytest.mark.parametrize("n,k,s,want", [
    (21, 4, 2, (1, 2)),   # the Nature CNN's second layer: asymmetric
    (84, 8, 4, (2, 2)),
    (11, 3, 1, (1, 1)),
    (12, 3, 2, (0, 1)),
    (5, 1, 2, (0, 0)),
])
def test_same_padding_is_xlas(n, k, s, want):
    assert tconv.same_pads(n, k, s) == want


@pytest.mark.parametrize("hw,k,s,cin,cout,padding", [
    (21, 4, 2, 32, 8, "SAME"),   # pads 1 before, 2 after
    (84, 8, 4, 4, 8, "SAME"),
    (12, 3, 2, 1, 16, "SAME"),
    (7, 3, 1, 3, 5, "SAME"),
    (9, 3, 2, 2, 4, "VALID"),
])
def test_conv_forward_matches_jax(hw, k, s, cin, cout, padding):
    p = jconv.init_conv(jax.random.PRNGKey(1), k, k, cin, cout)
    p = {"w": p["w"], "b": jnp.asarray(rand((cout,), 5))}
    x = rand((2, hw, hw, cin), 2)
    want = jconv.conv_forward(p, x, stride=s, padding=padding)
    got = tconv.conv_forward(convert.tree_from_jax(np_tree(p)),
                             torch.from_numpy(x), stride=s, padding=padding)
    close(got, want)


@pytest.mark.parametrize("c,groups", [(8, 8), (6, 4), (5, 8), (12, 8)])
def test_group_norm_matches_jax_with_the_divisor_fallback(c, groups):
    # (6, 4) falls back to 3 groups, (5, 8) to 5, (12, 8) to 6.
    p = {"scale": rand((c,), 3), "bias": rand((c,), 4)}
    x = rand((2, 5, 7, c), 6, scale=3.0) + 1.5
    want = jconv.group_norm(p, x, groups=groups)
    got = tconv.group_norm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), groups=groups)
    close(got, want)


def test_atari_torso_at_84x84x4_matches_jax_and_its_flatten_order():
    filters = jconv.ATARI_FILTERS
    jp = jconv.init_cnn_torso(jax.random.PRNGKey(2), (84, 84, 4), filters,
                              out_dim=128)
    x = rand((2, 84, 84, 4), 7)
    want = np.asarray(jconv.cnn_torso_forward(jp, x, filters))
    tp = convert.tree_from_jax(np_tree(jp))
    assert tuple(tp["proj_w"].shape) == (11 * 11 * 64, 128)
    assert tconv.torso_out_hw((84, 84, 4), filters) == (11, 11, 64)
    got = tconv.cnn_torso_forward(tp, torch.from_numpy(x), filters)
    close(got, want)
    # The same weights with proj_w's rows read in (c, h, w) order — what a
    # flatten of NCHW activations would need — give another function.
    perm = np.arange(11 * 11 * 64).reshape(11, 11, 64).transpose(2, 0, 1)
    wrong = dict(tp, proj_w=tp["proj_w"][torch.from_numpy(perm.reshape(-1))])
    bad = tconv.cnn_torso_forward(wrong, torch.from_numpy(x), filters)
    assert not np.allclose(bad.numpy(), want, rtol=1e-2, atol=1e-2)


def test_tiny_torso_matches_jax():
    jp = jconv.init_cnn_torso(jax.random.PRNGKey(3), (12, 12, 1),
                              jconv.TINY_FILTERS, out_dim=32)
    x = rand((3, 12, 12, 1), 8)
    close(tconv.cnn_torso_forward(convert.tree_from_jax(np_tree(jp)),
                                  torch.from_numpy(x), tconv.TINY_FILTERS),
          jconv.cnn_torso_forward(jp, x, jconv.TINY_FILTERS))


def _tree_params(tree):
    return [t.requires_grad_(True) for t in convert.flatten(tree).values()]


def test_narrow_resnet_forward_loss_and_gradients_match_jax():
    jcfg = jconv.ResNetConfig(num_classes=3, stage_sizes=(1, 2), width=8,
                              num_groups=4)
    tcfg = tconv.ResNetConfig(num_classes=3, stage_sizes=(1, 2), width=8,
                              num_groups=4)
    jp = jax.jit(lambda k: jconv.init_resnet(k, jcfg))(jax.random.PRNGKey(4))
    tp = convert.tree_from_jax(np_tree(jp))
    leaves = _tree_params(tp)
    x = rand((2, 16, 16, 3), 9)
    y = np.array([0, 2], dtype=np.int32)
    close(tconv.resnet_forward(tp, torch.from_numpy(x), tcfg),
          jconv.resnet_forward(jp, x, jcfg))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jconv.resnet_loss(p, b, jcfg), has_aux=True))(
        jp, {"x": x, "y": y})
    tl, tm = tconv.resnet_loss(tp, {"x": torch.from_numpy(x),
                                    "y": torch.from_numpy(y)}, tcfg)
    close(tl, jl)
    grads = torch.autograd.grad(tl, leaves)
    ours = convert.unflatten(dict(zip(convert.flatten(tp), grads)))
    close_trees(ours, jg, rtol=1e-4)


def _flat_axes(tree, prefix=""):
    if isinstance(tree, tuple):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_axes(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def test_resnet_logical_axes_mirror_the_tree_and_map_through_the_rules():
    from ray_tpu_torch.parallel.mesh import logical_to_physical

    cfg = tconv.ResNetConfig(num_classes=4, stage_sizes=(1, 1, 1), width=8)
    flat_p = convert.flatten(tconv.init_resnet(0, cfg))
    flat_a = _flat_axes(tconv.resnet_param_logical_axes(cfg))
    assert set(flat_p) == set(flat_a)
    for k, t in flat_p.items():
        assert len(flat_a[k]) == t.dim(), k
    # OIHW: output channels over tp, input channels over fsdp.
    assert logical_to_physical(flat_a["stages.1.0.conv1.w"]) == (
        "tp", "fsdp", None, None)
    assert logical_to_physical(flat_a["head_w"]) == ("fsdp", "tp")


def test_resnet_presets_mirror_jax():
    assert set(tconv.RESNET_CONFIGS) == set(jconv.RESNET_CONFIGS)
    for name, cfg in tconv.RESNET_CONFIGS.items():
        j = jconv.RESNET_CONFIGS[name]
        assert (cfg.stage_sizes, cfg.width, cfg.stem_kernel,
                cfg.stem_stride, cfg.num_classes) == (
            j.stage_sizes, j.width, j.stem_kernel, j.stem_stride,
            j.num_classes)
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


# -- rl/core/rl_module.py ---------------------------------------------------

def _pair(jcls, tcls, spec_j, spec_t, *args, seed=0):
    jm = jcls(spec_j, *args)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = tcls(spec_t, *args)
    tm.set_weights(np_tree(params))
    return jm, params, tm


MLP_SPEC = dict(obs_dim=5, num_actions=3, hidden=(16, 8))


@pytest.mark.parametrize("name", ["DiscretePolicyModule", "QNetworkModule",
                                  "DuelingQNetworkModule",
                                  "NoisyQNetworkModule"])
def test_mlp_modules_forward_match_jax(name):
    jm, params, tm = _pair(getattr(jrl, name), getattr(trl, name),
                           jrl.RLModuleSpec(**MLP_SPEC),
                           trl.RLModuleSpec(**MLP_SPEC))
    obs = rand((7, 5), 11)
    want = jm.forward(params, obs)
    got = tm(torch.from_numpy(obs))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], what=k)


def test_noisy_module_with_given_noise_matches_jax():
    jm, params, tm = _pair(jrl.NoisyQNetworkModule, trl.NoisyQNetworkModule,
                           jrl.RLModuleSpec(**MLP_SPEC),
                           trl.RLModuleSpec(**MLP_SPEC))
    eps_in, eps_out = jrl.factorized_noise_np(np.random.default_rng(3), 8, 3)
    t_in, t_out = trl.factorized_noise_np(np.random.default_rng(3), 8, 3)
    np.testing.assert_array_equal(eps_in, t_in)
    np.testing.assert_array_equal(eps_out, t_out)
    obs = rand((6, 5), 12)
    want = jm.forward(params, obs, noise=(eps_in, eps_out))["q_values"]
    got = tm(torch.from_numpy(obs), noise=(torch.from_numpy(eps_in),
                                           torch.from_numpy(eps_out)))
    close(got["q_values"], want)


def test_c51_module_matches_jax_and_its_expected_values():
    jm, params, tm = _pair(jrl.C51QNetworkModule, trl.C51QNetworkModule,
                           jrl.RLModuleSpec(**MLP_SPEC),
                           trl.RLModuleSpec(**MLP_SPEC), 11, -2.0, 2.0)
    close(tm.support, jm.support)
    obs = rand((4, 5), 13)
    want = jm.forward(params, obs)
    got = tm(torch.from_numpy(obs))
    for k in ("q_logits", "q_probs", "q_values"):
        close(got[k], want[k], what=k)
    expect = (got["q_probs"] * tm.support).sum(-1)
    close(got["q_values"], expect.detach().numpy())
    assert list(tm.state_dict()) == [f"q.{i}.{w}" for i in range(3)
                                     for w in ("w", "b")]


@pytest.mark.parametrize("obs_shape,filters", [
    ((12, 12, 1), None), ((84, 84, 4), jconv.ATARI_FILTERS)])
@pytest.mark.parametrize("name", ["ConvPolicyModule", "ConvQNetworkModule"])
def test_conv_modules_forward_match_jax(name, obs_shape, filters):
    kw = dict(num_actions=6, feature_dim=32, hidden=(16,))
    if filters is not None:
        kw["conv_filters"] = filters
    jm, params, tm = _pair(getattr(jrl, name), getattr(trl, name),
                           jrl.ConvModuleSpec(obs_shape, **kw),
                           trl.ConvModuleSpec(obs_shape, **kw))
    obs = rand((2, *obs_shape), 14)
    want = jm.forward(params, obs)
    got = tm(torch.from_numpy(obs))
    for k in want:
        close(got[k], want[k], what=k)


def test_continuous_module_deterministic_parts_match_jax():
    spec = dict(obs_dim=3, action_dim=2, action_low=-2.0, action_high=2.0,
                hidden=(16,))
    jm, params, tm = _pair(jrl.ContinuousPolicyModule,
                           trl.ContinuousPolicyModule,
                           jrl.ContinuousModuleSpec(**spec),
                           trl.ContinuousModuleSpec(**spec))
    obs = rand((5, 3), 15, scale=4.0)
    a = np.tanh(rand((5, 2), 16))
    for got, want in zip(tm._dist(torch.from_numpy(obs)),
                         jm._dist(params, obs)):
        close(got, want)
    close(tm.deterministic_action(torch.from_numpy(obs)),
          jm.deterministic_action(params, obs))
    for got, want in zip(tm.q_values(torch.from_numpy(obs),
                                     torch.from_numpy(a)),
                         jm.q_values(params, obs, a)):
        close(got, want)
    close(tm.scale_action(torch.from_numpy(a)), jm.scale_action(a))


@pytest.mark.parametrize("name", ["RecurrentPolicyModule",
                                  "RecurrentQNetworkModule"])
def test_recurrent_modules_step_and_sequence_match_jax(name):
    spec = dict(obs_dim=3, num_actions=2, state_dim=8, hidden=(16,))
    jm, params, tm = _pair(getattr(jrl, name), getattr(trl, name),
                           jrl.RecurrentModuleSpec(**spec),
                           trl.RecurrentModuleSpec(**spec))
    obs = rand((2, 6, 3), 17)
    h0 = rand((2, 8), 18)
    dones = np.array([[0, 0, 1, 0, 0, 0], [0, 1, 0, 0, 1, 0]], np.float32)
    want_out, want_h = jm.forward_step(params, obs[:, 0], h0)
    got_out, got_h = tm.forward_step(torch.from_numpy(obs[:, 0]),
                                     torch.from_numpy(h0))
    close(got_h, want_h)
    for k in want_out:
        close(got_out[k], want_out[k], what=k)
    want = jm.forward_seq(params, obs, h0, dones)
    got = tm.forward_seq(torch.from_numpy(obs), torch.from_numpy(h0),
                         torch.from_numpy(dones))
    for k in want:
        close(got[k], want[k], what=k)


def test_filters_for_matches_jax():
    for shape in ((84, 84, 4), (64, 80, 3), (12, 12, 1), (63, 200, 1)):
        assert trl.filters_for(shape) == jrl.filters_for(shape)
    assert trl.filters_for((84, 84, 4), ((8, 3, 1),)) == ((8, 3, 1),)


# -- the converter -----------------------------------------------------------

def test_weights_round_trip_the_jax_tree_bit_for_bit():
    spec = jrl.ConvModuleSpec((84, 84, 4), 6, conv_filters=jconv.ATARI_FILTERS)
    jm = jrl.ConvPolicyModule(spec)
    tree = np_tree(jm.init(jax.random.PRNGKey(5)))
    tm = trl.ConvPolicyModule(trl.ConvModuleSpec(
        (84, 84, 4), 6, conv_filters=tconv.ATARI_FILTERS))
    tm.set_weights(tree)
    # OIHW inside, HWIO across the exchange.
    assert tuple(tm.tree()["torso"]["convs"][0]["w"].shape) == (32, 4, 8, 8)
    back = tm.get_weights()
    flat_a, flat_b = convert.flatten(back), convert.flatten(tree)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
    assert isinstance(back["torso"]["convs"], list)
    with pytest.raises(ValueError):
        tm.set_weights({**tree, "extra": np.zeros(1, np.float32)})


def test_bf16_leaves_convert_bit_for_bit():
    cfg = jconv.RESNET_CONFIGS["resnet18"]
    w = jconv.init_conv(jax.random.PRNGKey(6), 3, 3, 4, 8, cfg.dtype)["w"]
    t = convert.leaf_from_jax(np.asarray(w))
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (8, 4, 3, 3)
    back = convert.leaf_to_jax(t)
    assert back.dtype == np.asarray(w).dtype
    np.testing.assert_array_equal(back.view(np.int16),
                                  np.asarray(w).view(np.int16))


def test_init_draws_from_the_seed_in_place():
    tm = trl.DiscretePolicyModule(trl.RLModuleSpec(4, 2))
    p = tm.tree()["pi"][0]["w"]
    a = tm.init(1).get_weights()
    b = tm.init(1).get_weights()
    c = tm.init(2).get_weights()
    assert tm.tree()["pi"][0]["w"] is p
    np.testing.assert_array_equal(a["pi"][0]["w"], b["pi"][0]["w"])
    assert not np.array_equal(a["pi"][0]["w"], c["pi"][0]["w"])
