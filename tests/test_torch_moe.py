"""Parity of the port's mixture-of-experts (ray_tpu_torch.parallel.moe and
the MoE layers of models/transformer.py) with the JAX package.

Single-process cases compare top_k_routing, moe_layer and the tiny MoE
model's loss and gradients with the reference on the same inputs; the
multi-rank cases (tests/torch_dist_cases.py:moe_cases on four gloo ranks,
one spawn for the module) split the experts over ep = 4 and run the MoE
model under dp x ep, fsdp x tp and sp x ep, each against the unsharded
JAX run. Routing is compared first: an f32 product summed in another
order could flip a near-tied argmax and change one token's output
completely, so every dispatch mask must equal the reference's before
any output is compared.

Tolerances, f32: dispatch masks exactly, combine weights within 1e-6;
outputs, logits and losses within rtol 1e-4 (atol 1e-6); gradients
within rtol 1e-3, atol 1e-5. The sharded forwards: 2e-3, the reference
tests' tolerance for GSPMD.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from ray_tpu.parallel import moe as jax_moe
from ray_tpu_torch.models import configs, forward, loss_fn, params_from_jax
from ray_tpu_torch.models.transformer import param_shapes
from ray_tpu_torch.parallel import moe as torch_moe

import torch_dist_cases as cases
from torch_dist_util import Ranks

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started at the module's first test; read after the JAX work."""
    handle = Ranks("tests/torch_dist_cases.py:moe_cases", 4,
                   tmp_path_factory.mktemp("moe"))
    yield handle
    handle.stop()


# -- routing -----------------------------------------------------------------
def _both_routings(logits, k, capacity):
    want = [np.asarray(a) for a in jax_moe.top_k_routing(
        jnp.asarray(logits), k=k, capacity=capacity)]
    got = [t.numpy() for t in torch_moe.top_k_routing(
        torch.from_numpy(logits), k=k, capacity=capacity)]
    return got, want


def test_top_k_routing_capacity():
    logits = np.array([[10.0, 0.0], [10.0, 0.0], [10.0, 0.0], [0.0, 10.0]],
                      dtype=np.float32)
    (dispatch, combine, aux), want = _both_routings(logits, 1, 2)
    # Expert 0 over-subscribed (3 tokens, capacity 2): one token dropped.
    assert float(dispatch[:, 0].sum()) == 2.0
    assert float(dispatch[:, 1].sum()) == 1.0
    assert float(aux) > 0
    np.testing.assert_array_equal(dispatch, want[0])
    np.testing.assert_allclose(combine, want[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux, want[2], rtol=1e-6)


@pytest.mark.parametrize("tokens,experts,k,capacity", [
    (64, 8, 2, 20), (64, 8, 2, 3), (37, 4, 1, 11), (50, 4, 3, 40),
    (16, 8, 2, 1)])
def test_top_k_routing_random_logits(tokens, experts, k, capacity):
    """Drops, several passes and a full queue: the same tokens land in
    the same slots, and the same gates weigh them."""
    logits = cases.rand(tokens + experts, (tokens, experts), 2.0)
    (dispatch, combine, aux), want = _both_routings(logits, k, capacity)
    np.testing.assert_array_equal(dispatch, want[0])
    np.testing.assert_allclose(combine, want[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux, want[2], rtol=1e-6)


# -- moe_layer ---------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_moe_layer():
    x, router, w, ct = (jnp.asarray(a) for a in cases.moe_layer_inputs())

    def expert_fn(w, xin):
        return jnp.einsum("ecd,edf->ecf", xin, w)

    def loss(x, router, w):
        y, aux = jax_moe.moe_layer(x, router, expert_fn, w, k=2)
        return (y * ct).sum() + aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x, router, w)
    return ({"y": np.asarray(y), "aux": np.asarray(aux)},
            {n: np.asarray(g) for n, g in zip(("dx", "drouter", "dw"),
                                              grads)})


def test_moe_layer_matches_reference():
    outs, grads = _jax_moe_layer()
    x, router, w, ct = (torch.from_numpy(a).requires_grad_(True)
                        for a in cases.moe_layer_inputs())
    y, aux = torch_moe.moe_layer(x, router, cases.moe_expert_fn, w, k=2)
    ((y * ct.detach()).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), outs["y"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(aux.detach().numpy(), outs["aux"], rtol=1e-4)
    for name, t in (("dx", x), ("drouter", router), ("dw", w)):
        np.testing.assert_allclose(t.grad.numpy(), grads[name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_moe_layer_experts_split_over_ep(ranks):
    outs, grads = _jax_moe_layer()
    for rec in ranks.get():
        e = int(rec["ep/coord"])
        np.testing.assert_allclose(rec["ep/y"], outs["y"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(rec["ep/aux"], outs["aux"], rtol=1e-4)
        np.testing.assert_allclose(rec["ep/dx"], grads["dx"], rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(rec["ep/drouter"], grads["drouter"],
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(rec["ep/dw"], grads["dw"][e:e + 1],
                                   rtol=1e-3, atol=1e-5)


# -- the MoE model -----------------------------------------------------------
class _JaxDispatch:
    """Records each JAX top_k_routing call's dispatch mask at run time."""

    def __init__(self, monkeypatch):
        self.masks = []
        orig = jax_moe.top_k_routing

        def wrapped(logits, k, capacity):
            d, c, a = orig(logits, k, capacity)
            jax.debug.callback(lambda m: self.masks.append(np.asarray(m)),
                               d, ordered=True)
            return d, c, a
        monkeypatch.setattr(jax_moe, "top_k_routing", wrapped)


def _jax_forward_masks(monkeypatch, tree, tokens, jcfg):
    rec = _JaxDispatch(monkeypatch)
    logits, aux = jax.jit(lambda p, t: jax_tf.forward(p, t, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))
    jax.effects_barrier()
    monkeypatch.undo()
    return np.asarray(logits), float(aux), rec.masks


def test_tiny_moe_loss_and_every_gradient(monkeypatch):
    jcfg, cfg = jax_configs.tiny_moe, configs.tiny_moe
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jax.random.PRNGKey(4), jcfg))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 17)).astype(np.int32)
    logits, aux, masks = _jax_forward_masks(monkeypatch, tree,
                                            tokens[:, :-1], jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        functools.partial(jax_tf.loss_fn, cfg=jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))
    grads = cases.flat(jax.tree_util.tree_map(np.asarray, grads))

    params = params_from_jax(tree, cfg, device="cpu")
    tok = torch.from_numpy(tokens).long()
    with torch.no_grad(), cases._RecordDispatch() as rec:
        got_logits, got_aux = forward(params, tok[:, :-1], cfg)
    assert len(rec.masks) == len(masks) == cfg.n_layers
    for got, want in zip(rec.masks, masks):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_logits.numpy(), logits, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(got_aux), aux, rtol=1e-4)
    leaves = cases.flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    got_loss = loss_fn(params, tok, cfg)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-4)
    assert float(leaves["layers/router"].grad.abs().sum()) > 0
    for name, g in grads.items():
        np.testing.assert_allclose(leaves[name].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-5, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_unsharded(case):
    """The JAX model on a case's whole batch: logits, aux, dispatch masks
    of the forward, loss and flat gradients."""
    name, overrides = cases.MOE_MODELS[case][:2]
    jcfg = dataclasses.replace(jax_configs.NAMED_CONFIGS[name], **overrides)
    _, params, tokens = cases.model_inputs(case, cases.MOE_MODELS)
    tokens = tokens.astype(np.int32)
    mp = pytest.MonkeyPatch()
    logits, aux, masks = _jax_forward_masks(mp, params, tokens[:, :-1], jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        functools.partial(jax_tf.loss_fn, cfg=jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens))
    return (logits, aux, masks, float(loss),
            cases.flat(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.mark.parametrize("case", list(cases.MOE_MODELS))
def test_sharded_moe_model_matches_unsharded(ranks, case):
    """Routing over the whole batch on every rank: the same masks as the
    unsharded reference, then its logits, aux loss, loss and gradients."""
    logits, aux, masks, loss, grads = _jax_unsharded(case)
    cfg = cases.model_cfg(*cases.MOE_MODELS[case][:2])
    config = cases.MOE_MODELS[case][2]
    sizes = config.axis_sizes()
    specs = cases.flat_axes(cfg)
    for rec in ranks.get():
        coords = {a: int(rec[f"{case}/coord/{a}"]) for a in sizes}
        for i, want in enumerate(masks):
            np.testing.assert_array_equal(rec[f"{case}/dispatch/{i}"], want)
            np.testing.assert_array_equal(rec[f"{case}/loss_dispatch/{i}"],
                                          want)
        blk = cases.np_block(logits, (("dp", "fsdp"), "sp"), sizes, coords)
        np.testing.assert_allclose(rec[f"{case}/logits"], blk, rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(rec[f"{case}/aux"], aux, rtol=1e-4)
        np.testing.assert_allclose(rec[f"{case}/loss"], loss, rtol=1e-4)
        for name, g in grads.items():
            np.testing.assert_allclose(
                rec[f"{case}/grad/{name}"],
                cases.np_block(g, specs[name], sizes, coords), rtol=1e-3,
                atol=1e-5, err_msg=name)


def test_mixtral_shapes_match_reference():
    """param_shapes(mixtral_8x7b) is the JAX init_params tree's, leaf for
    leaf (shapes only, through jax.eval_shape)."""
    jcfg, cfg = jax_configs.mixtral_8x7b, configs.mixtral_8x7b
    tree = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    want = {k: tuple(v.shape) for k, v in cases.flat(tree).items()}
    got = {k: tuple(v[0]) for k, v in cases.flat(param_shapes(cfg)).items()}
    assert got == want
    layer = sum(int(np.prod(s)) for k, s in got.items()
                if k.startswith("layers/")) // cfg.n_layers
    assert layer == 1_451_270_144
