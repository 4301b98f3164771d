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

The experts' operand dtype: with f32 weights the model's expert SwiGLU
is the f32 einsums bit for bit; with bf16 weights it is the dense MLP's
bf16 products taken per expert, within bf16's rounding, with no f32 copy
of a weight; moe_expert_products_total counts each call by that dtype.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from ray_tpu.parallel import moe as jax_moe
from ray_tpu_torch.models import (configs, forward, init_params, loss_fn,
                                  params_from_jax)
from ray_tpu_torch.models import transformer as tf
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


# -- the experts' operand dtype ----------------------------------------------
def _expert_inputs(dtype):
    """Slots as moe_layer hands them over: f32 rows that bf16 holds
    exactly, the last slot of each expert empty; weights in `dtype`. The
    widths differ from every slot shape, so no activation has a weight's
    shape."""
    gen = torch.Generator().manual_seed(21)
    e, c, d, f = 3, 5, 48, 80
    xin = torch.randn((e, c, d), generator=gen).bfloat16().float()
    xin[:, -1] = 0
    w = {n: (torch.randn(s, generator=gen) * 0.05).to(dtype)
         for n, s in (("gate", (e, d, f)), ("up", (e, d, f)),
                      ("down", (e, f, d)))}
    return xin, w, torch.randn((e, c, d), generator=gen)


def _dense_mlp_experts(w, xin):
    """Each expert as the dense MLP takes its products (transformer.py's
    `_layer_body`): bf16 operands, f32 activation and gating."""
    outs = []
    for e in range(xin.shape[0]):
        x = xin[e].bfloat16()
        gate = F.silu((x @ w["gate"][e]).float())
        up = (x @ w["up"][e]).float()
        outs.append(((gate * up).bfloat16() @ w["down"][e]).float())
    return torch.stack(outs)


def _f32_einsum_experts(w, xin):
    """The f32 experts as the port took them before the bf16 path, and as
    the reference's promoted jnp.einsums."""
    g = F.silu(torch.einsum("ecd,edf->ecf", xin, w["gate"].float()))
    u = torch.einsum("ecd,edf->ecf", xin, w["up"].float())
    return torch.einsum("ecf,efd->ecd", g * u, w["down"].float())


def _run(fn, xin, w, ct):
    """fn's output and the gradients of xin and each weight, on fresh
    leaves, with every op's output (dtype, shape) in the forward and the
    backward recorded."""
    xin = xin.clone().requires_grad_(True)
    w = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    with _OpOutputs() as ops:
        out = fn(w, xin)
        (out * ct).sum().backward()
    return out.detach(), xin.grad, {n: t.grad for n, t in w.items()}, ops


class _OpOutputs(TorchDispatchMode):
    """The (dtype, shape) of every tensor an aten op returns."""

    def __enter__(self):
        self.seen = set()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add((t.dtype, tuple(t.shape)))
        return out


def test_bf16_experts_take_the_dense_mlps_products():
    """bf16 weights: the output and every gradient are the dense MLP's
    casts applied per expert, within bf16's rounding (2^-8 relative: the
    batched and the per-expert products may sum in another order, and
    each rounds its bf16 result); no f32 tensor of a weight's shape
    exists in the forward or the backward, and the weights' gradients are
    bf16. The f32 einsums on the same bf16 weights make such copies, so
    the check sees them."""
    xin, w, ct = _expert_inputs(torch.bfloat16)
    got = _run(functools.partial(tf._moe_experts, act=F.silu), xin, w, ct)
    want = _run(_dense_mlp_experts, xin, w, ct)
    tol = {"rtol": 1e-2, "atol": 1e-3}
    torch.testing.assert_close(got[0], want[0], **tol)
    torch.testing.assert_close(got[1], want[1], **tol)
    for n in w:
        assert got[2][n].dtype == torch.bfloat16
        torch.testing.assert_close(got[2][n].float(), want[2][n].float(),
                                   **tol, msg=n)
    weight_f32 = {(torch.float32, tuple(t.shape)) for t in w.values()}
    assert not got[3].seen & weight_f32
    assert _run(_f32_einsum_experts, xin, w, ct)[3].seen & weight_f32


def test_f32_experts_are_the_f32_einsums():
    """f32 weights: the output and every gradient bit for bit the f32
    einsums', the path every parity test against the JAX package runs."""
    xin, w, ct = _expert_inputs(torch.float32)
    got = _run(functools.partial(tf._moe_experts, act=F.silu), xin, w, ct)
    want = _run(_f32_einsum_experts, xin, w, ct)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    for n in w:
        assert torch.equal(got[2][n], want[2][n]), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat", [False, True])
def test_expert_products_counted_per_layer_and_pass(dtype, remat):
    """moe_expert_products_total counts one call per MoE layer and pass
    (the forward, and remat's recompute in the backward) under the
    operand dtype the weights choose, and none under the other."""
    cfg = dataclasses.replace(configs.tiny_moe, dtype=dtype, remat=remat)
    params = init_params(cfg, seed=3, device="cpu")
    for t in cases.flat(params).values():
        t.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(3))
    counters = {t: tf._expert_products(t) for t in ("float32", "bfloat16")}

    def counts():
        return {t: c._deltas.get(key, 0.0) for t, (c, key) in counters.items()}

    before = counts()
    loss_fn(params, tokens, cfg).backward()
    after = counts()
    calls = cfg.n_layers * (2 if remat else 1)
    assert {t: after[t] - before[t] for t in counters} == {
        t: calls if t == str(dtype).removeprefix("torch.") else 0
        for t in counters}


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
