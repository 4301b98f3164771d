"""Parity of ray_tpu_torch.parallel (mesh, ring and Ulysses attention, the
GPipe schedule) and of the sharded model paths with the JAX package.

The port's side runs once per module on four gloo ranks of the CPU
(tests/torch_dist_cases.py:parallel_cases through torch_dist_util); the
JAX side runs the reference on four of the virtual CPU devices at the
same mesh shape, or unsharded where the claim is that a sharded run
computes what the unsharded one does. Inputs come from numpy seeds on
both sides; model weights from the port's init_params(seed=11), handed to
JAX as numpy.

Tolerances, f32: the ring and Ulysses primitives within rtol=atol=2e-4
and the pipeline within 1e-5 (the reference tests' own); the sharded
model forwards within 2e-3 (fsdp x tp) and 3e-3 (sequence-parallel), as
the reference's tests hold GSPMD; every sharded loss within rtol 1e-4
of the unsharded JAX loss and every gradient block within rtol 1e-3,
atol 1e-5 of the unsharded JAX gradient.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu import parallel as jpar
from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from ray_tpu.parallel.ring_attention import reference_attention
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import configs
from ray_tpu_torch.models.transformer import param_logical_axes

import torch_dist_cases as cases
from torch_dist_util import Ranks

torch.set_num_threads(1)
WORLD = 4


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The ranks start at the module's first test and run while the JAX
    side computes: a test calls `ranks.get()` after its JAX work."""
    handle = Ranks("tests/torch_dist_cases.py:parallel_cases", WORLD,
                   tmp_path_factory.mktemp("parallel"))
    yield handle
    handle.stop()


def _jmesh(config):
    return jpar.build_mesh(jpar.MeshConfig(**config.axis_sizes()),
                           jax.devices()[:WORLD])


def _coords(rec, prefix):
    return {a: int(rec[f"{prefix}/coord/{a}"]) for a in tpar.mesh.MESH_AXES}


def _jax_cfg(case, table):
    name, overrides = table[case][:2]
    return dataclasses.replace(jax_configs.NAMED_CONFIGS[name], **overrides)


# -- the mesh ----------------------------------------------------------------
@pytest.mark.parametrize("n,kw", [(8, {"tp": 2}), (8, {"tp": 3}),
                                  (16, {"sp": 2, "pp": 2, "pure_dp": 2}),
                                  (6, {"ep": 4}), (12, {"ep": 3, "tp": 2})])
def test_mesh_config_factorization(n, kw):
    def run(cls):
        try:
            return dataclasses.astuple(cls.for_devices(n, **kw))
        except ValueError as e:
            return str(e)
    assert run(tpar.MeshConfig) == run(jpar.MeshConfig)
    if not isinstance(run(tpar.MeshConfig), str):
        assert tpar.MeshConfig.for_devices(n, **kw).num_devices == n


@pytest.mark.parametrize("cfg_name", ["tiny", "tiny_moe", "tiny_qwen",
                                      "tiny_gemma"])
def test_logical_axes_and_partition_specs(cfg_name):
    """param_logical_axes matches the reference's tree, and every leaf's
    logical axes map to the reference's PartitionSpec."""
    jcfg = jax_configs.NAMED_CONFIGS[cfg_name]
    mine = cases.flat(param_logical_axes(configs.NAMED_CONFIGS[cfg_name]))
    want = cases.flat(jax_tf.param_logical_axes(jcfg))
    assert mine == want
    extra = [("batch", "seq", "act_heads"), ("batch", None, "act_mlp"),
             ("embed", "embed"), ("vocab", "heads"), (None,), ()]
    for axes in list(want.values()) + extra:
        assert tpar.logical_to_physical(axes) == tuple(
            jpar.logical_to_physical(axes)), axes


# -- ring attention, Ulysses, GPipe ------------------------------------------
def _jax_attention(kind, causal):
    q, k, v, ct = (jnp.asarray(a) for a in cases.attn_inputs(kind))
    mesh = _jmesh(tpar.MeshConfig(sp=4))
    fn = jpar.ring_attention if kind == "ring" else jpar.ulysses_attention

    def loss(q, k, v):
        o = fn(q, k, v, mesh, axis_name="sp", causal=causal)
        return (o * ct).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
    return {"o": o, "dq": grads[0], "dk": grads[1], "dv": grads[2]}


@pytest.mark.parametrize("kind,causal", [("ring", True), ("ring", False),
                                         ("ulysses", True)])
def test_sequence_parallel_attention_matches_reference(ranks, kind, causal):
    want = _jax_attention(kind, causal)
    q, k, v, _ = cases.attn_inputs(kind)
    unsharded = np.asarray(reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got_o = []
    for rec in ranks.get():
        i = _coords(rec, "sp")["sp"]
        for name, arr in want.items():
            blk = np.split(np.asarray(arr), 4, axis=1)[i]
            np.testing.assert_allclose(rec[f"{kind}/{causal}/{name}"], blk,
                                       rtol=2e-4, atol=2e-4, err_msg=name)
        got_o.append(rec[f"{kind}/{causal}/o"])
    np.testing.assert_allclose(np.concatenate(got_o, axis=1), unsharded,
                               rtol=2e-4, atol=2e-4)


def test_pipeline_matches_sequential(ranks):
    ws, xs, ct = (jnp.asarray(a) for a in cases.pipe_inputs())
    S = cases.PIPE["S"]

    def stage_fn(w, x):
        return jnp.tanh(x @ w[0])

    got = jpar.pipeline_stages(stage_fn, ws, xs, _jmesh(tpar.MeshConfig(pp=S)),
                               axis_name="pp")

    def sequential(ws, xs):
        out = xs
        for s in range(S):
            out = jax.vmap(lambda x: stage_fn(ws[s:s + 1], x))(out)
        return (out * ct).sum(), out

    (_, seq), (dw, dx) = jax.jit(jax.value_and_grad(
        sequential, argnums=(0, 1), has_aux=True))(ws, xs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(seq), rtol=1e-5,
                               atol=1e-5)
    for rec in ranks.get():
        s = int(rec["pipe/coord"])
        np.testing.assert_allclose(rec["pipe/y"], np.asarray(got), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(rec["pipe/dw"], np.asarray(dw)[s:s + 1],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rec["pipe/dx"], np.asarray(dx), rtol=1e-5,
                                   atol=1e-5)


# -- the model under a mesh --------------------------------------------------
def _jax_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_sharded_forward(case, table_name):
    table = getattr(cases, table_name)
    jcfg = _jax_cfg(case, table)
    _, params, tokens = cases.model_inputs(case, table)
    mesh = _jmesh(table[case][2])
    sharded = jpar.shard_params(_jax_params(params),
                                jax_tf.param_logical_axes(jcfg), mesh)
    inputs = tokens[:, :-1].astype(np.int32)
    spec = P(("dp", "fsdp"), "sp")
    tok = jax.device_put(jnp.asarray(inputs), NamedSharding(mesh, spec))
    logits, aux = jax.jit(lambda p, t: jax_tf.forward(p, t, jcfg,
                                                      mesh=mesh))(sharded, tok)
    return np.asarray(logits), float(aux)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(case, table_name):
    table = getattr(cases, table_name)
    jcfg = _jax_cfg(case, table)
    _, params, tokens = cases.model_inputs(case, table)
    loss, grads = jax.jit(jax.value_and_grad(
        functools.partial(jax_tf.loss_fn, cfg=jcfg)))(
        _jax_params(params), jnp.asarray(tokens.astype(np.int32)))
    return float(loss), cases.flat(jax.tree_util.tree_map(np.asarray, grads))


def check_forward(ranks, case, table_name, tol):
    table = getattr(cases, table_name)
    want, aux = _jax_sharded_forward(case, table_name)
    sizes = table[case][2].axis_sizes()
    for rec in ranks.get():
        blk = cases.np_block(want, (("dp", "fsdp"), "sp"), sizes,
                             _coords(rec, case))
        np.testing.assert_allclose(rec[f"{case}/logits"], blk, rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(rec[f"{case}/aux"], aux, rtol=1e-4,
                                   atol=1e-6)


def check_loss_and_grads(ranks, case, table_name):
    table = getattr(cases, table_name)
    loss, grads = _jax_loss_and_grads(case, table_name)
    cfg = cases.model_cfg(*table[case][:2])
    specs = cases.flat_axes(cfg)
    sizes = table[case][2].axis_sizes()
    for rec in ranks.get():
        np.testing.assert_allclose(rec[f"{case}/loss"], loss, rtol=1e-4)
        coords = _coords(rec, case)
        for name, g in grads.items():
            blk = cases.np_block(g, specs[name], sizes, coords)
            np.testing.assert_allclose(rec[f"{case}/grad/{name}"], blk,
                                       rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case,tol", [("fsdp_tp", 2e-3), ("ring", 3e-3),
                                      ("ulysses", 3e-3)])
def test_sharded_forward_matches_reference_mesh(ranks, case, tol):
    check_forward(ranks, case, "MODELS", tol)


@pytest.mark.parametrize("case", list(cases.MODELS))
def test_sharded_loss_and_grads_match_unsharded(ranks, case):
    check_loss_and_grads(ranks, case, "MODELS")


# -- the mesh on the ranks (last: by then the ranks are done) ---------------
def test_build_mesh_axis_order_and_coordinates(ranks):
    jm = _jmesh(tpar.MeshConfig(fsdp=2, tp=2))
    want = np.vectorize(lambda d: d.id)(jm.devices)
    for r, rec in enumerate(ranks.get()):
        np.testing.assert_array_equal(rec["mesh/ranks"], want)
        assert tuple(rec["mesh/names"]) == jm.axis_names
        pos = np.argwhere(want == r)[0]
        coords = _coords(rec, "mesh")
        assert [coords[a] for a in jm.axis_names] == list(pos)


def test_shard_params_gives_each_rank_its_block(ranks):
    jm = _jmesh(tpar.MeshConfig(fsdp=2, tp=2))
    w = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    sharded = jpar.shard_params({"w": jnp.asarray(w), "b": jnp.ones(16)},
                                {"w": ("embed", "mlp"), "b": None}, jm)
    shards = {s.device.id: np.asarray(s.data)
              for s in sharded["w"].addressable_shards}
    for r, rec in enumerate(ranks.get()):
        assert rec["shard/w"].shape == (4, 8)
        np.testing.assert_array_equal(rec["shard/w"], shards[r])
        np.testing.assert_array_equal(rec["shard/b"], np.ones(16))
