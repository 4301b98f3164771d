"""Rank programs for the multi-rank parity tests of ray_tpu_torch.parallel
(tests/test_torch_parallel.py, tests/test_torch_moe.py), and the inputs
both sides make from seeds.

Each `*_cases(rank, world)` runs on one gloo rank (tests/torch_dist_util
starts them) and returns a dict of numpy arrays: its local outputs and
gradients and its mesh coordinates. The tests rebuild the same inputs
from the same seeds, run the JAX package on them, and compare each
rank's block. This file imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tpu_torch.models import configs, forward, init_params, loss_fn
from ray_tpu_torch.models.transformer import param_logical_axes
from ray_tpu_torch.parallel import (MeshConfig, build_mesh, moe_layer,
                                    pipeline_stages, ring_attention,
                                    shard_params, ulysses_attention)
from ray_tpu_torch.parallel import moe as moe_mod
from ray_tpu_torch.parallel.mesh import (MESH_AXES, axis_index,
                                         logical_to_physical, spec_axes)


def rand(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def np_block(x: np.ndarray, spec, sizes: dict, coords: dict) -> np.ndarray:
    """The block of global `x` that the rank at `coords` holds under
    `spec` (numpy twin of parallel.mesh.local_shard)."""
    for dim, entry in enumerate(spec):
        for axis in spec_axes(entry):
            n = sizes[axis]
            if n > 1:
                x = np.split(x, n, axis=dim)[coords[axis]]
    return x


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def flat_axes(cfg):
    return {k: logical_to_physical(v)
            for k, v in flat(param_logical_axes(cfg)).items()}


# -- primitives --------------------------------------------------------------
ATTN = {"ring": (2, 64, 4, 16), "ulysses": (2, 64, 8, 16)}
PIPE = {"S": 4, "M": 8, "mb": 4, "dim": 16}


def attn_inputs(kind: str):
    shape = ATTN[kind]
    return [rand(s, shape) for s in (1, 2, 3, 4)]  # q, k, v, cotangent


def pipe_inputs():
    p = PIPE
    return (rand(5, (p["S"], p["dim"], p["dim"]), 0.1),
            rand(6, (p["M"], p["mb"], p["dim"])),
            rand(7, (p["M"], p["mb"], p["dim"])))


def pipe_stage(w, x):
    """The JAX test's stage: w is the stage's [1, dim, dim] stack."""
    return torch.tanh(x @ w[0])


# -- models ------------------------------------------------------------------
# name -> (named config, overrides, mesh, tokens [B, L+1], what to run)
SMALL = {"n_layers": 2, "d_model": 32, "d_ff": 64, "vocab_size": 128}
MODELS = {
    "fsdp_tp": ("tiny", {}, MeshConfig(fsdp=2, tp=2), (8, 33), "fwd+grad"),
    "ring": ("tiny", {"attn_impl": "ring", "max_seq": 256}, MeshConfig(sp=4),
             (2, 65), "fwd+grad"),
    "ulysses": ("tiny", {"attn_impl": "ulysses", "max_seq": 256},
                MeshConfig(sp=4), (2, 65), "fwd+grad"),
    "tied_chunked": ("tiny_gemma", {"ce_chunk": 16},
                     MeshConfig(fsdp=2, tp=2), (8, 33), "grad"),
    "pp4": ("tiny", dict(SMALL, n_layers=4), MeshConfig(pp=4), (8, 17),
            "grad"),
    "pp_dp": ("tiny", SMALL, MeshConfig(dp=2, pp=2), (8, 17), "grad"),
    "pp_tp": ("tiny", SMALL, MeshConfig(tp=2, pp=2), (8, 17), "grad"),
}
MOE_MODELS = {
    "moe_dp_ep": ("tiny_moe", {}, MeshConfig(dp=2, ep=2), (4, 17),
                  "fwd+grad"),
    "moe_fsdp_tp": ("tiny_moe", {}, MeshConfig(fsdp=2, tp=2), (4, 17),
                    "fwd+grad"),
    "moe_sp": ("tiny_moe", {"attn_impl": "ring"}, MeshConfig(sp=2, ep=2),
               (2, 17), "fwd+grad"),
}


def model_cfg(name, overrides):
    return dataclasses.replace(configs.NAMED_CONFIGS[name], **overrides)


def model_inputs(case: str, table=None):
    """(port config, numpy params, numpy tokens) of a model case."""
    name, overrides, _, tok_shape, _ = (table or {**MODELS,
                                                   **MOE_MODELS})[case]
    cfg = model_cfg(name, overrides)
    params = {k: (v.numpy() if not isinstance(v, dict)
                  else {kk: vv.numpy() for kk, vv in v.items()})
              for k, v in init_params(cfg, seed=11, device="cpu").items()}
    tokens = np.random.default_rng(12).integers(
        0, cfg.vocab_size, size=tok_shape).astype(np.int64)
    return cfg, params, tokens


def _mesh(config: MeshConfig):
    mesh = build_mesh(config, "cpu")
    coords = {a: axis_index(mesh, a) for a in MESH_AXES}
    return mesh, coords


def _coord_rec(prefix, coords):
    return {f"{prefix}/coord/{a}": np.array(i) for a, i in coords.items()}


class _RecordDispatch:
    """Wraps parallel.moe.route to keep each call's routing as the
    reference's one-hot dispatch mask."""

    def __init__(self):
        self.masks = []
        self.orig = moe_mod.route

    def __enter__(self):
        def wrapped(logits, k, capacity, *args, **kwargs):
            out = self.orig(logits, k, capacity, *args, **kwargs)
            expert, slot, gate, _ = out
            d, _ = moe_mod.dense_masks(expert, slot, gate.detach(),
                                       logits.shape[-1], capacity)
            self.masks.append(d.numpy().copy())
            return out
        moe_mod.route = wrapped
        return self

    def __exit__(self, *exc):
        moe_mod.route = self.orig


def _model_case(name, table, out):
    _, _, config, _, what = table[name]
    cfg, params, tokens = model_inputs(name, table)
    mesh, coords = _mesh(config)
    out.update(_coord_rec(name, coords))
    full = {k: (torch.from_numpy(v) if not isinstance(v, dict)
                else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
            for k, v in params.items()}
    local = shard_params(full, param_logical_axes(cfg), mesh)
    sizes = config.axis_sizes()
    batch = np_block(tokens, (("dp", "fsdp"),), sizes, coords)
    if "fwd" in what:
        blk = np_block(tokens[:, :-1], (("dp", "fsdp"), "sp"), sizes, coords)
        with torch.no_grad(), _RecordDispatch() as rec:
            logits, aux = forward(local, torch.from_numpy(blk), cfg, mesh)
        out[f"{name}/logits"] = logits.numpy()
        out[f"{name}/aux"] = aux.numpy()
        for i, m in enumerate(rec.masks):
            out[f"{name}/dispatch/{i}"] = m
    leaves = flat(local)
    for t in leaves.values():
        t.requires_grad_(True)
    with _RecordDispatch() as rec:
        loss = loss_fn(local, torch.from_numpy(batch), cfg, mesh)
    loss.backward()
    out[f"{name}/loss"] = loss.detach().numpy()
    for i, m in enumerate(rec.masks[:cfg.n_layers]):
        out[f"{name}/loss_dispatch/{i}"] = m
    for k, t in leaves.items():
        out[f"{name}/grad/{k}"] = t.grad.numpy()


# -- rank programs -----------------------------------------------------------
def parallel_cases(rank: int, world: int) -> dict:
    out = {}
    # The mesh: axis order and this rank's coordinates; shard_params.
    mesh, coords = _mesh(MeshConfig(fsdp=2, tp=2))
    out["mesh/ranks"] = mesh.mesh.numpy()
    out["mesh/names"] = np.array(mesh.mesh_dim_names)
    out.update(_coord_rec("mesh", coords))
    w = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    sharded = shard_params({"w": torch.from_numpy(w), "b": torch.ones(16)},
                           {"w": ("embed", "mlp"), "b": None}, mesh)
    out["shard/w"] = sharded["w"].numpy()
    out["shard/b"] = sharded["b"].numpy()

    # Ring attention (causal and not) and Ulysses at sp=4, with gradients.
    mesh, coords = _mesh(MeshConfig(sp=4))
    out.update(_coord_rec("sp", coords))
    for kind, causals in (("ring", (True, False)), ("ulysses", (True,))):
        arrays = attn_inputs(kind)
        for causal in causals:
            q, k, v, ct = (torch.from_numpy(np.ascontiguousarray(
                np.split(a, 4, axis=1)[coords["sp"]])) for a in arrays)
            for t in (q, k, v):
                t.requires_grad_(True)
            fn = ring_attention if kind == "ring" else ulysses_attention
            o = fn(q, k, v, mesh, axis_name="sp", causal=causal)
            (o * ct).sum().backward()
            key = f"{kind}/{causal}"
            out[f"{key}/o"] = o.detach().numpy()
            for n, t in (("dq", q), ("dk", k), ("dv", v)):
                out[f"{key}/{n}"] = t.grad.numpy()

    # The GPipe schedule at pp=4 against the sequential stages.
    mesh, coords = _mesh(MeshConfig(pp=4))
    ws, xs, ct = pipe_inputs()
    s = coords["pp"]
    w_local = torch.from_numpy(ws[s:s + 1].copy()).requires_grad_(True)
    x = torch.from_numpy(xs).requires_grad_(True)
    y = pipeline_stages(pipe_stage, w_local, x, mesh, axis_name="pp")
    (y * torch.from_numpy(ct)).sum().backward()
    out["pipe/coord"] = np.array(s)
    out["pipe/y"] = y.detach().numpy()
    out["pipe/dw"] = w_local.grad.numpy()
    out["pipe/dx"] = x.grad.numpy()

    for name in MODELS:
        _model_case(name, MODELS, out)
    return out


def moe_cases(rank: int, world: int) -> dict:
    out = {}
    # moe_layer with the experts split over ep=4 (the JAX ep test's shapes).
    mesh, coords = _mesh(MeshConfig(ep=4))
    x, router, w, ct = moe_layer_inputs()
    e = coords["ep"]
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(router).requires_grad_(True)
    wt = torch.from_numpy(w[e:e + 1].copy()).requires_grad_(True)
    y, aux = moe_layer(xt, rt, moe_expert_fn, wt, k=2, mesh=mesh)
    ((y * torch.from_numpy(ct)).sum() + aux).backward()
    out["ep/coord"] = np.array(e)
    out["ep/y"] = y.detach().numpy()
    out["ep/aux"] = aux.detach().numpy()
    out["ep/dx"] = xt.grad.numpy()
    out["ep/drouter"] = rt.grad.numpy()
    out["ep/dw"] = wt.grad.numpy()
    for name in MOE_MODELS:
        _model_case(name, MOE_MODELS, out)
    return out


MOE_LAYER = {"tokens": 32, "d": 16, "experts": 4}


def moe_layer_inputs():
    t, d, e = MOE_LAYER["tokens"], MOE_LAYER["d"], MOE_LAYER["experts"]
    return (rand(8, (t, d)), rand(9, (d, e), 0.1), rand(10, (e, d, d), 0.1),
            rand(13, (t, d)))


def moe_expert_fn(w, xin):  # xin: [E, C, D]
    return torch.einsum("ecd,edf->ecf", xin, w)


# -- a card's share of the experts, split over ep ----------------------------
MLA_MOE = {"tokens": 48, "d": 16, "experts": 8}
MLA_MOE_ROUTING = {"k": 3, "router": "sigmoid_bias", "norm_topk_prob": True,
                   "routed_scaling_factor": 2.5}


def mla_moe_inputs():
    """x, router, the correction bias, the experts' weights and a
    cotangent for moe_layer with DeepSeek-style routing."""
    t, d, e = MLA_MOE["tokens"], MLA_MOE["d"], MLA_MOE["experts"]
    return (rand(31, (t, d)), rand(32, (d, e), 0.3), rand(33, (e,), 0.5),
            rand(34, (e, d, d), 0.1), rand(35, (t, d)))


def mla_moe_cases(rank: int, world: int) -> dict:
    """moe_layer with the experts split over ep = world: each rank's
    output and gradients."""
    mesh, coords = _mesh(MeshConfig(ep=world))
    x, router, bias, w, ct = mla_moe_inputs()
    e, n = coords["ep"], MLA_MOE["experts"] // world
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(router).requires_grad_(True)
    wt = torch.from_numpy(w[e * n:(e + 1) * n].copy()).requires_grad_(True)
    y, _ = moe_layer(xt, rt, moe_expert_fn, wt, mesh=mesh,
                     router_bias=torch.from_numpy(bias), **MLA_MOE_ROUTING)
    (y * torch.from_numpy(ct)).sum().backward()
    return {"coord": np.array(e), "y": y.detach().numpy(),
            "dx": xt.grad.numpy(), "drouter": rt.grad.numpy(),
            "dw": wt.grad.numpy()}
