"""The port's latent attention (MLA) and DeepSeek-style experts against the
benchmark's plain reference (portbench/reference/mistral4.py, plain torch
in f32, which imports nothing of the port), on the CPU at toy widths.

* `loss_fn` on tiny_mla (YaRN rope with interleaved pairs, the llama-4
  query scale past the original context, sigmoid routing with a
  correction bias, renormalised gates, capacity drops, a shared expert, a
  card's share of the experts): the loss and every gradient.
* YaRN's tables, the interleaved rope and the softmax scale, at toy and at
  the published widths; the benchmark's configuration file is
  `configs.mistral_small_4` with its stated cuts.
* Dispatch and combine by index against the reference's one-hot einsums
  on the same routing, both routers, a share of the experts or all.
* The share test: the routed parts of all shares, plus the shared expert
  once, are the uncut reference layer.
* ep = 2 on gloo ranks equals the two `experts_held` halves.
* The routed-assignment counter; the serving engine's refusal of MLA.

Tolerances, f32: the model's loss within rtol 1e-5 and each gradient
within rtol 1e-4, atol 1e-6 (the same arithmetic summed in another order:
blocked against whole attention, index_add against a loop over experts);
the routing itself is compared exactly first, so a flipped choice cannot
hide in a tolerance. The index and one-hot forms: rtol 1e-5, atol 1e-6
(a token's k terms, and the router's gradient over the slots, summed in
another order: up to 4.4e-7 apart on gradients of order 0.01-0.1).
"""

import dataclasses
import functools
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import mla
from portbench.drivers import train_mla
from portbench.reference import mistral4 as ref
from portbench.reference.model import Precision
from ray_tpu_torch.models import configs, init_params, loss_fn
from ray_tpu_torch.models import transformer as tf
from ray_tpu_torch.ops import apply_rope
from ray_tpu_torch.ops.rope import deinterleave, yarn_tables
from ray_tpu_torch.parallel import moe as moe_mod

import torch_dist_cases as cases
from torch_dist_util import Ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _dims(cfg):
    """The reference's sizes of a port config."""
    held = cfg.experts_held or range(cfg.num_experts)
    return {
        "d": cfg.d_model, "layers": cfg.n_layers, "heads": cfg.n_heads,
        "q_rank": cfg.q_lora_rank, "kv_rank": cfg.kv_lora_rank,
        "nope": cfg.qk_nope_dim, "rope": cfg.qk_rope_dim,
        "v": cfg.v_head_dim, "experts": cfg.num_experts,
        "held": (held.start, held.stop), "top_k": cfg.experts_per_token,
        "moe_ff": cfg.expert_d_ff, "shared": cfg.n_shared_experts,
        "norm_topk": cfg.norm_topk_prob,
        "routed_scale": cfg.routed_scaling_factor, "capacity_factor": 1.25,
        "vocab": cfg.vocab_size, "eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta, "rope_factor": cfg.rope_factor,
        "rope_original_max": cfg.rope_original_max,
        "beta_fast": cfg.beta_fast, "beta_slow": cfg.beta_slow,
        "mscale": cfg.mscale, "mscale_all_dim": cfg.mscale_all_dim,
        "llama4_beta": cfg.llama4_scaling_beta,
        "interleave": cfg.rope_interleave,
    }


def _leaves(params):
    return {k: v for k, v in cases.flat(params).items()
            if not k.endswith("router_bias")}


def _reference_loss(params, tokens, cfg, prec=None):
    """The reference's forward and loss on the port's parameter tree."""
    dm, prec = _dims(cfg), prec or Precision()
    inp, lab = tokens[:, :-1], tokens[:, 1:]
    x = params["embed"][inp]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        x = ref.layer(x, lp, dm, prec, i)
    logits = ref.rms(x, params["final_norm"], cfg.norm_eps) @ \
        params["lm_head"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           lab.reshape(-1))


def _routes(fn):
    """fn() with every moe.route call's experts and slots recorded."""
    got, orig = [], moe_mod.route

    def logged(*args, **kwargs):
        out = orig(*args, **kwargs)
        got.append((out[0].clone(), out[1].clone()))
        return out

    moe_mod.route = logged
    try:
        return fn(), got
    finally:
        moe_mod.route = orig


@pytest.mark.parametrize("held", [None, range(2, 6)], ids=["all", "share"])
def test_loss_and_every_gradient_match_the_reference(held):
    cfg = dataclasses.replace(configs.tiny_mla, experts_held=held)
    params = init_params(cfg, seed=7, device="cpu")
    # A correction bias that moves choices, as a trained one would.
    params["layers"]["router_bias"] = torch.linspace(
        -0.2, 0.2, cfg.num_experts).repeat(cfg.n_layers, 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 41),
                           generator=torch.Generator().manual_seed(8))
    leaves = _leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, routes = _routes(lambda: loss_fn(params, tokens, cfg))
    loss.backward()
    got = {k: t.grad.clone() for k, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
    want_routes = []
    orig_route = Precision.route

    def record(self, key, choice):
        want_routes.append(choice.T)
        return choice

    Precision.route = record
    try:
        want = _reference_loss(params, tokens, cfg)
    finally:
        Precision.route = orig_route
    want.backward()
    assert len(routes) == len(want_routes) == cfg.n_layers
    for (expert, slot), choice in zip(routes, want_routes):
        assert torch.equal(expert, choice)
    # Some pairs were dropped past capacity, and some kept.
    cap = int(1.25 * 80 * cfg.experts_per_token / cfg.num_experts)
    assert any(bool((slot >= cap).any()) for _, slot in routes)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    for k, t in leaves.items():
        torch.testing.assert_close(got[k], t.grad, rtol=1e-4, atol=1e-6,
                                   msg=k)
        if k.endswith(("w_gate", "w_up", "w_down", "wkv_b", "router")):
            assert float(t.grad.abs().sum()) > 0, k


def test_yarn_tables_and_interleaved_rope_match_the_reference():
    for cfg in (configs.tiny_mla, configs.mistral_small_4):
        dm, L = _dims(cfg), 8192 if cfg.d_model > 64 else 64
        cos, sin = yarn_tables(cfg.qk_rope_dim, L, cfg.rope_theta,
                               cfg.rope_factor, cfg.rope_original_max,
                               cfg.beta_fast, cfg.beta_slow, cfg.mscale,
                               cfg.mscale_all_dim, torch.device("cpu"))
        rcos, rsin = ref.yarn_cos_sin(dm, L, "cpu")
        half = cfg.qk_rope_dim // 2
        torch.testing.assert_close(cos, rcos[:, :half], rtol=0, atol=2e-6)
        torch.testing.assert_close(sin, rsin[:, :half], rtol=0, atol=2e-6)
        x = torch.randn((2, L, 3, cfg.qk_rope_dim),
                        generator=torch.Generator().manual_seed(L))
        torch.testing.assert_close(
            apply_rope(deinterleave(x), cos, sin),
            ref.rope(x, rcos, rsin, True), rtol=0, atol=1e-5)
    # The published model: 2.2058 * 128^-0.5, DeepSeek-V3's scale.
    scale = tf.mla_softmax_scale(configs.mistral_small_4)
    assert scale == pytest.approx(ref.softmax_scale(
        _dims(configs.mistral_small_4)), rel=1e-12)
    assert scale * 128 ** 0.5 == pytest.approx(
        (0.1 * math.log(128) + 1) ** 2, rel=1e-12)
    assert round(scale * 128 ** 0.5, 4) == 2.2058


def test_the_cell_runs_the_named_config_with_its_stated_cuts():
    doc = json.loads((ROOT / "portbench/configs/mistral-small-4.json")
                     .read_text())
    dm = mla.dims(doc)
    cfg = train_mla.port_config(dm, {"remat_policy": "full"})
    named = configs.mistral_small_4
    assert cfg == dataclasses.replace(
        named, n_layers=9, vocab_size=16384, experts_held=range(0, 16),
        d_ff=named.moe_d_ff, remat=True)
    assert doc["published"] == {"num_hidden_layers": named.n_layers,
                                "n_routed_experts": named.num_experts,
                                "vocab_size": named.vocab_size}
    assert mla.param_count(dm) == 4_241_841_408
    shapes = tf.param_shapes(cfg)
    got = {f"layers.{k}": v[0] for k, v in shapes["layers"].items()}
    got.update({k: v[0] for k, v in shapes.items() if k != "layers"})
    assert got == {k: v[0] for k, v in mla.leaf_shapes(dm).items()}


def _dense_moe(x, router_w, expert_fn, w, held, **routing):
    """The reference's one-hot dispatch and combine einsums on `route`'s
    routing, the held experts' block of the masks."""
    tokens, e = x.shape[0], router_w.shape[-1]
    k = routing.pop("k")
    cap = max(1, int(1.25 * tokens * k / e))
    expert, slot, gate, _ = moe_mod.route(
        x @ router_w, k, cap, routing.get("router", "softmax"),
        routing.get("router_bias"), routing.get("norm_topk_prob", False),
        routing.get("routed_scaling_factor", 1.0))
    dispatch, combine = moe_mod.dense_masks(expert, slot, gate, e, cap)
    dispatch, combine = (m[:, held.start:held.stop]
                         for m in (dispatch, combine))
    xin = torch.einsum("tec,td->ecd", dispatch, x)
    return torch.einsum("tec,ecd->td", combine, expert_fn(w, xin))


@pytest.mark.parametrize("held", [None, range(2, 6)], ids=["all", "share"])
@pytest.mark.parametrize("routing", [
    {"k": 2},
    {"k": 3, "router": "sigmoid_bias", "norm_topk_prob": True,
     "routed_scaling_factor": 2.5}], ids=["softmax", "sigmoid_bias"])
def test_index_dispatch_equals_the_one_hot_einsums(routing, held):
    x, router, bias, w, ct = (torch.from_numpy(a) for a in
                              cases.mla_moe_inputs())
    routing = dict(routing)
    if routing.get("router") == "sigmoid_bias":
        routing["router_bias"] = bias
    share = held or range(w.shape[0])
    w = w[share.start:share.stop]
    outs = []
    for fn in (lambda *a: moe_mod.moe_layer(*a, experts_held=held,
                                            **routing)[0],
               lambda *a: _dense_moe(*a, share, **dict(routing))):
        leaves = [t.clone().requires_grad_(True) for t in (x, router, w)]
        y = fn(leaves[0], leaves[1], cases.moe_expert_fn, leaves[2])
        (y * ct).sum().backward()
        outs.append([y.detach()] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_shares_and_the_shared_expert_add_up_to_the_uncut_layer():
    cfg = dataclasses.replace(configs.tiny_mla, experts_per_token=3)
    params = init_params(cfg, seed=11, device="cpu")
    lp = {k: v[0] for k, v in params["layers"].items()}
    lp["router_bias"] = torch.linspace(-0.3, 0.3, cfg.num_experts)
    h = torch.randn((70, cfg.d_model),
                    generator=torch.Generator().manual_seed(12))
    whole = _dims(cfg)
    want = ref.moe(h, lp, whole, Precision()) + ref._swiglu(
        h, lp["w_shared_gate"], lp["w_shared_up"], lp["w_shared_down"],
        Precision())
    got = tf._swiglu(cfg, h, lp["w_shared_gate"], lp["w_shared_up"],
                     lp["w_shared_down"], None)
    for lo in range(0, cfg.num_experts, 2):
        share = range(lo, lo + 2)
        part = dataclasses.replace(cfg, experts_held=share)
        w = {n: lp[f"w_{n}"][lo:lo + 2] for n in ("gate", "up", "down")}
        routed, _ = moe_mod.moe_layer(
            h, lp["router"], functools.partial(tf._moe_experts, act=F.silu),
            w, k=part.experts_per_token, router=part.router,
            router_bias=lp["router_bias"], norm_topk_prob=True,
            experts_held=share)
        mine = ref.moe(h, dict(lp, w_gate=w["gate"], w_up=w["up"],
                               w_down=w["down"]),
                       dict(whole, held=(lo, lo + 2)), Precision())
        torch.testing.assert_close(routed, mine, rtol=1e-5, atol=1e-6)
        got = got + routed
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_ep_ranks_equal_the_experts_held_halves(tmp_path):
    ranks = Ranks("tests/torch_dist_cases.py:mla_moe_cases", 2, tmp_path)
    x, router, bias, w, ct = (torch.from_numpy(a) for a in
                              cases.mla_moe_inputs())
    n = w.shape[0] // 2
    y, dx, drouter, dw = 0, 0, 0, []
    for half in range(2):
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, router, w[half * n:(half + 1) * n])]
        part, _ = moe_mod.moe_layer(
            leaves[0], leaves[1], cases.moe_expert_fn, leaves[2],
            router_bias=bias, experts_held=range(half * n, (half + 1) * n),
            **cases.MLA_MOE_ROUTING)
        (part * ct).sum().backward()
        y, dx, drouter = (y + part.detach(), dx + leaves[0].grad,
                          drouter + leaves[1].grad)
        dw.append(leaves[2].grad)
    for rec in ranks.get():
        e = int(rec["coord"])
        np.testing.assert_allclose(rec["y"], y.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rec["dx"], dx.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rec["drouter"], drouter.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rec["dw"], dw[e].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_routed_assignments_are_counted_only_while_a_profiler_records():
    cfg = dataclasses.replace(configs.tiny_mla, remat=True,
                              experts_held=range(0, 4))
    params = init_params(cfg, seed=3, device="cpu")
    for t in _leaves(params).values():
        t.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 41),
                           generator=torch.Generator().manual_seed(3))
    moe_mod.routed_assignments()
    loss_fn(params, tokens, cfg).backward()
    assert moe_mod.routed_assignments() == {"kept": 0, "dropped": 0}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        _, routes = _routes(lambda: loss_fn(params, tokens, cfg).backward())
    got = moe_mod.routed_assignments()
    cap = int(1.25 * 80 * cfg.experts_per_token / cfg.num_experts)
    # The forward's routing in each layer; remat's recompute not again.
    want = {"kept": 0, "dropped": 0}
    for expert, slot in routes[:cfg.n_layers]:
        mine = expert < 4
        want["kept"] += int((mine & (slot < cap)).sum())
        want["dropped"] += int((mine & (slot >= cap)).sum())
    assert len(routes) == 2 * cfg.n_layers
    assert got == want and got["kept"] > 0


def test_the_serving_engine_refuses_latent_attention():
    from ray_tpu_torch.serve.llm import ContinuousBatchingEngine, LLMReplica

    cfg = configs.tiny_mla
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        ContinuousBatchingEngine(params, cfg)
    with pytest.raises(ValueError, match="MLA"):
        LLMReplica(lambda: (params, cfg))


def _tiny_cell():
    """The benchmark's latent-attention cell at toy widths."""
    import copy

    from portbench import harness

    cell = harness.Cell(harness.load_benchmark(), "mistral-small-4-train-8k")
    doc = copy.deepcopy(cell.config)
    doc.update({"hidden_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4, "q_lora_rank": 32,
                "kv_lora_rank": 16, "qk_nope_head_dim": 8,
                "qk_rope_head_dim": 8, "v_head_dim": 16,
                "moe_intermediate_size": 32, "vocab_size": 256,
                "n_routed_experts": 4, "experts_held": [2, 6],
                "published": {"n_routed_experts": 16}})
    doc["rope_parameters"] = dict(doc["rope_parameters"], factor=4,
                                  original_max_position_embeddings=16)
    cell.config = doc
    cell.traffic = dict(cell.traffic, batch=2, seq=32)
    return cell


@pytest.mark.parametrize("fault", [None, "state_unchanged"])
def test_the_cells_driver_runs_and_its_comparison_catches_a_fault(
        fault, monkeypatch):
    """The cell's driver end to end on the CPU at toy widths (the bf16
    program against the f32 reference): correct, with every span reader's
    metric; with AdamW's step a no-op, not correct."""
    import time

    from portbench import harness

    if fault:
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, *a, **k: None)
    cell = _tiny_cell()
    run = harness.Run(cell, 3_000_000_123, 0.5, True, torch.device("cpu"),
                      time.perf_counter())
    cell.driver().drive(run)
    assert run.correct == (fault is None), run.checks
    line = harness.result(run, "cpu")
    for name in ("mla_latent_ms_per_step.train",
                 "moe_shared_ms_per_step.train", "mfu.train",
                 "moe_routing_dispatch_ms_per_step.train",
                 "head_ms_per_step.train"):
        assert name in line["metrics"], name
    counted = run.notes["moe_routed_assignments_total"]
    assert counted["kept"] > 0
    assert "memory_peak_bytes" in run.notes
