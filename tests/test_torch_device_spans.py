"""Device-time spans inside the port's model (util/profiling.device_span):
the model's layers and the MoE's parts timed in the forward, remat's
recompute and the backward, while a torch profiler records; off, they
change and record nothing. Also the flight recorder's per-step device_ms
and its count of kernels built with nvcc, and the benchmark's readers of
the spans. CPU only: the CPU's spans read the host clock."""

import dataclasses
import os
import time
import types

import pytest
import torch

from portbench import harness, spans, yardstick
from ray_tpu_torch import _build
from ray_tpu_torch.models import configs, init_params, loss_fn
from ray_tpu_torch.models.transformer import forward_pipelined
from ray_tpu_torch.train import StepProfiler
from ray_tpu_torch.util import profiling

MODEL = ("model.embed", "model.attention", "model.mlp", "model.head")
INNER = yardstick.MOE_RANGES
LAYERED = ("model.attention", "model.mlp") + INNER


def _cfg(remat=True, **kw):
    return dataclasses.replace(configs.tiny_moe, remat=remat,
                               remat_policy="full", n_kv_heads=2, **kw)


def _setup(cfg):
    params = init_params(cfg, seed=0, device="cpu")
    leaves = [params["embed"], params["lm_head"], params["final_norm"],
              *params["layers"].values()]
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    return params, leaves, tokens


def _nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        todo.extend(f for f, _ in n.next_functions)
    return seen


def _step(params, leaves, tokens, cfg):
    for p in leaves:
        p.grad = None
    loss = loss_fn(params, tokens, cfg, aux_weight=0.02)
    nodes = _nodes(loss)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in leaves], nodes


@pytest.fixture(autouse=True)
def _clean_spans():
    profiling.reset_device_spans()
    yield
    profiling.reset_device_spans()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def spans_on():
    with _profiler():
        yield


def _is_marker(node):
    return type(node).__name__ in ("_EnterBackward", "_LeaveBackward")


def test_spans_change_no_loss_or_gradient_and_add_no_node_when_off():
    cfg = _cfg(dtype=torch.bfloat16)
    params, leaves, tokens = _setup(cfg)
    loss_off, grads_off, nodes_off = _step(params, leaves, tokens, cfg)
    with _profiler():
        loss_on, grads_on, nodes_on = _step(params, leaves, tokens, cfg)
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(grads_off, grads_on))
    markers = [n for n in nodes_on if _is_marker(n)]
    assert markers and not any(_is_marker(n) for n in nodes_off)
    assert len(nodes_off) == len(nodes_on) - len(markers)


def test_spans_off_record_nothing():
    cfg = _cfg()
    params, leaves, tokens = _setup(cfg)
    _step(params, leaves, tokens, cfg)
    assert profiling.device_span_totals() == {}
    sp = profiling.device_span("model.mlp")
    x = torch.ones(2, requires_grad=True)
    with sp:
        assert sp.entry(x) is x and sp.exit(x) is x


@pytest.mark.parametrize("remat", [True, False])
def test_the_profiler_turns_spans_on_and_every_pass_is_recorded(remat):
    cfg = _cfg(remat=remat)
    params, leaves, tokens = _setup(cfg)
    with _profiler() as prof:
        _step(params, leaves, tokens, cfg)
    got = profiling.device_span_totals()
    assert set(got) == set(MODEL + INNER)
    layers = cfg.n_layers
    for name, t in got.items():
        per_step = layers if name in LAYERED else 1
        assert t["forward_n"] == t["backward_n"] == per_step, name
        assert t["forward_ms"] > 0 and t["backward_ms"] > 0, name
        # Remat re-runs each layer once in the backward; the embedding and
        # the head are not under it.
        want = per_step if remat and name in LAYERED else 0
        assert t["recompute_n"] == want, name
        assert (t["recompute_ms"] > 0) == bool(want), name
        assert t["top"] == (name in MODEL), name
    ranges = {e.name for e in prof.events()}
    assert set(MODEL + INNER) <= ranges


def test_top_level_spans_sum_to_at_most_the_step(spans_on):
    cfg = _cfg()
    params, leaves, tokens = _setup(cfg)
    t0 = time.perf_counter()
    _step(params, leaves, tokens, cfg)
    wall_ms = (time.perf_counter() - t0) * 1e3
    got = profiling.device_span_totals()
    top = sum(got[n][f"{p}_ms"] for n in MODEL for p in profiling.PASSES)
    assert 0 < top <= wall_ms
    for n in MODEL + INNER:
        assert min(got[n][f"{p}_ms"] for p in profiling.PASSES) >= 0, n


def test_moe_span_names_are_the_benchmarks_frozen_ranges(spans_on):
    cfg = _cfg()
    params, leaves, tokens = _setup(cfg)
    _step(params, leaves, tokens, cfg)
    moe = {n for n in profiling.device_span_totals() if n.startswith("moe.")}
    assert moe == set(yardstick.MOE_RANGES)


def test_markers_return_views_and_run_no_op():
    x = torch.randn(4, 3, requires_grad=True)
    with _profiler() as prof:
        with profiling.device_span("probe") as sp:
            y = sp.entry(x)
            z = sp.exit(y * 2)
        z.sum().backward()
    assert y._is_view() and y.data_ptr() == x.data_ptr()
    assert z._is_view()
    inside = [e for e in prof.events()
              if e.cpu_parent is not None
              and e.cpu_parent.name in ("_Enter", "_Leave")]
    assert {e.name for e in inside} <= {"aten::view_as", "aten::view"}
    got = profiling.device_span_totals()["probe"]
    assert got["forward_n"] == got["backward_n"] == 1


def test_pipelined_forward_has_the_layer_spans(spans_on):
    cfg = dataclasses.replace(configs.tiny, n_layers=2, remat=True)
    params = init_params(cfg, seed=0, device="cpu")
    for p in [params["embed"], *params["layers"].values()]:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    logits, _ = forward_pipelined(params, tokens, cfg, mesh=None,
                                  num_microbatches=1)
    logits.float().sum().backward()
    got = profiling.device_span_totals()
    assert set(MODEL) <= set(got)
    for name in ("model.attention", "model.mlp"):
        # The schedule differentiates each stage inside its own backward.
        assert got[name]["forward_n"] == cfg.n_layers
        assert got[name]["backward_n"] == cfg.n_layers


def test_reset_drops_totals(spans_on):
    with profiling.device_span("probe") as sp:
        sp.exit(sp.entry(torch.ones(3)) + 1)
    assert "probe" in profiling.device_span_totals()
    profiling.reset_device_spans()
    assert profiling.device_span_totals() == {}


# -- the flight recorder ---------------------------------------------------------


def test_step_profiler_records_device_ms_per_fenced_step(spans_on):
    cfg = _cfg()
    params, leaves, tokens = _setup(cfg)
    prof = StepProfiler(ring=8, rank=0, emit_metrics=False)
    for _ in range(2):
        with prof.step(tokens=tokens.numel()) as s:
            loss = loss_fn(params, tokens, cfg)
            loss.backward()
            s.fence(loss)
    recs = prof.records()
    for rec in recs:
        assert set(rec["device_ms"]) == set(MODEL)
        for name, passes in rec["device_ms"].items():
            assert set(passes) == set(profiling.PASSES)
            assert passes["forward"] > 0 and passes["backward"] > 0
        assert 0 < sum(sum(p.values()) for p in rec["device_ms"].values()) \
            <= rec["wall_s"] * 1e3
    # Each record is its own step's: the totals are the records' sum.
    total = profiling.device_span_totals()["model.mlp"]["forward_ms"]
    assert sum(r["device_ms"]["model.mlp"]["forward"]
               for r in recs) == pytest.approx(total)


def test_step_profiler_without_a_profiler_adds_no_device_ms():
    prof = StepProfiler(ring=4, rank=0, emit_metrics=False)
    with prof.step() as s:
        s.fence(torch.ones(2))
    assert "device_ms" not in prof.records()[-1]
    assert profiling.device_span("x") is profiling._NO_SPAN


# -- the nvcc build counter -----------------------------------------------------


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An nvcc that writes an empty library; a loader that opens nothing."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
                    'done\necho "ptxas info : Used 8 registers"\n'
                    ': > "$out"\n')
    os.chmod(nvcc, 0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_builds", 0)
    monkeypatch.setattr(_build, "ctypes",
                        types.SimpleNamespace(CDLL=lambda path: ("lib", path)))


def test_build_counts_each_library_built(fake_nvcc):
    assert _build.build_count() == 0
    _build.load("rmsnorm")
    _build.load("rmsnorm")  # loaded: not built again
    assert _build.build_count() == 1
    _build.build_all()  # the kernels not built yet
    assert _build.build_count() == len(_build.kernel_names())


def test_step_record_counts_kernels_built_inside_the_step(fake_nvcc):
    prof = StepProfiler(ring=8, rank=0, emit_metrics=False)
    for name in ("rmsnorm", "rmsnorm", "flash_attention"):
        with prof.step():
            _build.load(name)
    assert [r["compiles"] for r in prof.records()] == [1, 0, 1]


# -- the benchmark's readers -------------------------------------------------------


READERS = {
    "moe_experts_ms_per_step.train": ("moe.experts",),
    "moe_routing_dispatch_ms_per_step.train": ("moe.routing", "moe.dispatch",
                                               "moe.combine"),
    "attention_ms_per_step.train": ("model.attention",),
    "head_ms_per_step.train": ("model.head",),
}


def _stub_totals():
    out = {}
    for i, name in enumerate(MODEL + INNER):
        out[name] = {"forward_ms": 1.0 + i, "recompute_ms": 10.0 * (i + 1),
                     "backward_ms": 100.0 * (i + 1), "forward_n": 1,
                     "recompute_n": 1, "backward_n": 1,
                     "top": name in MODEL}
    return out


def _stub_run(steps=2, kind="train"):
    return types.SimpleNamespace(facts={"kind": kind,
                                        "trace": {"steps": steps}})


@pytest.mark.parametrize("metric", sorted(READERS) + [
    "recompute_ms_per_step.train"])
def test_span_readers_read_ms_per_traced_step(metric, monkeypatch):
    cell = harness.Cell(harness.load_benchmark(), "mixtral-8x7b-train-1k")
    reader = cell.reader(metric)
    entry = next(m for m in cell.per_layer if m["name"] == metric)
    assert (reader.LAYER, reader.SOURCE, reader.MOVES) == (
        entry["layer"], "program_counter", "train_tokens_per_s")
    totals = _stub_totals()
    monkeypatch.setattr(profiling, "device_span_totals", lambda: totals)
    if metric in READERS:
        want = sum(totals[n][f"{p}_ms"] for n in READERS[metric]
                   for p in spans.PASSES) / 2
    else:
        want = sum(totals[n]["recompute_ms"] for n in MODEL) / 2
    assert reader.read(_stub_run()) == pytest.approx(want)
    assert reader.read(_stub_run(kind="serve")) is None
    assert reader.read(types.SimpleNamespace(facts={"kind": "train"})) is None
    monkeypatch.setattr(profiling, "device_span_totals", lambda: {})
    assert reader.read(_stub_run()) is None
    # A program without the counter reads as nothing, and does not raise.
    monkeypatch.delattr(profiling, "device_span_totals")
    assert reader.read(_stub_run()) is None
