"""The port's load generator (ray_tpu_torch.loadgen, `rt loadgen`) held
against the JAX package's:

  * the 31 cases of tests/test_loadgen.py, run against the port (trace
    determinism, arrivals, runner semantics with a stub call_fn, the
    reconciliation math and its gate, schedule-anchored chaos, workload
    shapes);
  * for a set of specs (open and closed loops, Poisson and Pareto, a
    flash crowd, a ramp, a diurnal curve, a chaos schedule), both
    packages' `generate` give byte-identical files, and so does each
    package's `rt loadgen gen`;
  * `reconcile` of the same cards and server records gives equal
    reports in both packages;
  * one driver script, run under each package, serves a sleeping
    streaming deployment (bench_serve_macro.py's Witness) and replays a
    short trace through `rt loadgen run`: both count every request, with
    no error and no unmatched card.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu.loadgen as jax_loadgen
from ray_tpu.loadgen import trace as jax_trace
from ray_tpu_torch.loadgen import (
    GAP_FRACTION_LIMIT,
    LengthMix,
    RateCurve,
    StampCard,
    TenantBlend,
    TraceSpec,
    apply_chaos_schedule,
    closed_loop_think_times,
    default_blend,
    open_loop_arrivals,
    reconcile,
    run_trace,
)
from ray_tpu_torch.loadgen import trace as trace_mod
from tests.test_torch_serve_api import PRELUDE, run_driver

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _spec(**kw):
    kw.setdefault("seed", 42)
    kw.setdefault("duration_s", 10.0)
    kw.setdefault("curve", RateCurve(
        base_qps=20.0, ramp_to_qps=60.0, ramp_s=6.0,
        diurnal_amplitude=0.3, diurnal_period_s=20.0,
        flash=[(4.0, 1.5, 3.0)]))
    return TraceSpec(**kw)


# ---------------------------------------------------------------------------
# trace determinism / byte-identical replay
# ---------------------------------------------------------------------------


class TestTraceDeterminism:
    def test_same_seed_identical_bytes(self):
        h1, r1 = trace_mod.generate(_spec())
        h2, r2 = trace_mod.generate(_spec())
        assert trace_mod.dumps(h1, r1) == trace_mod.dumps(h2, r2)

    def test_different_seed_differs(self):
        h1, r1 = trace_mod.generate(_spec(seed=1))
        h2, r2 = trace_mod.generate(_spec(seed=2))
        assert trace_mod.dumps(h1, r1) != trace_mod.dumps(h2, r2)

    def test_replay_from_own_header_is_byte_identical(self, tmp_path):
        spec = _spec(chaos=[
            {"kind": "kill_replica", "t": 3.0, "kwargs": {"app": "A"}},
            {"kind": "drop_controller", "t": 5.0,
             "kwargs": {"restart": True}},
        ])
        header, records = trace_mod.generate(spec)
        path = str(tmp_path / "t.jsonl")
        trace_mod.write(path, header, records)
        with open(path, "rb") as f:
            on_disk = f.read()
        assert trace_mod.regenerate_bytes(path) == on_disk

    def test_header_roundtrips_through_spec(self):
        spec = _spec(kind="closed", num_requests=17, mean_think_s=0.2,
                     concurrency=4)
        assert TraceSpec.from_header(spec.header()).header() == \
            spec.header()

    def test_pareto_trace_deterministic_and_distinct(self):
        hp1, rp1 = trace_mod.generate(_spec(process="pareto"))
        hp2, rp2 = trace_mod.generate(_spec(process="pareto"))
        assert trace_mod.dumps(hp1, rp1) == trace_mod.dumps(hp2, rp2)
        _, rpois = trace_mod.generate(_spec(process="poisson"))
        assert [r["t"] for r in rp1] != [r["t"] for r in rpois]

    def test_shapes_independent_of_arrival_process(self):
        # Same seed, different arrival process: the request SHAPES
        # (tenant, lengths) must not reshuffle — the shape rng is
        # salted independently of the arrival rng.
        _, ra = trace_mod.generate(_spec(process="poisson"))
        _, rb = trace_mod.generate(_spec(process="pareto"))
        n = min(len(ra), len(rb))
        keep = ("tenant", "prompt_tokens", "max_tokens")
        assert [{k: r[k] for k in keep} for r in ra[:n]] == \
            [{k: r[k] for k in keep} for r in rb[:n]]

    def test_closed_loop_records_carry_think_times(self):
        spec = _spec(kind="closed", num_requests=25, mean_think_s=0.1)
        _, records = trace_mod.generate(spec)
        assert len(records) == 25
        assert [r["t"] for r in records] == \
            closed_loop_think_times(25, 42, 0.1)

    def test_unknown_schema_rejected(self, tmp_path):
        path = str(tmp_path / "bad.jsonl")
        with open(path, "w") as f:
            f.write('{"schema":99}\n')
        with pytest.raises(ValueError, match="schema"):
            trace_mod.read(path)


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------


class TestArrivals:
    def test_open_loop_offsets_sorted_in_range(self):
        for process in ("poisson", "pareto"):
            ts = open_loop_arrivals(RateCurve(30.0), 5.0, seed=3,
                                    process=process)
            assert ts == sorted(ts)
            assert all(0.0 <= t < 5.0 for t in ts)

    def test_poisson_tracks_rate(self):
        ts = open_loop_arrivals(RateCurve(50.0), 10.0, seed=1)
        assert 350 <= len(ts) <= 650  # ~500 expected

    def test_flash_crowd_concentrates_arrivals(self):
        curve = RateCurve(10.0, flash=[(2.0, 1.0, 5.0)])
        ts = open_loop_arrivals(curve, 4.0, seed=7)
        in_flash = sum(1 for t in ts if 2.0 <= t < 3.0)
        before = sum(1 for t in ts if 0.0 <= t < 1.0)
        assert in_flash > 2 * before

    def test_pareto_is_burstier_than_poisson(self):
        # Same mean load; the Pareto renewal process should show a
        # heavier-tailed gap distribution (larger max inter-arrival).
        pois = open_loop_arrivals(RateCurve(20.0), 20.0, seed=5)
        par = open_loop_arrivals(RateCurve(20.0), 20.0, seed=5,
                                 process="pareto")
        gap = lambda ts: max(  # noqa: E731
            b - a for a, b in zip(ts, ts[1:]))
        assert gap(par) > gap(pois)

    def test_bad_process_and_alpha_rejected(self):
        with pytest.raises(ValueError, match="arrival process"):
            open_loop_arrivals(RateCurve(1.0), 1.0, 0, process="uniform")
        with pytest.raises(ValueError, match="pareto_alpha"):
            open_loop_arrivals(RateCurve(1.0), 1.0, 0, process="pareto",
                               pareto_alpha=1.0)

    def test_think_times(self):
        assert closed_loop_think_times(4, 1, 0.0) == [0.0] * 4
        a = closed_loop_think_times(10, 1, 0.5)
        assert a == closed_loop_think_times(10, 1, 0.5)
        assert all(t > 0 for t in a)


# ---------------------------------------------------------------------------
# runner semantics (stub call_fn, no cluster)
# ---------------------------------------------------------------------------


class _ConcurrencyProbe:
    """A call_fn that services requests with a fixed sleep and records
    the peak number of in-flight calls."""

    def __init__(self, service_s: float):
        self.service_s = service_s
        self.cur = 0
        self.peak = 0
        self.lock = threading.Lock()

    def __call__(self, request, card):
        with self.lock:
            self.cur += 1
            self.peak = max(self.peak, self.cur)
        time.sleep(self.service_s)
        with self.lock:
            self.cur -= 1
        card.first_byte_p = time.perf_counter()
        card.done_p = time.perf_counter()
        card.chunks = 1
        return card


class TestRunnerSemantics:
    def test_open_loop_does_not_wait_for_completions(self):
        # 10 arrivals in a burst, each taking 0.3s: an open-loop driver
        # must overlap them (exogenous arrivals), not serialize.
        records = [{"i": i, "t": 0.01 * i, "tenant": "t"}
                   for i in range(10)]
        header = {"kind": "open", "duration_s": 0.1}
        probe = _ConcurrencyProbe(0.3)
        t0 = time.perf_counter()
        result = run_trace(header, records, probe, workers=16,
                           emit_metrics=False)
        wall = time.perf_counter() - t0
        assert probe.peak >= 5
        assert wall < 10 * 0.3  # far below the serialized time
        assert result.summary()["ok"] == 10

    def test_open_loop_respects_schedule(self):
        records = [{"i": i, "t": 0.25 * i, "tenant": "t"}
                   for i in range(4)]
        header = {"kind": "open", "duration_s": 1.0}
        sends = {}

        def call(request, card):
            sends[request["i"]] = time.perf_counter()
            card.first_byte_p = card.done_p = time.perf_counter()
            return card

        t0 = time.perf_counter()
        run_trace(header, records, call, workers=4, emit_metrics=False)
        for i in range(4):
            offset = sends[i] - t0
            assert offset == pytest.approx(0.25 * i, abs=0.2)

    def test_closed_loop_bounds_concurrency(self):
        records = [{"i": i, "t": 0.0, "tenant": "t"} for i in range(12)]
        header = {"kind": "closed", "duration_s": 0.0, "concurrency": 3}
        probe = _ConcurrencyProbe(0.05)
        result = run_trace(header, records, probe, emit_metrics=False)
        assert probe.peak <= 3
        assert result.summary()["ok"] == 12

    def test_call_fn_exception_lands_on_card(self):
        records = [{"i": i, "t": 0.0, "tenant": "t"} for i in range(3)]
        header = {"kind": "closed", "duration_s": 0.0, "concurrency": 1}

        def boom(request, card):
            raise RuntimeError("injected")

        result = run_trace(header, records, boom, emit_metrics=False)
        assert result.summary()["errors"] == 3
        assert all("RuntimeError" in c.error for c in result.cards)


# ---------------------------------------------------------------------------
# reconciliation
# ---------------------------------------------------------------------------


def _card(idx, rid, e2e_s, tenant="t", ttfb_s=0.01, error=None):
    c = StampCard(idx, tenant)
    c.rid = rid
    c.send_p = 100.0
    if error is None:
        c.first_byte_p = 100.0 + ttfb_s
        c.done_p = 100.0 + e2e_s
    else:
        c.error = error
    return c


def _server(rid, phases, ttft_s=0.01):
    return {"rid": rid, "tenant": "t", "method": "__call__",
            "ts": 0.0, "phases": dict(phases),
            "e2e_s": sum(phases.values()), "ttft_s": ttft_s,
            "tpot_s": 0.0, "tokens_in": 1, "tokens_out": 1}


class TestReconcile:
    def test_gap_is_exactly_e2e_minus_phase_sum(self):
        cards = [_card(0, "r0", 1.0)]
        server = [_server("r0", {"handle_queue": 0.125, "dispatch": 0.125,
                                 "exec": 0.5})]
        report = reconcile(cards, server)
        row = report["requests"][0]
        assert row["server_attributed_s"] == 0.75
        assert row["gap_s"] == 0.25
        assert row["gap_fraction"] == 0.25
        assert report["summary"]["matched"] == 1

    def test_negative_gap_clamped_to_zero(self):
        # Server attributes MORE than the client saw (sub-ms clock
        # disagreement): the gap must clamp at zero, not go negative.
        cards = [_card(0, "r0", 0.5)]
        server = [_server("r0", {"exec": 0.6})]
        row = reconcile(cards, server)["requests"][0]
        assert row["gap_s"] == 0.0
        assert row["gap_fraction"] == 0.0

    def test_gate_passes_on_well_attributed_run(self):
        cards, server = [], []
        for i in range(50):
            e2e = 0.2 + 0.001 * i
            cards.append(_card(i, f"r{i}", e2e))
            server.append(_server(f"r{i}", {"exec": e2e * 0.99}))
        s = reconcile(cards, server)["summary"]
        assert s["matched"] == 50
        assert s["gap_fraction"]["p99"] <= GAP_FRACTION_LIMIT
        assert s["gate_pass"] is True

    def test_gate_trips_on_injected_unattributed_stall(self):
        # 50 clean requests plus a handful whose client e2e carries a
        # 500ms stall the server never attributed — the p99 gate must
        # catch them.
        cards, server = [], []
        for i in range(50):
            cards.append(_card(i, f"r{i}", 0.2))
            server.append(_server(f"r{i}", {"exec": 0.199}))
        for i in range(50, 55):
            cards.append(_card(i, f"r{i}", 0.7))  # 0.5s stall
            server.append(_server(f"r{i}", {"exec": 0.2}))
        s = reconcile(cards, server)["summary"]
        assert s["gap_fraction"]["p99"] > GAP_FRACTION_LIMIT
        assert s["gate_pass"] is False

    def test_unmatched_and_errors_counted_not_hidden(self):
        cards = [
            _card(0, "r0", 0.2),
            _card(1, "gone", 0.2),       # replica died with its ring
            _card(2, "", 0.0, error="ServeOverloadedError: shed"),
        ]
        server = [_server("r0", {"exec": 0.199})]
        s = reconcile(cards, server)["summary"]
        assert s["matched"] == 1
        assert s["unmatched"] == 1
        assert s["errors"] == 1

    def test_no_matches_is_a_failure_not_a_vacuous_pass(self):
        s = reconcile([_card(0, "x", 0.1)], [])["summary"]
        assert s["gate_pass"] is False


# ---------------------------------------------------------------------------
# schedule-anchored chaos replay
# ---------------------------------------------------------------------------


class TestChaosSchedule:
    def test_apply_requires_known_kinds(self):
        from ray_tpu_torch._private import chaos

        chaos.enable()
        try:
            with pytest.raises(ValueError, match="unknown chaos kind"):
                apply_chaos_schedule(
                    {"chaos": [{"kind": "meteor", "t": 1.0}]})
        finally:
            chaos.disable()

    def test_scheduled_fault_fires_at_anchor_offset(self):
        from ray_tpu_torch._private import chaos

        chaos.enable()
        try:
            apply_chaos_schedule({"chaos": [
                {"kind": "kill_replica", "t": 0.05,
                 "kwargs": {"app": "NoSuchApp"}},
            ]})
            faults = chaos.scheduled_faults()
            assert len(faults) == 1 and not faults[0]["fired"]
            chaos.anchor_schedule()
            deadline = time.time() + 2.0
            while time.time() < deadline:
                faults = chaos.scheduled_faults()
                if faults[0]["fired"]:
                    break
                time.sleep(0.02)
            assert faults[0]["fired"]
            # No cluster here: the executor errored, and the schedule
            # recorded it instead of crashing the scheduler thread.
            assert str(faults[0]["result"]).startswith("error")
        finally:
            chaos.disable()

    def test_clear_cancels_pending_faults(self):
        from ray_tpu_torch._private import chaos

        chaos.enable()
        try:
            apply_chaos_schedule({"chaos": [
                {"kind": "drop_controller", "t": 30.0,
                 "kwargs": {"restart": True}},
            ]})
            assert len(chaos.scheduled_faults()) == 1
            chaos.clear()
            assert chaos.scheduled_faults() == []
        finally:
            chaos.disable()


# ---------------------------------------------------------------------------
# workload shapes
# ---------------------------------------------------------------------------


class TestWorkload:
    def test_blend_draw_respects_bounds(self):
        import random

        blend = default_blend()
        rng = random.Random(0)
        for _ in range(500):
            r = blend.draw(rng)
            assert r["tenant"] in ("interactive", "batch")
            assert r["prompt_tokens"] >= 1
            assert r["max_tokens"] >= 1

    def test_length_mix_tail_bucket(self):
        import random

        mix = LengthMix(median=10, sigma=0.1, lo=1, hi=2000,
                        tail_p=1.0, tail_lo=1000, tail_hi=2000)
        rng = random.Random(0)
        assert all(1000 <= mix.draw(rng) <= 2000 for _ in range(50))

    def test_rate_curve_peak_catches_flash_edges(self):
        curve = RateCurve(10.0, flash=[(1.05, 0.02, 10.0)])
        assert curve.peak(5.0) == pytest.approx(100.0)

    def test_blend_needs_a_tenant(self):
        with pytest.raises(ValueError):
            TenantBlend([])


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def test_the_port_exports_the_reference_names():
    import ray_tpu_torch.loadgen as lg

    assert sorted(lg.__all__) == sorted(jax_loadgen.__all__)
    assert lg.GAP_FRACTION_LIMIT == jax_loadgen.GAP_FRACTION_LIMIT


_CURVE = {"base_qps": 20.0, "ramp_to_qps": 60.0, "ramp_s": 6.0,
          "diurnal_amplitude": 0.3, "diurnal_period_s": 20.0,
          "flash": [(4.0, 1.5, 3.0)]}
_CHAOS = [{"kind": "kill_replica", "t": 3.0, "kwargs": {"app": "A"}},
          {"kind": "drop_controller", "t": 5.0, "kwargs": {"restart": True}}]
SPECS = {
    "open_poisson": dict(seed=42, duration_s=10.0, curve=_CURVE),
    "open_pareto": dict(seed=7, duration_s=10.0, curve=_CURVE,
                        process="pareto", pareto_alpha=1.3),
    "flash_crowd": dict(seed=0, duration_s=30.0,
                        curve={"base_qps": 1.0, "flash": [(10.0, 5.0, 4.0)]}),
    "ramp": dict(seed=3, duration_s=20.0,
                 curve={"base_qps": 5.0, "ramp_to_qps": 40.0, "ramp_s": 15.0}),
    "closed": dict(seed=11, duration_s=0.0, curve={"base_qps": 0.0},
                   kind="closed", num_requests=40, concurrency=6,
                   mean_think_s=0.25),
    "chaos": dict(seed=20260807, duration_s=12.0, curve=_CURVE, chaos=_CHAOS),
    "custom_blend": dict(seed=5, duration_s=8.0, curve={"base_qps": 12.0},
                         blend=[{"name": "a", "weight": 3.0,
                                 "prompt": {"median": 40, "sigma": 0.5},
                                 "output": {"median": 8, "tail_p": 0.0}},
                                {"name": "b", "weight": 1.0,
                                 "prompt": {"median": 300, "hi": 2048},
                                 "output": {"median": 64}}]),
}


def _build(pkg_loadgen, spec):
    kw = dict(spec)
    curve = dict(kw.pop("curve"))
    curve["flash"] = [tuple(f) for f in curve.get("flash", [])]
    kw["curve"] = pkg_loadgen.RateCurve(**curve)
    if "blend" in kw:
        kw["blend"] = pkg_loadgen.TenantBlend(kw["blend"])
    return pkg_loadgen.TraceSpec(**kw)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_the_port_writes_the_references_trace_bytes(name, tmp_path):
    import ray_tpu_torch.loadgen as lg

    files = {}
    for tag, pkg, tmod in (("jax", jax_loadgen, jax_trace),
                           ("torch", lg, trace_mod)):
        header, records = tmod.generate(_build(pkg, SPECS[name]))
        path = tmp_path / f"{tag}.jsonl"
        tmod.write(str(path), header, records)
        files[tag] = path.read_bytes()
        assert tmod.regenerate_bytes(str(path)) == files[tag]
    assert files["torch"] == files["jax"]
    assert len(files["torch"].splitlines()) > 1


def test_rt_loadgen_gen_writes_the_same_file_in_both_packages(tmp_path):
    args = ["loadgen", "gen", "--seed", "0", "--duration", "30", "--qps",
            "1.0", "--flash", "10:5:4", "--ramp-to", "2.0", "--ramp-s",
            "20", "--process", "pareto"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        path = tmp_path / f"{pkg}.jsonl"
        proc = subprocess.run(
            [sys.executable, "-m", pkg, *args[:2], str(path), *args[2:]],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[pkg] = (path.read_bytes(), proc.stdout.replace(pkg, "PKG"))
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    closed = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        path = tmp_path / f"closed_{pkg}.jsonl"
        proc = subprocess.run(
            [sys.executable, "-m", pkg, "loadgen", "gen", str(path),
             "--closed", "--requests", "9", "--concurrency", "3",
             "--think", "0.1", "--seed", "4"],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        closed[pkg] = path.read_bytes()
    assert closed["ray_tpu_torch"] == closed["ray_tpu"]


def _cards_and_records(card_cls):
    cards, server = [], []
    for i in range(40):
        c = card_cls(i, "t" if i % 3 else "u")
        c.rid = f"r{i}"
        c.send_p = 100.0
        c.first_byte_p = 100.0 + 0.01 * (i % 5)
        c.done_p = 100.0 + 0.2 + 0.003 * i
        cards.append(c)
        server.append({"rid": f"r{i}", "tenant": c.tenant,
                       "method": "__call__", "ts": 0.0,
                       "phases": {"handle_queue": 0.001,
                                  "dispatch": 0.002,
                                  "decode": (0.2 + 0.003 * i) * 0.96},
                       "e2e_s": 0.2, "ttft_s": 0.01, "tpot_s": 0.0,
                       "tokens_in": 1, "tokens_out": 1})
    gone = card_cls(40, "t")
    gone.rid, gone.send_p, gone.done_p = "gone", 1.0, 1.5
    failed = card_cls(41, "u")
    failed.error = "ServeOverloadedError: shed"
    return cards + [gone, failed], server


def test_reconcile_reports_equal_the_references():
    import ray_tpu_torch.loadgen as lg

    ref = jax_loadgen.reconcile(*_cards_and_records(jax_loadgen.StampCard))
    out = lg.reconcile(*_cards_and_records(lg.StampCard))
    assert out == ref
    assert out["summary"]["matched"] == 40
    assert (out["summary"]["unmatched"], out["summary"]["errors"]) == (1, 1)
    assert lg.render_report(out) == jax_loadgen.render_report(ref)


REPLAY = PRELUDE + r"""
import subprocess
import tempfile

worker_mod = importlib.import_module(pkg + "._private.worker")

rt.init(num_cpus=4)
try:
    @serve.deployment(name="Witness", max_ongoing_requests=64)
    class Witness:
        # bench_serve_macro.py's sleeping stand-in for an LLM: a
        # prompt-scaled prefill, then one chunk per token.
        def __call__(self, request):
            p = int(request.get("prompt_tokens", 64))
            n = min(int(request.get("max_tokens", 8)), 6)
            time.sleep(0.005 + p * 2e-5)
            for i in range(max(n, 1)):
                time.sleep(0.002)
                yield i

    serve.run(Witness.bind(), name="W")
    tmp = tempfile.mkdtemp()
    trace = os.path.join(tmp, "trace.jsonl")
    report = os.path.join(tmp, "report.json")
    env = dict(os.environ)
    cli = [sys.executable, "-m", pkg, "loadgen"]
    gen = subprocess.run(cli + ["gen", trace, "--seed", "1", "--duration",
                                "3", "--qps", "5", "--flash", "1:1:2"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert gen.returncode == 0, gen.stderr
    run = subprocess.run(
        cli + ["run", trace, "--app", "W", "--address",
               worker_mod._global_node.gcs_address, "--out", report],
        env=env, capture_output=True, text=True, timeout=240)
    with open(report) as f:
        doc = json.load(f)
    with open(trace) as f:
        n = len(f.read().splitlines()) - 1
    s = doc["reconciliation"]["summary"]
    print("RESULT " + json.dumps({
        "rc": run.returncode, "trace": n, "issued": doc["run"]["issued"],
        "ok": doc["run"]["ok"], "errors": doc["run"]["errors"],
        "matched": s["matched"], "unmatched": s["unmatched"],
        "gate_pass": s["gate_pass"],
        "by_tenant": doc["run"]["by_tenant"]}))
finally:
    serve.shutdown()
    rt.shutdown()
"""


def test_rt_loadgen_run_replays_a_trace_in_both_packages(tmp_path):
    ref = run_driver(tmp_path, REPLAY, "ray_tpu")
    out = run_driver(tmp_path, REPLAY, "ray_tpu_torch")
    for res in (ref, out):
        assert res["issued"] == res["ok"] == res["matched"] == res["trace"]
        assert (res["errors"], res["unmatched"]) == (0, 0)
        assert res["rc"] == (0 if res["gate_pass"] else 1)
    assert out["trace"] == ref["trace"] > 5
    assert out["by_tenant"] == ref["by_tenant"]
