"""The port's pure Serve modules held against the JAX package's, in
process, on the same inputs: the autoscaler's decisions over
hypothesis-drawn load sequences, the observatory's phase vectors, SLO
windows and burn rates under a fixed clock, deployment options and
`schema`'s config parsing. Then what only the port has: `Sealed`, the
stdlib proxy's HTTP parser and router, and the engine's observatory
stamps and head-of-line journal on the tiny model.
"""

import asyncio
import importlib
import json
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu.serve import autoscale as jax_autoscale
from ray_tpu.serve import observatory as jax_observatory
from ray_tpu.serve import schema as jax_schema
from ray_tpu_torch.serve import autoscale, observatory, proxy, schema

# `serve.deployment` is the decorator; the modules come from sys.modules.
jax_deployment = importlib.import_module("ray_tpu.serve.deployment")
deployment = importlib.import_module("ray_tpu_torch.serve.deployment")

torch.set_num_threads(1)

# -- autoscale -----------------------------------------------------------

_tick = st.fixed_dictionaries({
    "ongoing": st.lists(st.floats(0, 8, allow_nan=False), min_size=1,
                        max_size=4),
    "unreachable": st.lists(st.booleans(), min_size=4, max_size=4),
    "waiting": st.integers(0, 12),
    "ttft_p99": st.one_of(st.none(), st.floats(0, 2, allow_nan=False)),
    "burn": st.floats(0, 5, allow_nan=False),
    "dt": st.floats(0.05, 4.0, allow_nan=False),
})

_acfg = st.fixed_dictionaries({
    "min_replicas": st.integers(1, 2),
    "max_replicas": st.integers(2, 5),
    "target_ongoing_requests": st.floats(0.5, 4, allow_nan=False),
    "upscale_delay_s": st.floats(0, 3, allow_nan=False),
    "downscale_delay_s": st.floats(0, 6, allow_nan=False),
    "upscale_queue_depth": st.one_of(st.none(), st.floats(0, 3)),
    "ttft_p99_high_ms": st.one_of(st.none(), st.floats(50, 1500)),
    "burn_rate_high": st.one_of(st.none(), st.floats(0.5, 3)),
})


def _signals(tick):
    reps = [{"ongoing": o, "unreachable": u}
            for o, u in zip(tick["ongoing"], tick["unreachable"])]
    return {"replicas": reps, "waiting": tick["waiting"],
            "ttft_s": {"p99": tick["ttft_p99"]},
            "tenants": {"t": {"slo_windows": {"60": {
                "e2e": {"burn": tick["burn"]}}}}}}


@settings(max_examples=60, deadline=None)
@given(acfg=_acfg, ticks=st.lists(_tick, min_size=1, max_size=30))
def test_autoscale_decisions_match_the_jax_module(acfg, ticks):
    cfgs = [mod.AutoscalingConfig(**acfg)
            for mod in (jax_deployment, deployment)]
    states = [jax_autoscale.AutoscalerState(), autoscale.AutoscalerState()]
    targets = [acfg["min_replicas"]] * 2
    now = 100.0
    for tick in ticks:
        now += tick["dt"]
        sig = _signals(tick)
        for i, mod in enumerate((jax_autoscale, autoscale)):
            assert mod.extract_load(sig) == jax_autoscale.extract_load(sig)
            targets[i] = mod.decide(sig, cfgs[i], states[i], now,
                                    targets[i], len(tick["ongoing"]))
        assert targets[0] == targets[1]
        assert vars(states[0]) == vars(states[1])


# -- observatory under a fixed clock ---------------------------------------

class _Clock:
    """Stands in for the `time` module of an observatory: every reading
    is the value the test set."""

    def __init__(self):
        self.now = 1_000_000.0

    def time(self):
        return self.now

    def perf_counter(self):
        return self.now - 999_000.0

    def monotonic(self):
        return self.now - 990_000.0


# (tenant, phases as offsets from receive in seconds, tokens_in, tokens_out)
_REQUESTS = [
    ("acme", {"engine_enqueue": 0.001, "slot_grant": 0.004,
              "first_token": 0.030, "engine_done": 0.090, "end": 0.091},
     12, 8),
    ("acme", {"engine_enqueue": 0.002, "slot_grant": 0.050,
              "first_token": 0.400, "engine_done": 0.900, "end": 0.905},
     300, 32),
    ("beta", {"end": 0.020}, 0, 0),
    ("beta", {"engine_enqueue": 0.001, "slot_grant": 0.001,
              "end": 0.010}, 5, 0),  # failed before its first token
    ("acme", {"engine_enqueue": 0.001, "slot_grant": 0.002,
              "first_token": 0.005, "engine_done": 0.006, "end": 0.006},
     3, 1),
]


def _drive_observatory(mod, slo_mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    mod.reset_for_tests()
    mod.configure("obs-app", slo_mod.SloConfig(ttft_ms=100.0, tpot_ms=20.0,
                                               e2e_ms=500.0, objective=0.9))
    records = []
    for i, (tenant, marks, t_in, t_out) in enumerate(_REQUESTS):
        clock.now += 1.0
        wire = {"rid": f"r{i}", "tenant": tenant, "enq_t": clock.now - 0.003,
                "disp_t": clock.now - 0.001, "sampled": False}
        ctx = mod.begin(wire, "obs-app", "__call__")
        recv_p = clock.perf_counter()
        for name, off in marks.items():
            if name != "end":
                ctx.mark(name, at=recv_p + off)
        ctx.tokens_in, ctx.tokens_out = t_in, t_out
        clock.now += marks["end"]
        records.append(mod.finish(ctx))
    mod.record_shed("obs-app", "beta", "queue_full")
    mod.record_deadline_expired("obs-app", "engine_admission")
    clock.now += 30.0
    snap = mod.profiler().snapshot()
    mod.reset_for_tests()
    return records, snap


def test_observatory_phases_and_slo_match_the_jax_module(monkeypatch):
    ref_recs, ref_snap = _drive_observatory(jax_observatory, jax_deployment,
                                            monkeypatch)
    recs, snap = _drive_observatory(observatory, deployment, monkeypatch)
    assert recs == ref_recs
    assert snap == ref_snap
    for rec in recs:
        assert abs(sum(rec["phases"].values()) - rec["e2e_s"]) < 1e-12
    assert set(recs[0]["phases"]) == {
        "handle_queue", "dispatch", "engine_admission_wait", "prefill",
        "decode", "stream"}
    assert set(recs[2]["phases"]) == {"handle_queue", "dispatch", "exec"}
    fast = snap["tenants"]["acme"]["slo_windows"][str(snap["slo_windows_s"][0])]
    # acme: request 1 meets every target; request 2 misses all three;
    # request 5 has one token (no TPOT). burn = bad share / 0.1.
    assert fast["e2e"] == {"good": 2, "total": 3,
                           "burn": pytest.approx(10 / 3)}
    assert fast["tpot"]["total"] == 2
    assert snap["shed_total"] == 1


@pytest.mark.parametrize("good,total,objective", [
    (98, 100, 0.99), (50, 50, 0.99), (0, 0, 0.99), (99, 100, 0.99),
    (3, 7, 0.5), (0, 4, 0.999)])
def test_burn_rate_matches_the_jax_module(good, total, objective):
    assert observatory.burn_rate(good, total, objective) == \
        jax_observatory.burn_rate(good, total, objective)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_percentile_matches_the_jax_module(q):
    vals = sorted(np.random.default_rng(3).random(37).tolist())
    assert observatory.percentile(vals, q) == jax_observatory.percentile(vals, q)
    assert observatory.percentile([], q) == jax_observatory.percentile([], q)


# -- deployment options and schema ----------------------------------------

def _dep_view(d):
    return {"name": d.name, "num_replicas": d.num_replicas,
            "ray_actor_options": d.ray_actor_options,
            "max_ongoing_requests": d.max_ongoing_requests,
            "autoscaling": vars(d.autoscaling_config)
            if d.autoscaling_config else None,
            "user_config": d.user_config,
            "slo": vars(d.slo) if d.slo else None,
            "target": getattr(d.func_or_class, "__name__", None)}


def _deployments(mod):
    class Model:
        pass

    def fn():
        return 1

    a = mod.deployment(Model)
    b = mod.deployment(name="named", num_replicas=3,
                       ray_actor_options={"num_cpus": 2},
                       max_ongoing_requests=7, user_config={"k": 1},
                       slo={"ttft_ms": 100, "objective": 0.95})(fn)
    c = b.options(num_replicas=1, slo={"e2e_ms": 5.0},
                  autoscaling_config=mod.AutoscalingConfig(max_replicas=2))
    app = c.bind(1, k=2)
    try:
        a.options(no_such_option=1)
        bad = None
    except ValueError as e:
        bad = str(e)
    return [_dep_view(a), _dep_view(b), _dep_view(c),
            [app.init_args, app.init_kwargs, _dep_view(app.deployment)], bad]


def test_deployment_options_match_the_jax_module():
    assert _deployments(deployment) == _deployments(jax_deployment)


_APP_MODULE = """
import importlib
serve = importlib.import_module({pkg!r} + ".serve")


@serve.deployment
class Echo:
    def __init__(self, prefix="x"):
        self.prefix = prefix


app = Echo.bind(prefix="cfg")
dep = Echo


def builder(prefix="b"):
    return Echo.options(num_replicas=2).bind(prefix=prefix)


def builds_deployment():
    return Echo


not_an_app = 42
"""


def _schema_views(mod, pkg, tmp_path, monkeypatch):
    name = f"schema_app_{pkg}"
    (tmp_path / f"{name}.py").write_text(_APP_MODULE.format(pkg=pkg))
    monkeypatch.syspath_prepend(str(tmp_path))
    out = []
    for entry in [
        {"import_path": f"{name}:app"},
        {"import_path": f"{name}:dep", "args": {"prefix": "d"}},
        {"import_path": f"{name}:builder", "args": {"prefix": "z"},
         "deployments": [{"name": "Echo", "max_ongoing_requests": 3},
                         {"name": "Other", "num_replicas": 9}]},
        {"import_path": f"{name}:builds_deployment"},
        {"import_path": f"{name}:not_an_app"},
        {"import_path": f"{name}.app"},
    ]:
        try:
            app = mod.build_application(entry)
            out.append([_dep_view(app.deployment), app.init_args,
                        app.init_kwargs])
        except (TypeError, ValueError) as e:
            out.append([type(e).__name__, str(e).replace(pkg, "PKG")])
    cfg_file = tmp_path / f"serve_{pkg}.json"
    cfg_file.write_text(json.dumps({"applications": [], "http": None}))
    out.append(mod.load_config(str(cfg_file)))
    yaml_file = tmp_path / f"serve_{pkg}.yaml"
    yaml_file.write_text("applications:\n  - name: a\n    import_path: m:x\n")
    out.append(mod.load_config(str(yaml_file)))
    return out


def test_schema_parsing_matches_the_jax_module(tmp_path, monkeypatch):
    ref = _schema_views(jax_schema, "ray_tpu", tmp_path, monkeypatch)
    out = _schema_views(schema, "ray_tpu_torch", tmp_path, monkeypatch)
    assert out == ref
    assert out[2][0]["num_replicas"] == 2
    assert out[2][0]["max_ongoing_requests"] == 3
    assert out[4][0] == "TypeError" and out[5][0] == "ValueError"


# -- what only the port has ------------------------------------------------

def test_sealed_values_compare_by_their_bytes():
    import pickle

    from ray_tpu_torch._vendor import cloudpickle

    def loader():
        return np.ones(3)

    a, b = deployment.Sealed((loader, {"k": [1, 2]})), \
        deployment.Sealed((loader, {"k": [1, 2]}))
    assert a == b and hash(a) == hash(b)
    assert a != deployment.Sealed((loader, {"k": [1, 3]}))
    back = pickle.loads(cloudpickle.dumps(a))
    assert back == a
    fn, kw = back.open()
    assert kw == {"k": [1, 2]} and fn().tolist() == [1.0, 1.0, 1.0]


def _parse(raw: bytes):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        out = []
        while True:
            try:
                req = await proxy._read_request(reader)
            except proxy._BadRequest as e:
                out.append(("bad", str(e).split(" ")[0]))
                break
            if req is None:
                break
            out.append((req.method, req.path, req.query, req.body,
                        req.keep_alive, req.headers.get("x-a")))
        return out
    return asyncio.run(go())


def test_proxy_parses_pipelined_and_chunked_requests():
    raw = (b"POST /my%20app?stream=1&x=2 HTTP/1.1\r\nHost: h\r\n"
           b"Content-Length: 7\r\nX-A: one\r\n\r\n{\"a\":1}"
           b"POST /b HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
           b"Connection: close\r\n\r\n"
           b"3\r\n{\"x\r\n5;ext=1\r\n\": 2}\r\n0\r\nTrailer: t\r\n\r\n"
           b"GET /-/healthz HTTP/1.0\r\n\r\n")
    assert _parse(raw) == [
        ("POST", "/my app", {"stream": ["1"], "x": ["2"]}, b'{"a":1}',
         True, "one"),
        ("POST", "/b", {}, b'{"x": 2}', False, None),
        ("GET", "/-/healthz", {}, b"", False, None),
    ]
    assert _parse(b"NONSENSE\r\n\r\n") == [("bad", "bad")]
    assert _parse(b"GET / SPDY/3\r\n\r\n") == [("bad", "unsupported")]
    assert _parse(b"POST /a HTTP/1.1\r\nContent-Length: 9\r\n\r\nab") == [
        ("bad", "bad")]
    assert _parse(b"GET /" + b"x" * 70000 + b" HTTP/1.1\r\n\r\n") == [
        ("bad", "bad")]


def test_proxy_refuses_bodies_over_aiohttps_limit():
    big = proxy._MAX_BODY_BYTES + 1
    for raw in (f"POST /a HTTP/1.1\r\nContent-Length: {big}\r\n\r\n"
                .encode(),
                b"POST /a HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
                + b"%x\r\n" % big + b"x" * big + b"\r\n0\r\n\r\n"):
        async def go():
            reader = asyncio.StreamReader(limit=2 ** 22)
            reader.feed_data(raw)
            reader.feed_eof()
            with pytest.raises(proxy._TooLarge) as e:
                await proxy._read_request(reader)
            return e.value.status
        assert asyncio.run(go()) == 413


@pytest.mark.parametrize("method,path,route", [
    ("GET", "/-/healthz", ("healthz", "")),
    ("HEAD", "/-/healthz", ("healthz", "")),
    ("POST", "/-/healthz", ("405", "")),
    ("POST", "/llm", ("app", "llm")),
    ("GET", "/llm", ("405", "")),
    ("POST", "/", ("404", "")),
    ("POST", "/a/b", ("404", "")),
])
def test_proxy_routes_like_the_aiohttp_router(method, path, route):
    assert proxy._route(method, path) == route


def test_proxy_response_framing():
    out = proxy._json_response({"result": [1, 2]}, status=429,
                               keep_alive=False,
                               headers={"Retry-After": "3"})
    head, body = out.split(b"\r\n\r\n", 1)
    lines = head.decode().split("\r\n")
    assert lines[0] == "HTTP/1.1 429 Too Many Requests"
    assert "Content-Type: application/json; charset=utf-8" in lines
    assert "Retry-After: 3" in lines and "Connection: close" in lines
    assert f"Content-Length: {len(body)}" in lines
    assert json.loads(body) == {"result": [1, 2]}


# -- the engine's observatory stamps and HOL journal (port only) ----------

@pytest.fixture
def tiny_engine():
    import dataclasses

    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

    cfg = dataclasses.replace(configs.tiny, dtype=torch.float32)
    made = []

    def make(**kw):
        eng = ContinuousBatchingEngine(init_params(cfg, seed=0, device="cpu"),
                                       cfg, **kw)
        made.append(eng)
        return eng

    observatory.reset_for_tests()
    yield make
    for eng in made:
        eng.shutdown()
    observatory.reset_for_tests()


def test_engine_stamps_the_request_phase_vector_and_exports_metrics(
        tiny_engine):
    from ray_tpu_torch.serve.llm import _engine_metrics

    eng = tiny_engine(num_slots=2, max_len=64, prefill_chunk=8)
    m = _engine_metrics()
    before = {k: m[k].summary()["count"]
              for k in ("ttft_s", "tpot_s", "admission_wait_s")}
    observatory.configure("llm-test", None)
    wire = observatory.make_wire_ctx("acme")
    wire["disp_t"] = time.time()
    ctx = observatory.begin(wire, "llm-test", "__call__")
    out = eng.submit(list(range(1, 20)), max_new_tokens=8).result(60)
    rec = observatory.finish(ctx)
    assert len(out) == 8
    # The process-wide export saw the request once in each histogram.
    assert {k: m[k].summary()["count"] - n for k, n in before.items()} == {
        "ttft_s": 1, "tpot_s": 1, "admission_wait_s": 1}
    assert set(rec["phases"]) == {
        "handle_queue", "dispatch", "engine_admission_wait", "prefill",
        "decode", "stream"}
    assert abs(sum(rec["phases"].values()) - rec["e2e_s"]) < 1e-9
    assert rec["tokens_in"] == 19 and rec["tokens_out"] == 8
    assert rec["ttft_s"] is not None and rec["tpot_s"] is not None
    snap = observatory.profiler().snapshot()
    assert snap["tenants"]["acme"]["tokens_out"] == 8


def test_hol_watchdog_journals_and_requests_a_postmortem(tiny_engine):
    """A chaos-stretched prefill pass while another request decodes: the
    watchdog records the stall, blames the prefilling request, journals
    `serve.hol` and asks for a postmortem (the JAX engine's calls)."""
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.util import journal

    eng = tiny_engine(num_slots=2, max_len=128)
    n0 = sum(e.get("kind") == "serve.hol" for e in journal.snapshot())
    chaos.enable()
    try:
        long_h = eng.submit([3, 7, 11, 2], max_new_tokens=80)
        deadline = time.monotonic() + 60
        while not (eng.stats()["active"] == 1
                   and eng.stats()["prefilling"] == 0):
            assert time.monotonic() < deadline, eng.stats()
            time.sleep(0.01)
        chaos.delay_prefills(0.2, count=1)
        blocker = eng.submit([5, 1, 8, 2, 9, 4], max_new_tokens=4)
        blocker.result(timeout=60)
        long_h.result(timeout=60)
        stats = eng.stats()
    finally:
        chaos.disable()
        chaos.clear()
    ev = stats["hol"]["events"][0]
    assert ev["prefill_s"] >= 0.2 and ev["victims"] == 1
    assert blocker.request_id in [c["request_id"] for c in ev["culprits"]]
    events = journal.snapshot()
    hol = [e for e in events if e.get("kind") == "serve.hol"]
    assert len(hol) - n0 >= 1 and hol[-1]["victims"] == 1
    assert any(e.get("kind") == "journal.trigger_requested"
               and e.get("reason") == "hol_blocking" for e in events)
