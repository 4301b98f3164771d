"""The port's cluster black box (ray_tpu_torch.util.journal, chaos's
postmortem capture): the cases of tests/test_journal.py run against
ray_tpu_torch. HLC correctness, ring accounting, bundle assembly and
causal chains in-process; chaos.kill_replica under in-flight Serve
traffic and chaos.postmortem() on the port's runtime; the profiling
atexit drain in a subprocess of the port."""

import json
import os
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.util import journal
from ray_tpu_torch.util.journal import HLC


@pytest.fixture
def rt_start():
    """A real single-node runtime of the port."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


@pytest.fixture
def cfg_override():
    """Mutate the config singleton for this (test) process; restore on
    exit. Worker processes are unaffected — driver/GCS-side knobs only."""
    cfg = get_config()
    saved = {}

    def override(**kw):
        for k, v in kw.items():
            if k not in saved:
                saved[k] = getattr(cfg, k)
            setattr(cfg, k, v)

    yield override
    for k, v in saved.items():
        setattr(cfg, k, v)


@pytest.fixture
def serve_session(rt_start):
    from ray_tpu_torch import serve

    yield rt_start
    serve.shutdown()


# -- hybrid logical clock -------------------------------------------------


def test_hlc_monotone_under_clock_regression(monkeypatch):
    """An NTP step / VM migration walks the wall clock BACKWARDS; stamps
    must still be strictly increasing (lc bumps instead of pt reversing)."""
    walls = [1000.0, 999.0, 998.5, 1005.0]

    def fake_time():
        return walls.pop(0) if walls else 1005.0

    monkeypatch.setattr(journal.time, "time", fake_time)
    clk = HLC()
    stamps = [clk.tick() for _ in range(4)]
    assert stamps == sorted(stamps)
    assert len(set(stamps)) == 4  # strictly increasing, no duplicates
    # The regression ticks reuse the frozen pt and count up the lc.
    assert stamps[1][0] == stamps[0][0] and stamps[1][1] == stamps[0][1] + 1
    assert stamps[2][1] == stamps[1][1] + 1
    # Once the wall catches up, pt advances and lc resets.
    assert stamps[3][0] > stamps[0][0] and stamps[3][1] == 0


def test_hlc_skewed_cross_process_ordering(monkeypatch):
    """Sender's wall clock is 1000s AHEAD of the receiver's. update()
    must still order send < receive < every later receiver stamp."""
    now = {"wall": 2000.0}
    monkeypatch.setattr(journal.time, "time", lambda: now["wall"])
    sender = HLC()
    sent = sender.tick()

    now["wall"] = 1000.0  # receiver is far behind
    receiver = HLC()
    received = receiver.update(sent)
    assert received > sent  # send happens-before receive in stamp order
    later = receiver.tick()
    assert later > received  # local progress stays after the merge
    # pt was adopted from the sender; the receiver's lagging wall clock
    # never issues a stamp that sorts before the message it saw.
    assert later[0] == sent[0]


def test_wire_stamp_observe_roundtrip(cfg_override):
    """wire_stamp/observe_wire thread the module clock through frames:
    after observing a remote stamp from the near future, the next local
    event sorts after it. Malformed/absent stamps are ignored."""
    cfg_override(journal_enabled=True)
    s = journal.wire_stamp()
    assert s is not None and len(s) == 2
    remote = [s[0] + 1_500_000, 7]  # 1.5s ahead of us
    journal.observe_wire(remote)
    journal.emit("test.after_observe")
    last = journal.snapshot()[-1]
    assert last["kind"] == "test.after_observe"
    assert tuple(last["hlc"]) > (remote[0], remote[1])
    # Garbage on the wire must never raise or move the clock backwards.
    journal.observe_wire(None)
    journal.observe_wire({"not": "a stamp"})
    journal.observe_wire([-5])
    assert journal.wire_stamp() > last["hlc"]


def test_wire_stamp_disabled_returns_none(cfg_override):
    cfg_override(journal_enabled=False)
    assert journal.wire_stamp() is None
    before = journal.counts()
    journal.emit("test.disabled")  # swallowed, not buffered
    assert journal.counts() == before


# -- ring accounting ------------------------------------------------------


def test_ring_overflow_drops_and_counts(cfg_override):
    cfg_override(journal_ring=16)
    ev0, drop0 = journal.counts()
    for i in range(40):
        journal.emit("test.fill", i=i)
    ev1, drop1 = journal.counts()
    assert ev1 - ev0 == 40
    assert drop1 - drop0 >= 24  # everything past the ring was dropped
    tail = [e for e in journal.snapshot() if e["kind"] == "test.fill"]
    assert len(tail) <= 16
    assert tail[-1]["i"] == 39  # ring keeps the NEWEST events


def test_emit_never_raises_on_weird_fields(cfg_override):
    cfg_override(journal_ring=64)
    journal.emit("test.weird", obj=object(), blob=b"\xff", none=None)
    e = journal.snapshot()[-1]
    assert e["kind"] == "test.weird"
    # dump() must serialize it anyway (default=str).
    assert json.dumps(e, default=str)


# -- bundle assembly ------------------------------------------------------


def test_dump_and_load_bundle_merges_across_processes(tmp_path, cfg_override):
    """Two per-process files (one real dump, one hand-written 'remote'
    file) merge into a single HLC-ordered timeline with per-file metas."""
    cfg_override(journal_ring=256, journal_window_s=60.0)
    journal.emit("test.local_a")
    a = journal.snapshot()[-1]["hlc"]
    # A remote process stamps an event just after ours, sends it to us;
    # observing the stamp forces our NEXT event after it (HLC contract).
    mid = [a[0], a[1] + 1]
    journal.observe_wire(mid)
    journal.emit("test.local_b")
    b = journal.snapshot()[-1]["hlc"]
    assert tuple(b) > tuple(mid)
    bundle = str(tmp_path / "pm-test")
    path = journal.dump(bundle, trigger={"trigger_id": "t1", "reason": "unit"})
    assert path and os.path.exists(path)

    remote = [
        {"hlc": mid, "ts": time.time(), "kind": "test.remote_mid",
         "proc": "replica:Echo", "pid": 99999},
        {"hlc": [b[0], b[1] + 1], "ts": time.time(), "kind": "test.remote_late",
         "proc": "replica:Echo", "pid": 99999},
    ]
    with open(os.path.join(bundle, "replica_Echo-99999.jsonl"), "w") as f:
        f.write(json.dumps({"kind": "journal.meta", "proc": "replica:Echo",
                            "pid": 99999, "ts": time.time(),
                            "hlc": remote[-1]["hlc"], "events": 2,
                            "trigger": {}}) + "\n")
        for e in remote:
            f.write(json.dumps(e) + "\n")

    events, metas = journal.load_bundle(bundle)
    assert len(metas) == 2
    assert {m["proc"] for m in metas} == {journal.process_label(), "replica:Echo"}
    kinds = [e["kind"] for e in events]
    ia, imid = kinds.index("test.local_a"), kinds.index("test.remote_mid")
    ib, ilate = kinds.index("test.local_b"), kinds.index("test.remote_late")
    assert ia < imid < ib < ilate  # interleaved by (pt, lc), not by file
    assert events == journal.merge_events(events)
    text = journal.render_timeline(events, limit=10)
    assert "test.remote_mid" in text and "replica:Echo" in text


def test_causal_chain_names_culprits_and_stops_at_client_error():
    mk = lambda pt, kind, **kw: dict({"hlc": [pt, 0], "ts": pt / 1e6,
                                      "kind": kind, "proc": "p", "pid": 1}, **kw)
    events = [
        mk(1, "serve.request", rid="r0"),  # pre-fault noise: not a link
        mk(2, "gcs.actor", state="ALIVE", actor_id="aa"),  # churn: skipped
        mk(3, "chaos.kill_replica", app="Echo", index=0),
        mk(4, "gcs.actor", state="DEAD", actor_id="aa"),
        mk(5, "serve.controller", action="replace_dead", app="Echo"),
        mk(6, "serve.redispatch", rid="r1"),
        mk(7, "serve.redispatch", rid="r2"),  # duplicate link: collapsed
        mk(8, "client.error", rid="r1", error="TaskError"),
        mk(9, "serve.shed", rid="r3"),  # after the client effect: excluded
    ]
    chain = journal.causal_chain(events)
    assert [e["kind"] for e in chain] == [
        "chaos.kill_replica", "gcs.actor", "serve.controller",
        "serve.redispatch", "client.error",
    ]
    assert journal.causal_chain([mk(1, "serve.request")]) == []  # no seed


# -- failure-triggered capture, end to end --------------------------------


def _get_postmortems(rt):
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    resp = client._run(client._gcs_call("get_postmortems", {}))
    return resp.get("postmortems", [])


def _wait_bundle_settled(bundle, timeout_s=10.0, settle_s=1.0):
    """Per-process dumps arrive asynchronously; wait until the file
    count has been stable for settle_s (or the timeout lapses)."""
    deadline = time.monotonic() + timeout_s
    last_n, last_change = -1, time.monotonic()
    while time.monotonic() < deadline:
        try:
            n = len([f for f in os.listdir(bundle) if f.endswith(".jsonl")])
        except OSError:
            n = 0
        if n != last_n:
            last_n, last_change = n, time.monotonic()
        elif n > 0 and time.monotonic() - last_change >= settle_s:
            break
        time.sleep(0.2)
    return last_n


def test_chaos_postmortem_forced_capture(rt_start, tmp_path, monkeypatch,
                                         cfg_override):
    """chaos.postmortem() forces a bundle through the GCS even inside
    the cooldown window; the driver's ring lands in it with the trigger
    recorded in the meta header."""
    monkeypatch.setenv("RT_CHAOS", "1")
    cfg_override(journal_dir=str(tmp_path))
    journal.emit("test.before_forced_dump", probe=1)
    bundle = chaos.postmortem("unit-forced")
    assert bundle.startswith(str(tmp_path))
    assert _wait_bundle_settled(bundle) >= 1
    events, metas = journal.load_bundle(bundle)
    assert any(m["trigger"].get("reason") == "unit-forced" for m in metas)
    assert any(e["kind"] == "test.before_forced_dump" for e in events)
    pms = _get_postmortems(rt_start)
    assert any(p["bundle"] == bundle and p["source"] == "chaos" for p in pms)


def test_kill_replica_autocaptures_causal_postmortem(serve_session, tmp_path,
                                                     monkeypatch, cfg_override):
    """The acceptance path in miniature: kill one of two replicas under
    in-flight traffic. WITHOUT any manual step, the controller's
    replace_dead observer must trigger a cluster dump, and the merged
    bundle must reconstruct injection -> replacement causally, with
    events from more than one process."""
    from ray_tpu_torch import serve

    monkeypatch.setenv("RT_CHAOS", "1")
    # cooldown=0 (a GCS-side knob; the GCS runs in this process): the
    # controller's replica_dead trigger mints its own bundle even though
    # the handle's breaker-open observer fires first.
    cfg_override(journal_dir=str(tmp_path), journal_cooldown_s=0.0)
    t0 = time.time()

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            time.sleep(0.4)
            return x * 2

    h = serve.run(Echo.bind())
    rs = [h.remote(i) for i in range(6)]
    time.sleep(0.15)  # let dispatches land on both replicas
    chaos.kill_replica("Echo", 0)
    assert sorted(r.result(timeout=90) for r in rs) == [0, 2, 4, 6, 8, 10]

    bundle = None
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and bundle is None:
        for p in _get_postmortems(serve_session):
            if p["ts"] >= t0 and p["reason"].startswith("replica_dead"):
                bundle = p["bundle"]
                break
        time.sleep(0.5)
    assert bundle, "replica death produced no automatic postmortem"
    assert _wait_bundle_settled(bundle) >= 1

    events, metas = journal.load_bundle(bundle)
    procs = {(m["proc"], m["pid"]) for m in metas}
    assert len(procs) >= 2, f"bundle only covers {procs}"
    kinds = {e["kind"] for e in events}
    assert "chaos.kill_replica" in kinds  # the driver's injection record
    assert any(e["kind"] == "serve.controller" and
               e.get("action") == "replace_dead" for e in events)
    chain = journal.causal_chain(events)
    assert chain and chain[0]["kind"].startswith("chaos.")
    assert len(chain) >= 2  # injection plus at least one downstream link
    # The injection sorts before the replacement it caused — across
    # processes, on HLC order alone.
    i_kill = next(i for i, e in enumerate(events)
                  if e["kind"] == "chaos.kill_replica")
    i_replace = next(i for i, e in enumerate(events)
                     if e["kind"] == "serve.controller"
                     and e.get("action") == "replace_dead")
    assert i_kill < i_replace


# -- profiling atexit drain (regression) ----------------------------------


_ATEXIT_SCRIPT = """
import os
os.environ["JAX_PLATFORMS"] = "cpu"
from ray_tpu_torch._private import worker as worker_mod


class FakeClient:
    def _gcs_call(self, method, payload):
        return (method, payload)
    def _run(self, rpc, timeout=None):
        method, payload = rpc
        print("ATEXIT_FLUSH %s %d" % (method, len(payload["events"])), flush=True)

worker_mod.get_client = lambda: FakeClient()
from ray_tpu_torch.util import profiling
# Long delay: the batch timer must NOT be what saves these events.
profiling.buffer_events([{"event_type": "span", "name": "late"},
                         {"event_type": "span", "name": "later"}],
                        flush_delay_s=3600.0)
print("BUFFERED", flush=True)
"""


def test_profiling_buffer_drains_at_exit():
    """Spans buffered moments before interpreter exit still reach the
    GCS: the atexit hook force-flushes past the armed batch timer."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _ATEXIT_SCRIPT],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "BUFFERED" in lines
    assert "ATEXIT_FLUSH add_task_events 2" in lines
    # ...and strictly AFTER the script body finished: it is the exit
    # hook, not an eager per-event RPC.
    assert lines.index("BUFFERED") < lines.index("ATEXIT_FLUSH add_task_events 2")


def test_emit_envelope_fields_cannot_collide(cfg_override):
    """A payload field named like an envelope key ("kind", "ts", ...)
    must neither raise at call time nor clobber the event's own stamp —
    the chaos scheduler once lost an injection to exactly this."""
    cfg_override(journal_ring=64)
    journal.emit("test.envelope", kind="kill_replica", ts=0, pid=-1)
    e = journal.snapshot()[-1]
    assert e["kind"] == "test.envelope"
    assert e["pid"] == os.getpid() and e["ts"] > 0
    assert e["f_kind"] == "kill_replica"


def test_causal_chain_injection_outranks_ambient_seeds():
    """Teardown noise from an unrelated app (worker deaths) inside the
    capture window must not steal the seed from an explicit injection."""
    mk = lambda pt, kind, **kw: dict({"hlc": [pt, 0], "ts": pt / 1e6,
                                      "kind": kind, "proc": "p", "pid": 1}, **kw)
    events = [
        mk(1, "raylet.worker_dead", pid_dead=123),  # old app's teardown
        mk(2, "gcs.actor", state="DEAD", actor_id="old"),
        mk(3, "chaos.kill_replica", app="Echo", index=0),
        mk(4, "gcs.actor", state="DEAD", actor_id="victim"),
        mk(5, "serve.controller", action="replace_dead", app="Echo"),
    ]
    chain = journal.causal_chain(events)
    assert chain[0]["kind"] == "chaos.kill_replica"
    assert [e["kind"] for e in chain] == [
        "chaos.kill_replica", "gcs.actor", "serve.controller"]
    assert chain[1]["actor_id"] == "victim"  # not the stale teardown death
    # Without an injection the earliest typed infrastructure seed wins.
    chain2 = journal.causal_chain([e for e in events
                                   if not e["kind"].startswith("chaos.")])
    assert chain2[0]["kind"] == "raylet.worker_dead"
