"""Flight recorder: always-cheap, ring-buffered per-step telemetry for
the training hot loop (the port of ray_tpu/train/flight_recorder.py).

The runtime can time tasks, spans, and object transfers — but none of
that decomposes a slow TRAINING STEP. This module supplies the missing
layer: a `StepProfiler` the loop wraps around each step that records a
per-step wall-time breakdown (data-wait, compute, collective, checkpoint,
other), compile/retrace counts (watched callables' caches and the CUDA
kernels built with nvcc inside the step), throughput, an MFU estimate
and, while a torch profiler records, the card's milliseconds in each of
the model's top-level device spans, into a fixed-size ring buffer. Recording
is a handful of `perf_counter` reads and dict writes per step — cheap
enough to leave on in production (bench_obs.py pins the overhead;
BENCH_OBS.json).

Per-rank records ride the existing report/poll stream back to the
trainer, which computes CROSS-RANK SKEW and names the slowest rank
(straggler attribution in `Result.metrics_history` and the
`train_step_skew_seconds` metric) — the rank-level visibility The Big
Send-off (arXiv:2409.05208-adjacent, PAPERS.md) identifies as the root
of most large-scale collective slowdowns, and the per-phase overlap
ledger T3 (arXiv:2401.16677) shows is the prerequisite for optimizing
compute/collective overlap. Aggregates also flush through the GCS
metrics stream (rank-tagged), powering `rt top` and the Grafana panels.

Usage (inside a train_loop_per_worker):

    from ray_tpu_torch import train

    prof = train.StepProfiler(flops_per_step=model_flops)
    prof.attach_feed(it)                    # data-wait from FeedStats
    for batch in it:
        with prof.step(tokens=batch_tokens) as s:
            with prof.phase("compute"):
                loss = train_step(batch)
            s.fence(loss)                   # torch.cuda.synchronize
        train.report({"loss": float(loss)}) # step records ride along

Collective time needs no annotation: every eager op of util.collective
reaches the "collective" phase through an op observer the profiler
registers (as in the JAX package), and `train.allreduce_gradients` over
the torch process group attributes its own wall time there. Phases not
covered by an explicit `phase(...)`/`fence` land in "other_s", so the
breakdown always sums to the step wall time.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ray_tpu_torch import _build
from ray_tpu_torch._private import chaos
from ray_tpu_torch.util import journal, profiling

#: Phase keys every record carries (plus "other_s" for the remainder).
PHASES = ("data", "compute", "collective", "checkpoint")

# Dense peak-flops table (bf16, per card) for the MFU estimate; matched
# by substring against torch.cuda.get_device_name(). The H100's is the
# data sheet's dense bf16 rate (SXM, 700 W). Overridable (and extendable
# to unlisted hardware) via RT_PEAK_FLOPS_PER_S.
_PEAK_FLOPS_BY_KIND = (
    ("h100", 989e12),
)

_tls = threading.local()  # .step = the thread's in-flight _StepHandle

_metrics_lock = threading.Lock()
_metrics: Optional[Dict] = None
_collective_hooked = False


def peak_flops_per_s() -> Optional[float]:
    """Per-device peak flops/s for MFU: RT_PEAK_FLOPS_PER_S env override,
    else the device-name table; None when unknown (no card, or a process
    that has not loaded torch: this never imports it)."""
    env = os.environ.get("RT_PEAK_FLOPS_PER_S")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name().lower()
    for sub, flops in _PEAK_FLOPS_BY_KIND:
        if sub in kind:
            return flops
    return None


def _recorder_metrics() -> Dict:
    """Process-wide recorder metrics (created on first StepProfiler, not
    import, so importing train/ never starts the metrics flusher)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util import metrics as m

            _metrics = {
                "wall": m.get_or_create(
                    m.Histogram, "train_step_wall_seconds",
                    "Training step wall time per rank.",
                    boundaries=m.LATENCY_BOUNDARIES, tag_keys=("rank",),
                ),
                "phase": m.get_or_create(
                    m.Counter, "train_step_phase_seconds_total",
                    "Cumulative step wall time by phase "
                    "(data/compute/collective/checkpoint/other) and rank.",
                    tag_keys=("rank", "phase"),
                ),
                "compiles": m.get_or_create(
                    m.Counter, "train_step_compiles_total",
                    "Compilations observed during training steps "
                    "(steady-state steps should never compile).",
                    tag_keys=("rank",),
                ),
                "throughput": m.get_or_create(
                    m.Gauge, "train_tokens_per_s",
                    "Tokens (or samples) per second of the latest step.",
                    tag_keys=("rank",),
                ),
                "mfu": m.get_or_create(
                    m.Gauge, "train_step_mfu",
                    "Model-flops utilization estimate of the latest step.",
                    tag_keys=("rank",),
                ),
            }
        return _metrics


def note_phase(name: str, seconds: float) -> None:
    """Attribute `seconds` to phase `name` of this thread's in-flight
    step. No-op (two attribute reads) when no step is open — safe to
    call from library code unconditionally."""
    step = getattr(_tls, "step", None)
    if step is not None:
        step._phases[name] = step._phases.get(name, 0.0) + seconds


def _collective_observer(op_name: str, seconds: float,
                         info: Optional[dict] = None) -> None:
    # `info` carries {tier, algo, bytes, ...} from the collective layer;
    # step attribution only needs the wall time, but accepting it keeps
    # this on the three-arg observer protocol.
    note_phase("collective", seconds)


def _ensure_collective_hook() -> None:
    global _collective_hooked
    if _collective_hooked:
        return
    _collective_hooked = True
    from ray_tpu_torch.util.collective import collective as col

    col.add_op_observer(_collective_observer)


def _synchronize(tree: Any) -> None:
    """Wait for the card's work on every CUDA tensor in `tree` (a tensor
    or a nested dict/list/tuple of them): one torch.cuda.synchronize per
    device. CPU tensors are computed when they return; a process that has
    not loaded torch holds no tensor to wait for."""
    torch = sys.modules.get("torch")
    if torch is None:
        return
    if isinstance(tree, torch.Tensor):
        leaves = [tree]
    else:
        from ray_tpu_torch.train.checkpoint import flatten_tree

        leaves = flatten_tree(tree)[0]
    devices = {leaf.device for leaf in leaves
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def _top_span_ms() -> Dict[str, Dict[str, float]]:
    """The top-level device spans' cumulative ms per pass."""
    return {name: {p: t[f"{p}_ms"] for p in profiling.PASSES}
            for name, t in profiling.device_span_totals().items()
            if t["top"]}


class _StepHandle:
    """The object `with prof.step() as s:` yields — the in-flight step's
    accumulator AND context manager (class-based, not @contextmanager:
    this runs once per training step). `fence(tree)` closes the
    async-launch gap: it blocks until the card's work on the step's
    tensors is done and attributes the block time to "compute" (without a
    fence, device time still queued on the stream at step exit lands in
    the NEXT step's wall). While a torch profiler records, the device
    spans are on (util.profiling.device_span) and the fence also reads
    their device time, which the card has then finished."""

    __slots__ = ("_prof", "_phases", "tokens", "samples", "_t0", "_prev",
                 "_builds0", "_device0", "_device_ms")

    def __init__(self, prof, tokens=None, samples=None):
        self._prof = prof
        self._phases: Dict[str, float] = {}
        self.tokens = tokens
        self.samples = samples
        self._t0 = 0.0
        self._prev = None
        self._builds0 = 0
        self._device0 = self._device_ms = None

    def __enter__(self):
        self._prev = getattr(_tls, "step", None)
        _tls.step = self
        self._builds0 = _build.build_count()
        if profiling.device_spans_on():
            self._device0 = _top_span_ms()
        self._t0 = time.perf_counter()
        # Chaos straggler injection sleeps INSIDE the timed window — the
        # recorder must see the slowness it models (as other_s: a real
        # straggler's lost time is exactly the un-attributed kind).
        delay = chaos.take_step_delay()
        if delay:
            time.sleep(delay)
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        _tls.step = self._prev
        self._prof._finish(self, wall)
        return False

    def fence(self, tree: Any) -> None:
        t0 = time.perf_counter()
        _synchronize(tree)
        self._phases["compute"] = (
            self._phases.get("compute", 0.0) + time.perf_counter() - t0
        )
        if self._device0 is not None:
            was = self._device0
            self._device_ms = {
                name: {p: v - was.get(name, {}).get(p, 0.0)
                       for p, v in t.items()}
                for name, t in _top_span_ms().items()}


class _PhaseTimer:
    """`with prof.phase(name):` — times the block into the active step."""

    __slots__ = ("_name", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        note_phase(self._name, time.perf_counter() - self._t0)
        return False


class StepProfiler:
    """Ring-buffered per-step recorder (one per rank, one per loop).

    ring: records kept in memory (old steps fall off — flight-recorder
      discipline: always on, bounded, overwrite-oldest).
    flops_per_step / peak_flops: MFU estimate inputs; peak defaults to
      the device table (RT_PEAK_FLOPS_PER_S override). No flops → no MFU.
    rank: tag for the exported metrics; defaults to the active train
      session's world rank (standalone use: pass explicitly).
    emit_metrics: also observe per-step aggregates into rank-tagged
      util.metrics series (what `rt top`/Grafana read). Ring recording
      itself never touches the metrics path.

    While a torch profiler records, each fenced step's record also
    carries `device_ms`, {span: {"forward", "recompute", "backward"}} in
    ms, for the device spans entered with no other span open.

    Thread discipline: step()/phase() run on the loop thread; summary()
    and drain_records() may be called from another thread (the actor's
    poll) — shared aggregates are lock-guarded.
    """

    def __init__(self, ring: int = 512,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 rank: Optional[int] = None,
                 emit_metrics: bool = True):
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        self._ring: "collections.deque" = collections.deque(maxlen=ring)
        self._pending: "collections.deque" = collections.deque(maxlen=ring)
        self._lock = threading.Lock()
        self._flops_per_step = flops_per_step
        self._peak_flops = peak_flops or peak_flops_per_s()
        self._emit = emit_metrics
        self._watched: List[Any] = []
        self._last_compiles = 0
        self._feed = None
        self._feed_last: Dict[str, float] = {}
        self._steps = 0
        self._totals: Dict[str, float] = {}
        self._total_wall = 0.0
        self._total_tokens = 0.0
        self._last_wall = 0.0
        if rank is None:
            try:
                from ray_tpu_torch.train.session import get_session

                rank = get_session().world_rank
            except Exception:  # rtlint: disable=RT007 — standalone profiler, no session
                rank = None
        self.rank = rank
        self._rank_tag = {"rank": str(rank if rank is not None else "-")}
        _ensure_collective_hook()
        # Metric series keys resolved ONCE — _finish runs per step and
        # must not merge/sort tag dicts or take the registry lock there.
        self._m = _recorder_metrics() if self._emit else None
        if self._m is not None:
            m = self._m
            self._wall_key = m["wall"]._key(self._rank_tag)
            self._compiles_key = m["compiles"]._key(self._rank_tag)
            self._throughput_key = m["throughput"]._key(self._rank_tag)
            self._mfu_key = m["mfu"]._key(self._rank_tag)
            self._phase_keys = {
                k: m["phase"]._key({**self._rank_tag, "phase": k})
                for k in PHASES + ("other",)
            }
        # Auto-attach to the active session so step records ride
        # session.report / worker poll without extra user wiring.
        try:
            from ray_tpu_torch.train.session import get_session

            get_session().attach_profiler(self)
        except Exception:  # rtlint: disable=RT007 — no session (driver/bench use)
            pass

    # -- loop-side API ---------------------------------------------------
    def watch_jit(self, *fns: Any) -> "StepProfiler":
        """Track compiled-program cache growth of these callables (any
        object with a `_cache_size()`, as a jax.jit function has): any
        growth during a step is recorded as that step's `compiles`
        (a steady-state loop should record 0 — growth means a retrace)."""
        self._watched.extend(fns)
        self._last_compiles = self._compile_count()
        return self

    def attach_feed(self, source: Any) -> "StepProfiler":
        """Wire data-wait accounting to an input pipeline: `source` is a
        FeedStats, or anything with feed_stats()/stats — a
        ray_tpu_torch.data DataIterator (its newest iter_torch_batches
        feed) or the _DevicePrefetcher that iter_torch_batches returns.
        Each step records the delta of the feed's consumer wait; steps
        with no explicit "data" phase attribute the delta to data_s
        automatically."""
        self._feed = source
        self._feed_last = self._feed_snapshot() or {}
        return self

    def step(self, tokens: Optional[float] = None,
             samples: Optional[float] = None) -> _StepHandle:
        """Record one training step. Yields the step handle (set .tokens
        /.samples late, call .fence(tree) before exit)."""
        return _StepHandle(self, tokens=tokens, samples=samples)

    def phase(self, name: str) -> "_PhaseTimer":
        """Attribute the enclosed wall time to `name` within the current
        step ("data", "compute", "collective", "checkpoint", or any
        custom key). Outside a step: a plain no-op timer. Class-based
        (not @contextmanager) — this runs inside the hot loop."""
        return _PhaseTimer(name)

    # -- record assembly -------------------------------------------------
    def _compile_count(self) -> int:
        n = 0
        for f in self._watched:
            try:
                n += f._cache_size()
            except (AttributeError, TypeError):
                # A callable without jit cache introspection just
                # disables retrace counting for itself.
                pass
        return n

    def _feed_snapshot(self) -> Optional[Dict[str, float]]:
        src = self._feed
        if src is None:
            return None
        for attr in ("snapshot", "feed_stats"):
            fn = getattr(src, attr, None)
            if callable(fn):
                try:
                    snap = fn()
                except Exception:  # rtlint: disable=RT007 — feed gone mid-run
                    return None
                return snap if isinstance(snap, dict) else None
        stats = getattr(src, "stats", None)
        if stats is not None and hasattr(stats, "snapshot"):
            return stats.snapshot()
        return None

    def _finish(self, handle: _StepHandle, wall: float) -> None:
        phases = handle._phases
        rec: Dict[str, Any] = {
            "step": self._steps,
            "ts": time.time(),
            "wall_s": wall,
        }
        # Feed delta: consumer wait the pipeline measured this step.
        snap = self._feed_snapshot()
        if snap is not None:
            wait = snap.get("wait_s", 0.0) - self._feed_last.get("wait_s", 0.0)
            stalls = (snap.get("stall_count", 0)
                      - self._feed_last.get("stall_count", 0))
            self._feed_last = snap
            rec["feed_wait_s"] = max(wait, 0.0)
            rec["feed_stalls"] = max(stalls, 0)
            if "data" not in phases:
                # No explicit data phase: the measured feed wait IS the
                # step's data time.
                phases["data"] = rec["feed_wait_s"]
        named = 0.0
        for k in PHASES:
            v = min(phases.get(k, 0.0), wall)
            rec[f"{k}_s"] = v
            named += v
        for k, v in phases.items():
            if k not in PHASES:
                rec[f"{k}_s"] = v
                named += v
        rec["other_s"] = max(wall - named, 0.0)
        # Retraces of watched callables, and CUDA kernels built mid-step.
        compiles = _build.build_count() - handle._builds0
        if self._watched:
            n = self._compile_count()
            compiles += max(n - self._last_compiles, 0)
            self._last_compiles = n
        rec["compiles"] = compiles
        if handle._device_ms is not None:
            rec["device_ms"] = handle._device_ms
        tokens = handle.tokens if handle.tokens is not None else handle.samples
        if tokens is not None and wall > 0:
            rec["tokens"] = tokens
            rec["tokens_per_s"] = tokens / wall
        if self._flops_per_step and self._peak_flops and wall > 0:
            rec["mfu"] = self._flops_per_step / wall / self._peak_flops
        with self._lock:
            self._steps += 1
            rec["step"] = self._steps - 1
            self._ring.append(rec)
            self._pending.append(rec)
            self._total_wall += wall
            self._last_wall = wall
            if tokens is not None:
                self._total_tokens += tokens
            for k in list(rec):
                # Phase-time keys only ("tokens_per_s" is a rate).
                if k.endswith("_s") and k not in ("tokens_per_s", "wall_s"):
                    self._totals[k] = self._totals.get(k, 0.0) + rec[k]
        m = self._m
        if m is not None:
            m["wall"].observe_keyed(self._wall_key, wall)
            phase_keys = self._phase_keys
            phase_counter = m["phase"]
            for k in PHASES + ("other",):
                v = rec.get(f"{k}_s", 0.0)
                if v > 0:
                    phase_counter.inc_keyed(phase_keys[k], v)
            if compiles:
                m["compiles"].inc_keyed(self._compiles_key, compiles)
            if "tokens_per_s" in rec:
                m["throughput"].set_keyed(
                    self._throughput_key, rec["tokens_per_s"]
                )
            if "mfu" in rec:
                m["mfu"].set_keyed(self._mfu_key, rec["mfu"])
        journal.emit("train.step", step=rec["step"],
                     wall_s=round(wall, 6), compiles=compiles,
                     **({"tokens": tokens} if tokens is not None else {}))

    # -- observer-side API -----------------------------------------------
    def records(self) -> List[Dict]:
        """The ring buffer's current contents (oldest first)."""
        with self._lock:
            return list(self._ring)

    def drain_records(self) -> List[Dict]:
        """Pop records not yet shipped (the session.report path calls
        this so each report carries the steps since the last one)."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
            return out

    def summary(self) -> Dict:
        """Cumulative per-rank stats — the compact record each poll ships
        to the trainer for cross-rank skew computation."""
        with self._lock:
            steps = self._steps
            out = {
                "rank": self.rank,
                "steps": steps,
                "wall_s": self._total_wall,
                "mean_step_s": self._total_wall / steps if steps else 0.0,
                "last_step_s": self._last_wall,
                "tokens": self._total_tokens,
            }
            for k, v in self._totals.items():
                out[k] = v
            return out


def compute_skew(rank_summaries: Sequence[Optional[Dict]]) -> Optional[Dict]:
    """Cross-rank straggler attribution from per-rank summary() dicts
    (driver-side; entries may be None for ranks not yet reporting).

    Returns {"skew_s", "straggler_rank", "mean_step_s_by_rank",
    "straggler_breakdown"} — skew is (slowest - fastest) mean step wall;
    the straggler is the argmax rank; its per-phase means show WHERE the
    lost time goes. None until >= 2 ranks have completed steps.
    """
    ranked = [
        (i, s) for i, s in enumerate(rank_summaries)
        if s and s.get("steps", 0) > 0
    ]
    if len(ranked) < 2:
        return None
    means = {i: s["wall_s"] / s["steps"] for i, s in ranked}
    straggler = max(means, key=means.get)
    skew = means[straggler] - min(means.values())
    s = dict(ranked)[straggler]
    steps = s["steps"]
    breakdown = {
        k: round(v / steps, 6)
        for k, v in s.items()
        if isinstance(v, (int, float)) and k.endswith("_s")
        and k not in ("wall_s", "mean_step_s", "last_step_s", "tokens_per_s")
    }
    return {
        "skew_s": skew,
        "straggler_rank": straggler,
        "mean_step_s_by_rank": {i: round(m, 6) for i, m in means.items()},
        "straggler_breakdown": breakdown,
    }
