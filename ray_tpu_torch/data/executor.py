"""Streaming executor: blocks flow through an operator graph with
per-operator in-flight windows and no stage barriers (the port of
ray_tpu/data/executor.py).

Analog of the reference's StreamingExecutor
(data/_internal/execution/streaming_executor.py:57; scheduling loop :242)
over PhysicalOperators (execution/interfaces/physical_operator.py:136),
with TaskPool/ActorPool map operators
(execution/operators/actor_pool_map_operator.py) and backpressure
policies (execution/backpressure_policy/). Design differences are
deliberate: the logical plan is the list of Stage dataclasses a Dataset
accumulates, compiled here into physical operators — fusion merges
adjacent compatible map stages into one task per block, and the driver
loop moves blocks between operator queues as completions arrive.

Execution model per scheduling tick:
  1. drain completed tasks from every operator into its output queue;
  2. pull outputs downstream while the downstream operator has queue
     room (per-operator backpressure: a slow operator's backlog stalls
     its upstream, not the whole pipeline);
  3. submit new work for any operator with input + window room, subject
     to a global in-flight budget derived from cluster CPUs
     (resource-aware backpressure, ConcurrencyCapBackpressurePolicy
     analog);
  4. block in rt.wait on the union of in-flight refs.

ActorPoolMapOperator keeps stateful workers (e.g. a model loaded once
onto the actor's card in its __init__) and routes blocks to the
least-loaded live actor — the GPU batch-inference path: with
resources={"GPU": 1} the raylet grants each pool actor a card id and
confines its process to it.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as rt


# ---------------------------------------------------------------------------
# Logical stages (what Dataset accumulates)
# ---------------------------------------------------------------------------


@dataclass
class MapStage:
    """A per-block transform executed as remote tasks."""

    fn: Callable  # Block -> Block  (or (Block, index) with with_index)
    name: str = "map"
    max_in_flight: int = 4
    resources: Optional[dict] = None
    # fn receives the block's position as a second arg (e.g. per-block
    # seed salting for sampling).
    with_index: bool = False


@dataclass
class ActorPoolStage:
    """A per-block transform on a pool of stateful actors.

    `factory` builds the per-actor state once (e.g. load a model);
    `fn(state, block)` transforms each block. The reference expresses
    this as a callable class + ActorPoolStrategy
    (actor_pool_map_operator.py)."""

    factory: Callable[[], Any]
    fn: Callable[[Any, Any], Any]
    name: str = "actor_map"
    pool_size: int = 2
    max_in_flight_per_actor: int = 2
    resources: Optional[dict] = None


@dataclass
class ActorPoolStrategy:
    """User-facing knob for `Dataset.map_batches(..., compute=...)` —
    run the UDF as a pool of stateful actors (reference:
    ray.data.ActorPoolStrategy)."""

    size: int = 2
    max_tasks_in_flight_per_actor: int = 2


@dataclass
class AllToAllStage:
    """A barrier stage consuming all blocks at once (shuffle/sort/repartition)."""

    fn: Callable  # List[block_ref] -> List[block_ref]
    name: str = "all_to_all"


def _apply_fused(fns, block, index=None):
    for fn, with_index in fns:
        block = fn(block, index) if with_index else fn(block)
    return block


# ---------------------------------------------------------------------------
# Physical operators
# ---------------------------------------------------------------------------


class _PhysicalOp:
    """One node of the physical plan: input queue -> tasks -> output queue."""

    name: str = "op"

    def __init__(self, max_in_flight: int):
        self.inq: deque = deque()  # (idx, ref)
        self.outq: deque = deque()  # (idx, ref)
        self.inflight: Dict[Any, int] = {}  # result ref -> idx
        self.max_in_flight = max_in_flight
        self.upstream_done = False
        self.submitted = 0

    # -- scheduling interface -------------------------------------------
    def can_submit(self) -> bool:
        # Backlog guard: stop feeding tasks when our consumer is behind —
        # the per-operator backpressure that bounds intermediate memory.
        return (
            bool(self.inq)
            and len(self.inflight) < self.max_in_flight
            and len(self.outq) < 2 * self.max_in_flight
        )

    def submit_one(self) -> None:
        raise NotImplementedError

    def drain_completed(self, ready: set) -> None:
        for ref in [r for r in self.inflight if r in ready]:
            self.outq.append((self.inflight.pop(ref), ref))

    def done(self) -> bool:
        return self.upstream_done and not self.inq and not self.inflight

    def wait_refs(self) -> List:
        return list(self.inflight)

    def close(self) -> None:
        pass


class TaskMapOperator(_PhysicalOp):
    """Fused run of map stages: ONE task per block applies every fn."""

    def __init__(self, stages: List[MapStage]):
        super().__init__(max(min(s.max_in_flight for s in stages), 1))
        self.name = "+".join(s.name for s in stages)
        self._fns = [(s.fn, s.with_index) for s in stages]
        self._needs_index = any(s.with_index for s in stages)
        resources = stages[0].resources
        # Deterministic + idempotent block transforms: retry worker
        # crashes forever (the reference's data-task default).
        f = rt.remote(_apply_fused).options(max_retries=-1)
        if resources:
            f = f.options(resources=resources)
        self._remote = f

    def submit_one(self) -> None:
        idx, ref = self.inq.popleft()
        if self._needs_index:
            out = self._remote.remote(self._fns, ref, idx)
        else:
            out = self._remote.remote(self._fns, ref)
        self.inflight[out] = idx
        self.submitted += 1


class _PoolActor:
    """Generic stateful block worker (module level so workers can
    unpickle it by reference)."""

    def __init__(self, factory):
        self.state = factory()

    def apply(self, fn, block):
        return fn(self.state, block)


class ActorPoolMapOperator(_PhysicalOp):
    """Routes blocks to a fixed pool of stateful actors, least-loaded
    first (actor_pool_map_operator.py; power-of-two is unnecessary here —
    the driver sees exact per-actor in-flight counts)."""

    def __init__(self, stage: ActorPoolStage):
        super().__init__(
            max(stage.pool_size * stage.max_in_flight_per_actor, 1)
        )
        self.name = stage.name
        self._stage = stage
        self._actors: List = []
        self._per_actor: Dict[int, int] = {}  # actor index -> in-flight
        self._ref_actor: Dict[Any, int] = {}  # result ref -> actor index
        self._started = False

    def _ensure_pool(self) -> None:
        if self._started:
            return
        self._started = True
        cls = rt.remote(_PoolActor)
        if self._stage.resources:
            cls = cls.options(resources=self._stage.resources)
        for i in range(self._stage.pool_size):
            self._actors.append(cls.remote(self._stage.factory))
            self._per_actor[i] = 0

    def can_submit(self) -> bool:
        if not super().can_submit():
            return False
        self._ensure_pool()
        cap = self._stage.max_in_flight_per_actor
        return any(v < cap for v in self._per_actor.values())

    def submit_one(self) -> None:
        idx, ref = self.inq.popleft()
        ai = min(self._per_actor, key=self._per_actor.get)
        out = self._actors[ai].apply.remote(self._stage.fn, ref)
        self._per_actor[ai] += 1
        self._ref_actor[out] = ai
        self.inflight[out] = idx
        self.submitted += 1

    def drain_completed(self, ready: set) -> None:
        for ref in [r for r in self.inflight if r in ready]:
            self.outq.append((self.inflight.pop(ref), ref))
            ai = self._ref_actor.pop(ref, None)
            if ai is not None:
                self._per_actor[ai] -= 1

    def close(self) -> None:
        for a in self._actors:
            try:
                rt.kill(a)
            except Exception:  # noqa: BLE001
                pass
        self._actors.clear()


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def _fuse(stages: List[Any]) -> List[Any]:
    """Merge adjacent MapStages with identical resource shapes into one
    operator — one task per block instead of one per stage per block
    (the reference's OperatorFusionRule, _internal/logical/rules)."""
    out: List[Any] = []
    run: List[MapStage] = []
    for s in stages:
        if isinstance(s, MapStage) and (
            not run or run[-1].resources == s.resources
        ):
            run.append(s)
            continue
        if run:
            out.append(TaskMapOperator(run))
            run = []
        if isinstance(s, MapStage):
            run = [s]
        elif isinstance(s, ActorPoolStage):
            out.append(ActorPoolMapOperator(s))
        else:
            out.append(s)  # AllToAllStage stays logical (barrier)
    if run:
        out.append(TaskMapOperator(run))
    return out


class StreamingExecutor:
    def __init__(self, stages: List[Any], max_in_flight: int = 4,
                 cpu_budget: Optional[int] = None):
        self.stages = stages
        self.max_in_flight = max_in_flight
        # Global concurrency budget: total in-flight block tasks across
        # every operator is capped near the cluster's CPU count so a deep
        # pipeline cannot oversubscribe the node (resource-aware
        # backpressure; reference: backpressure_policy/concurrency_cap).
        self._cpu_budget = cpu_budget
        # Per-stage-run execution stats (reference: Dataset.stats(),
        # _internal/stats.py): [{"stage", "blocks", "wall_s", "tasks"}].
        self.stats: List[dict] = []

    def _budget(self) -> int:
        if self._cpu_budget is None:
            try:
                cpus = rt.cluster_resources().get("CPU", 4)
            except Exception:  # noqa: BLE001
                cpus = 4
            from ray_tpu_torch._private.config import get_config

            self._cpu_budget = max(
                int(cpus * get_config().data_cpu_budget_factor), 4
            )
        return self._cpu_budget

    def execute(self, input_refs: List) -> List:
        """Run the stage pipeline over input block refs; returns output refs."""
        refs = list(input_refs)
        plan = _fuse(self.stages)
        # Split at barriers; each segment streams internally.
        segment: List[_PhysicalOp] = []
        for op in plan:
            if isinstance(op, AllToAllStage):
                if segment:
                    refs = self._timed_ops(segment, refs)
                    segment = []
                refs = self._timed(op.name, lambda o=op, x=refs: o.fn(x),
                                   len(refs))
            else:
                segment.append(op)
        if segment:
            refs = self._timed_ops(segment, refs)
        return refs

    def _timed(self, name: str, fn, n_blocks: int):
        start = time.perf_counter()
        out = fn()
        self.stats.append({
            "stage": name,
            "blocks": n_blocks,
            "wall_s": round(time.perf_counter() - start, 4),
        })
        return out

    def _timed_ops(self, ops: List[_PhysicalOp], refs: List) -> List:
        start = time.perf_counter()
        out = self._run_segment(ops, refs)
        self.stats.append({
            "stage": "->".join(op.name for op in ops),
            "blocks": len(refs),
            "tasks": sum(op.submitted for op in ops),
            "wall_s": round(time.perf_counter() - start, 4),
        })
        return out

    def execute_iter(self, input_refs: List) -> "Iterator":
        """Streaming variant of execute(): yields output block refs of the
        FINAL pipeline segment as they complete (completion order), so a
        consumer (streaming_split's coordinator) can hand blocks to
        trainers while upstream tasks are still running. Barrier stages
        (all-to-all) still synchronize internally."""
        refs = list(input_refs)
        plan = _fuse(self.stages)
        segments: List = []
        cur: List[_PhysicalOp] = []
        for op in plan:
            if isinstance(op, AllToAllStage):
                if cur:
                    segments.append(("ops", cur))
                    cur = []
                segments.append(("barrier", op))
            else:
                cur.append(op)
        if cur:
            segments.append(("ops", cur))
        if not segments:
            yield from refs
            return
        for kind, seg in segments[:-1]:
            refs = seg.fn(refs) if kind == "barrier" else (
                self._run_segment(seg, refs)
            )
        kind, last = segments[-1]
        if kind == "barrier":
            yield from last.fn(refs)
        else:
            for _idx, ref in self._run_segment_iter(last, refs):
                yield ref

    def _run_segment(self, ops: List[_PhysicalOp], input_refs: List) -> List:
        """Drive a barrier-free run of operators to completion; results in
        input order."""
        out: List = [None] * len(input_refs)
        for idx, ref in self._run_segment_iter(ops, input_refs):
            out[idx] = ref
        return out

    def _run_segment_iter(self, ops: List[_PhysicalOp], input_refs: List):
        """Generator core: yields (input_index, output_ref) as blocks
        finish the segment."""
        source = deque(enumerate(input_refs))
        budget = self._budget()
        n_done = 0
        try:
            while n_done < len(input_refs):
                # 1+2. Move data downstream (last op first so freshly
                # drained outputs don't double-hop in one tick).
                for i in range(len(ops) - 1, -1, -1):
                    op = ops[i]
                    sink = ops[i + 1] if i + 1 < len(ops) else None
                    while op.outq:
                        if sink is not None:
                            if len(sink.inq) >= 2 * sink.max_in_flight:
                                break  # downstream backlog: stall upstream
                            sink.inq.append(op.outq.popleft())
                        else:
                            idx, ref = op.outq.popleft()
                            # _run_segment lands results at their ORIGINAL
                            # positions: consumers (zip, ordered
                            # iteration) rely on block order surviving
                            # completion order.
                            n_done += 1
                            yield idx, ref
                # Feed the first operator from the source.
                first = ops[0]
                while source and len(first.inq) < 2 * first.max_in_flight:
                    first.inq.append(source.popleft())
                first.upstream_done = not source
                for i in range(1, len(ops)):
                    ops[i].upstream_done = ops[i - 1].done()
                # 3. Submit under the global budget.
                total_inflight = sum(len(op.inflight) for op in ops)
                for op in ops:
                    while op.can_submit() and total_inflight < budget:
                        op.submit_one()
                        total_inflight += 1
                if n_done >= len(input_refs):
                    break
                # 4. Wait for any completion anywhere.
                all_refs = [r for op in ops for r in op.wait_refs()]
                if not all_refs:
                    time.sleep(0.005)
                    continue
                ready, _ = rt.wait(all_refs, num_returns=1, timeout=60.0)
                ready_set = set(ready)
                for op in ops:
                    op.drain_completed(ready_set)
        finally:
            for op in ops:
                op.close()
