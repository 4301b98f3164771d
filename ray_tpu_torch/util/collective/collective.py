"""Collective communication API (the port of
ray_tpu/util/collective/collective.py).

Mirrors the reference's python/ray/util/collective/collective.py surface
(init_collective_group :120, create_collective_group :151, allreduce :258,
barrier :298, reduce :311, broadcast :373, allgather :423, reducescatter
:472, send/recv :531/:594, GroupManager :40) with these backends:

  * Backend.DCN  — cross-process eager collectives over TCP rings with
    GCS-KV rendezvous (role of the reference's gloo backend).
  * Backend.XLA  — NCCL over this process's visible cards, one tensor per
    card (role of the reference's nccl multi-GPU entry points; the name
    is the JAX package's).
  * Backend.HIER — the two composed.

Every op takes torch tensors (or numpy arrays) and returns what it was
given, on its device. The mesh-sharded model paths (parallel/) reduce
over torch.distributed instead; this module serves data-parallel
gradient sync outside them, the gang's epoch fence and op deadline,
control-plane sync, and CPU testing.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.util import journal
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

# The groups load torch; this module does not until a group is made, so
# that the flight recorder can register its observer in a process that
# never loads torch.


class GroupManager:
    """Per-process registry of collective groups (reference: GroupManager
    collective.py:40)."""

    def __init__(self):
        self._groups: Dict[str, object] = {}
        self._meta: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def create(self, backend: Backend, world_size: int, rank: int,
               group_name: str, epoch: int = 0,
               op_timeout_s: Optional[float] = None):
        with self._lock:
            if group_name in self._groups:
                raise ValueError(f"collective group {group_name!r} already exists")
        from ray_tpu_torch.util.collective.dcn_group import DcnGroup
        from ray_tpu_torch.util.collective.hier_group import \
            HierarchicalGroup
        from ray_tpu_torch.util.collective.local_group import LocalGroup

        if backend == Backend.DCN:
            client = worker_mod.get_client()
            group = DcnGroup(client, world_size, rank, group_name,
                             epoch=epoch, op_timeout=op_timeout_s)
        elif backend == Backend.XLA:
            group = LocalGroup(world_size if world_size > 0 else None)
        elif backend == Backend.HIER:
            client = worker_mod.get_client()
            group = HierarchicalGroup(client, world_size, rank, group_name,
                                      epoch=epoch, op_timeout_s=op_timeout_s)
        else:
            raise ValueError(backend)
        with self._lock:
            self._groups[group_name] = group
            self._meta[group_name] = {
                "backend": backend,
                "world_size": world_size,
                "rank": rank,
                "epoch": epoch,
            }
        return group

    def get(self, group_name: str):
        # create/destroy mutate these maps under the lock from other
        # threads (epoch bumps during fault recovery), so reads take it
        # too — a torn create must not hand out a half-registered group.
        with self._lock:
            g = self._groups.get(group_name)
        if g is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized in this "
                f"process; call init_collective_group first"
            )
        return g

    def meta(self, group_name: str) -> dict:
        with self._lock:
            return self._meta[group_name]

    def destroy(self, group_name: str):
        with self._lock:
            g = self._groups.pop(group_name, None)
            self._meta.pop(group_name, None)
        if g is not None:
            g.destroy()


_manager = GroupManager()


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "dcn",
    group_name: str = "default",
    epoch: int = 0,
    op_timeout_s: Optional[float] = None,
):
    """Join this process to a collective group (reference :120).

    epoch: gang attempt number — rendezvous is epoch-stamped so members
    of a torn-down prior attempt cannot join the rebuilt ring.
    op_timeout_s: per-op socket deadline (DCN); None uses the
    RT_COLLECTIVE_OP_TIMEOUT_S config default.
    """
    b = Backend.validate(backend)
    return _manager.create(b, world_size, rank, group_name, epoch=epoch,
                           op_timeout_s=op_timeout_s)


def create_collective_group(
    actors: List,
    world_size: int,
    ranks: List[int],
    backend: str = "dcn",
    group_name: str = "default",
    epoch: int = 0,
    timeout_s: Optional[float] = None,
):
    """Declaratively set up a group across actors (reference :151).

    Each actor must expose the reference convention of running
    `init_collective_group` inside itself; here we call a well-known
    method name via an internal task.

    epoch is forwarded to each actor's init so rendezvous keys are
    gang-epoch-stamped; epoch=0 keeps the legacy 4-arg call so actors
    written before the epoch parameter existed keep working (a gang
    that actually restarts must expose an epoch-accepting init).  The
    gather of init acks is bounded by `timeout_s` (default: the
    RT_COLLECTIVE_RENDEZVOUS_TIMEOUT_S config) — a member that never
    reaches rendezvous must surface as GetTimeoutError, not hang the
    caller forever.
    """
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.config import get_config

    if timeout_s is None:
        timeout_s = get_config().collective_rendezvous_timeout_s

    refs = []
    for actor, rank in zip(actors, ranks):
        method = (actor._do_init_collective
                  if hasattr(actor, "_do_init_collective")
                  else actor.init_collective)
        args = (world_size, rank, backend, group_name)
        if epoch:
            refs.append(method.remote(*args, epoch=epoch))
        else:
            refs.append(method.remote(*args))
    rt.get(refs, timeout=timeout_s)


def destroy_collective_group(group_name: str = "default"):
    _manager.destroy(group_name)


def get_rank(group_name: str = "default") -> int:
    return _manager.meta(group_name)["rank"]


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.meta(group_name)["world_size"]


# Collective-op observers: callables (op_name, seconds, info) invoked
# after each eager collective completes. The flight recorder registers one
# so the step profiler can attribute collective wall time per training
# step without this module importing anything from train/. `info` is the
# group's last_op_info dict ({tier, algo, bytes, dtype, quant}) for
# backends that record one, else None; legacy two-arg observers keep
# working (called without info). The timed path only runs when an
# observer is registered or the group records op info.
_op_observers: List = []

_metrics = None  # lazy: {bytes: Counter, seconds: Histogram}


def add_op_observer(cb) -> None:
    """Register `cb(op_name: str, seconds: float, info: Optional[dict])`
    to run after every eager collective op in this process (idempotent
    per callable). Two-arg callables are still supported."""
    if cb not in _op_observers:
        _op_observers.append(cb)


def remove_op_observer(cb) -> None:
    try:
        _op_observers.remove(cb)
    except ValueError:
        pass


def _collective_metrics():
    """collective_bytes_total / collective_op_seconds, created on the
    first instrumented op so importing this module registers nothing."""
    global _metrics
    if _metrics is None:
        from ray_tpu_torch.util import metrics as metrics_mod

        _metrics = {
            "bytes": metrics_mod.get_or_create(
                metrics_mod.Counter,
                "collective_bytes_total",
                "Bytes eager collectives pushed on the wire, by link tier, "
                "algorithm, and element dtype.",
                tag_keys=("tier", "algo", "dtype"),
            ),
            "seconds": metrics_mod.get_or_create(
                metrics_mod.Histogram,
                "collective_op_seconds",
                "Wall time of eager collective ops.",
                boundaries=metrics_mod.LATENCY_BOUNDARIES,
                tag_keys=("op", "tier", "algo"),
            ),
        }
    return _metrics


def _emit_metrics(op_name: str, dt: float, info: Optional[dict]) -> None:
    if not info:
        return
    try:
        m = _collective_metrics()
        tier = str(info.get("tier", ""))
        algo = str(info.get("algo", ""))
        nbytes = info.get("bytes", 0)
        if nbytes:
            m["bytes"].inc(
                float(nbytes),
                tags={"tier": tier, "algo": algo,
                      "dtype": str(info.get("dtype", ""))},
            )
        m["seconds"].observe(
            dt, tags={"op": op_name, "tier": tier, "algo": algo}
        )
    except Exception:  # rtlint: disable=RT007 — metrics must never break the op
        pass


def _observed(op_name: str, fn, group=None):
    """Run fn(), reporting wall time + the group's recorded op info
    (tier/algo/bytes) to observers and the collective metrics."""
    records_info = group is not None and hasattr(group, "last_op_info")
    if not _op_observers and not records_info:
        return fn()
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        dt = time.perf_counter() - t0
        info = group.last_op_info if records_info else None
        info = dict(info) if info else None  # snapshot; {} -> None
        _emit_metrics(op_name, dt, info)
        journal.emit("collective.op", op=op_name, seconds=round(dt, 6),
                     **({k: info[k] for k in ("tier", "algo", "bytes")
                         if k in info} if info else {}))
        for cb in list(_op_observers):
            try:
                try:
                    cb(op_name, dt, info)
                except TypeError:
                    cb(op_name, dt)  # pre-info two-arg observer
            except Exception:  # rtlint: disable=RT007 — observers must never break the op
                pass


def last_op_info(group_name: str = "default") -> dict:
    """The {op, tier, algo, bytes, dtype, quant} record of the group's
    most recent eager op ({} for backends that do not record one)."""
    return dict(getattr(_manager.get(group_name), "last_op_info", None) or {})


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM,
              quant: Optional[str] = None, error_feedback: bool = False,
              algo: Optional[str] = None):
    """Allreduce (reference :258). Returns the reduced value in the kind
    and on the device it was given (a list of them for the local and
    hierarchical backends).

    quant ("int8"/"fp8") and error_feedback quantize the DCN tier of the
    exchange (see util/collective/quant.py); algo ("ring"/"rd"/"hier")
    overrides the topology cost model's per-op choice. All three are
    DCN/hierarchical-only — the local backend reduces over the cards'
    own links, so asking to quantize it is an error.
    """
    from ray_tpu_torch.util.collective.local_group import LocalGroup

    g = _manager.get(group_name)
    if isinstance(g, LocalGroup):
        if quant is not None or error_feedback or algo is not None:
            raise ValueError(
                "quant/error_feedback/algo apply to the DCN tier; the local "
                "backend (\"xla\") reduces over this process's cards"
            )
        return _observed("allreduce", lambda: g.allreduce(tensor, op), g)
    return _observed(
        "allreduce",
        lambda: g.allreduce(tensor, op, quant=quant,
                            error_feedback=error_feedback, algo=algo),
        g,
    )


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    g = _manager.get(group_name)
    return _observed("reduce", lambda: g.reduce(tensor, dst_rank, op), g)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    g = _manager.get(group_name)
    return _observed("broadcast", lambda: g.broadcast(tensor, src_rank), g)


def allgather(tensor, group_name: str = "default"):
    g = _manager.get(group_name)
    return _observed("allgather", lambda: g.allgather(tensor), g)


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    g = _manager.get(group_name)
    return _observed("reducescatter", lambda: g.reducescatter(tensor, op), g)


def barrier(group_name: str = "default"):
    g = _manager.get(group_name)
    _observed("barrier", g.barrier, g)


def send(tensor, dst_rank: int, group_name: str = "default"):
    g = _manager.get(group_name)
    _observed("send", lambda: g.send(tensor, dst_rank), g)


def recv(tensor_shape, src_rank: int, group_name: str = "default"):
    """The tensor `src_rank` sent. Where `tensor_shape` is a tensor (or a
    numpy array), the result comes back in its kind and on its device;
    a shape gives a CPU torch tensor."""
    g = _manager.get(group_name)
    like = tensor_shape if hasattr(tensor_shape, "shape") else None
    return _observed("recv", lambda: g.recv(src_rank, like=like), g)
