"""User-facing exceptions.

Mirrors the taxonomy in the reference's python/ray/exceptions.py: task
errors wrap the remote traceback, actor errors/unavailability, object loss,
and cancellation.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch errors."""


class TaskError(RayTpuError):
    """A task raised an exception remotely (reference: RayTaskError).

    Raised on `get()` of the task's return ref; carries the remote traceback.
    """

    def __init__(self, cause_cls_name: str, traceback_str: str, cause=None):
        self.cause_cls_name = cause_cls_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"Remote task failed with {cause_cls_name}:\n{traceback_str}")


class ActorError(RayTpuError):
    """Base class for actor-related failures (reference: RayActorError)."""


class ActorDiedError(ActorError):
    """The actor process is dead; calls on its handle will fail."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class CollectiveTimeoutError(RayTpuError, TimeoutError):
    """A collective op missed its deadline: a peer is dead or wedged.

    Raised by the eager DCN ring instead of hanging in ``recv`` forever,
    so one preempted rank converts into a restartable failure for the
    whole gang. Carries enough context to identify the bad link."""

    def __init__(self, message: str, *, group_name: str = "",
                 rank=None, peer_rank=None):
        self.group_name = group_name
        self.rank = rank
        self.peer_rank = peer_rank
        super().__init__(message)


class ServeOverloadedError(RayTpuError):
    """The serving tier shed this request instead of queueing it.

    Raised when a bounded admission queue (replica or engine) is full,
    or a draining/sick replica refuses new work and no healthy replica
    remains. Always retryable: the request was REJECTED before consuming
    a slot, so a later retry is safe regardless of deployment semantics.
    ``retry_after_s`` is the server's backlog-drain estimate — the proxy
    surfaces it as HTTP 429 + ``Retry-After``."""

    def __init__(self, message: str, *, app: str = "", tenant: str = "",
                 reason: str = "queue_full", retry_after_s: float = 1.0):
        self.app = app
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = retry_after_s
        super().__init__(message)


class PromptTooLongError(RayTpuError, ValueError):
    """The prompt cannot fit the serving engine's KV capacity.

    Raised by ``ContinuousBatchingEngine.submit`` BEFORE queueing: the
    bound is ``max_len - 2`` positions and, under the paged KV cache,
    the page pool's total capacity — whichever is smaller. Not
    retryable against the same engine (the limit is structural); the
    proxy maps it to HTTP 413. Subclasses ValueError so callers of the
    historical untyped rejection keep working."""

    def __init__(self, message: str, *, prompt_len: int = 0,
                 max_prompt_len: int = 0):
        self.prompt_len = prompt_len
        self.max_prompt_len = max_prompt_len
        super().__init__(message)


class RequestCancelledError(RayTpuError):
    """A serve request was cancelled instead of executed to completion.

    ``reason`` is one of ``"deadline"`` (the propagated absolute deadline
    expired — every hop checks it and expired work is evicted rather than
    run), ``"client"`` (the caller closed the stream / cancelled), or
    ``"shutdown"`` (the engine/replica is going away). Deadline
    cancellations are NOT retryable — the budget is gone by definition."""

    def __init__(self, message: str, *, reason: str = "deadline",
                 app: str = "", rid: str = ""):
        self.reason = reason
        self.app = app
        self.rid = rid
        super().__init__(message)


class ReplicaDrainingError(RayTpuError):
    """The chosen replica is draining (scale-down / migration) and no
    longer admits requests. Retryable by construction: the handle
    redispatches to a live replica exactly as for a dead one."""

    def __init__(self, message: str, *, app: str = ""):
        self.app = app
        super().__init__(message)


class ObjectLostError(RayTpuError):
    """All copies of the object are gone and it cannot be reconstructed."""


class ObjectStoreFullError(RayTpuError):
    """The shared-memory store could not allocate after eviction."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before or during execution."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get()` exceeded its timeout."""


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing the runtime environment for a task/actor failed."""


class PlacementGroupSchedulingError(RayTpuError):
    """The placement group could not be scheduled (infeasible bundles)."""
