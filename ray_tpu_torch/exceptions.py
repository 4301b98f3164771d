"""User-facing exceptions of the serving path. Copies of the three serving
exceptions of ray_tpu/exceptions.py, under the same names."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for the port's errors."""


class ServeOverloadedError(RayTpuError):
    """The serving tier shed this request instead of queueing it.

    Raised when a bounded admission queue is full. Always retryable: the
    request was REJECTED before consuming a slot. ``retry_after_s`` is the
    server's backlog-drain estimate."""

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
    bound is ``max_len - 2`` positions and, under the paged KV cache, the
    page pool's total capacity — whichever is smaller. Not retryable
    against the same engine. Subclasses ValueError."""

    def __init__(self, message: str, *, prompt_len: int = 0,
                 max_prompt_len: int = 0):
        self.prompt_len = prompt_len
        self.max_prompt_len = max_prompt_len
        super().__init__(message)


class RequestCancelledError(RayTpuError):
    """A serve request was cancelled instead of executed to completion.

    ``reason`` is one of ``"deadline"`` (the propagated absolute deadline
    expired), ``"client"`` (the caller cancelled) or ``"shutdown"``.
    Deadline cancellations are NOT retryable."""

    def __init__(self, message: str, *, reason: str = "deadline",
                 app: str = "", rid: str = ""):
        self.reason = reason
        self.app = app
        self.rid = rid
        super().__init__(message)
