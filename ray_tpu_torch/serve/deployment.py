"""Deployments: the unit of serving.

Analog of the reference's @serve.deployment + Deployment/Application
objects (python/ray/serve/api.py, serve/deployment.py): a decorated class
or function plus replica/autoscaling config; `.bind(...)` produces an
application graph node for `serve.run`.

The port adds `Sealed`: `serve.run` ships a deployment's class or
function and its init arguments to the controller as cloudpickle bytes,
which only the replica opens. The controller routes user code without
running it, so it never imports what the code imports (torch, CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._vendor import cloudpickle


@dataclass
class AutoscalingConfig:
    """Per-deployment autoscaling (reference:
    serve/_private/autoscaling_policy.py + serve/config.py)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    # Signals-driven pressure thresholds (ray_tpu_torch/serve/autoscale.py).
    # Queued-per-replica above this is upscale pressure even while
    # ongoing looks fine (saturation shows in the admission queue first).
    upscale_queue_depth: Optional[float] = 1.0
    # Opt-in latency/SLO pressure: None disables each signal.
    ttft_p99_high_ms: Optional[float] = None
    burn_rate_high: Optional[float] = None


@dataclass
class SloConfig:
    """Declared latency objectives the request observatory scores every
    finished request against, per tenant (observatory.RequestProfiler).

    Each `*_ms` bound is optional: declare only the dimensions that
    matter for the deployment (TTFT/TPOT only make sense for token
    streams; e2e applies everywhere). `objective` is the attainment
    target the burn-rate math divides by — 0.99 means a 1% error
    budget, and a burn rate of 1.0 consumes it exactly on schedule.
    """

    ttft_ms: Optional[float] = None   # time-to-first-token bound
    tpot_ms: Optional[float] = None   # mean time-per-output-token bound
    e2e_ms: Optional[float] = None    # end-to-end request wall bound
    objective: float = 0.99


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    max_ongoing_requests: int = 100
    autoscaling_config: Optional[AutoscalingConfig] = None
    user_config: Optional[Dict] = None
    slo: Optional[SloConfig] = None

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def options(self, **overrides) -> "Deployment":
        import copy

        d = copy.copy(self)
        for k, v in overrides.items():
            if not hasattr(d, k):
                raise ValueError(f"unknown deployment option {k!r}")
            if k == "slo" and isinstance(v, dict):
                v = SloConfig(**v)
            setattr(d, k, v)
        return d


@dataclass
class Application:
    """A bound deployment graph node (reference: Application from .bind())."""

    deployment: Deployment
    init_args: tuple
    init_kwargs: dict


def deployment(
    _func_or_class: Optional[Any] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    ray_actor_options: Optional[Dict] = None,
    max_ongoing_requests: int = 100,
    autoscaling_config: Optional[AutoscalingConfig] = None,
    user_config: Optional[Dict] = None,
    slo: Optional[SloConfig] = None,
):
    """@serve.deployment decorator (reference: serve/api.py)."""
    if isinstance(slo, dict):
        slo = SloConfig(**slo)

    def wrap(obj):
        return Deployment(
            func_or_class=obj,
            name=name or getattr(obj, "__name__", "deployment"),
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options or {},
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config,
            user_config=user_config,
            slo=slo,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


class Sealed:
    """A value that crosses the Serve controller as cloudpickle bytes.

    Two seals are equal when their bytes are: the controller's no-op
    redeploy check compares user code and init arguments this way (the
    JAX controller compares the arguments with `==`, so there equal
    arrays or a re-created function read as a change)."""

    __slots__ = ("blob",)

    def __init__(self, value):
        self.blob = cloudpickle.dumps(value)

    def open(self):
        return cloudpickle.loads(self.blob)

    def __eq__(self, other):
        return isinstance(other, Sealed) and self.blob == other.blob

    def __hash__(self):
        return hash(self.blob)

    def __getstate__(self):
        return self.blob

    def __setstate__(self, blob):
        self.blob = blob
