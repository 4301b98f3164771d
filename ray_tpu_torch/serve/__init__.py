"""ray_tpu_torch.serve: model serving. Counterpart of ray_tpu/serve/.

Public surface mirrors the reference's ray.serve: @serve.deployment,
serve.run / serve.delete / serve.status / serve.shutdown,
DeploymentHandle composition, queue-length autoscaling, and an HTTP proxy.
GPU replicas ask for the card through ray_actor_options
(`{"num_gpus": 1}`), which flows into the actor scheduler.

`llm_deployment` (in `serve.llm`, which imports torch) serves a model
through the continuous-batching engine. The control plane imports no
torch: `serve.run` seals the deployment's code and init arguments
(`deployment.Sealed`) so that only the replica opens them, and the HTTP
proxy is built on the standard library (`proxy.py`).
"""

from __future__ import annotations

import logging
from typing import Optional

import ray_tpu_torch as rt
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, get_or_create_controller
from ray_tpu_torch.serve.deployment import (
    Application,
    AutoscalingConfig,
    Deployment,
    Sealed,
    SloConfig,
    deployment,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.proxy import ProxyActor
from ray_tpu_torch.serve.schema import run_from_config

logger = logging.getLogger("ray_tpu_torch.serve")

_proxy = None


def run(app: Application, name: Optional[str] = None,
        _blocking: bool = True) -> DeploymentHandle:
    """Deploy an application (reference: serve.run, serve/api.py:429).

    Bound applications nested in init args/kwargs deploy first and
    arrive as DeploymentHandles — the reference's composition idiom:

        handle = serve.run(Pipeline.bind(Preprocess.bind()))

    Duplicate deployment names within one composition pass are
    uniquified with _1/_2 suffixes (the reference's DAG builder does
    the same), so two bound instances of the same class route to their
    own deployments instead of the second silently replacing the first.
    Suffix assignment is deterministic left-to-right, so re-running the
    same graph redeploys over the same names.
    """
    controller = get_or_create_controller()
    return _run_app(app, name, controller, set(), {})


def _run_app(app: Application, name: Optional[str], controller,
             used_names: set, resolved: dict) -> DeploymentHandle:
    # The same Application OBJECT appearing twice in a graph (a shared
    # dependency) stays one deployment; only distinct .bind() calls
    # with colliding names are uniquified.
    if id(app) in resolved:
        return resolved[id(app)]
    base = name or app.deployment.name
    app_name, i = base, 1
    while app_name in used_names:
        app_name = f"{base}_{i}"
        i += 1
    used_names.add(app_name)

    def resolve(obj):
        if isinstance(obj, Application):
            return _run_app(obj, None, controller, used_names, resolved)
        if isinstance(obj, (list, tuple)):
            return type(obj)(resolve(v) for v in obj)
        if isinstance(obj, dict):
            return {k: resolve(v) for k, v in obj.items()}
        return obj

    init_args = tuple(resolve(a) for a in app.init_args)
    init_kwargs = {k: resolve(v) for k, v in app.init_kwargs.items()}
    _reject_buried_applications((init_args, init_kwargs), app_name)
    dep = app.deployment.options(
        func_or_class=Sealed(app.deployment.func_or_class))
    rt.get(
        controller.deploy.remote(
            app_name, dep, Sealed(init_args), Sealed(init_kwargs)
        ),
        timeout=get_config().serve_deploy_timeout_s,
    )
    handle = DeploymentHandle(app_name)
    resolved[id(app)] = handle
    return handle


def _reject_buried_applications(obj, app_name: str, _seen=None, _depth=0):
    """An Application that survives resolution (e.g. buried in a user
    object's attributes) would arrive at the replica as a raw graph node
    and fail there with an opaque error; fail here with a clear one.
    Containers were already resolved — this walks one extra level into
    plain-object attributes, bounded by depth and an id-set."""
    if isinstance(obj, Application):
        raise ValueError(
            f"init args of deployment {app_name!r} contain a bound "
            "Application inside an unsupported container or object "
            "attribute; pass nested .bind() apps directly, or in "
            "lists/tuples/dicts, so serve.run can deploy them "
            "and inject DeploymentHandles."
        )
    if _depth > 4:
        return
    if _seen is None:
        _seen = set()
    if id(obj) in _seen:
        return
    _seen.add(id(obj))
    if isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            _reject_buried_applications(v, app_name, _seen, _depth + 1)
    elif isinstance(obj, dict):
        for v in obj.values():
            _reject_buried_applications(v, app_name, _seen, _depth + 1)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for v in vars(obj).values():
            _reject_buried_applications(v, app_name, _seen, _depth + 1)


def call(app_name: str, *args, method: str = "__call__", **kwargs):
    """Invoke a deployment and return its result, synchronously.

    The cross-language serving entry point: a foreign client submits the
    task `ray_tpu_torch.serve:call` with plain args (e.g. the C++ client's
    Submit("ray_tpu_torch.serve:call", {app, payload...})), the executing pool
    worker builds a handle and routes through the normal data plane —
    power-of-two choice, batching, multiplexing all apply. (Reference
    analog: the gRPC proxy's role for non-Python serve clients.)
    """
    handle = get_app_handle(app_name)
    if method != "__call__":
        handle = handle.options(method_name=method)
    return handle.remote(*args, **kwargs).result(
        timeout=get_config().serve_result_timeout_s
    )


def get_app_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def delete(name: str):
    controller = get_or_create_controller()
    rt.get(controller.delete.remote(name),
           timeout=get_config().serve_admin_timeout_s)


def status() -> dict:
    controller = get_or_create_controller()
    return rt.get(controller.status.remote(),
                  timeout=get_config().serve_admin_timeout_s)


def shutdown():
    global _proxy
    try:
        controller = rt.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    try:
        rt.get(controller.shutdown.remote(),
               timeout=get_config().serve_admin_timeout_s)
        rt.kill(controller)
    except Exception:  # noqa: BLE001 — teardown is best-effort
        logger.warning("serve controller shutdown did not complete "
                       "cleanly; its actors may linger", exc_info=True)
    _proxy = None


def start_http_proxy(host: str = "127.0.0.1", port: int = 8000):
    """Start the HTTP ingress (reference: proxies start with serve.start)."""
    global _proxy
    if _proxy is None:
        _proxy = ProxyActor.options(num_cpus=0.1).remote(host, port)
        rt.get(_proxy.ready.remote(),
               timeout=get_config().serve_ready_timeout_s)
    return rt.get(_proxy.address.remote(),
                  timeout=get_config().serve_ready_timeout_s)


def start(proxy_location: str = "HeadOnly", host: str = "127.0.0.1",
          port: int = 8000):
    """Start serve's ingress tier (reference: serve.start + ProxyLocation).

    ``proxy_location="EveryNode"`` hands proxy lifecycle to the
    controller's ProxyStateManager: one proxy actor per ALIVE node
    (node-affinity pinned, dead ones replaced each reconcile tick), each
    exposing HTTP and a binary msgpack-framed ingress. Returns the
    node_id -> address map ({"http": ..., "binary": [host, port]})."""
    controller = get_or_create_controller()
    if proxy_location == "EveryNode":
        rt.get(controller.start_proxies.remote(),
               timeout=get_config().serve_deploy_timeout_s)
        return rt.get(controller.proxy_addresses.remote(),
                      timeout=get_config().serve_admin_timeout_s)
    return {"head": {"http": start_http_proxy(host, port), "binary": None}}


def proxy_addresses() -> dict:
    """Live per-node proxy addresses (EveryNode mode)."""
    controller = get_or_create_controller()
    return rt.get(controller.proxy_addresses.remote(),
                  timeout=get_config().serve_admin_timeout_s)


__all__ = [
    "deployment",
    "Deployment",
    "Application",
    "AutoscalingConfig",
    "SloConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "run",
    "get_app_handle",
    "delete",
    "status",
    "shutdown",
    "start",
    "start_http_proxy",
    "proxy_addresses",
    "run_from_config",
]
