"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

It mirrors ray_tpu's module paths and names so each piece has a findable
counterpart, and imports neither JAX nor anything of ray_tpu. The runtime
core (GCS, raylet, shared-memory object store, workers, tasks and actors)
schedules the card as the `GPU` resource. The library serves
Llama-family decoders through the continuous-batching engine
(`ray_tpu_torch.serve.llm`) and trains them (`ray_tpu_torch.models`
`forward` / `loss_fn`); every RMSNorm and attention on a CUDA tensor runs
the hand-written kernels in `csrc/`, built on first use by `_build`.

Model entry points run on the card unless the caller passes
`device="cpu"`; with no device given and no card present they raise.

Public core API mirrors the reference (python/ray/__init__.py):
init / shutdown / remote / get / put / wait / kill / get_actor / ...
"""

from __future__ import annotations

import atexit
import inspect
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._version import version as __version__  # noqa: F401
from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.worker import (  # noqa: F401
    ActorHandle,
    ObjectRef,
    ObjectRefGenerator,
)
from ray_tpu_torch.actor import ActorClass, method  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction

_node = None
_client = None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    local_mode: bool = False,
    labels: Optional[Dict[str, str]] = None,
    ignore_reinit_error: bool = False,
    runtime_env: Optional[Dict] = None,
):
    """Start (or connect to) a ray_tpu_torch cluster.

    Reference analog: ray.init (python/ray/_private/worker.py:1228). With no
    address this bootstraps a head node in-process (GCS + raylet services on
    a background event loop; worker processes are real subprocesses).
    With address="host:port" it connects to an existing GCS as a new node;
    with address="rt://host:port" it attaches as a REMOTE driver (the
    reference's Ray Client, ray://): no local node, no shared memory —
    puts/gets proxy through the head raylet over TCP.
    """
    global _node, _client
    if _worker.is_initialized():
        if ignore_reinit_error:
            return
        raise RuntimeError("ray_tpu_torch.init() called twice")

    if address is not None and address.startswith("rt://"):
        bad = {
            "num_cpus": num_cpus, "num_gpus": num_gpus,
            "resources": resources,
            "object_store_memory": object_store_memory,
            "labels": labels, "local_mode": local_mode or None,
        }
        bad = [k for k, v in bad.items() if v]
        if bad:
            raise ValueError(
                f"rt:// remote drivers attach without a local node; "
                f"{bad} cannot apply (configure nodes cluster-side)"
            )
        _client = _remote_attach(address.removeprefix("rt://"))
        if runtime_env:
            _client.default_runtime_env = runtime_env
        _worker.set_client(_client, "driver", None)
        atexit.register(shutdown)
        return

    if local_mode:
        from ray_tpu_torch._private.local_mode import LocalClient

        client = LocalClient(resources)
        _worker.set_client(client, "local")
        _client = client
        return

    from ray_tpu_torch._private.node import Node

    if address is None:
        _node = Node(
            head=True,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources,
            object_store_memory=object_store_memory,
            labels=labels,
        )
        _client = _node.make_client()
    else:
        # Join an existing cluster as a new node + driver.
        _node = Node(
            head=False,
            gcs_address=address,
            num_cpus=num_cpus if num_cpus is not None else 0,
            num_gpus=num_gpus,
            resources=resources,
            object_store_memory=object_store_memory,
            labels=labels,
        )
        _client = _node.make_client()
    if runtime_env:
        _client.default_runtime_env = runtime_env
    else:
        # A driver launched by the job supervisor inherits the job-level
        # runtime env (already resolved to URIs + hash by the submitter).
        import json as _json
        import os as _os

        job_env = _os.environ.get("RT_JOB_RUNTIME_ENV")
        if job_env:
            _client.default_runtime_env = _json.loads(job_env)
    _worker.set_client(_client, "driver", _node)
    atexit.register(shutdown)


def _remote_attach(address: str):
    """Attach as a remote (rt://) driver: connect to the GCS, find the head
    raylet, and build a storeless CoreClient proxying through it."""
    import asyncio as _asyncio

    from ray_tpu_torch._private.ids import JobID as _JobID
    from ray_tpu_torch._private.node import EventLoopThread
    from ray_tpu_torch._private.protocol import connect as _connect
    from ray_tpu_torch._private.worker import CoreClient

    host, port = address.rsplit(":", 1)
    io = EventLoopThread("rt-client")

    async def _find_head():
        gcs = await _connect(host, int(port))
        try:
            nodes = (await gcs.call("get_nodes", {}))["nodes"]
        finally:
            await gcs.close()
        heads = [n for n in nodes if n["state"] == "ALIVE" and n.get("is_head")]
        alive = heads or [n for n in nodes if n["state"] == "ALIVE"]
        if not alive:
            raise ConnectionError(f"no live nodes behind rt://{address}")
        return alive[0]

    try:
        head = io.run(_find_head())
        client = CoreClient(
            io.loop,
            (host, int(port)),
            (head["address"], head["port"]),
            None,  # no local store: remote mode
            head["node_id"],
            _JobID.from_random(),
            mode="driver",
        )
        client.connect()
    except BaseException:
        io.stop()  # failed attach must not leak the loop thread
        raise
    client._owns_io = io  # torn down in disconnect via shutdown()
    return client


def shutdown():
    """Tear down the cluster started by init() (reference: ray.shutdown)."""
    global _node, _client
    if _client is not None:
        try:
            _client.disconnect()
        except Exception:
            pass
        io = getattr(_client, "_owns_io", None)
        if io is not None:  # remote (rt://) driver owns its loop thread
            try:
                io.stop()
            except Exception:
                pass
        _client = None
    if _node is not None:
        try:
            _node.stop()
        except Exception:
            pass
        _node = None
    _worker.set_client(None, None)


def is_initialized() -> bool:
    return _worker.is_initialized()


def remote(*args, **options):
    """@remote decorator for functions and classes (reference:
    python/ray/remote_function.py:40, python/ray/actor.py)."""

    def decorate(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, **options)
        return RemoteFunction(obj, **options)

    if len(args) == 1 and callable(args[0]) and not options:
        return decorate(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return decorate


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
):
    """Fetch object values (reference: ray.get, _private/worker.py:2570).

    Accepts ObjectRefs and objects exposing one via `.ref` (e.g.
    serve.DeploymentResponse), matching ray.get's handling of responses.
    """
    client = _worker.get_client()
    if not isinstance(refs, ObjectRef) and hasattr(refs, "ref"):
        refs = refs.ref
    if isinstance(refs, ObjectRef):
        return client.get([refs], timeout)[0]
    return client.get(
        [r.ref if not isinstance(r, ObjectRef) and hasattr(r, "ref") else r
         for r in refs],
        timeout,
    )


def put(value: Any) -> ObjectRef:
    """Store a value in the object store (reference: ray.put,
    _private/worker.py:2688)."""
    return _worker.get_client().put(value)


def prefetch(refs: Union[ObjectRef, Sequence[ObjectRef]]) -> int:
    """Start pulling remote objects to this node without blocking.

    A later get() on the same refs joins the in-flight pull instead of
    starting its own probe, so transfer overlaps whatever the caller does
    in between. Purely advisory: failures are deferred to get(), which
    re-resolves with full reconstruction semantics. Returns the number of
    pulls started (already-local refs are skipped)."""
    if isinstance(refs, ObjectRef):
        refs = [refs]
    return _worker.get_client().prefetch(
        [r.ref if not isinstance(r, ObjectRef) and hasattr(r, "ref") else r
         for r in refs]
    )


def wait(
    refs: List[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    """Wait for refs to complete (reference: ray.wait)."""
    return _worker.get_client().wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    """Forcefully stop an actor (reference: ray.kill)."""
    actor._kill(no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    """Best-effort task cancellation (reference: ray.cancel)."""
    # Round 1: cancellation only prevents un-dispatched local work.
    if ref._future is not None:
        ref._future.cancel()


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    """Look up a named actor (reference: ray.get_actor)."""
    return _worker.get_client().get_actor_by_name(name, namespace)


def nodes() -> List[dict]:
    """Cluster node table (reference: ray.nodes)."""
    return _worker.get_client().nodes()


def cluster_resources() -> Dict[str, float]:
    return _worker.get_client().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _worker.get_client().available_resources()


def get_runtime_context():
    from ray_tpu_torch.runtime_context import get_runtime_context as _grc

    return _grc()


__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "prefetch",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "method",
    "ObjectRef",
    "ActorHandle",
    "exceptions",
    "__version__",
]
