"""Durable workflows: DAG execution with storage-backed step checkpoints
(the port of ray_tpu/workflow).

Analog of the reference's ``ray.workflow`` (workflow/api.py:123 run,
workflow_executor.py, workflow_state_from_dag.py): a task DAG executes
step by step, each step's result is checkpointed to durable storage, and
``resume()`` re-runs a failed/interrupted workflow skipping every step
whose checkpoint exists.

Storage layout (one directory per workflow under the storage root):
    <root>/<workflow_id>/status.json
    <root>/<workflow_id>/input.pkl
    <root>/<workflow_id>/steps/<step_key>.pkl

Step keys are stable across runs: the function's qualname plus its
position in the deterministic topological order. The layout, the JSON
status and the pickled step, input, event and output values are the JAX
package's, so either package reads the other's status and results;
`dag.pkl` holds the package's own DAG nodes, so a workflow resumes under
the package that ran it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.dag_node import DAGNode, FunctionNode, InputNode

_DEFAULT_ROOT = os.path.join(
    os.path.expanduser("~"), ".ray_tpu_torch", "workflows"
)


def _root(storage: Optional[str]) -> str:
    return storage or os.environ.get("RT_WORKFLOW_STORAGE") or _DEFAULT_ROOT


def _wf_dir(workflow_id: str, storage: Optional[str]) -> str:
    return os.path.join(_root(storage), workflow_id)


def _step_key(node: DAGNode, index: int) -> str:
    if isinstance(node, FunctionNode):
        name = getattr(node._remote_fn, "__qualname__", "fn")
    elif isinstance(node, EventNode):
        name = f"event-{node.event_name}"
    else:
        name = type(node).__name__
    return f"{index:04d}-{name.replace('/', '_').replace('<', '').replace('>', '')}"


def _checkpoint(path: str, value: Any):
    """Durably persist a step/event result: write-then-rename, so the
    checkpoint is either complete or absent."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(value, f, protocol=5)
    os.replace(tmp, path)


def _write_status(d: str, **fields):
    path = os.path.join(d, "status.json")
    status = {}
    if os.path.exists(path):
        with open(path) as f:
            status = json.load(f)
    status.update(fields)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(status, f)
    os.replace(tmp, path)


def _read_status(d: str) -> Optional[dict]:
    try:
        with open(os.path.join(d, "status.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class EventNode(DAGNode):
    """A workflow step that resolves when an external signal arrives.

    Reference analog: workflow events (workflow.wait_for_event): the node
    blocks the workflow until `workflow.signal(workflow_id, name, ...)`
    delivers a payload; the payload checkpoints like any step, so a
    resumed workflow does not wait again for an event it already received.
    """

    def __init__(self, name: str, timeout_s: Optional[float] = None,
                 poll_s: float = 0.2):
        super().__init__((), {})
        self.event_name = name
        self.timeout_s = timeout_s
        self.poll_s = poll_s

    def _execute_node(self, resolved):
        raise WorkflowError(
            f"workflow.event({self.event_name!r}) only resolves under "
            "workflow.run(...), which provides the durable signal store"
        )


def event(name: str, timeout_s: Optional[float] = None) -> EventNode:
    """Declare an event dependency in a workflow DAG."""
    return EventNode(name, timeout_s=timeout_s)


def signal(workflow_id: str, name: str, payload: Any = None,
           storage: Optional[str] = None):
    """Deliver an event payload to a (possibly waiting) workflow. Durable:
    signaling before the workflow reaches the event is fine."""
    import tempfile

    d = os.path.join(_wf_dir(workflow_id, storage), "events")
    os.makedirs(d, exist_ok=True)
    # Unique tmp per signaler: concurrent signals must never interleave
    # writes into one tmp inode before the atomic rename.
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        pickle.dump(payload, f, protocol=5)
    os.replace(tmp, os.path.join(d, name + ".pkl"))


class WorkflowError(Exception):
    pass


def _execute(dag: DAGNode, wf_dir: str, input_value, max_step_retries: int):
    import ray_tpu_torch as rt

    steps_dir = os.path.join(wf_dir, "steps")
    os.makedirs(steps_dir, exist_ok=True)
    topo = dag._topo()
    resolved: Dict[int, Any] = {}
    for index, node in enumerate(topo):
        if isinstance(node, InputNode):
            resolved[node._id] = input_value
            continue
        if isinstance(node, EventNode):
            key = _step_key(node, index)
            ckpt = os.path.join(steps_dir, key + ".pkl")
            if os.path.exists(ckpt):
                with open(ckpt, "rb") as f:
                    resolved[node._id] = pickle.load(f)
                continue
            ev_path = os.path.join(wf_dir, "events", node.event_name + ".pkl")
            _write_status(wf_dir, state="WAITING", waiting_on=node.event_name)
            deadline = (
                None if node.timeout_s is None
                else time.monotonic() + node.timeout_s
            )
            while not os.path.exists(ev_path):
                if deadline is not None and time.monotonic() > deadline:
                    raise WorkflowError(
                        f"timed out waiting for event {node.event_name!r}"
                    )
                time.sleep(node.poll_s)
            with open(ev_path, "rb") as f:
                payload = pickle.load(f)
            _checkpoint(ckpt, payload)
            _write_status(wf_dir, state="RUNNING", last_step=key,
                          waiting_on=None, updated_at=time.time())
            resolved[node._id] = payload
            continue
        if not isinstance(node, FunctionNode):
            raise WorkflowError(
                "workflows support task (function) DAGs; actor nodes hold "
                "process state that cannot be checkpoint-resumed"
            )
        key = _step_key(node, index)
        ckpt = os.path.join(steps_dir, key + ".pkl")
        if os.path.exists(ckpt):
            with open(ckpt, "rb") as f:
                resolved[node._id] = pickle.load(f)
            continue
        args, kwargs = node._resolve_args(resolved)
        last_exc = None
        for _ in range(max_step_retries + 1):
            try:
                value = rt.get(node._remote_fn.remote(*args, **kwargs))
                break
            except Exception as e:  # noqa: BLE001
                last_exc = e
        else:
            raise WorkflowError(f"step {key} failed: {last_exc}") from last_exc
        _checkpoint(ckpt, value)  # atomic: a step is durable or absent
        _write_status(wf_dir, last_step=key, updated_at=time.time())
        resolved[node._id] = value
    return resolved[dag._id]


def run(
    dag: DAGNode,
    *args,
    workflow_id: Optional[str] = None,
    storage: Optional[str] = None,
    max_step_retries: int = 3,
):
    """Execute a DAG durably; returns the final result.

    Reference: workflow.run (workflow/api.py:123).
    """
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    wf_dir = _wf_dir(workflow_id, storage)
    os.makedirs(wf_dir, exist_ok=True)
    input_value = args[0] if args else None
    _write_status(wf_dir, workflow_id=workflow_id, state="RUNNING",
                  created_at=time.time())
    # Everything after the RUNNING mark reports failures durably —
    # run_async callers would otherwise time out with no recorded error
    # when e.g. the DAG is not serializable.
    try:
        _checkpoint(os.path.join(wf_dir, "input.pkl"), input_value)
        with open(os.path.join(wf_dir, "dag.pkl"), "wb") as f:
            from ray_tpu_torch._vendor import cloudpickle

            cloudpickle.dump(dag, f)
        result = _execute(dag, wf_dir, input_value, max_step_retries)
    except BaseException as e:
        _write_status(wf_dir, state="FAILED", error=str(e))
        raise
    return _commit_output(wf_dir, result)


def resume(workflow_id: str, storage: Optional[str] = None,
           max_step_retries: int = 3):
    """Re-run a workflow, skipping checkpointed steps
    (workflow.resume in the reference)."""
    wf_dir = _wf_dir(workflow_id, storage)
    status = _read_status(wf_dir)
    if status is None:
        raise WorkflowError(f"no such workflow: {workflow_id}")
    if status.get("state") == "SUCCEEDED":
        with open(os.path.join(wf_dir, "output.pkl"), "rb") as f:
            return pickle.load(f)
    from ray_tpu_torch._vendor import cloudpickle

    with open(os.path.join(wf_dir, "dag.pkl"), "rb") as f:
        dag = cloudpickle.load(f)
    with open(os.path.join(wf_dir, "input.pkl"), "rb") as f:
        input_value = pickle.load(f)
    _write_status(wf_dir, state="RUNNING")
    try:
        result = _execute(dag, wf_dir, input_value, max_step_retries)
    except BaseException as e:
        _write_status(wf_dir, state="FAILED", error=str(e))
        raise
    return _commit_output(wf_dir, result)


def _commit_output(wf_dir: str, result):
    """Durably commit a finished workflow: atomic output write, THEN the
    SUCCEEDED status — readers key off the status, so they can never see
    a partial output or a success without one."""
    _checkpoint(os.path.join(wf_dir, "output.pkl"), result)
    _write_status(wf_dir, state="SUCCEEDED", finished_at=time.time())
    return result


def run_async(
    dag: DAGNode,
    *args,
    workflow_id: Optional[str] = None,
    storage: Optional[str] = None,
    max_step_retries: int = 3,
) -> str:
    """Start a workflow without blocking; returns its id immediately
    (reference: workflow.run_async, workflow/api.py). Follow with
    get_output(workflow_id, wait=...) or signal()/get_status()."""
    import threading

    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"
    t = threading.Thread(
        target=run,
        args=(dag, *args),
        kwargs={
            "workflow_id": workflow_id,
            "storage": storage,
            "max_step_retries": max_step_retries,
        },
        daemon=True,
    )
    t.start()
    return workflow_id


def get_status(workflow_id: str, storage: Optional[str] = None) -> Optional[str]:
    status = _read_status(_wf_dir(workflow_id, storage))
    return status.get("state") if status else None


def get_output(workflow_id: str, storage: Optional[str] = None,
               wait: float = 0.0):
    """The workflow's result. With wait > 0, blocks up to that many
    seconds for an in-flight run (run_async) to finish; FAILED surfaces
    as WorkflowError with the recorded error.

    Keys off the status, not the output file: SUCCEEDED is written after
    the atomic output commit, so a SUCCEEDED status guarantees a complete
    output.pkl."""
    wf_dir = _wf_dir(workflow_id, storage)
    deadline = time.monotonic() + wait
    while True:
        status = _read_status(wf_dir) or {}
        state = status.get("state")
        if state == "SUCCEEDED":
            with open(os.path.join(wf_dir, "output.pkl"), "rb") as f:
                return pickle.load(f)
        if state == "FAILED":
            raise WorkflowError(
                f"workflow {workflow_id} failed: {status.get('error')}"
            )
        if time.monotonic() >= deadline:
            raise WorkflowError(f"workflow {workflow_id} has no output yet")
        time.sleep(0.05)


def list_all(storage: Optional[str] = None) -> List[dict]:
    root = _root(storage)
    out = []
    if not os.path.isdir(root):
        return out
    for wid in sorted(os.listdir(root)):
        status = _read_status(os.path.join(root, wid))
        if status:
            out.append(status)
    return out


def delete(workflow_id: str, storage: Optional[str] = None):
    shutil.rmtree(_wf_dir(workflow_id, storage), ignore_errors=True)


from ray_tpu_torch.workflow.virtual_actor import (  # noqa: E402 — needs _root
    VirtualActorClass,
    VirtualActorHandle,
    readonly,
    virtual_actor,
)
