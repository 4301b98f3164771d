"""Compiled DAG execution over shared-memory channels.

Analog of the reference's ``CompiledDAG`` (dag/compiled_dag_node.py:141):
an actor-only DAG is lowered once — every edge gets a pre-allocated
mutable shared-memory channel (experimental/channel.py) and every
participating actor starts a resident exec loop (do_exec_compiled_task
:34) that reads its input channels, runs the bound method, and writes its
output channels. ``execute()`` then costs one channel write + one channel
read on the driver: no scheduler, no GCS, no per-call RPC.

Restrictions (as in the reference's aDAG): all compute nodes must be actor
method calls; actors must be co-located with the driver's host (channels
are same-host shared memory).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.experimental.channel import Channel


class CompiledDAG:
    def __init__(self, root: DAGNode, max_buf_size: int = 10_000_000):
        self._root = root
        self._max_buf_size = max_buf_size
        self._channels: List[Channel] = []
        self._input_channels: List[Channel] = []
        self._output_channels: List[Channel] = []
        self._actor_loops: List[tuple] = []  # (actor_id, loop_id)
        self._torn_down = False
        self._desynced = False
        self._compile()

    # -- lowering ---------------------------------------------------------
    def _new_channel(self) -> Channel:
        ch = Channel(create=True, max_size=self._max_buf_size)
        self._channels.append(ch)
        return ch

    def _compile(self):
        topo = self._root._topo()
        outputs = (
            list(self._root._bound_args)
            if isinstance(self._root, MultiOutputNode)
            else [self._root]
        )
        compute_nodes = [
            n for n in topo if not isinstance(n, (InputNode, MultiOutputNode))
        ]
        for n in compute_nodes:
            if not isinstance(n, ClassMethodNode):
                raise ValueError(
                    "experimental_compile supports actor-method DAGs only "
                    "(plain task nodes execute eagerly via .execute())"
                )

        # Count consumers per producing node: k consumers => k channels
        # (channels are strictly SPSC).
        consumers: Dict[int, int] = {}
        for n in compute_nodes:
            for up in n._upstream():
                consumers[up._id] = consumers.get(up._id, 0) + 1
        for out in outputs:
            consumers[out._id] = consumers.get(out._id, 0) + 1

        produced: Dict[int, List[Channel]] = {}  # node id -> its channels
        taken: Dict[int, int] = {}  # node id -> channels handed out

        def channels_for(node: DAGNode) -> List[Channel]:
            if node._id not in produced:
                produced[node._id] = [
                    self._new_channel() for _ in range(consumers.get(node._id, 0))
                ]
            return produced[node._id]

        def take_channel(node: DAGNode) -> Channel:
            chans = channels_for(node)
            idx = taken.get(node._id, 0)
            taken[node._id] = idx + 1
            return chans[idx]

        # Per-actor stage lists in topo order.
        stages_by_actor: Dict[bytes, List[dict]] = {}
        for n in compute_nodes:
            arg_spec = []
            for a in n._bound_args:
                if isinstance(a, DAGNode):
                    arg_spec.append({"kind": "chan", "name": take_channel(a).name})
                else:
                    arg_spec.append({"kind": "const", "value": pickle.dumps(a)})
            kwarg_spec = {}
            for k, v in n._bound_kwargs.items():
                if isinstance(v, DAGNode):
                    kwarg_spec[k] = {"kind": "chan", "name": take_channel(v).name}
                else:
                    kwarg_spec[k] = {"kind": "const", "value": pickle.dumps(v)}
            out_chans = [c.name for c in channels_for(n)]
            actor_id = n._actor_handle._actor_id
            stages_by_actor.setdefault(actor_id, []).append(
                {
                    "method": n._method_name,
                    "args": arg_spec,
                    "kwargs": kwarg_spec,
                    "out_channels": out_chans,
                }
            )

        # Driver endpoints.
        for n in topo:
            if isinstance(n, InputNode):
                self._input_channels = channels_for(n)
        self._output_channels = [take_channel(o) for o in outputs]
        self._multi_output = isinstance(self._root, MultiOutputNode)

        # Start resident loops.
        client = worker_mod.get_client()
        for actor_id, stages in stages_by_actor.items():
            aid = actor_id.binary() if hasattr(actor_id, "binary") else actor_id
            r = client.actor_raw_call(
                actor_id, "dag_start",
                {"actor_id": aid, "stages": stages},
            )
            if not r.get("ok"):
                self.teardown()
                raise RuntimeError(
                    f"compiled-DAG loop failed to start: {r.get('error')}"
                )
            self._actor_loops.append((actor_id, r.get("loop_id")))

    # -- execution --------------------------------------------------------
    def execute(self, *input_values, timeout: float = 30.0):
        """One pipelined pass: returns the output value(s) directly."""
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        if self._desynced:
            raise RuntimeError(
                "compiled DAG is desynchronized after a timed-out execute "
                "(an input is still in flight); teardown() and recompile"
            )
        if self._input_channels:
            if not input_values:
                raise ValueError("DAG has an InputNode; pass execute(value)")
            for ch in self._input_channels:
                ch.write(input_values[0], timeout=timeout)
        try:
            outs = [ch.read(timeout=timeout) for ch in self._output_channels]
        except TimeoutError:
            # The input was already written: a late result would pair with
            # the NEXT execute's read, silently skewing every later call.
            self._desynced = True
            raise
        for o in outs:
            if isinstance(o, _StageError):
                raise o.rebuild()
        return outs if self._multi_output else outs[0]

    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        client = worker_mod.get_client_or_none()
        for ch in self._channels:
            ch.close()
        if client is not None:
            for actor_id, loop_id in self._actor_loops:
                try:
                    client.actor_raw_call(
                        actor_id, "dag_stop", {"loop_id": loop_id}
                    )
                except Exception:
                    pass
        for ch in self._channels:
            ch.destroy()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


class _StageError:
    """Error marker shipped through channels by a failing stage."""

    def __init__(self, exc: BaseException):
        import traceback

        self.type_name = type(exc).__name__
        self.message = str(exc)
        self.traceback_str = traceback.format_exc()

    def rebuild(self) -> Exception:
        from ray_tpu_torch.exceptions import TaskError

        return TaskError(self.type_name, self.traceback_str or self.message)
