"""DAG node types + lazy `.bind()` composition.

Analog of the reference's python/ray/dag/ (dag_node.py, input_node.py,
class_node.py, output_node.py): ``fn.bind(...)`` / ``actor.method.bind(...)``
build a lazy graph; ``dag.execute(input)`` runs it eagerly through normal
task/actor submission, and ``dag.experimental_compile()`` lowers an
actor-only DAG onto pre-allocated shared-memory channels for repeat
low-latency execution (compiled_dag_node.py:141).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

_node_ids = itertools.count()


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._id = next(_node_ids)

    # -- graph helpers ----------------------------------------------------
    def _upstream(self) -> List["DAGNode"]:
        ups = [a for a in self._bound_args if isinstance(a, DAGNode)]
        ups += [v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def _topo(self) -> List["DAGNode"]:
        seen: Dict[int, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if node._id in seen:
                return
            seen[node._id] = node
            for up in node._upstream():
                visit(up)
            order.append(node)

        visit(self)
        return order

    # -- eager execution --------------------------------------------------
    def execute(self, *input_values, timeout: Optional[float] = None):
        """Run the DAG once through normal task/actor submission."""
        import ray_tpu_torch as rt

        topo = self._topo()
        input_nodes = [n for n in topo if isinstance(n, InputNode)]
        if len(input_nodes) > 1:
            raise ValueError(
                "a DAG may use a single InputNode (reuse the same `inp` "
                "placeholder for every consumer)"
            )
        resolved: Dict[int, Any] = {}
        for node in topo:
            if isinstance(node, InputNode):
                if not input_values:
                    raise ValueError("DAG has an InputNode; pass execute(value)")
                resolved[node._id] = input_values[0]
            else:
                resolved[node._id] = node._execute_node(resolved)
        out = resolved[self._id]
        if isinstance(self, MultiOutputNode):
            return rt.get(list(out), timeout=timeout)
        return rt.get(out, timeout=timeout)

    def _execute_node(self, resolved: Dict[int, Any]):
        raise NotImplementedError

    def _resolve_args(self, resolved):
        args = [
            resolved[a._id] if isinstance(a, DAGNode) else a
            for a in self._bound_args
        ]
        kwargs = {
            k: resolved[v._id] if isinstance(v, DAGNode) else v
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    # -- compilation -------------------------------------------------------
    def experimental_compile(self, max_buf_size: int = 10_000_000):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self, max_buf_size=max_buf_size)


class InputNode(DAGNode):
    """`with InputNode() as inp:` — the DAG's runtime input placeholder."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_node(self, resolved):
        args, kwargs = self._resolve_args(resolved)
        return self._remote_fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, actor_method, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_method = actor_method

    @property
    def _actor_handle(self):
        return self._actor_method._handle

    @property
    def _method_name(self) -> str:
        return self._actor_method._name

    def _execute_node(self, resolved):
        args, kwargs = self._resolve_args(resolved)
        return self._actor_method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_node(self, resolved):
        return [resolved[o._id] for o in self._bound_args]
