"""@remote functions.

Analog of python/ray/remote_function.py (RemoteFunction at :40, _remote at
:262 which feeds worker.core_worker.submit_task) and the option plumbing in
python/ray/_private/ray_option_utils.py.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod


def _resources_from_options(opts: Dict[str, Any]) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    num_gpus = opts.get("num_gpus")
    if num_cpus is not None:
        resources["CPU"] = float(num_cpus)
    elif "CPU" not in resources:
        resources["CPU"] = 1.0
    if num_gpus is not None:
        resources["GPU"] = float(num_gpus)
    accelerator_type = opts.get("accelerator_type")
    if accelerator_type:
        resources[accelerator_type] = 0.001
    return resources


def _scheduling_from_options(opts: Dict[str, Any]):
    strategy = opts.get("scheduling_strategy")
    if strategy is None:
        return None
    if isinstance(strategy, str):
        if strategy == "SPREAD":
            return {"type": "spread"}
        if strategy == "DEFAULT":
            return None
        raise ValueError(f"unknown scheduling strategy {strategy!r}")
    return strategy.to_dict()


class RemoteFunction:
    def __init__(self, fn, **options):
        self._function = fn
        self._options = options
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs):
        client = worker_mod.get_client()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        refs = client.submit_task(
            self._function,
            args,
            kwargs,
            name=opts.get("name") or self._function.__qualname__,
            num_returns=num_returns,
            resources=_resources_from_options(opts),
            scheduling=_scheduling_from_options(opts),
            max_retries=opts.get("max_retries"),
            runtime_env=opts.get("runtime_env"),
            max_calls=opts.get("max_calls"),
            priority=int(opts.get("priority") or 0),
        )
        return refs[0] if num_returns in (1, "dynamic") else refs

    def options(self, **new_options):
        merged = {**self._options, **new_options}
        return RemoteFunction(self._function, **merged)

    def bind(self, *args, **kwargs):
        """Lazy DAG composition (reference: dag/function_node.py)."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._function.__name__!r} cannot be called "
            f"directly; use .remote(...)"
        )
