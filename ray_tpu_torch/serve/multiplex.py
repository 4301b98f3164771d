"""Model multiplexing: many models per deployment, LRU-loaded per replica.

Analog of the reference's @serve.multiplexed + get_multiplexed_model_id
(python/ray/serve/multiplex.py): the client tags a request with a model id
(handle.options(multiplexed_model_id=...)), the router prefers replicas
that already have that model resident, and the replica's loader caches up
to max_num_models_per_replica models, evicting least-recently-used.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional

# Per-request context (set by the replica around user-code invocation).
_request_ctx = threading.local()


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id this request was tagged with."""
    return getattr(_request_ctx, "model_id", "")


def _set_request_model_id(model_id: str):
    _request_ctx.model_id = model_id or ""


class _MultiplexWrapper:
    """Descriptor wrapping the user's model-loader method."""

    def __init__(self, fn: Callable, max_num_models_per_replica: int):
        self._fn = fn
        self.max_models = max_num_models_per_replica
        self.__name__ = getattr(fn, "__name__", "multiplexed")

    def _state_for(self, instance):
        key = f"__serve_multiplex_{self.__name__}"
        st = instance.__dict__.get(key)
        if st is None:
            st = {"models": OrderedDict(), "lock": threading.Lock()}
            instance.__dict__[key] = st
        return st

    def __get__(self, instance, owner=None):
        if instance is None:
            return self

        def load(model_id: str):
            st = self._state_for(instance)
            with st["lock"]:
                if model_id in st["models"]:
                    st["models"].move_to_end(model_id)
                    return st["models"][model_id]
            # Load outside the lock (loads can be slow: HBM transfers).
            model = self._fn(instance, model_id)
            with st["lock"]:
                st["models"][model_id] = model
                st["models"].move_to_end(model_id)
                while len(st["models"]) > self.max_models:
                    _mid, evicted = st["models"].popitem(last=False)
                    # Give the model a chance to release device memory.
                    del evicted
            return model

        load.__name__ = self.__name__
        return load


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator for the per-replica model loader:

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str): ...

    Called with a model id, returns the (cached) model.
    """

    def deco(fn):
        return _MultiplexWrapper(fn, max_num_models_per_replica)

    if _fn is not None:
        return deco(_fn)
    return deco
