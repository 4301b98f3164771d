"""Collective types (the port of ray_tpu/util/collective/types.py).

The backends:

  * "xla": collectives over the devices attached to this process, one
    tensor per device. In the port this is `local_group.LocalGroup`:
    NCCL over the visible cards inside one process, plain torch on a
    list of CPU tensors. The name stays "xla" so callers written against
    the JAX package's API run unchanged.
  * "dcn": eager cross-process collectives over TCP rings, rendezvous
    through the GCS KV (dcn_group.py).
  * "hier": the two tiers composed: the local group inside each process,
    then the DCN ring across processes with one crossing per process
    (hier_group.py).
"""

from __future__ import annotations

from enum import Enum


class Backend(str, Enum):
    XLA = "xla"
    DCN = "dcn"
    HIER = "hier"

    @classmethod
    def validate(cls, value: str) -> "Backend":
        try:
            return cls(value)
        except ValueError:
            raise ValueError(
                f"unknown collective backend {value!r}; valid: "
                f"{[b.value for b in cls]}"
            ) from None


class ReduceOp(str, Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
