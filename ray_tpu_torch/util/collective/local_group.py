"""Eager collectives over the devices attached to this process (the port of
ray_tpu/util/collective/xla_group.py).

On a TPU host one process owns all local chips and the JAX package runs
small jitted programs over them. On a GPU host the counterpart is NCCL
over the cards this process sees: one tensor per card, reduced card to
card (`torch.cuda.nccl` over the card list), never through the host. A
list of CPU tensors, which the tests ask for explicitly, is reduced with
plain torch in device order.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ray_tpu_torch.util.collective._tensors import as_torch, dtype_name
from ray_tpu_torch.util.collective.types import ReduceOp

# NCCL's ncclRedOp_t values, as torch.cuda.nccl takes them.
_NCCL_OPS = {ReduceOp.SUM: 0, ReduceOp.PRODUCT: 1, ReduceOp.MAX: 2,
             ReduceOp.MIN: 3}


def _fold(op: ReduceOp, tensors: List[torch.Tensor]) -> torch.Tensor:
    out = tensors[0].clone()
    for t in tensors[1:]:
        if op == ReduceOp.SUM:
            out.add_(t)
        elif op == ReduceOp.PRODUCT:
            out.mul_(t)
        elif op == ReduceOp.MIN:
            torch.minimum(out, t, out=out)
        elif op == ReduceOp.MAX:
            torch.maximum(out, t, out=out)
        else:
            raise ValueError(op)
    return out


class LocalGroup:
    """Collectives across this process's local devices.

    The "ranks" of this group are local devices, not processes: values are
    lists with one tensor per device (the reference's multi-GPU entry
    points, e.g. allreduce_multigpu). `device` is "cuda" (every visible
    card, or the first `num_devices`) or "cpu" (`num_devices` CPU
    tensors); by default the cards where CUDA has any, else the CPU.
    """

    def __init__(self, num_devices: Optional[int] = None,
                 device: Optional[str] = None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        if device == "cuda":
            n = torch.cuda.device_count()
            if num_devices is not None:
                n = min(n, num_devices)
            self.devices = [torch.device("cuda", i) for i in range(n)]
        elif device == "cpu":
            self.devices = [torch.device("cpu")] * (num_devices or 1)
        else:
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.world_size = len(self.devices)
        # Same shape DcnGroup records, so the collective metrics/observer
        # stream covers both tiers. "bytes" is the LOGICAL per-device
        # message size — the local link's wire bytes are NCCL's business.
        self.last_op_info: dict = {}

    def _record_op(self, op_name: str, dtype, nbytes: int,
                   algo: str) -> None:
        self.last_op_info = {
            "op": op_name,
            "algo": algo,
            "tier": "local",
            "bytes": int(nbytes),
            "dtype": dtype_name(dtype),
            "quant": None,
        }

    def _inputs(self, tensors: List):
        """(tensors, backs, on_cards): one tensor per device, each where
        its caller holds it, and per device the function that returns a
        result in its caller's kind on that device. Card tensors must sit
        one per card, in card order; CPU tensors are reduced on the CPU;
        a mix is refused."""
        if len(tensors) != self.world_size:
            raise ValueError(
                f"need one tensor per device ({self.world_size}), got "
                f"{len(tensors)}")
        pairs = [as_torch(t) for t in tensors]
        ts = [t for t, _ in pairs]
        kinds = {t.device.type for t in ts}
        if len(kinds) != 1:
            raise ValueError("the local group takes all card tensors or all "
                             f"CPU tensors, got {sorted(kinds)}")
        on_cards = kinds == {"cuda"}
        if on_cards and [t.device for t in ts] != self.devices:
            raise ValueError(
                f"card tensors must lie one per card in order "
                f"{[str(d) for d in self.devices]}, got "
                f"{[str(t.device) for t in ts]}")
        return ts, [b for _, b in pairs], on_cards

    def allreduce(self, tensors: List, op: ReduceOp = ReduceOp.SUM) -> List:
        ts, backs, on_cards = self._inputs(tensors)
        if on_cards:
            from torch.cuda import nccl

            outs = [t.clone() for t in ts]
            nccl.all_reduce(outs, op=_NCCL_OPS[ReduceOp(op)])
        else:
            reduced = _fold(ReduceOp(op), ts)
            outs = [reduced.clone() for _ in ts]
        self._record_op("allreduce", ts[0].dtype,
                        ts[0].numel() * ts[0].element_size(),
                        "nccl" if on_cards else "host")
        return [b(o) for b, o in zip(backs, outs)]

    def allgather(self, tensors: List) -> List[List]:
        ts, backs, on_cards = self._inputs(tensors)
        n = self.world_size
        if on_cards:
            from torch.cuda import nccl

            flat = [t.reshape(-1) for t in ts]
            outs = [torch.empty(n * flat[0].numel(), dtype=t.dtype,
                                device=t.device) for t in ts]
            nccl.all_gather(flat, outs)
            lists = [[back(c.reshape(ts[0].shape)) for c in o.chunk(n)]
                     for back, o in zip(backs, outs)]
        else:
            lists = [[back(t.clone()) for t in ts] for back in backs]
        self._record_op("allgather", ts[0].dtype,
                        ts[0].numel() * ts[0].element_size(),
                        "nccl" if on_cards else "host")
        return lists

    def reducescatter(self, tensors: List,
                      op: ReduceOp = ReduceOp.SUM) -> List:
        ts, backs, _ = self._inputs(tensors)
        reduced = self.allreduce(ts, op)
        algo = self.last_op_info["algo"]
        outs = [backs[i](torch.tensor_split(reduced[i].reshape(-1),
                                            self.world_size)[i].clone())
                for i in range(self.world_size)]
        self._record_op("reducescatter", ts[0].dtype,
                        ts[0].numel() * ts[0].element_size(), algo)
        return outs

    def broadcast(self, tensors: List, root_rank: int = 0) -> List:
        ts, backs, on_cards = self._inputs(tensors)
        src = ts[root_rank]
        if on_cards:
            from torch.cuda import nccl

            outs = [src.clone() if i == root_rank else
                    torch.empty_like(src, device=d)
                    for i, d in enumerate(self.devices)]
            nccl.broadcast(outs, root=root_rank)
        else:
            outs = [src.clone() for _ in ts]
        self._record_op("broadcast", src.dtype,
                        src.numel() * src.element_size(),
                        "nccl" if on_cards else "host")
        return [b(o) for b, o in zip(backs, outs)]

    def barrier(self):
        on_cards = self.devices[0].type == "cuda"
        self.allreduce([torch.zeros(1, device=d) for d in self.devices])
        self._record_op("barrier", torch.float32, 0,
                        "nccl" if on_cards else "host")

    def destroy(self):
        pass
