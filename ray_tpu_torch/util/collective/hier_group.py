"""Hierarchical collectives: the local group over this process's devices,
the DCN ring across processes (the port of
ray_tpu/util/collective/hier_group.py).

A multi-host topology has two bandwidth tiers: the cards of one host
(fast; NCCL over NVLink in local_group.py) and DCN between hosts (orders
of magnitude slower). A flat cross-host ring would push every device's
data over DCN; the hierarchical schedule reduces locally first and SHARDS
the cross-tier exchange:

    allreduce = local reduce-scatter          # n_local shards of local sum
              -> DCN exchange, ONE shard per lane  (1/n_local the bytes
                 a flat all-devices DCN ring would push per process)
              -> local allgather of the reduced shards

The two-tier schedule (local sum -> full-array DCN ring -> broadcast)
remains available as the "ring" algorithm; "rd" runs the full local sum
through the latency-optimal recursive-doubling exchange instead (small
messages). The choice comes from the alpha-beta cost model in
topology.py per (collective, topology, nbytes), overridable with
RT_COLLECTIVE_ALGO, and is recorded in `last_op_info`.

Quantization (quant="int8"/"fp8") applies to the DCN tier only — the
local tier stays full-precision, exactly the EQuARX placement: compress
where the wire is slow, never where it is free.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ray_tpu_torch.util.collective._tensors import as_torch, dtype_name
from ray_tpu_torch.util.collective.dcn_group import DcnGroup
from ray_tpu_torch.util.collective.local_group import LocalGroup
from ray_tpu_torch.util.collective.topology import (
    ALGO_HIER,
    ALGO_RD,
    ALGO_RING,
    Topology,
)
from ray_tpu_torch.util.collective.types import ReduceOp


def _replicate(t: torch.Tensor, like: List) -> List:
    """One copy of `t` per local device, each in the kind and on the
    device of the matching entry of `like`."""
    return [as_torch(x)[1](t.clone()) for x in like]


class HierarchicalGroup:
    """Two-tier collective group.

    `world_size`/`rank` count PROCESSES (hosts); each process contributes
    one tensor per local device, like LocalGroup.
    """

    def __init__(self, client, world_size: int, rank: int, group_name: str,
                 num_local_devices=None, epoch: int = 0,
                 op_timeout_s=None):
        self.local = LocalGroup(num_local_devices)
        self.dcn = DcnGroup(client, world_size, rank, group_name + "::dcn",
                            epoch=epoch, op_timeout=op_timeout_s)
        self.world_size = world_size
        self.rank = rank
        # Two-tier topology: DCN width = processes, local width = the
        # devices this process actually drives.
        self.topo = Topology.detect(world_size, n_local=self.local.world_size)
        self.last_op_info: dict = {}

    @property
    def total_ranks(self) -> int:
        return self.world_size * self.local.world_size

    def _record_op(self, op_name: str, algo: str, dcn_bytes0: int,
                   dtype, quant: Optional[str] = None) -> None:
        self.last_op_info = {
            "op": op_name,
            "algo": algo,
            "tier": "local+dcn",
            "bytes": self.dcn.bytes_sent - dcn_bytes0,  # slow-tier bytes
            "dtype": dtype_name(dtype),
            "quant": quant,
        }

    def allreduce(self, tensors: List, op: ReduceOp = ReduceOp.SUM,
                  quant: Optional[str] = None,
                  error_feedback: bool = False,
                  algo: Optional[str] = None) -> List:
        """tensors: one per local device. Returns the GLOBAL reduction
        (across every device of every process), one copy per local
        device. quant/error_feedback apply to the DCN tier only."""
        t0, _ = as_torch(tensors[0])
        dcn_bytes0 = self.dcn.bytes_sent
        if algo is None:
            algo = self.topo.select("allreduce",
                                    t0.numel() * t0.element_size())
        if algo == ALGO_HIER and self.local.world_size == 1:
            algo = ALGO_RING  # nothing to shard over
        if self.world_size == 1:
            out = self.local.allreduce(tensors, op)
            self._record_op("allreduce", algo, dcn_bytes0, t0.dtype, quant)
            return out

        if algo == ALGO_HIER:
            # Local tier: reduce-scatter — device d ends with shard d of
            # the local sum (flat, 1/n_local of the elements).
            shards = self.local.reducescatter(tensors, op)
            # DCN tier: each shard crosses as its own lane (per-card NICs
            # in hardware; sequential over one socket here), so a lane's
            # wire cost is 1/n_local of the full-array exchange.
            reduced = [
                as_torch(self.dcn.allreduce(
                    shard, op, quant=quant, error_feedback=error_feedback,
                    algo=ALGO_RING,
                    ef_key=("hier_lane", lane, as_torch(shard)[0].numel()),
                ))[0]
                for lane, shard in enumerate(shards)
            ]
            # Local tier: allgather of the reduced shards.
            full = torch.cat([s.reshape(-1).to(t0.device) for s in reduced])
            full = full.reshape(t0.shape).to(t0.dtype)
            self._record_op("allreduce", ALGO_HIER, dcn_bytes0,
                            t0.dtype, quant)
            return _replicate(full, tensors)

        # Two-tier schedules: full local reduction, then the whole array
        # crosses DCN once per process (ring or recursive doubling), then
        # local broadcast by replication.
        local = self.local.allreduce(tensors, op)
        dcn_algo = ALGO_RD if algo == ALGO_RD else ALGO_RING
        global_val, _ = as_torch(self.dcn.allreduce(
            local[0], op, quant=quant, error_feedback=error_feedback,
            algo=dcn_algo,
        ))
        self._record_op("allreduce", dcn_algo, dcn_bytes0, t0.dtype, quant)
        return _replicate(global_val, tensors)

    def broadcast(self, tensors: List, root_process: int = 0,
                  root_local: int = 0) -> List:
        dcn_bytes0 = self.dcn.bytes_sent
        local = self.local.broadcast(tensors, root_local)
        src, _ = as_torch(tensors[root_local])
        if self.world_size == 1:
            self._record_op("broadcast", ALGO_RING, dcn_bytes0, src.dtype)
            return local
        global_val, _ = as_torch(self.dcn.broadcast(local[0], root_process))
        self._record_op("broadcast", ALGO_RING, dcn_bytes0, global_val.dtype)
        return _replicate(global_val, tensors)

    def allgather(self, tensors: List) -> List[List]:
        """Returns, per local device, the list of every device's tensor
        across all processes (process-major, local-device-minor order)."""
        dcn_bytes0 = self.dcn.bytes_sent
        local_lists = self.local.allgather(tensors)  # all local tensors
        t0, _ = as_torch(tensors[0])
        if self.world_size == 1:
            self._record_op("allgather", ALGO_RING, dcn_bytes0, t0.dtype)
            return local_lists
        n_local = len(local_lists[0])
        stacked = torch.stack([as_torch(t)[0].to(t0.device)
                               for t in local_lists[0]])
        gathered = self.dcn.allgather(stacked)  # [world][n_local, ...]
        flat = [g[i] for g in gathered for i in range(n_local)]
        self._record_op("allgather", ALGO_RING, dcn_bytes0, stacked.dtype)
        return [[as_torch(x)[1](f.clone()) for f in flat] for x in tensors]

    def reducescatter(self, tensors: List,
                      op: ReduceOp = ReduceOp.SUM) -> List:
        """Global reduce, then each local device takes its slice of the
        process's shard (total_ranks-way split)."""
        dcn_bytes0 = self.dcn.bytes_sent
        reduced = self.allreduce(tensors, op)
        algo = self.last_op_info.get("algo", ALGO_RING)
        outs = []
        n_local = self.local.world_size
        for i in range(n_local):
            r, back = as_torch(reduced[i])
            chunks = torch.tensor_split(r.reshape(-1), self.total_ranks)
            outs.append(back(chunks[self.rank * n_local + i].clone()))
        self._record_op("reducescatter", algo, dcn_bytes0,
                        as_torch(tensors[0])[0].dtype)
        return outs

    def barrier(self):
        dcn_bytes0 = self.dcn.bytes_sent
        self.local.barrier()
        if self.world_size > 1:
            self.dcn.barrier()
        self._record_op("barrier", self.dcn.last_op_info.get("algo", ALGO_RING)
                        if self.world_size > 1 else ALGO_RING,
                        dcn_bytes0, torch.int32)

    def destroy(self):
        self.local.destroy()
        if self.world_size > 1:
            self.dcn.destroy()
