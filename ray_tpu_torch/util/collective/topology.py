"""Topology model + alpha-beta cost model for collective algorithm
selection (the port of ray_tpu/util/collective/topology.py).

The gang's interconnect has two bandwidth tiers (SURVEY.md, PAPERS.md
"The Big Send-off"): the local tier between the cards one process owns
(fast; NVLink on a GPU host, reached through NCCL in local_group.py) and
DCN between processes/hosts (orders of magnitude slower, reached through
the eager TCP rings in dcn_group.py). The tiers keep the JAX package's
names, "ici" and "dcn", so the model and its env overrides read the
same. A collective's best schedule depends on where its bytes
would land on that topology and how big the message is — TACCL
(arXiv:2111.04867) phrases this as a communication sketch; here the
sketch is fixed (ring / recursive doubling / sharded two-tier) and an
alpha-beta cost model picks among them per (collective, topology,
nbytes) at call time:

  * ring            — bandwidth-optimal, 2(n-1) latency terms; wins for
                      large messages on a flat topology.
  * recursive       — latency-optimal, ceil(log2 n) rounds each moving
    doubling          the full message; wins below the alpha/beta
                      crossover (small control-plane tensors, scalars).
  * sharded hier    — local reduce-scatter, DCN exchange of one
                      local shard per lane, local allgather; wins for large
                      messages whenever the topology HAS a local tier
                      (cuts DCN bytes per process to 1/n_local of the
                      flat all-devices ring — see hier_group.py).

`RT_COLLECTIVE_ALGO` (ring|rd|hier|auto) overrides the model for every
op, so a bad model decision can be steered around in production without
a code change; the chosen algorithm is recorded per op either way
(collective.last_op_info / the flight-recorder observer stream).

Link constants default to the JAX package's published TPU-pod ballparks
and are env-overridable (RT_COLLECTIVE_{ICI,DCN}_{ALPHA_S,GBPS}) — the
model only has to rank algorithms, not predict wall clock. They are kept
as they are so that `select()` gives the JAX package's table; the card's
own loopback figures are measured by chip_smoke.py and recorded in
PERF.md, not written here.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

# Modeled algorithms (string enum kept loose: these travel through op
# observers, metrics tags, and the RT_COLLECTIVE_ALGO env override).
ALGO_RING = "ring"
ALGO_RD = "rd"            # recursive doubling (latency-optimal)
ALGO_HIER = "hier"        # sharded two-tier (local reduce-scatter / DCN / local)
ALGO_AUTO = "auto"
_VALID_ALGOS = (ALGO_RING, ALGO_RD, ALGO_HIER)

_ALGO_ENV = "RT_COLLECTIVE_ALGO"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return default


@dataclass(frozen=True)
class LinkTier:
    """One interconnect tier under the alpha-beta model: a message of b
    bytes costs alpha_s + b * beta_s_per_byte on one link."""

    name: str               # "ici" | "dcn"
    alpha_s: float          # per-message latency (s)
    beta_s_per_byte: float  # inverse bandwidth (s/byte)

    def xfer(self, nbytes: float) -> float:
        return self.alpha_s + nbytes * self.beta_s_per_byte


def ici_tier() -> LinkTier:
    """Local-tier defaults: ~1 us latency, ~100 GB/s per link. These are
    TPU model constants (the v4/v5 ICI ballpark), not H100 figures."""
    gbps = _env_float("RT_COLLECTIVE_ICI_GBPS", 100.0)
    return LinkTier(
        "ici",
        alpha_s=_env_float("RT_COLLECTIVE_ICI_ALPHA_S", 1e-6),
        beta_s_per_byte=1.0 / (gbps * 1e9),
    )


def dcn_tier() -> LinkTier:
    """DCN defaults: ~50 us latency, ~12.5 GB/s (100 Gbps) per host (the
    JAX package's TPU-pod model constants)."""
    gbps = _env_float("RT_COLLECTIVE_DCN_GBPS", 12.5)
    return LinkTier(
        "dcn",
        alpha_s=_env_float("RT_COLLECTIVE_DCN_ALPHA_S", 50e-6),
        beta_s_per_byte=1.0 / (gbps * 1e9),
    )


@dataclass(frozen=True)
class Topology:
    """The gang's link shape as the cost model sees it.

    n_procs  — DCN ring members (processes/slices/hosts).
    n_local  — devices each process reaches over the fast local tier
               (the visible cards; a list of CPU tensors in tests);
               1 means the topology is flat and "hier" is meaningless.
    """

    n_procs: int
    n_local: int
    ici: LinkTier
    dcn: LinkTier

    @property
    def total_ranks(self) -> int:
        return self.n_procs * self.n_local

    @property
    def has_local_tier(self) -> bool:
        return self.n_local > 1

    # -- construction ----------------------------------------------------
    @classmethod
    def detect(cls, n_procs: int, n_local: Optional[int] = None) -> "Topology":
        """Build the topology at group creation: DCN width from the
        gang's world size, local width from the cards this process sees
        (falling back to flat)."""
        if n_local is None:
            n_local = cls._detect_n_local()
        return cls(
            n_procs=max(1, int(n_procs)),
            n_local=max(1, int(n_local)),
            ici=ici_tier(),
            dcn=dcn_tier(),
        )

    @staticmethod
    def _detect_n_local() -> int:
        """The cards this process sees: its CUDA_VISIBLE_DEVICES, else the
        node's card count (accelerators/gpu.py); 1 (flat) with none."""
        try:
            from ray_tpu_torch._private.accelerators.gpu import (
                GPUAcceleratorManager as gpus)

            visible = gpus.get_current_process_visible_accelerator_ids()
            n = (len(visible) if visible is not None
                 else gpus.get_current_node_num_accelerators())
            return max(1, int(n))
        except Exception:  # noqa: BLE001 — metadata probe only: flat topo
            return 1

    # -- cost model ------------------------------------------------------
    def cost_ring_allreduce(self, nbytes: float, n: Optional[int] = None,
                            tier: Optional[LinkTier] = None) -> float:
        """Ring reduce-scatter + allgather over `n` members of `tier`:
        2(n-1) serialized steps each moving nbytes/n."""
        n = n or self.n_procs
        tier = tier or self.dcn
        if n <= 1:
            return 0.0
        return 2 * (n - 1) * tier.xfer(nbytes / n)

    def cost_rd_allreduce(self, nbytes: float, n: Optional[int] = None,
                          tier: Optional[LinkTier] = None) -> float:
        """Recursive doubling: ceil(log2 n) rounds, full message each
        round (plus a fold round when n is not a power of two)."""
        n = n or self.n_procs
        tier = tier or self.dcn
        if n <= 1:
            return 0.0
        rounds = math.ceil(math.log2(n))
        if n & (n - 1):  # non-power-of-2 pays the fold in and out
            rounds += 2
        return rounds * tier.xfer(nbytes)

    def cost_hier_allreduce(self, nbytes: float) -> float:
        """Sharded two-tier: local reduce-scatter + per-lane DCN ring of
        one nbytes/n_local shard + local allgather. The DCN lanes are
        modeled parallel (per-chip NICs), so the DCN term is one ring
        over a single shard — the 1/n_local cut hier_group implements."""
        if not self.has_local_tier:
            return float("inf")
        shard = nbytes / self.n_local
        ici = 2 * (self.n_local - 1) * self.ici.xfer(nbytes / self.n_local)
        dcn = self.cost_ring_allreduce(shard, self.n_procs, self.dcn)
        return ici + dcn

    def crossover_nbytes(self) -> int:
        """Smallest power-of-2 message size at which the model stops
        picking the latency-optimal algorithm for allreduce (bisection
        over the same costs select_algorithm uses)."""
        lo = 1
        for exp in range(1, 34):
            size = 1 << exp
            if self.select("allreduce", size) != ALGO_RD:
                return size
            lo = size
        return lo

    # -- selection -------------------------------------------------------
    def select(self, collective: str, nbytes: float) -> str:
        """Pick the modeled-cheapest algorithm for one op. Env override
        RT_COLLECTIVE_ALGO wins (value "auto" falls through to the
        model); unknown values raise so a typo cannot silently pick a
        default."""
        forced = os.environ.get(_ALGO_ENV, "").strip().lower()
        if forced and forced != ALGO_AUTO:
            if forced not in _VALID_ALGOS:
                raise ValueError(
                    f"{_ALGO_ENV}={forced!r}: valid values are "
                    f"{_VALID_ALGOS + (ALGO_AUTO,)}"
                )
            if forced == ALGO_HIER and not self.has_local_tier:
                return ALGO_RING  # flat topology cannot shard locally
            return forced
        if self.n_procs <= 1:
            return ALGO_RING  # degenerate: no DCN exchange at all
        costs = {
            ALGO_RING: self.cost_ring_allreduce(nbytes),
            ALGO_RD: self.cost_rd_allreduce(nbytes),
        }
        if self.has_local_tier and collective in (
                "allreduce", "reducescatter"):
            costs[ALGO_HIER] = self.cost_hier_allreduce(nbytes)
        return min(costs, key=costs.get)


def select_algorithm(collective: str, topo: Topology, nbytes: float) -> str:
    """Module-level alias (the per-op call sites read better with it)."""
    return topo.select(collective, nbytes)
