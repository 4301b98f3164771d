"""Device mesh construction and sharding rules.

Counterpart of ray_tpu/parallel/mesh.py. The reference builds one
`jax.sharding.Mesh` and lets GSPMD insert the collectives; the port runs
one process per rank over torch.distributed (NCCL on the card, gloo on
the CPU) and builds a `torch.distributed.device_mesh.DeviceMesh` with the
same axis names and order. Functions take the mesh and the rank's LOCAL
shards and do explicitly what GSPMD inserted. Axis conventions:

  * "dp"   — pure data parallelism (replicated params, sharded batch)
  * "fsdp" — data parallelism with parameter sharding (ZeRO-3 style:
             params all-gathered for use, grads reduce-scattered)
  * "tp"   — tensor (megatron-style) parallelism over hidden/head dims
  * "sp"   — sequence/context parallelism (ring or Ulysses attention)
  * "pp"   — pipeline stages
  * "ep"   — expert parallelism for MoE

The caller starts the process group (`init_process_group` with its own
address, rank and world size) before `build_mesh`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

MESH_AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
# The mesh's axis order: "tp" and "sp" innermost (nearest links), "dp" and
# "pp" outermost (they tolerate the slowest links), as in the reference.
MESH_ORDER = ("dp", "pp", "ep", "fsdp", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. Axes of size 1 are kept so sharding rules never
    need to special-case missing axes."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.pp * self.ep

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    @staticmethod
    def for_devices(n: int, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
                    pure_dp: int = 1) -> "MeshConfig":
        """FSDP-first factorization: whatever is not spent on tp/sp/pp/ep/dp
        becomes the fsdp axis."""
        rest = n // (tp * sp * pp * ep * pure_dp)
        if rest * tp * sp * pp * ep * pure_dp != n:
            raise ValueError(
                f"cannot factor {n} devices into dp={pure_dp} tp={tp} sp={sp} "
                f"pp={pp} ep={ep}"
            )
        return MeshConfig(dp=pure_dp, fsdp=rest, tp=tp, sp=sp, pp=pp, ep=ep)


def build_mesh(config: MeshConfig, device_type: Optional[str] = None):
    """A DeviceMesh over the first `config.num_devices` ranks of the
    default process group, axes in MESH_ORDER (size-1 axes kept).

    device_type: "cuda" (the default) or "cpu" (gloo). Every rank of the
    group calls this; a rank past the mesh's size holds no coordinate.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs torch.distributed initialised: "
                           "call init_process_group first")
    n = config.num_devices
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    shape = tuple(getattr(config, a) for a in MESH_ORDER)
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type or "cuda", ranks, mesh_dim_names=MESH_ORDER)


# ---------------------------------------------------------------------------
# Axis queries on a mesh (None means no mesh: every axis has size 1)
# ---------------------------------------------------------------------------


def axis_size(mesh, name: str) -> int:
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along `name` (jax.lax.axis_index)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


# ---------------------------------------------------------------------------
# Logical axis rules (flax-style rules table, copied from the reference)
# ---------------------------------------------------------------------------

# Logical activation/parameter axis -> mesh axes.
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    # activations
    "batch": ("dp", "fsdp"),
    "seq": ("sp",),
    "act_embed": None,
    "act_heads": ("tp",),
    "act_mlp": ("tp",),
    # params
    "embed": ("fsdp",),      # ZeRO-3: shard the non-tp dim over fsdp
    "mlp": ("tp",),
    "heads": ("tp",),
    "kv": None,
    "qkv_embed": ("fsdp",),
    "vocab": ("tp",),
    "expert": ("ep",),
    "stage": ("pp",),
    "norm": None,
}


def logical_to_physical(logical_axes: Sequence[Optional[str]],
                        rules: Optional[Dict] = None) -> tuple:
    """Map a tuple of logical axis names to a partition spec: one entry per
    dimension, None (replicated), a mesh axis name, or a tuple of them
    (split over their product, the first axis major) — what the
    reference's PartitionSpec holds. A mesh axis is used at most once."""
    rules = rules or DEFAULT_RULES
    spec = []
    used: set = set()
    for name in logical_axes:
        axes = rules.get(name) if name is not None else None
        if axes is None:
            spec.append(None)
            continue
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            spec.append(None)
        elif len(axes) == 1:
            spec.append(axes[0])
        else:
            spec.append(axes)
    return tuple(spec)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one partition-spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor `x` under `spec`."""
    for dim, entry in enumerate(spec):
        for axis in spec_axes(entry):
            n = axis_size(mesh, axis)
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} "
                                 f"does not split over {axis}={n}")
            x = x.chunk(n, dim=dim)[axis_index(mesh, axis)]
    return x


def shard_params(params, logical_axes_tree, mesh, rules=None):
    """This rank's local shard of every leaf of `params` (a nested dict of
    tensors), by its logical axes tree (a leaf of None is replicated).
    The port's counterpart of device-putting the tree onto the mesh."""
    if isinstance(params, dict):
        return {k: shard_params(v, logical_axes_tree[k], mesh, rules)
                for k, v in params.items()}
    if logical_axes_tree is None:
        return params
    spec = logical_to_physical(logical_axes_tree, rules)
    return local_shard(params, spec, mesh).contiguous()


def with_sharding_constraint(x, logical_axes, mesh=None, rules=None):
    """The identity: the port's tensors are already the rank's local
    shards, placed where its functions put them."""
    return x
