"""NVIDIA GPU accelerator manager: detection, type label, visible devices.

Follows the public model of upstream Ray's NvidiaGPUAcceleratorManager
(python/ray/_private/accelerators/nvidia_gpu.py). It counts cards in this
order:

  1. an explicit count, `RT_NUM_GPUS`;
  2. `CUDA_VISIBLE_DEVICES`, where it is set;
  3. `nvidia-smi --query-gpu=index,name --format=csv,noheader`, whose
     names also give the type label ("NVIDIA H100 80GB HBM3" ->
     "GPU-H100");
  4. the driver's `/proc/driver/nvidia/gpus/*` entries.

It never calls `torch.cuda`: the raylet and the zygote detect cards, and
the zygote forks every worker. A CUDA context made before a fork leaves
CUDA unusable in each child, and even `torch.cuda.is_available()` can
initialise the driver. Workers import torch themselves, after the fork.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
from typing import List, Optional

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager

GPU_RESOURCE_NAME = "GPU"
CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
NUM_GPUS_ENV = "RT_NUM_GPUS"
NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=index,name",
                    "--format=csv,noheader"]
_PROC_GPUS = "/proc/driver/nvidia/gpus"
# "NVIDIA H100 80GB HBM3" -> "H100", "Tesla V100-SXM2-16GB" -> "V100"
# (upstream nvidia_gpu.py's NVIDIA_GPU_NAME_PATTERN).
_NAME_PATTERN = re.compile(r"\w+\s+([A-Z0-9]+)")


def _nvidia_smi_names() -> Optional[List[str]]:
    """The card names nvidia-smi lists, in index order; None when it is
    missing or fails. NVML answers the query: no CUDA context is made."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    names = []
    for line in out.stdout.splitlines():
        if line.strip():
            _, _, name = line.partition(",")
            names.append(name.strip())
    return names


def _proc_names() -> List[str]:
    """Card names from the driver's /proc entries ("Model:" lines)."""
    names = []
    for info in sorted(glob.glob(os.path.join(_PROC_GPUS, "*", "information"))):
        try:
            with open(info) as f:
                model = next((ln.split(":", 1)[1].strip() for ln in f
                              if ln.startswith("Model:")), "")
        except OSError:
            model = ""
        names.append(model)
    return names


def _visible(raw: str) -> List[str]:
    if raw in ("", "NoDevFiles"):
        return []
    return raw.split(",")


def gpu_type_label(name: str) -> Optional[str]:
    """The scheduler's type label for a card name, e.g. "GPU-H100"."""
    m = _NAME_PATTERN.match(name or "")
    return f"GPU-{m.group(1)}" if m else None


class GPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return GPU_RESOURCE_NAME

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return CUDA_VISIBLE_DEVICES_ENV

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        """Card count: explicit env > CUDA_VISIBLE_DEVICES > nvidia-smi >
        /proc/driver/nvidia."""
        explicit = os.environ.get(NUM_GPUS_ENV)
        if explicit:
            return int(explicit)
        visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if visible is not None:
            return len(_visible(visible))
        names = _nvidia_smi_names()
        if names is not None:
            return len(names)
        return len(_proc_names())

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        names = _nvidia_smi_names()
        if names is None:
            names = _proc_names()
        return gpu_type_label(names[0]) if names else None

    @staticmethod
    def validate_resource_request_quantity(quantity: float):
        """A fraction of one card, or a whole number of cards."""
        if 0 < quantity < 1 or (quantity >= 1 and float(quantity).is_integer()):
            return True, None
        return (
            False,
            f"GPU request must be a fraction of one GPU or a whole number "
            f"of GPUs (got {quantity})",
        )

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        raw = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        return None if raw is None else _visible(raw)

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        """Confine this process to specific cards. Takes effect before the
        process makes its CUDA context, not after."""
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in ids)


class GPUInstances:
    """Which cards of a node are granted to whom (upstream Ray's
    per-instance GPU accounting, resource_instance_set.cc). The raylet's
    counts say how much `GPU` is free; this says which card ids, so a
    worker can be confined to its own through CUDA_VISIBLE_DEVICES.

    A whole-card request takes that many free cards; a fraction shares
    one card, the fullest that still fits. When fractions have left no
    free card for a request that the counts admit, the least-loaded
    cards are shared instead (the counts stay exact; only the ids
    overlap)."""

    def __init__(self, total: float, ids: Optional[List[str]] = None):
        n = int(-(-total // 1)) if total > 0 else 0
        ids = list(ids or [])[:n]
        ids += [str(i) for i in range(len(ids), n)]
        self._free = {i: 1.0 for i in ids}
        if n and total < n:
            self._free[ids[-1]] = total - (n - 1)

    def take(self, amount: float,
             prefer: Optional[List[str]] = None) -> List[str]:
        if amount <= 0 or not self._free:
            return []
        whole = amount >= 1
        need = 1.0 if whole else amount
        fits = [i for i, c in self._free.items() if c + 1e-9 >= need]
        n = int(round(amount)) if whole else 1
        if prefer and len(prefer) == n and all(p in fits for p in prefer):
            ids = list(prefer)
        elif len(fits) >= n:
            ids = (fits[:n] if whole
                   else [min(fits, key=lambda i: self._free[i])])
        else:
            ids = sorted(self._free, key=lambda i: -self._free[i])[:n]
        for i in ids:
            self._free[i] -= need
        return ids

    def give(self, ids: List[str], amount: float) -> None:
        need = 1.0 if amount >= 1 else amount
        for i in ids:
            if i in self._free:
                self._free[i] += need

    def free(self) -> dict:
        return dict(self._free)


# The card ids the raylet granted this worker's current task or actor.
_GRANTED: List[str] = []


def granted_gpu_ids() -> List[str]:
    """The card ids this worker holds (upstream ray.get_gpu_ids); empty
    when its task or actor asked for no GPU."""
    return list(_GRANTED)


def confine_process_to_gpus(ids: List[str]) -> None:
    """Make this worker see only `ids`, as CUDA_VISIBLE_DEVICES. CUDA
    reads the variable once, when the process makes its context, so a
    worker whose context already serves other cards cannot be moved:
    that raises rather than run on a card another worker holds. With no
    ids the worker holds no card, and the variable is left as it is."""
    import sys

    _GRANTED[:] = ids
    if not ids:
        return
    value = ",".join(ids)
    if os.environ.get(CUDA_VISIBLE_DEVICES_ENV) == value:
        return
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(
            f"this worker's CUDA context was made for "
            f"CUDA_VISIBLE_DEVICES={os.environ.get(CUDA_VISIBLE_DEVICES_ENV)!r}"
            f" and cannot move to the cards {value!r} it was granted")
    os.environ[CUDA_VISIBLE_DEVICES_ENV] = value
