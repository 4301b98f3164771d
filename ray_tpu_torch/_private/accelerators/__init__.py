"""Accelerator manager registry.

Analog of python/ray/_private/accelerators/__init__.py:34 in the reference.
The NVIDIA GPU is the accelerator here; the registry stays pluggable so
other accelerators can be added.
"""

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager

_MANAGERS = {
    "GPU": GPUAcceleratorManager,
}


def get_all_accelerator_managers():
    return dict(_MANAGERS)


def get_accelerator_manager(resource_name: str):
    return _MANAGERS.get(resource_name)


__all__ = [
    "AcceleratorManager",
    "GPUAcceleratorManager",
    "get_all_accelerator_managers",
    "get_accelerator_manager",
]
