"""Accelerator manager interface.

Analog of the reference ABC (python/ray/_private/accelerators/accelerator.py:5)
— detection, type labeling, extra gang resources, and per-task visible-device
isolation.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional


class AcceleratorManager(ABC):
    @staticmethod
    @abstractmethod
    def get_resource_name() -> str:
        """Scheduler resource name, e.g. "GPU"."""

    @staticmethod
    @abstractmethod
    def get_visible_accelerator_ids_env_var() -> str:
        """Env var that confines a process to specific accelerator ids."""

    @staticmethod
    @abstractmethod
    def get_current_node_num_accelerators() -> int:
        """How many accelerators this node has."""

    @staticmethod
    @abstractmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        """Label like "GPU-H100"."""

    @staticmethod
    def get_current_node_additional_resources() -> Dict[str, float]:
        """Extra custom resources this node should advertise."""
        return {}

    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> tuple[bool, Optional[str]]:
        return True, None

    @staticmethod
    @abstractmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        ...

    @staticmethod
    @abstractmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        ...
