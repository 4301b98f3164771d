"""Bridge so `ray_tpu_torch.tune.report(...)` works inside trial functions."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.train.session import TrainSession

_active: Optional[TrainSession] = None


def set_active_session(session: TrainSession):
    global _active
    _active = session


def get_active_session() -> TrainSession:
    if _active is None:
        raise RuntimeError("no active tune session in this process")
    return _active
