"""Connectors: composable observation/action transform pipelines (the
port of ray_tpu/rl/connectors.py, pure numpy as there).

Analog of the reference's connector framework (rllib/connectors/, ~4k LoC
of env-to-module and module-to-env pipelines). Connectors sit between the
env and the policy inside env runners so preprocessing (flattening,
normalization, reward clipping) is part of the sampling path and the
exact transformed observations land in the training batch — the learner
never needs to replicate the transform.

Stateful connectors (running normalization) expose get_state/set_state so
their statistics can ship with checkpoints or merge across runners, the
reference's connector-state sync shape.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transform stage. Subclasses override __call__ (obs -> obs)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class FlattenObs(Connector):
    """Flattens any observation shape to a 1-D float32 vector (reference:
    the flatten-observations default connector)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return np.asarray(obs, dtype=np.float32).reshape(-1)


class NormalizeObs(Connector):
    """Running mean/std observation normalization (Welford update).

    Reference analog: MeanStdFilter / the normalize-observations
    connector. Stats update on every observation seen during sampling;
    the normalized obs is what lands in the batch, so the learner sees a
    consistent distribution without needing the stats itself.
    """

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self.count = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, dtype=np.float32)
        if self.mean is None:
            self.mean = np.zeros_like(obs, dtype=np.float64)
            self.m2 = np.zeros_like(obs, dtype=np.float64)
        self.count += 1
        delta = obs - self.mean
        self.mean = self.mean + delta / self.count
        self.m2 = self.m2 + delta * (obs - self.mean)
        if self.count < 2:
            return np.clip(obs, -self.clip, self.clip).astype(np.float32)
        std = np.sqrt(self.m2 / (self.count - 1)) + self.eps
        return np.clip(
            (obs - self.mean) / std, -self.clip, self.clip
        ).astype(np.float32)

    def get_state(self) -> Dict[str, Any]:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class ClipReward(Connector):
    """Clips rewards to [-bound, bound]; applied via transform_reward
    (reference: the clip-rewards connector / config.clip_rewards)."""

    def __init__(self, bound: float = 1.0):
        self.bound = bound

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return obs  # identity on observations

    def transform_reward(self, reward: float) -> float:
        return float(np.clip(reward, -self.bound, self.bound))


class ConnectorPipeline:
    """Ordered connector list applied obs -> obs; rewards pass through
    every stage that defines transform_reward."""

    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, obs) -> np.ndarray:
        out = np.asarray(obs, dtype=np.float32)
        for c in self.connectors:
            out = c(out)
        return out

    def transform_reward(self, reward: float) -> float:
        for c in self.connectors:
            fn = getattr(c, "transform_reward", None)
            if fn is not None:
                reward = fn(reward)
        return float(reward)

    def get_state(self) -> List[Dict[str, Any]]:
        return [c.get_state() for c in self.connectors]

    def set_state(self, states: List[Dict[str, Any]]) -> None:
        for c, s in zip(self.connectors, states):
            c.set_state(s)
