"""Replay buffers for off-policy algorithms (the port of
ray_tpu/rl/replay.py, pure numpy as there: the same seed draws the same
samples in both packages).

Reference analog: rllib/utils/replay_buffers/ — a uniform ring buffer
(ReplayBuffer) plus proportional prioritized sampling
(PrioritizedReplayBuffer, the reference's
prioritized_episode_buffer.py machinery collapsed to transition arrays),
and the n-step return transform the reference applies in its DQN
connectors (rllib/connectors/learner/add_next_observations_from_episodes
+ n_step handling in dqn.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def n_step_transitions(batch: Dict[str, np.ndarray], ep_ends: np.ndarray,
                       n: int, gamma: float) -> Dict[str, np.ndarray]:
    """Collapse time-ordered 1-step transitions into n-step ones.

    For each start index t the window runs forward until the first
    episode end (terminated OR truncated), the rollout end, or n steps —
    whichever comes first (length m). The output transition carries the
    discounted reward sum over the window, the successor state after the
    window, dones = terminated-at-window-end, and ``discounts`` =
    gamma**m, so Q targets are  R + discount * (1 - done) * V(next_obs).
    Windows never bridge episodes (ep_ends includes truncations even
    though dones does not).
    """
    T = len(batch["obs"])
    if n <= 1:
        return {**batch, "discounts": np.full(T, gamma, dtype=np.float32)}
    rewards = np.zeros(T, dtype=np.float32)
    next_obs = np.empty_like(batch["next_obs"])
    dones = np.zeros(T, dtype=np.float32)
    discounts = np.zeros(T, dtype=np.float32)
    for t in range(T):
        acc, disc = 0.0, 1.0
        m = 0
        for k in range(n):
            j = t + k
            if j >= T:
                break
            acc += disc * float(batch["rewards"][j])
            disc *= gamma
            m = j
            if ep_ends[j]:
                break
        rewards[t] = acc
        next_obs[t] = batch["next_obs"][m]
        dones[t] = batch["dones"][m]
        discounts[t] = disc
    return {
        "obs": batch["obs"],
        "actions": batch["actions"],
        "rewards": rewards,
        "next_obs": next_obs,
        "dones": dones,
        "discounts": discounts,
    }


class ReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 action_dim: int = 0, store_discounts: bool = False):
        """obs_dim: flat dim (int) or an obs SHAPE tuple (image envs).
        action_dim=0 -> discrete int actions; >0 -> float vectors.
        store_discounts: keep a per-transition bootstrap discount
        (gamma**m for m-step windows) alongside the usual fields."""
        self.capacity = capacity
        obs_shape = (obs_dim,) if isinstance(obs_dim, int) else tuple(obs_dim)
        self.obs = np.zeros((capacity, *obs_shape), dtype=np.float32)
        self.next_obs = np.zeros((capacity, *obs_shape), dtype=np.float32)
        if action_dim:
            self.actions = np.zeros((capacity, action_dim), dtype=np.float32)
        else:
            self.actions = np.zeros(capacity, dtype=np.int32)
        self.rewards = np.zeros(capacity, dtype=np.float32)
        self.dones = np.zeros(capacity, dtype=np.float32)
        self.store_discounts = store_discounts
        if store_discounts:
            self.discounts = np.zeros(capacity, dtype=np.float32)
        self._rng = np.random.default_rng(seed)
        self._next = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(batch["obs"])
        idx = (self._next + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"]
        self.next_obs[idx] = batch["next_obs"]
        self.actions[idx] = batch["actions"]
        self.rewards[idx] = batch["rewards"]
        self.dones[idx] = batch["dones"]
        if self.store_discounts:
            self.discounts[idx] = batch["discounts"]
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        return idx

    def _gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        out = {
            "obs": self.obs[idx],
            "next_obs": self.next_obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
        }
        if self.store_discounts:
            out["discounts"] = self.discounts[idx]
        return out

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return self._gather(idx)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized experience replay (Schaul et al. 2016).

    Sampling probability ∝ priority**alpha; importance-sampling weights
    (N * P)**-beta normalized by their max ride along in the batch as
    ``weights`` plus the sampled ``indices`` for update_priorities.
    New transitions enter at the current max priority so every
    transition is seen at least once (reference:
    rllib/utils/replay_buffers/prioritized_episode_buffer.py).
    """

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 action_dim: int = 0, store_discounts: bool = False,
                 alpha: float = 0.6, eps: float = 1e-6):
        super().__init__(capacity, obs_dim, seed=seed, action_dim=action_dim,
                         store_discounts=store_discounts)
        self.alpha = alpha
        self.eps = eps
        self.priorities = np.zeros(capacity, dtype=np.float64)

    def add_batch(self, batch: Dict[str, np.ndarray]):
        max_p = self.priorities[: self._size].max() if self._size else 1.0
        idx = super().add_batch(batch)
        self.priorities[idx] = max(max_p, self.eps)
        return idx

    def sample(self, batch_size: int, beta: float = 0.4) -> Dict[str, np.ndarray]:
        p = self.priorities[: self._size] ** self.alpha
        probs = p / p.sum()
        idx = self._rng.choice(self._size, size=batch_size, p=probs)
        out = self._gather(idx)
        w = (self._size * probs[idx]) ** (-beta)
        out["weights"] = (w / w.max()).astype(np.float32)
        out["indices"] = idx
        return out

    def update_priorities(self, indices: np.ndarray, td_abs: np.ndarray):
        self.priorities[indices] = np.abs(td_abs).astype(np.float64) + self.eps
