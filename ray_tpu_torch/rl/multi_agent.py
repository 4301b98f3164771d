"""Multi-agent RL: envs, module dicts, runners, and multi-agent PPO (the
port of ray_tpu/rl/multi_agent.py).

Analog of the reference's multi-agent stack: MultiAgentEnv
(rllib/env/multi_agent_env.py), MultiRLModule (the per-policy module dict,
rllib/core/rl_module/multi_rl_module.py), the agent->policy mapping fn
(AlgorithmConfig.multi_agent(policy_mapping_fn=...)), and multi-agent
episode collection. The runner keeps one CPU module per policy and one
generator; each policy's Learner computes on the config's device (the
card unless the caller asks for the CPU), and per-policy learners update
independently (shared or separate policies both fall out of the mapping
fn).

Synchronous stepping: every agent acts at every env step until the episode
ends for all (the "__all__" key, as the reference's terminateds dict).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.models.mlp import generator
from ray_tpu_torch.rl.algorithms.ppo import ppo_loss
from ray_tpu_torch.rl.core.learner import Learner, minibatch_epochs
from ray_tpu_torch.rl.core.rl_module import DiscretePolicyModule, RLModuleSpec
from ray_tpu_torch.rl.env_runner import (
    EpisodeTracker,
    _obs_tensor,
    _runner_threads,
    compute_gae,
)


class MultiAgentEnv:
    """Base class for synchronous multi-agent envs.

    reset() -> (obs_dict, info); step(action_dict) ->
    (obs_dict, reward_dict, terminated_dict, truncated_dict, info) where
    terminated_dict carries the "__all__" episode-end key (reference
    convention: rllib/env/multi_agent_env.py).
    """

    agent_ids: Tuple[str, ...] = ()

    def reset(self):  # pragma: no cover - interface
        raise NotImplementedError

    def step(self, action_dict: Dict[str, int]):  # pragma: no cover
        raise NotImplementedError


class MultiRLModule:
    """A dict of policy modules keyed by policy id (reference:
    MultiRLModule / MultiAgentRLModuleSpec); its weights are a dict of
    the JAX layout's trees by policy id."""

    def __init__(self, specs: Dict[str, RLModuleSpec]):
        self.specs = specs
        self.modules = {
            pid: DiscretePolicyModule(spec) for pid, spec in specs.items()
        }

    def init(self, seed: int = 0) -> Dict[str, Dict]:
        """Draw every policy's parameters again, the j-th policy id in
        sorted order from seed + j; returns the weights."""
        for j, pid in enumerate(sorted(self.modules)):
            self.modules[pid].init(seed + j)
        return self.get_weights()

    def get_weights(self) -> Dict[str, Dict]:
        return {pid: m.get_weights() for pid, m in self.modules.items()}

    def set_weights(self, weights: Dict[str, Dict]) -> None:
        for pid, w in weights.items():
            self.modules[pid].set_weights(w)

    def __getitem__(self, policy_id: str) -> DiscretePolicyModule:
        return self.modules[policy_id]


@rt.remote
class MultiAgentEnvRunner:
    """Collects per-policy, per-agent trajectories from a synchronous
    multi-agent env.

    Each env step samples one action per agent from that agent's mapped
    policy. Experience is buffered PER AGENT (agents sharing a policy must
    not interleave into one sequence — GAE assumes temporal adjacency);
    completed trajectories are grouped under their policy id, the
    reference's shared-policy semantics.

    Bootstraps mirror the single-agent runner: termination ends the value
    chain; truncation ("__all__" truncs without terms) folds
    gamma * V(s_final) into the final reward; a rollout cut mid-episode
    bootstraps via the trajectory's `last_value` = V(current obs).
    """

    def __init__(self, env_creator, specs: Dict[str, RLModuleSpec],
                 policy_mapping_fn: Callable[[str], str], seed: int = 0,
                 rollout_length: int = 200, gamma: float = 0.99):
        _runner_threads()
        self.env = env_creator()
        self.marl = MultiRLModule(specs)
        self.mapping = policy_mapping_fn
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.rng = generator(seed)
        self.params: Optional[Dict[str, Dict]] = None
        self._obs = None
        self._tracker = EpisodeTracker()

    def set_weights(self, weights: Dict[str, Dict]):
        self.marl.set_weights(weights)
        self.params = weights
        return True

    def _value_of(self, pid: str, obs: np.ndarray) -> float:
        with torch.inference_mode():
            return float(self.marl[pid](_obs_tensor(obs[None]))["value"][0])

    def sample(self) -> Dict[str, List[Dict[str, np.ndarray]]]:
        """Returns {policy_id: [trajectory, ...]}, each trajectory a
        GAE-ready batch for one agent's episode segment."""
        assert self.params is not None, "set_weights first"
        if self._obs is None:
            self._obs, _ = self.env.reset()
        agent_bufs: Dict[str, Dict[str, list]] = {}
        out: Dict[str, List[Dict[str, np.ndarray]]] = {
            pid: [] for pid in self.marl.modules
        }

        def finalize(aid: str, last_value: float):
            b = agent_bufs.pop(aid, None)
            if not b or not b["obs"]:
                return
            out[self.mapping(aid)].append({
                "obs": np.stack(b["obs"]),
                "actions": np.asarray(b["actions"], dtype=np.int32),
                "logp": np.asarray(b["logp"], dtype=np.float32),
                "values": np.asarray(b["values"], dtype=np.float32),
                "rewards": np.asarray(b["rewards"], dtype=np.float32),
                "dones": np.asarray(b["dones"], dtype=np.float32),
                "last_value": float(last_value),
            })

        for _ in range(self.rollout_length):
            actions: Dict[str, int] = {}
            step_meta: Dict[str, Tuple[str, np.ndarray, float, float]] = {}
            for aid, obs in self._obs.items():
                pid = self.mapping(aid)
                obs = np.asarray(obs, dtype=np.float32)
                with torch.inference_mode():
                    a, logp, value = self.marl[pid].sample_action(
                        _obs_tensor(obs[None]), self.rng)
                actions[aid] = int(a[0])
                step_meta[aid] = (pid, obs, float(logp[0]), float(value[0]))
            nxt, rewards, terms, truncs, _ = self.env.step(actions)
            terminated = bool(terms.get("__all__", False))
            truncated = bool(truncs.get("__all__", False))
            done = terminated or truncated
            for aid, (pid, obs, logp, value) in step_meta.items():
                b = agent_bufs.setdefault(
                    aid, {k: [] for k in ("obs", "actions", "logp", "values",
                                          "rewards", "dones")}
                )
                rew = float(rewards.get(aid, 0.0))
                if truncated and not terminated:
                    # Time-limit cut: the final state still has value.
                    final_obs = np.asarray(nxt[aid], dtype=np.float32)
                    rew += self.gamma * self._value_of(pid, final_obs)
                b["obs"].append(obs)
                b["actions"].append(actions[aid])
                b["logp"].append(logp)
                b["values"].append(value)
                b["rewards"].append(rew)
                b["dones"].append(float(done))
            self._tracker.add(float(sum(rewards.values())))
            if done:
                for aid in list(agent_bufs):
                    finalize(aid, 0.0)  # terminal (or folded) — no bootstrap
                self._tracker.end_episode()
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        # Rollout ended mid-episode: bootstrap each agent with the value of
        # its current observation under its own policy.
        for aid in list(agent_bufs):
            pid = self.mapping(aid)
            obs = np.asarray(self._obs[aid], dtype=np.float32)
            finalize(aid, self._value_of(pid, obs))
        return out

    def episode_stats(self) -> Dict[str, Any]:
        return self._tracker.stats()


@dataclass
class MultiAgentPPOConfig:
    """Multi-agent PPO config (reference: PPOConfig().multi_agent(...))."""

    env_creator: Optional[Callable] = None
    policies: Dict[str, RLModuleSpec] = field(default_factory=dict)
    policy_mapping_fn: Callable[[str], str] = lambda aid: "default"
    num_env_runners: int = 2
    rollout_length: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    num_epochs: int = 4
    minibatch_size: int = 64
    seed: int = 0
    device: Optional[str] = None  # the learners' device; None: the card

    def environment(self, env_creator):
        self.env_creator = env_creator
        return self

    def multi_agent(self, policies: Dict[str, RLModuleSpec],
                    policy_mapping_fn: Callable[[str], str]):
        self.policies = policies
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def env_runners(self, num_env_runners=None, rollout_length=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_length is not None:
            self.rollout_length = rollout_length
        return self

    def training(self, lr=None, num_epochs=None, minibatch_size=None,
                 gamma=None, lambda_=None, device=None):
        for name, val in (
            ("lr", lr), ("num_epochs", num_epochs),
            ("minibatch_size", minibatch_size), ("gamma", gamma),
            ("lambda_", lambda_), ("device", device),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """Per-policy PPO learners over shared multi-agent rollouts."""

    def __init__(self, config: MultiAgentPPOConfig):
        assert config.env_creator is not None, "config.environment(...) first"
        assert config.policies, "config.multi_agent(policies=...) first"
        self.config = config
        self.marl = MultiRLModule(config.policies)
        self.learners = {
            pid: Learner(self.marl[pid], ppo_loss, seed=config.seed + j,
                         lr=config.lr, device=config.device)
            for j, pid in enumerate(sorted(config.policies))
        }
        self.env_runners = [
            MultiAgentEnvRunner.options(num_cpus=0.5).remote(
                config.env_creator,
                config.policies,
                config.policy_mapping_fn,
                seed=config.seed + 1 + i,
                rollout_length=config.rollout_length,
                gamma=config.gamma,
            )
            for i in range(config.num_env_runners)
        ]
        self._iteration = 0
        self._broadcast_weights()

    def _broadcast_weights(self):
        weights = {pid: lr.get_weights() for pid, lr in self.learners.items()}
        rt.get([r.set_weights.remote(weights) for r in self.env_runners],
               timeout=300)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        rollouts = rt.get(
            [r.sample.remote() for r in self.env_runners], timeout=600
        )
        metrics: Dict[str, float] = {}
        rng = np.random.default_rng(cfg.seed + self._iteration)
        for pid, learner in self.learners.items():
            # GAE runs per agent-trajectory (temporal adjacency), then the
            # policy's trajectories concatenate into one SGD batch.
            parts = [
                compute_gae(traj, cfg.gamma, cfg.lambda_)
                for r in rollouts for traj in r.get(pid, [])
            ]
            if not parts:
                continue
            batch = {
                k: np.concatenate([p[k] for p in parts])
                for k in ("obs", "actions", "logp", "values", "advantages",
                          "returns")
            }
            m = minibatch_epochs(
                learner.update_from_batch, batch, cfg.num_epochs,
                cfg.minibatch_size, rng,
            )
            metrics.update({f"{pid}/{k}": v for k, v in m.items()})
        self._broadcast_weights()
        self._iteration += 1
        stats = rt.get(
            [r.episode_stats.remote() for r in self.env_runners], timeout=300
        )
        returns = [s["mean_return"] for s in stats if s["episodes"] > 0]
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": float(np.mean(returns)) if returns else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            **{f"learner/{k}": v for k, v in metrics.items()},
        }

    def stop(self):
        for r in self.env_runners:
            try:
                rt.kill(r)
            except Exception:  # noqa: BLE001 — already gone
                pass
