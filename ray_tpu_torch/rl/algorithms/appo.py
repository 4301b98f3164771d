"""APPO: asynchronous PPO with V-trace off-policy correction (the port of
ray_tpu/rl/algorithms/appo.py).

PPO's clipped surrogate computed on V-trace-corrected advantages, so
slightly-stale rollouts from non-blocking samplers stay usable. Rollouts
come from VectorEnvRunner actors (one batched policy call per step
across N envs), and the driver keeps sample futures standing across
updates exactly like IMPALA's harvest loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rl.algorithms.algorithm import ConfigEvalMixin
from ray_tpu_torch.rl.algorithms.impala import _bt_forward, _HarvestLoop, vtrace
from ray_tpu_torch.rl.core.learner_group import LearnerGroup
from ray_tpu_torch.rl.core.rl_module import DiscretePolicyModule, RLModuleSpec
from ray_tpu_torch.rl.env_runner import VectorEnvRunner


def appo_loss(module, batch, gamma: float = 0.99, clip_eps: float = 0.2,
              vf_coeff: float = 0.5, entropy_coeff: float = 0.01):
    """Clipped-surrogate policy loss on V-trace advantages, [B, T] batch."""
    logp_all, values, target_logp = _bt_forward(module, batch)
    bootstrap = batch.get("last_values")
    if bootstrap is None:
        bootstrap = module(batch["last_obs"])["value"]
    vs, pg_adv = vtrace(batch["logp"], target_logp, batch["rewards"],
                        values, bootstrap, batch["dones"], gamma=gamma)
    adv = (pg_adv - pg_adv.mean()) / (pg_adv.std(correction=0) + 1e-8)
    ratio = torch.exp(target_logp - batch["logp"])
    surr = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv,
    )
    policy_loss = -surr.mean()
    value_loss = ((values - vs) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = policy_loss + vf_coeff * value_loss - entropy_coeff * entropy
    return loss, {
        "total_loss": loss,
        "policy_loss": policy_loss,
        "vf_loss": value_loss,
        "entropy": entropy,
        "mean_ratio": ratio.mean(),
    }


@dataclass
class APPOConfig(ConfigEvalMixin):
    """Builder-style config (reference: APPOConfig)."""

    env_creator: Optional[Callable] = None
    obs_dim: int = 4
    num_actions: int = 2
    hidden: tuple = (64, 64)
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_length: int = 64
    lr: float = 3e-3
    gamma: float = 0.99
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    updates_per_iteration: int = 8
    rollouts_per_update: int = 1
    seed: int = 0
    device: Optional[str] = None  # the learner's device; None: the card

    def environment(self, env_creator=None, obs_dim=None, num_actions=None):
        if env_creator is not None:
            self.env_creator = env_creator
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        return self

    def env_runners(self, num_env_runners=None, num_envs_per_runner=None,
                    rollout_length=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_runner is not None:
            self.num_envs_per_runner = num_envs_per_runner
        if rollout_length is not None:
            self.rollout_length = rollout_length
        return self

    def training(self, lr=None, gamma=None, clip_eps=None,
                 updates_per_iteration=None, rollouts_per_update=None,
                 vf_coeff=None, entropy_coeff=None, device=None):
        for k, v in (("lr", lr), ("gamma", gamma), ("clip_eps", clip_eps),
                     ("updates_per_iteration", updates_per_iteration),
                     ("rollouts_per_update", rollouts_per_update),
                     ("vf_coeff", vf_coeff),
                     ("entropy_coeff", entropy_coeff), ("device", device)):
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self) -> "APPO":
        return APPO(self)


class APPO(_HarvestLoop):
    """Async actor-learner loop over vectorized samplers: each harvested
    (T, N, ...) rollout transposes to the [B=N, T] layout the V-trace
    loss consumes."""

    def __init__(self, config: APPOConfig):
        assert config.env_creator is not None, "config.environment(...) first"
        self.config = config
        spec = RLModuleSpec(config.obs_dim, config.num_actions, config.hidden)
        module_factory = self._module_factory = lambda: DiscretePolicyModule(spec)  # noqa: E731

        loss = lambda m, b: appo_loss(  # noqa: E731
            m, b, gamma=config.gamma, clip_eps=config.clip_eps,
            vf_coeff=config.vf_coeff, entropy_coeff=config.entropy_coeff,
        )
        self.learner_group = LearnerGroup(
            module_factory, loss, num_learners=1, seed=config.seed,
            lr=config.lr, device=config.device,
        )
        self.env_runners = [
            VectorEnvRunner.options(num_cpus=0.5).remote(
                config.env_creator,
                module_factory,
                num_envs=config.num_envs_per_runner,
                seed=config.seed + 1 + i,
                rollout_length=config.rollout_length,
                gamma=config.gamma,
            )
            for i in range(config.num_env_runners)
        ]
        self._start_pipeline()

    @staticmethod
    def _to_bt(rollout: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """(T, N, ...) time-major sample -> (B=N, T, ...) rollout batch."""
        out = {k: np.swapaxes(rollout[k], 0, 1)
               for k in ("obs", "actions", "logp", "values", "rewards",
                         "dones")}
        out["last_values"] = rollout["last_values"]
        out["last_obs"] = rollout["last_obs"]
        return out

    def _batch(self, rollouts):
        rollouts = [self._to_bt(b) for b in rollouts]
        return {k: np.concatenate([b[k] for b in rollouts])
                for k in rollouts[0]}
