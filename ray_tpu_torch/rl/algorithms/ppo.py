"""PPO: proximal policy optimization on the learner stack (the port of
ray_tpu/rl/algorithms/ppo.py).

Algorithm.training_step samples via env runners, updates via the
LearnerGroup, then broadcasts weights. Config uses the builder pattern
of AlgorithmConfig; `device` is where the learners compute (None: the
card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as rt
from ray_tpu_torch.rl.algorithms.algorithm import AlgorithmBase, ConfigEvalMixin
from ray_tpu_torch.rl.core.learner_group import LearnerGroup
from ray_tpu_torch.rl.core.rl_module import (
    ConvModuleSpec,
    ConvPolicyModule,
    DiscretePolicyModule,
    RLModuleSpec,
    filters_for,
)
from ray_tpu_torch.rl.env_runner import EnvRunner, compute_gae


def _normalized(adv: torch.Tensor) -> torch.Tensor:
    # numpy's population std, as jnp.std: correction=0.
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def _taken(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return logp_all.gather(-1, actions.long()[..., None])[..., 0]


def _entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -(torch.exp(logp_all) * logp_all).sum(-1).mean()


def clipped_surrogate(out, batch, clip: float = 0.2, vf_coef: float = 0.5,
                      ent_coef: float = 0.01):
    """The PPO clipped-surrogate body: callers only differ in how `out`
    (action_logits + value) was computed. Works on any leading shape —
    logits [..., A], actions/logp/advantages/returns [...]."""
    logp_all = F.log_softmax(out["action_logits"], dim=-1)
    logp = _taken(logp_all, batch["actions"])
    ratio = torch.exp(logp - batch["logp"])
    adv = _normalized(batch["advantages"])
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    policy_loss = -surr.mean()
    value_loss = ((out["value"] - batch["returns"]) ** 2).mean()
    entropy = _entropy(logp_all)
    loss = policy_loss + vf_coef * value_loss - ent_coef * entropy
    return loss, {
        "total_loss": loss,
        "policy_loss": policy_loss,
        "vf_loss": value_loss,
        "entropy": entropy,
        "kl": (batch["logp"] - logp).mean(),
    }


def ppo_loss(module, batch):
    """Clipped-surrogate PPO loss (standard formulation)."""
    return clipped_surrogate(module(batch["obs"]), batch)


def a2c_loss(module, batch):
    """Vanilla advantage actor-critic loss: plain policy gradient on
    normalized GAE advantages, no ratio clipping (one pass over fresh
    on-policy rollouts)."""
    out = module(batch["obs"])
    logp_all = F.log_softmax(out["action_logits"], dim=-1)
    logp = _taken(logp_all, batch["actions"])
    adv = _normalized(batch["advantages"])
    policy_loss = -(logp * adv).mean()
    value_loss = ((out["value"] - batch["returns"]) ** 2).mean()
    entropy = _entropy(logp_all)
    loss = policy_loss + 0.5 * value_loss - 0.01 * entropy
    return loss, {
        "total_loss": loss,
        "policy_loss": policy_loss,
        "vf_loss": value_loss,
        "entropy": entropy,
    }


@dataclass
class PPOConfig(ConfigEvalMixin):
    """Builder-style config (reference: AlgorithmConfig/PPOConfig)."""

    # The surrogate loss the learner optimizes; A2CConfig swaps in
    # a2c_loss.
    loss_fn: Callable = None  # resolved to ppo_loss in build()

    env_creator: Optional[Callable] = None
    obs_dim: int = 4
    # Image observations: set obs_shape=(H, W, C) and the policy gets a
    # conv torso (filters auto-sized by resolution unless given).
    obs_shape: Optional[tuple] = None
    conv_filters: Optional[tuple] = None
    num_actions: int = 2
    hidden: tuple = (64, 64)
    num_env_runners: int = 2
    rollout_length: int = 200
    connectors_factory: Optional[Callable] = None
    num_learners: int = 1
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    num_epochs: int = 4
    minibatch_size: int = 128
    seed: int = 0
    device: Optional[str] = None  # the learners' device; None: the card

    def environment(self, env_creator=None, obs_dim=None, num_actions=None,
                    obs_shape=None, conv_filters=None):
        if env_creator is not None:
            self.env_creator = env_creator
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        if obs_shape is not None:
            self.obs_shape = tuple(obs_shape)
        if conv_filters is not None:
            self.conv_filters = tuple(conv_filters)
        return self

    def env_runners(self, num_env_runners=None, rollout_length=None,
                    connectors_factory=None):
        """connectors_factory: zero-arg callable returning a fresh
        ConnectorPipeline — each runner gets its own instance."""
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_length is not None:
            self.rollout_length = rollout_length
        if connectors_factory is not None:
            self.connectors_factory = connectors_factory
        return self

    def training(self, lr=None, num_epochs=None, minibatch_size=None,
                 gamma=None, lambda_=None, num_learners=None, device=None):
        for name, val in (
            ("lr", lr), ("num_epochs", num_epochs),
            ("minibatch_size", minibatch_size), ("gamma", gamma),
            ("lambda_", lambda_), ("num_learners", num_learners),
            ("device", device),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "PPO":
        return PPO(self)


def policy_module_factory(config):
    """The policy module a PPO-family config asks for: a conv torso for
    image observations, MLP towers otherwise."""
    if config.obs_shape is not None:
        spec = ConvModuleSpec(
            config.obs_shape, config.num_actions,
            conv_filters=filters_for(config.obs_shape, config.conv_filters),
            hidden=config.hidden[-1:] or (64,),
        )
        return lambda: ConvPolicyModule(spec)
    spec = RLModuleSpec(config.obs_dim, config.num_actions, config.hidden)
    return lambda: DiscretePolicyModule(spec)


class PPO(AlgorithmBase):
    """The algorithm object (reference: Algorithm, a Tune Trainable —
    train() returns one iteration's metrics)."""

    def __init__(self, config: PPOConfig):
        assert config.env_creator is not None, "config.environment(...) first"
        self.config = config
        module_factory = self._module_factory = policy_module_factory(config)
        self.learner_group = LearnerGroup(
            module_factory,
            config.loss_fn or ppo_loss,
            num_learners=config.num_learners,
            seed=config.seed,
            lr=config.lr,
            device=config.device,
        )
        self.env_runners = [
            EnvRunner.options(num_cpus=0.5).remote(
                config.env_creator,
                module_factory,
                seed=config.seed + 1 + i,
                rollout_length=config.rollout_length,
                connectors=(
                    config.connectors_factory()
                    if config.connectors_factory else None
                ),
                gamma=config.gamma,
            )
            for i in range(config.num_env_runners)
        ]
        self._iteration = 0
        self._broadcast_weights()

    def _broadcast_weights(self):
        weights = self.learner_group.get_weights()
        rt.get([r.set_weights.remote(weights) for r in self.env_runners],
               timeout=300)

    def train(self) -> Dict[str, Any]:
        """One training iteration: rollouts, GAE, minibatch epochs, then
        the weight broadcast."""
        cfg = self.config
        # 1. parallel rollout collection
        rollouts = rt.get(
            [r.sample.remote() for r in self.env_runners], timeout=600
        )
        processed = [compute_gae(b, cfg.gamma, cfg.lambda_) for b in rollouts]
        batch = {
            k: np.concatenate([p[k] for p in processed])
            for k in ("obs", "actions", "logp", "values", "advantages", "returns")
        }
        # 2. minibatch SGD epochs on the learner group
        from ray_tpu_torch.rl.core.learner import minibatch_epochs

        metrics: Dict[str, float] = minibatch_epochs(
            self.learner_group.update_from_batch, batch,
            cfg.num_epochs, cfg.minibatch_size,
            np.random.default_rng(cfg.seed + self._iteration),
        )
        # 3. broadcast new weights to env runners
        self._broadcast_weights()
        self._iteration += 1
        stats = rt.get(
            [r.episode_stats.remote() for r in self.env_runners], timeout=300
        )
        returns = [s["mean_return"] for s in stats if s["episodes"] > 0]
        return self._finish_iteration({
            "training_iteration": self._iteration,
            "episode_return_mean": float(np.mean(returns)) if returns else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            **{f"learner/{k}": v for k, v in metrics.items()},
        })

    def stop(self):
        self.stop_eval_runners()
        self.learner_group.shutdown()
        for r in self.env_runners:
            try:
                rt.kill(r)
            except Exception:  # noqa: BLE001 — already gone
                pass


@dataclass
class A2CConfig(PPOConfig):
    """Synchronous advantage actor-critic: the PPO machinery driven by
    the unclipped policy-gradient loss for exactly one pass over each
    fresh on-policy batch."""

    num_epochs: int = 1  # on-policy: a single pass per batch

    def __post_init__(self):
        if self.loss_fn is None:
            self.loss_fn = a2c_loss
