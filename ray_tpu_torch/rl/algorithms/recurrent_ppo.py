"""Recurrent PPO: proximal policy optimization with a stateful policy (the
port of ray_tpu/rl/algorithms/recurrent_ppo.py).

The policy carries a GRU hidden state across steps (reset at episode
boundaries), rollouts ship the state each window started with, and the
learner replays whole [B, T] sequences through forward_seq so the
recomputed logits/values see exactly the states the behavior policy saw.

Reference analog: recurrent-model support + stored-state replay
(rllib/models/torch/recurrent_net.py, rllib/algorithms/r2d2/ — the
use_lstm path of PPO's old stack). Minibatching is over SEQUENCES
(rollout windows), never over shuffled timesteps, which would sever the
state chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.algorithms.algorithm import AlgorithmBase
from ray_tpu_torch.rl.algorithms.ppo import PPOConfig, clipped_surrogate
from ray_tpu_torch.rl.core.learner_group import LearnerGroup
from ray_tpu_torch.rl.core.rl_module import (
    RecurrentModuleSpec,
    RecurrentPolicyModule,
)
from ray_tpu_torch.rl.env_runner import RecurrentEnvRunner, compute_gae


def recurrent_ppo_loss(module, batch):
    """Clipped-surrogate PPO over [B, T] sequences replayed through the
    GRU (batch carries state0 [B, H] and dones [B, T]); the surrogate
    body is shared with plain PPO (ppo.clipped_surrogate)."""
    out = module.forward_seq(batch["obs"], batch["state0"], batch["dones"])
    return clipped_surrogate(out, batch)


@dataclass
class RecurrentPPOConfig(PPOConfig):
    """PPOConfig plus the recurrent knobs; hidden state size rides
    state_dim. minibatch_size is ignored (sequence-level batching)."""

    state_dim: int = 32

    def build(self) -> "RecurrentPPO":
        return RecurrentPPO(self)


class RecurrentPPO(AlgorithmBase):
    def __init__(self, config: RecurrentPPOConfig):
        assert config.env_creator is not None, "config.environment(...) first"
        if config.obs_shape is not None:
            raise ValueError(
                "RecurrentPPO takes vector observations (obs_dim=...); "
                "a conv+recurrent torso is not composed here"
            )
        if config.num_learners > config.num_env_runners:
            # The recurrent batch axis is SEQUENCES (one per runner
            # window): more learners than runners would shard to empty
            # batches and train on NaNs.
            raise ValueError(
                f"num_learners={config.num_learners} exceeds "
                f"num_env_runners={config.num_env_runners}; recurrent "
                "batches shard by rollout window"
            )
        self.config = config
        spec = RecurrentModuleSpec(
            config.obs_dim, config.num_actions,
            state_dim=config.state_dim, hidden=config.hidden[-1:] or (32,),
        )
        module_factory = self._module_factory = (  # noqa: E731
            lambda: RecurrentPolicyModule(spec)
        )
        self.learner_group = LearnerGroup(
            module_factory,
            config.loss_fn or recurrent_ppo_loss,
            num_learners=config.num_learners,
            seed=config.seed,
            lr=config.lr,
            device=config.device,
        )
        self.env_runners = [
            RecurrentEnvRunner.options(num_cpus=0.5).remote(
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
        cfg = self.config
        rollouts = rt.get(
            [r.sample.remote() for r in self.env_runners], timeout=600
        )
        processed = [compute_gae(b, cfg.gamma, cfg.lambda_) for b in rollouts]
        # Sequences stay whole: [B, T, ...] with B = rollout windows.
        batch = {
            k: np.stack([p[k] for p in processed])
            for k in ("obs", "actions", "logp", "advantages", "returns",
                      "dones")
        }
        batch["state0"] = np.stack([p["state0"] for p in processed])
        metrics: Dict[str, float] = {}
        for _ in range(cfg.num_epochs):
            metrics = self.learner_group.update_from_batch(batch)
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
