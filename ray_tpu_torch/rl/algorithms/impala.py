"""IMPALA: asynchronous actor-learner training with V-trace correction
(the port of ray_tpu/rl/algorithms/impala.py).

Env-runner actors sample continuously and the learner consumes rollouts
as they arrive, so sample collection and SGD overlap; harvested rollouts
were collected under slightly stale weights, and V-trace truncated
importance sampling (Espeholt et al. 2018) keeps the update unbiased.
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
from ray_tpu_torch.rl.core.rl_module import DiscretePolicyModule, RLModuleSpec
from ray_tpu_torch.rl.env_runner import EnvRunner


def vtrace(
    behavior_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    dones: torch.Tensor,
    gamma: float = 0.99,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
):
    """V-trace targets and policy-gradient advantages over rollouts whose
    last axis is time ([T], or [B, T] with bootstrap [B]).

    vs_t - V_t = delta_t + gamma * nonterminal_t * c_t * (vs_{t+1} - V_{t+1})
    with delta_t = rho_t * (r_t + gamma * nonterminal_t * V_{t+1} - V_t),
    rho/c the clipped importance ratios: the JAX package's reverse
    lax.scan as a loop over T, the same operations in the same order.
    Both outputs are constants of the gradient (stop_gradient there).
    """
    with torch.no_grad():
        log_ratio = target_logp - behavior_logp
        rho = torch.clamp(torch.exp(log_ratio), max=clip_rho)
        c = torch.clamp(torch.exp(log_ratio), max=clip_c)
        nonterminal = 1.0 - dones
        boot = torch.as_tensor(bootstrap_value, dtype=values.dtype,
                               device=values.device)[..., None]
        values_next = torch.cat([values[..., 1:], boot], dim=-1)
        deltas = rho * (rewards + gamma * nonterminal * values_next - values)
        disc = gamma * nonterminal
        acc = torch.zeros_like(deltas[..., 0])
        out = [None] * deltas.shape[-1]
        for t in reversed(range(deltas.shape[-1])):
            acc = deltas[..., t] + disc[..., t] * c[..., t] * acc
            out[t] = acc
        vs = values + torch.stack(out, dim=-1)
        vs_next = torch.cat([vs[..., 1:], boot], dim=-1)
        pg_adv = rho * (rewards + gamma * nonterminal * vs_next - values)
    return vs, pg_adv


def _bt_forward(module, batch):
    """(logp_all [B, T, A], values [B, T], target_logp [B, T]) of a
    [B, T] rollout batch."""
    B, T = batch["actions"].shape
    out = module(batch["obs"].reshape(B * T, -1))
    logp_all = F.log_softmax(out["action_logits"], dim=-1).reshape(B, T, -1)
    values = out["value"].reshape(B, T)
    target_logp = logp_all.gather(
        -1, batch["actions"].long()[..., None])[..., 0]
    return logp_all, values, target_logp


def impala_loss(module, batch, gamma: float = 0.99,
                vf_coeff: float = 0.5, entropy_coeff: float = 0.01):
    """V-trace actor-critic loss over a [B, T] batch of rollouts."""
    logp_all, values, target_logp = _bt_forward(module, batch)
    bootstrap = module(batch["last_obs"])["value"]
    vs, pg_adv = vtrace(batch["logp"], target_logp, batch["rewards"],
                        values, bootstrap, batch["dones"], gamma=gamma)
    policy_loss = -(pg_adv * target_logp).mean()
    value_loss = ((values - vs) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = policy_loss + vf_coeff * value_loss - entropy_coeff * entropy
    return loss, {
        "total_loss": loss,
        "policy_loss": policy_loss,
        "vf_loss": value_loss,
        "entropy": entropy,
        "mean_rho": torch.exp(target_logp - batch["logp"]).mean(),
    }


@dataclass
class IMPALAConfig(ConfigEvalMixin):
    """Builder-style config (reference: IMPALAConfig)."""

    env_creator: Optional[Callable] = None
    obs_dim: int = 4
    num_actions: int = 2
    hidden: tuple = (64, 64)
    num_env_runners: int = 2
    rollout_length: int = 64
    connectors_factory: Optional[Callable] = None
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    updates_per_iteration: int = 8
    rollouts_per_update: int = 2
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

    def env_runners(self, num_env_runners=None, rollout_length=None,
                    connectors_factory=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_length is not None:
            self.rollout_length = rollout_length
        if connectors_factory is not None:
            self.connectors_factory = connectors_factory
        return self

    def training(self, lr=None, gamma=None, updates_per_iteration=None,
                 rollouts_per_update=None, vf_coeff=None, entropy_coeff=None,
                 device=None):
        for name, val in (
            ("lr", lr), ("gamma", gamma),
            ("updates_per_iteration", updates_per_iteration),
            ("rollouts_per_update", rollouts_per_update),
            ("vf_coeff", vf_coeff), ("entropy_coeff", entropy_coeff),
            ("device", device),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "IMPALA":
        return IMPALA(self)


class _HarvestLoop(AlgorithmBase):
    """The standing sample pipeline IMPALA and APPO share: sample futures
    stay in flight across updates; each update harvests whichever
    rollouts finished first (rt.wait), applies one SGD step, then
    refreshes only the harvested runners' weights and resubmits them."""

    def _start_pipeline(self):
        weights = self.learner_group.get_weights()
        rt.get([r.set_weights.remote(weights) for r in self.env_runners],
               timeout=300)
        self._pending: Dict[Any, Any] = {
            r.sample.remote(): r for r in self.env_runners
        }
        self._iteration = 0

    def _batch(self, rollouts) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.updates_per_iteration):
            want = min(cfg.rollouts_per_update, len(self._pending))
            ready, _ = rt.wait(
                list(self._pending), num_returns=want, timeout=300
            )
            if not ready:
                continue
            rollouts = rt.get(ready, timeout=300)
            runners = [self._pending.pop(ref) for ref in ready]
            metrics = self.learner_group.update_from_batch(
                self._batch(rollouts))
            weights = self.learner_group.get_weights()
            # The harvested runners are idle here, so awaiting the weight
            # push is cheap (in-memory swap) and surfaces a dead runner
            # now instead of leaking the error with the dropped ref.
            rt.get([r.set_weights.remote(weights) for r in runners],
                   timeout=300)
            for r in runners:
                self._pending[r.sample.remote()] = r
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


class IMPALA(_HarvestLoop):
    """Async actor-learner loop: runners that are mid-rollout are never
    stalled — the IMPALA throughput property."""

    def __init__(self, config: IMPALAConfig):
        assert config.env_creator is not None, "config.environment(...) first"
        self.config = config
        spec = RLModuleSpec(config.obs_dim, config.num_actions, config.hidden)
        module_factory = self._module_factory = lambda: DiscretePolicyModule(spec)  # noqa: E731

        loss = lambda m, b: impala_loss(  # noqa: E731
            m, b, gamma=config.gamma, vf_coeff=config.vf_coeff,
            entropy_coeff=config.entropy_coeff,
        )
        self.learner_group = LearnerGroup(
            module_factory, loss, num_learners=1, seed=config.seed,
            lr=config.lr, device=config.device,
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
        self._start_pipeline()

    def _batch(self, rollouts):
        return {k: np.stack([b[k] for b in rollouts])
                for k in ("obs", "actions", "logp", "rewards", "dones",
                          "last_obs")}

    def pending_rollouts(self, num: int = 1, timeout: float = 120.0):
        """Harvest up to `num` completed rollouts from the standing
        sample pipeline without consuming them for training; harvested
        runners are resubmitted so the pipeline keeps flowing."""
        ready, _ = rt.wait(
            list(self._pending), num_returns=min(num, len(self._pending)),
            timeout=timeout,
        )
        rollouts = rt.get(ready, timeout=timeout)
        for ref in ready:
            runner = self._pending.pop(ref)
            self._pending[runner.sample.remote()] = runner
        return rollouts
