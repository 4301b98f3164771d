"""TD3: twin-delayed deep deterministic policy gradient (the port of
ray_tpu/rl/algorithms/td3.py).

Analog of the reference's TD3 (rllib/algorithms/td3 — Fujimoto et al.
2018; the reference reaches it through its DDPG family). The update —
the twin-critic TD step with target-policy smoothing, the delayed
deterministic policy step, and the polyak sync of every target — runs
on the config's device in the driver, as SAC's. The JAX package's
`lax.cond` on the step count is a host branch here: the count is part of
the state and of the checkpoint, and on a skipped step the actor, its
optimizer and all targets stay as they were. The target-policy noise's
standard normal draw is an input, as SAC's draws are.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.mlp import init_mlp, mlp_forward
from ray_tpu_torch.rl.algorithms.algorithm import ConfigEvalMixin
from ray_tpu_torch.rl.algorithms.sac import (
    OffPolicyContinuous,
    continuous_spec,
    load_subtree,
    polyak,
    subtree,
)
from ray_tpu_torch.rl.core import convert
from ray_tpu_torch.rl.core.learner import adam, step
from ray_tpu_torch.rl.core.rl_module import ContinuousModuleSpec, RLModule


class DeterministicPolicyModule(RLModule):
    """tanh-deterministic actor + twin Q towers (the DDPG/TD3 module
    shape). Exploration noise is added by the runner-side sampler;
    actions live normalized in [-1, 1] internally."""

    def __init__(self, spec: ContinuousModuleSpec,
                 explore_sigma: float = 0.1):
        super().__init__(spec)
        self.explore_sigma = explore_sigma

    def _init_tree(self, gen):
        sizes = [self.spec.obs_dim, *self.spec.hidden, self.spec.action_dim]
        qin = self.spec.obs_dim + self.spec.action_dim
        qsizes = [qin, *self.spec.hidden, 1]
        return {
            "pi": init_mlp(gen, sizes),
            "q1": init_mlp(gen, qsizes),
            "q2": init_mlp(gen, qsizes),
        }

    def scale_action(self, a_norm):
        lo, hi = self.spec.action_low, self.spec.action_high
        return a_norm * (hi - lo) / 2.0 + (hi + lo) / 2.0

    def policy(self, obs: torch.Tensor) -> torch.Tensor:
        """tanh(pi(obs)), the JAX module's `pi` (here "pi" names the
        actor's weight tree)."""
        return torch.tanh(mlp_forward(self.tree()["pi"], obs))

    def q_values(self, obs: torch.Tensor, a_norm: torch.Tensor):
        p = self.tree()
        x = torch.cat([obs, a_norm], dim=-1)
        return (mlp_forward(p["q1"], x)[..., 0],
                mlp_forward(p["q2"], x)[..., 0])

    def deterministic_action(self, obs: torch.Tensor) -> torch.Tensor:
        return self.policy(obs)

    def forward(self, obs: torch.Tensor):
        return {"action": self.policy(obs)}

    def sample_with_logp(self, obs: torch.Tensor, gen: torch.Generator = None,
                         eps: torch.Tensor = None):
        """Behavior policy: pi(s) + N(0, sigma), clipped to [-1, 1]
        (`eps` the standard normal draw, from `gen` unless given; logp is
        a placeholder so the runner's interface matches SAC's module)."""
        a = self.policy(obs)
        if eps is None:
            eps = torch.randn(a.shape, generator=gen, device=a.device)
        a_norm = torch.clamp(a + self.explore_sigma * eps, -1.0, 1.0)
        return a_norm, torch.zeros(a_norm.shape[:-1], device=a.device)

    def sample_action(self, obs: torch.Tensor, gen: torch.Generator):
        a_norm, logp = self.sample_with_logp(obs, gen)
        return self.scale_action(a_norm), logp, torch.zeros(
            a_norm.shape[:-1], device=a_norm.device)


_ALL = ("pi", "q1", "q2")
_Q = ("q1", "q2")


def init_td3_state(module: DeterministicPolicyModule, lr: float):
    """The update's state around `module`: targets of all three towers
    start as copies, the step count at 0."""
    return {
        "module": module,
        "target": copy.deepcopy(module).requires_grad_(False),
        "pi_opt": adam(subtree(module, "pi").values(), lr),
        "q_opt": adam(subtree(module, _Q).values(), lr),
        "step": 0,
    }


def td3_state_to_jax(state) -> Dict[str, Any]:
    m = state["module"]
    return {
        "params": m.get_weights(),
        "target": state["target"].get_weights(),
        "pi_opt": convert.adam_to_jax(state["pi_opt"], subtree(m, "pi")),
        "q_opt": convert.adam_to_jax(state["q_opt"], subtree(m, _Q)),
        "step": np.asarray(state["step"], np.int32),
    }


def load_td3_state(state, jstate) -> None:
    m = state["module"]
    m.set_weights(jstate["params"])
    load_subtree(state["target"], jstate["target"])
    convert.load_adam(state["pi_opt"], subtree(m, "pi"), jstate["pi_opt"])
    convert.load_adam(state["q_opt"], subtree(m, _Q), jstate["q_opt"])
    state["step"] = int(np.asarray(jstate["step"]))


def make_td3_update(gamma: float, tau: float, target_noise: float,
                    noise_clip: float, policy_delay: int):
    """One TD3 step: `update(state, batch, noise)` advances `state` in
    place and returns its metrics as tensors. `noise` is the standard
    normal draw [B, action_dim] behind the clipped target-policy noise."""

    def update(state, batch, noise):
        module, target = state["module"], state["target"]
        with torch.no_grad():
            smooth = torch.clamp(target_noise * noise, -noise_clip,
                                 noise_clip)
            next_a = torch.clamp(target.policy(batch["next_obs"]) + smooth,
                                 -1.0, 1.0)
            tq1, tq2 = target.q_values(batch["next_obs"], next_a)
            td_target = batch["rewards"] + gamma * (
                1.0 - batch["dones"]) * torch.minimum(tq1, tq2)
        q1, q2 = module.q_values(batch["obs"], batch["actions"])
        q_loss = ((q1 - td_target) ** 2).mean() + \
            ((q2 - td_target) ** 2).mean()
        step(state["q_opt"], subtree(module, _Q).values(), q_loss)
        if state["step"] % policy_delay == 0:
            # The actor against the updated critics; the targets move on
            # policy steps only (TD3's delay).
            q1_pi, _ = module.q_values(batch["obs"], module.policy(batch["obs"]))
            pi_loss = -q1_pi.mean()
            step(state["pi_opt"], subtree(module, "pi").values(), pi_loss)
            polyak(subtree(target, _ALL), subtree(module, _ALL), tau)
            pi_loss = pi_loss.detach()
        else:
            pi_loss = torch.zeros((), device=q_loss.device)
        state["step"] += 1
        with torch.no_grad():
            mean_q = module.q_values(batch["obs"],
                                     batch["actions"])[0].mean()
        return {"q_loss": q_loss.detach(), "pi_loss": pi_loss,
                "mean_q": mean_q}

    return update


@dataclass
class TD3Config(ConfigEvalMixin):
    env_creator: Optional[Any] = None
    obs_dim: int = 3
    action_dim: int = 1
    action_low: float = -1.0
    action_high: float = 1.0
    hidden: tuple = (64, 64)
    num_env_runners: int = 1
    rollout_length: int = 200
    lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 128
    updates_per_iteration: int = 200
    warmup_steps: int = 500
    buffer_capacity: int = 100_000
    explore_sigma: float = 0.1
    target_noise: float = 0.2
    noise_clip: float = 0.5
    policy_delay: int = 2
    seed: int = 0
    device: Optional[str] = None  # where the update runs; None: the card

    def environment(self, env_creator=None, obs_dim=None, action_dim=None,
                    action_low=None, action_high=None):
        for name, val in (("env_creator", env_creator),
                          ("obs_dim", obs_dim), ("action_dim", action_dim),
                          ("action_low", action_low),
                          ("action_high", action_high)):
            if val is not None:
                setattr(self, name, val)
        return self

    def env_runners(self, num_env_runners=None, rollout_length=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_length is not None:
            self.rollout_length = rollout_length
        return self

    def training(self, lr=None, gamma=None, tau=None, batch_size=None,
                 updates_per_iteration=None, warmup_steps=None,
                 buffer_capacity=None, explore_sigma=None,
                 target_noise=None, noise_clip=None, policy_delay=None,
                 device=None):
        for name, val in (
            ("lr", lr), ("gamma", gamma), ("tau", tau),
            ("batch_size", batch_size),
            ("updates_per_iteration", updates_per_iteration),
            ("warmup_steps", warmup_steps),
            ("buffer_capacity", buffer_capacity),
            ("explore_sigma", explore_sigma),
            ("target_noise", target_noise), ("noise_clip", noise_clip),
            ("policy_delay", policy_delay), ("device", device),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "TD3":
        return TD3(self)


class TD3(OffPolicyContinuous):
    """Off-policy deterministic actor-critic loop: collect -> replay ->
    twin-delayed updates."""

    def __init__(self, config: TD3Config):
        assert config.env_creator is not None, "config.environment(...) first"
        spec = continuous_spec(config)
        module = DeterministicPolicyModule(spec, config.explore_sigma).init(
            config.seed).to(resolve_device(config.device))
        self.state = init_td3_state(module, config.lr)
        self._update = make_td3_update(
            config.gamma, config.tau, config.target_noise,
            config.noise_clip, config.policy_delay)
        self._start(config, module,
                    lambda s=spec, sg=config.explore_sigma:
                    DeterministicPolicyModule(s, sg),
                    config.seed + 77)

    def _noise(self, n, batch_size):
        return torch.randn((n, batch_size, self.config.action_dim),
                           generator=self._gen, device=self.device)

    def _update_one(self, batch, noise):
        return self._update(self.state, batch, noise)

    # AlgorithmBase state hooks (the SAC pattern: the whole state, the
    # step count included, in the JAX layout)
    def _get_learner_state(self):
        return td3_state_to_jax(self.state)

    def _set_learner_state(self, state):
        load_td3_state(self.state, state)


@dataclass
class DDPGConfig(TD3Config):
    """DDPG as the degenerate TD3 (reference: rllib's DDPG, which TD3
    historically extended): no policy delay, no target-policy smoothing.
    The twin critic stays (the minimum over twins only reduces
    overestimation)."""

    policy_delay: int = 1
    target_noise: float = 0.0
    noise_clip: float = 0.0
