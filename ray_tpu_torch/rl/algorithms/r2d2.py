"""R2D2: recurrent replay distributed DQN (the port of
ray_tpu/rl/algorithms/r2d2.py).

Analog of the reference's R2D2 (rllib/algorithms/r2d2/): value-based
learning with a recurrent (GRU) Q-network over SEQUENCE replay — the
buffer stores fixed-length windows with the hidden state each window
started from (stored-state strategy), the learner replays whole windows
through the GRU with a burn-in prefix that refreshes the state under
current weights but takes no gradient, and targets are double-DQN over
the target network's replay of the same window.

The online and target networks and the optimizer (Adam behind optax's
clip by global norm at 10, without an epsilon) live on the config's
device in the driver; window runners sample on the CPU.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.algorithms.algorithm import AlgorithmBase, ConfigEvalMixin
from ray_tpu_torch.rl.core import convert
from ray_tpu_torch.rl.core.learner import adam, readback, step, to_tensors
from ray_tpu_torch.rl.core.rl_module import (
    RecurrentModuleSpec,
    RecurrentQNetworkModule,
)
from ray_tpu_torch.rl.env_runner import _EnvRunnerBase

GRAD_CLIP = 10.0


@rt.remote
class RecurrentWindowRunner(_EnvRunnerBase):
    """Collects fixed-length windows for sequence replay: each window
    ships the GRU state it STARTED from plus per-step
    (obs, action, reward, done) — the stored-state scheme R2D2 uses."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._policy_state = None

    def sample(self, epsilon: float = 0.0) -> Dict[str, np.ndarray]:
        self._begin_rollout()
        if self._policy_state is None:
            self._policy_state = self.module.initial_state(1)
        T = self.rollout_length
        state0 = self._policy_state.numpy()[0].copy()
        obs_buf, act_buf, rew_buf, done_buf = [], [], [], []
        for _ in range(T):
            obs = self._obs_conn
            action, self._policy_state = self._sample(
                obs[None], self._policy_state, epsilon
            )
            action = int(action[0])
            obs_buf.append(obs)
            act_buf.append(action)
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            rew = self._reward(reward)
            self._advance(nxt, reward, terminated, truncated)
            if terminated or truncated:
                self._policy_state = self.module.initial_state(1)
            rew_buf.append(rew)
            done_buf.append(bool(terminated or truncated))
        return {
            "obs": np.stack(obs_buf).astype(np.float32),
            "actions": np.asarray(act_buf, dtype=np.int32),
            "rewards": np.asarray(rew_buf, dtype=np.float32),
            "dones": np.asarray(done_buf, dtype=np.float32),
            "state0": state0.astype(np.float32),
        }


class SequenceReplayBuffer:
    """Uniform ring buffer of windows (reference:
    rllib/utils/replay_buffers storing SampleBatch sequences); the JAX
    package's numpy code, so one seed draws the same windows in both."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._items: list = []
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def add(self, window: Dict[str, np.ndarray]):
        if len(self._items) < self.capacity:
            self._items.append(window)
        else:
            self._items[self._next] = window
            self._next = (self._next + 1) % self.capacity

    def __len__(self):
        return len(self._items)

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(self._items), size=n)
        return {
            k: np.stack([self._items[i][k] for i in idx])
            for k in self._items[0]
        }


def r2d2_update_fn(gamma: float, burn_in: int):
    """The loss over a [B, T] window batch: `loss_fn(module, target,
    batch) -> (loss, metrics)`.

    Burn-in: the first `burn_in` steps replay only to refresh the GRU
    state (their TD terms are masked out of the loss). Targets are
    within-window double-DQN: a* from the online replay at t+1 (the
    first of tied maxima, as jnp.argmax), value from the target replay
    at t+1; the window's last step has no in-window successor and is
    masked too."""

    def loss_fn(module, target, batch):
        q_online = module.forward_seq(
            batch["obs"], batch["state0"], batch["dones"])["q_values"]
        with torch.no_grad():
            q_target = target.forward_seq(
                batch["obs"], batch["state0"], batch["dones"])["q_values"]
        q_taken = q_online.gather(
            -1, batch["actions"].long()[..., None])[..., 0]   # [B, T]
        a_star = q_online[:, 1:].detach().argmax(dim=-1)      # [B, T-1]
        next_v = q_target[:, 1:].gather(-1, a_star[..., None])[..., 0]
        r = batch["rewards"][:, :-1]
        nonterminal = 1.0 - batch["dones"][:, :-1]
        td_target = r + gamma * nonterminal * next_v
        td = q_taken[:, :-1] - td_target
        T = q_taken.shape[1]
        mask = (torch.arange(T - 1, device=td.device) >= burn_in).to(
            td.dtype)[None, :]
        # Huber on the TD error (R2D2 uses clipped/rescaled losses; the
        # invertible value rescaling is omitted at these reward scales).
        huber = torch.where(td.abs() <= 1.0, 0.5 * td ** 2, td.abs() - 0.5)
        loss = (huber * mask).sum() / torch.clamp(
            mask.sum() * td.shape[0], min=1)
        return loss, {"td_loss": loss,
                      "q_mean": (q_taken[:, :-1] * mask).mean()}

    return loss_fn


@dataclass
class R2D2Config(ConfigEvalMixin):
    env_creator: Optional[Callable] = None
    obs_dim: int = 4
    num_actions: int = 2
    state_dim: int = 32
    hidden: tuple = (32,)
    num_env_runners: int = 2
    window_length: int = 16
    burn_in: int = 2
    buffer_capacity: int = 2000       # windows
    learning_starts: int = 32         # windows before updates begin
    train_batch_size: int = 16        # windows per update
    updates_per_iteration: int = 16
    target_update_freq: int = 2       # iterations between target syncs
    lr: float = 1e-3
    gamma: float = 0.99
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iters: int = 10
    seed: int = 0
    connectors_factory: Optional[Callable] = None
    device: Optional[str] = None  # where the update runs; None: the card

    def environment(self, env_creator=None, obs_dim=None, num_actions=None):
        if env_creator is not None:
            self.env_creator = env_creator
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        return self

    def env_runners(self, num_env_runners=None, window_length=None,
                    connectors_factory=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if window_length is not None:
            self.window_length = window_length
        if connectors_factory is not None:
            self.connectors_factory = connectors_factory
        return self

    def training(self, lr=None, gamma=None, train_batch_size=None,
                 updates_per_iteration=None, target_update_freq=None,
                 buffer_capacity=None, learning_starts=None, burn_in=None,
                 device=None):
        for name, val in (
            ("lr", lr), ("gamma", gamma),
            ("train_batch_size", train_batch_size),
            ("updates_per_iteration", updates_per_iteration),
            ("target_update_freq", target_update_freq),
            ("buffer_capacity", buffer_capacity),
            ("learning_starts", learning_starts),
            ("burn_in", burn_in), ("device", device),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def exploration(self, epsilon_start=None, epsilon_end=None,
                    epsilon_decay_iters=None):
        for name, val in (
            ("epsilon_start", epsilon_start),
            ("epsilon_end", epsilon_end),
            ("epsilon_decay_iters", epsilon_decay_iters),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "R2D2":
        return R2D2(self)


class R2D2(AlgorithmBase):
    def __init__(self, config: R2D2Config):
        assert config.env_creator is not None, "config.environment(...) first"
        self.config = config
        self.device = resolve_device(config.device)
        spec = RecurrentModuleSpec(
            config.obs_dim, config.num_actions,
            state_dim=config.state_dim, hidden=config.hidden,
        )
        self._module_factory = lambda: RecurrentQNetworkModule(spec)  # noqa: E731
        self.module = RecurrentQNetworkModule(spec).init(config.seed).to(
            self.device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._params = convert.flatten(self.module.tree())
        self.optimizer = adam(self._params.values(), config.lr)
        self._loss = r2d2_update_fn(config.gamma, config.burn_in)
        self.buffer = SequenceReplayBuffer(config.buffer_capacity,
                                           seed=config.seed)
        self.env_runners = [
            RecurrentWindowRunner.options(num_cpus=0.5).remote(
                config.env_creator,
                self._module_factory,
                seed=config.seed + 1 + i,
                rollout_length=config.window_length,
                connectors=(config.connectors_factory()
                            if config.connectors_factory else None),
                gamma=config.gamma,
            )
            for i in range(config.num_env_runners)
        ]
        self._iteration = 0
        self._broadcast_weights()

    def update(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update on a window batch on the device."""
        loss, metrics = self._loss(self.module, self.target, batch)
        step(self.optimizer, self._params.values(), loss, GRAD_CLIP)
        return {k: v.detach() for k, v in metrics.items()}

    def sync_target(self):
        with torch.no_grad():
            for t, p in zip(self.target.parameters(),
                            self.module.parameters()):
                t.copy_(p)

    # AlgorithmBase state hooks (save/restore without a LearnerGroup),
    # in the JAX package's layout.
    def _get_learner_state(self):
        return {
            "params": self.module.get_weights(),
            "target_params": self.target.get_weights(),
            "opt_state": convert.adam_to_jax(self.optimizer, self._params),
        }

    def _set_learner_state(self, state):
        self.module.set_weights(state["params"])
        self.target.set_weights(state["target_params"])
        convert.load_adam(self.optimizer, self._params, state["opt_state"])
        self._broadcast_weights()

    def _current_weights(self):
        return self.module.get_weights()

    def _broadcast_weights(self):
        weights = self.module.get_weights()
        rt.get([r.set_weights.remote(weights) for r in self.env_runners],
               timeout=300)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._iteration / max(cfg.epsilon_decay_iters, 1))
        return cfg.epsilon_start + frac * (cfg.epsilon_end -
                                           cfg.epsilon_start)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        eps = self._epsilon()
        windows = rt.get(
            [r.sample.remote(eps) for r in self.env_runners], timeout=600
        )
        for w in windows:
            self.buffer.add(w)
        metrics: Dict[str, float] = {}
        if len(self.buffer) >= cfg.learning_starts:
            m = {}
            for _ in range(cfg.updates_per_iteration):
                m = self.update(to_tensors(
                    self.buffer.sample(cfg.train_batch_size), self.device))
            metrics = readback(m) if m else {}
        if self._iteration % cfg.target_update_freq == 0:
            self.sync_target()
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
            "buffer_windows": len(self.buffer),
            "epsilon": eps,
            **{f"learner/{k}": v for k, v in metrics.items()},
        })

    def stop(self):
        self.stop_eval_runners()
        for r in self.env_runners:
            try:
                rt.kill(r)
            except Exception:  # noqa: BLE001 — already gone
                pass
