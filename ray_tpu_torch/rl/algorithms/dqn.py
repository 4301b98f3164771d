"""DQN: deep Q-learning with replay and a target network (the port of
ray_tpu/rl/algorithms/dqn.py).

TransitionEnvRunner actors collect epsilon-greedy transitions into a
ReplayBuffer, the LearnerGroup applies Huber TD updates against targets
computed from a periodically-synced target network, and fresh weights
broadcast back to the runners. The target network and the online copy
that picks double-DQN actions and refreshes PER priorities live on the
config's device (the card unless the caller asks for the CPU), as
modules loaded from the learner's weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as rt
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.algorithms.algorithm import AlgorithmBase, ConfigEvalMixin
from ray_tpu_torch.rl.core.learner_group import LearnerGroup
from ray_tpu_torch.rl.core.rl_module import (
    C51QNetworkModule,
    ConvModuleSpec,
    ConvQNetworkModule,
    DuelingQNetworkModule,
    NoisyQNetworkModule,
    QNetworkModule,
    RLModuleSpec,
    factorized_noise_np,
    filters_for,
)
from ray_tpu_torch.rl.env_runner import TransitionEnvRunner
from ray_tpu_torch.rl.replay import PrioritizedReplayBuffer, ReplayBuffer


def _huber_td(q, batch):
    q_sa = q.gather(-1, batch["actions"].long()[:, None])[:, 0]
    td = q_sa - batch["targets"]
    huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
    if "weights" in batch:
        loss = (batch["weights"] * huber).mean()
    else:
        loss = huber.mean()
    return loss, {
        "total_loss": loss,
        "q_mean": q_sa.mean(),
        "td_abs_mean": td.abs().mean(),
    }


def dqn_loss(module, batch):
    """Huber TD loss against precomputed targets (target-network Q-values
    are computed driver-side so the learner stays a pure
    module+batch -> grads function). With prioritized replay the batch
    carries importance-sampling ``weights`` applied per sample."""
    return _huber_td(module(batch["obs"])["q_values"], batch)


def noisy_dqn_loss(module, batch):
    """NoisyNet variant: the batch carries one factorized noise draw
    (eps_in/eps_out), so sigma trains through the same batch plumbing."""
    q = module(batch["obs"], noise=(batch["eps_in"], batch["eps_out"]))
    return _huber_td(q["q_values"], batch)


def c51_loss(module, batch):
    """Categorical cross-entropy against the driver-projected target
    distribution (Bellemare et al. 2017)."""
    logits = module(batch["obs"])["q_logits"]
    idx = batch["actions"].long()[:, None, None].expand(-1, 1,
                                                         logits.shape[-1])
    la = logits.gather(1, idx)[:, 0]
    logp = F.log_softmax(la, dim=-1)
    ce = -(batch["target_probs"] * logp).sum(-1)
    if "weights" in batch:
        loss = (batch["weights"] * ce).mean()
    else:
        loss = ce.mean()
    return loss, {"total_loss": loss, "ce_mean": ce.mean()}


def categorical_projection(next_probs: np.ndarray, support: np.ndarray,
                           rewards: np.ndarray, discounts: np.ndarray,
                           dones: np.ndarray) -> np.ndarray:
    """Project the bootstrapped distribution r + disc*(1-d)*z onto the
    fixed support (the C51 projection step, computed driver-side so the
    learner loss stays a pure params+batch function)."""
    v_min, v_max = float(support[0]), float(support[-1])
    dz = (v_max - v_min) / (len(support) - 1)
    B, N = next_probs.shape
    tz = np.clip(
        rewards[:, None]
        + discounts[:, None] * (1.0 - dones[:, None]) * support[None],
        v_min, v_max,
    )
    b = (tz - v_min) / dz
    # Clamp: float rounding can push b past N-1 when tz clips to v_max
    # (e.g. (v_max - v_min)/dz = 94.000000001 -> ceil = 95).
    lo = np.clip(np.floor(b).astype(np.int64), 0, N - 1)
    hi = np.clip(np.ceil(b).astype(np.int64), 0, N - 1)
    # When b lands exactly on an atom (lo == hi) give it the full mass.
    frac_hi = b - lo
    frac_lo = np.where(lo == hi, 1.0, 1.0 - frac_hi)
    out = np.zeros_like(next_probs)
    rows = np.repeat(np.arange(B), N)
    np.add.at(out, (rows, lo.ravel()), (next_probs * frac_lo).ravel())
    np.add.at(out, (rows, hi.ravel()), (next_probs * frac_hi).ravel())
    return out.astype(np.float32)


@dataclass
class DQNConfig(ConfigEvalMixin):
    """Builder-style config (reference: DQNConfig)."""

    env_creator: Optional[Callable] = None
    obs_dim: int = 4
    # Image observations: obs_shape=(H, W, C) -> conv torso Q-network
    # (reference: pixel DQN via catalog conv_filters).
    obs_shape: Optional[tuple] = None
    conv_filters: Optional[tuple] = None
    num_actions: int = 2
    hidden: tuple = (64, 64)
    num_env_runners: int = 2
    rollout_length: int = 100
    connectors_factory: Optional[Callable] = None
    num_learners: int = 1
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    updates_per_iteration: int = 32
    target_update_freq: int = 2  # iterations between target syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iters: int = 20
    seed: int = 0
    # Rainbow-style extensions (reference: DQNConfig double_q / dueling /
    # n_step / replay_buffer_config prioritized fields).
    double_q: bool = True
    dueling: bool = False
    n_step: int = 1
    prioritized_replay: bool = False
    per_alpha: float = 0.6
    per_beta_start: float = 0.4
    per_beta_iters: int = 50  # iterations to anneal beta -> 1.0
    # C51 distributional head (reference: DQNConfig.num_atoms/v_min/v_max).
    distributional: bool = False
    num_atoms: int = 51
    v_min: float = -10.0
    v_max: float = 10.0
    # NoisyNet exploration (reference: DQNConfig.noisy): learned
    # parametric noise on the head replaces epsilon-greedy.
    noisy: bool = False
    device: Optional[str] = None  # learner and target nets; None: the card

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
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_length is not None:
            self.rollout_length = rollout_length
        if connectors_factory is not None:
            self.connectors_factory = connectors_factory
        return self

    def training(self, lr=None, gamma=None, train_batch_size=None,
                 updates_per_iteration=None, target_update_freq=None,
                 buffer_capacity=None, learning_starts=None,
                 num_learners=None, double_q=None, dueling=None, n_step=None,
                 prioritized_replay=None, per_alpha=None,
                 per_beta_start=None, per_beta_iters=None,
                 distributional=None, num_atoms=None, v_min=None,
                 v_max=None, noisy=None, device=None):
        for name, val in (
            ("lr", lr), ("gamma", gamma),
            ("train_batch_size", train_batch_size),
            ("updates_per_iteration", updates_per_iteration),
            ("target_update_freq", target_update_freq),
            ("buffer_capacity", buffer_capacity),
            ("learning_starts", learning_starts),
            ("num_learners", num_learners),
            ("double_q", double_q), ("dueling", dueling), ("n_step", n_step),
            ("prioritized_replay", prioritized_replay),
            ("per_alpha", per_alpha), ("per_beta_start", per_beta_start),
            ("per_beta_iters", per_beta_iters),
            ("distributional", distributional), ("num_atoms", num_atoms),
            ("v_min", v_min), ("v_max", v_max), ("noisy", noisy),
            ("device", device),
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

    def build(self) -> "DQN":
        return DQN(self)


class DQN(AlgorithmBase):
    """The algorithm object (reference: Algorithm; train() = one iteration)."""

    def __init__(self, config: DQNConfig):
        assert config.env_creator is not None, "config.environment(...) first"
        self.config = config
        spec = RLModuleSpec(config.obs_dim, config.num_actions, config.hidden)
        if sum((config.distributional, config.dueling, config.noisy)) > 1:
            raise ValueError(
                "distributional / dueling / noisy heads are not composed; "
                "pick one head structure"
            )
        if config.obs_shape is not None:
            if config.distributional or config.dueling or config.noisy:
                raise ValueError(
                    "image observations use the conv Q-network; "
                    "distributional/dueling/noisy heads are MLP-only here"
                )
            conv_spec = ConvModuleSpec(
                config.obs_shape, config.num_actions,
                conv_filters=filters_for(config.obs_shape,
                                         config.conv_filters),
                hidden=config.hidden[-1:] or (64,),
            )
            module_factory = self._module_factory = (  # noqa: E731
                lambda: ConvQNetworkModule(conv_spec)
            )
            loss = dqn_loss
        elif config.distributional:
            if config.num_atoms < 2:
                raise ValueError("distributional DQN needs num_atoms >= 2")
            module_factory = self._module_factory = (  # noqa: E731
                lambda: C51QNetworkModule(
                    spec, config.num_atoms, config.v_min, config.v_max
                )
            )
            loss = c51_loss
        elif config.noisy:
            module_factory = self._module_factory = (  # noqa: E731
                lambda: NoisyQNetworkModule(spec)
            )
            loss = noisy_dqn_loss
        else:
            cls = DuelingQNetworkModule if config.dueling else QNetworkModule
            module_factory = self._module_factory = lambda: cls(spec)  # noqa: E731
            loss = dqn_loss
        self.module = module_factory()

        self.learner_group = LearnerGroup(
            module_factory,
            loss,
            num_learners=config.num_learners,
            seed=config.seed,
            lr=config.lr,
            device=config.device,
        )
        self.buffer = self._make_buffer()
        self.env_runners = [
            TransitionEnvRunner.options(num_cpus=0.5).remote(
                config.env_creator,
                module_factory,
                seed=config.seed + 1 + i,
                rollout_length=config.rollout_length,
                gamma=config.gamma,
                n_step=config.n_step,
                connectors=(
                    config.connectors_factory()
                    if config.connectors_factory else None
                ),
            )
            for i in range(config.num_env_runners)
        ]
        # Driver-side copies on the config's device: the target net and
        # the online net used for the double-DQN argmax and PER priority
        # refresh (synced once per iteration — the same one-iteration
        # staleness the reference's async variants accept).
        self.device = resolve_device(config.device)
        self._target_net = module_factory().to(self.device)
        self._online_net = module_factory().to(self.device)
        self.target_params = self.learner_group.get_weights()
        self._online_params = self.target_params
        self._np_rng = np.random.default_rng(config.seed + 31)
        self._iteration = 0
        self._broadcast_weights()

    @property
    def target_params(self):
        return self._target_weights

    @target_params.setter
    def target_params(self, weights):
        self._target_weights = weights
        self._target_net.set_weights(weights)

    @property
    def _online_params(self):
        return self._online_weights

    @_online_params.setter
    def _online_params(self, weights):
        self._online_weights = weights
        self._online_net.set_weights(weights)

    def _fwd(self, net, obs: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            out = net(torch.from_numpy(np.ascontiguousarray(obs))
                      .to(self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _broadcast_weights(self, weights=None):
        if weights is None:
            weights = self.learner_group.get_weights()
        rt.get([r.set_weights.remote(weights) for r in self.env_runners],
               timeout=300)

    def _checkpoint_extra_state(self):
        return {
            "target_params": self.target_params,
            "online_params": self._online_params,
        }

    def _restore_extra_state(self, extra):
        # Through the setters: the target and online nets load the
        # checkpoint's numpy trees onto self.device, wherever they were
        # saved from.
        if "target_params" in extra:
            self.target_params = extra["target_params"]
        if "online_params" in extra:
            self._online_params = extra["online_params"]

    def _epsilon(self) -> float:
        cfg = self.config
        if cfg.noisy:
            return 0.0  # exploration is the head's learned noise
        frac = min(1.0, self._iteration / max(cfg.epsilon_decay_iters, 1))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def _per_beta(self) -> float:
        cfg = self.config
        frac = min(1.0, self._iteration / max(cfg.per_beta_iters, 1))
        return cfg.per_beta_start + frac * (1.0 - cfg.per_beta_start)

    # -- replay interface (overridden by APEX's sharded replay actors) ----
    def _make_buffer(self):
        config = self.config
        buffer_cls = (
            PrioritizedReplayBuffer if config.prioritized_replay
            else ReplayBuffer
        )
        buffer_kwargs = dict(seed=config.seed, store_discounts=True)
        if config.prioritized_replay:
            buffer_kwargs["alpha"] = config.per_alpha
        return buffer_cls(
            config.buffer_capacity,
            config.obs_shape if config.obs_shape is not None
            else config.obs_dim,
            **buffer_kwargs,
        )

    def _collect(self, eps: float):
        rollouts = rt.get(
            [r.sample.remote(eps) for r in self.env_runners], timeout=600
        )
        for b in rollouts:
            self.buffer.add_batch(b)

    def _buffer_size(self) -> int:
        return len(self.buffer)

    def _sample_minibatch(self, beta: float):
        if self.config.prioritized_replay:
            return self.buffer.sample(self.config.train_batch_size, beta=beta)
        return self.buffer.sample(self.config.train_batch_size)

    def _update_priorities(self, mb, td_abs: np.ndarray):
        self.buffer.update_priorities(mb["indices"], td_abs)

    def _episode_stats(self):
        return rt.get(
            [r.episode_stats.remote() for r in self.env_runners], timeout=300
        )

    def _report_epsilon(self, eps: float):
        """What the 'epsilon' result key reports (APEX overrides: its
        runners keep a fixed exploration ladder, not this schedule)."""
        return eps

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        eps = self._epsilon()
        # 1. parallel epsilon-greedy collection into the replay buffer
        self._collect(eps)
        metrics: Dict[str, float] = {}
        # 2. TD updates once the buffer warms up
        if self._buffer_size() >= cfg.learning_starts:
            beta = self._per_beta()
            # Hard target sync BEFORE the update loop, from the pre-loop
            # online snapshot; _online_params then refreshes from the
            # learner mid-loop so the double-DQN argmax net trains away
            # from the frozen target instead of mirroring it all
            # iteration.
            if self._iteration % cfg.target_update_freq == 0:
                self.target_params = self._online_params
            refresh = max(1, cfg.updates_per_iteration // 4)
            for u in range(cfg.updates_per_iteration):
                if u and u % refresh == 0 and (
                    cfg.double_q or cfg.prioritized_replay
                ):
                    self._online_params = self.learner_group.get_weights()
                mb = self._sample_minibatch(beta)
                if mb is None:  # sharded replay still warming up
                    continue
                B = len(mb["obs"])
                out_t = self._fwd(self._target_net, mb["next_obs"])
                next_q_t = out_t["q_values"]
                # One fused online-net forward serves both the double-DQN
                # argmax (next_obs half) and the PER priority refresh
                # (obs half).
                if cfg.double_q or cfg.prioritized_replay:
                    q_on = self._fwd(
                        self._online_net,
                        np.concatenate([mb["obs"], mb["next_obs"]]),
                    )["q_values"]
                    q_on_obs, q_on_next = q_on[:B], q_on[B:]
                if cfg.double_q:
                    # Double DQN: online net picks the action, target net
                    # evaluates it (van Hasselt 2016).
                    a_star = q_on_next.argmax(axis=-1)
                else:
                    a_star = next_q_t.argmax(axis=-1)
                if cfg.distributional:
                    # C51: project the bootstrapped distribution of the
                    # chosen next action onto the fixed support.
                    support = self.module.support.numpy()
                    next_probs = out_t["q_probs"][np.arange(B), a_star]
                    target_probs = categorical_projection(
                        next_probs, support,
                        mb["rewards"], mb["discounts"], mb["dones"],
                    )
                    targets = (target_probs * support).sum(-1)  # scalar expectations, for PER priorities
                    batch = {
                        "obs": mb["obs"],
                        "actions": mb["actions"],
                        "target_probs": target_probs,
                    }
                else:
                    next_val = np.take_along_axis(
                        next_q_t, a_star[:, None], axis=-1
                    )[:, 0]
                    targets = mb["rewards"] + mb["discounts"] * (
                        1.0 - mb["dones"]
                    ) * next_val
                    batch = {
                        "obs": mb["obs"],
                        "actions": mb["actions"],
                        "targets": targets.astype(np.float32),
                    }
                if cfg.noisy:
                    # One fresh factorized draw per update: sigma trains
                    # against real noise, actions decorrelate per batch.
                    width = self._online_params["mu_w"].shape[0]
                    batch["eps_in"], batch["eps_out"] = factorized_noise_np(
                        self._np_rng, width, cfg.num_actions
                    )
                if cfg.prioritized_replay:
                    batch["weights"] = mb["weights"]
                    q_sa = np.take_along_axis(
                        q_on_obs,
                        mb["actions"][:, None].astype(np.int64), axis=-1,
                    )[:, 0]
                    self._update_priorities(mb, np.abs(q_sa - targets))
                metrics = self.learner_group.update_from_batch(batch)
            # 3. runner weight broadcast (the fetch also refreshes the
            # online snapshot for the next iteration's sync).
            weights = self.learner_group.get_weights()
            self._online_params = weights
            self._broadcast_weights(weights)
        self._iteration += 1
        stats = self._episode_stats()
        returns = [s["mean_return"] for s in stats if s["episodes"] > 0]
        return self._finish_iteration({
            "training_iteration": self._iteration,
            "episode_return_mean": float(np.mean(returns)) if returns else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "epsilon": self._report_epsilon(eps),
            "buffer_size": self._buffer_size(),
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
