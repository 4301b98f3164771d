"""SAC: soft actor-critic for continuous control (the port of
ray_tpu/rl/algorithms/sac.py).

Reference analog: rllib/algorithms/sac (SACConfig/SAC + sac_learner's
three-part update). The update — the twin-critic TD loss against soft
targets, the reparameterized actor loss against the critics after their
Adam step, the automatic entropy temperature, and the polyak sync of the
critic targets — runs on the config's device (the card unless the
caller asks for the CPU) in the driver, as DQN's target nets do.

The state is the module (pi, q1, q2), a target copy of it whose q1 and
q2 move, log_alpha, and one `torch.optim.Adam` each for the actor, the
critics and the temperature (`optax.adam` in the JAX package). The
update's Gaussian draws are an input (`noise`): the JAX package draws
them inside its jitted update, and the same draws give the same update
in both packages.
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
    ContinuousModuleSpec,
    ContinuousPolicyModule,
)
from ray_tpu_torch.rl.env_runner import ContinuousTransitionRunner
from ray_tpu_torch.rl.replay import ReplayBuffer


def subtree(module, keys) -> Dict[str, torch.Tensor]:
    """The module's parameters under the top-level `keys`, by flat path
    (the paths of the JAX package's tree of those keys)."""
    tree = module.tree()
    if isinstance(keys, str):
        return convert.flatten(tree[keys])
    return convert.flatten({k: tree[k] for k in keys})


@torch.no_grad()
def polyak(target: Dict[str, torch.Tensor], online: Dict[str, torch.Tensor],
           tau: float) -> None:
    """target <- (1 - tau) * target + tau * online, leaf by leaf."""
    for k, t in target.items():
        t.copy_((1.0 - tau) * t + tau * online[k])


@torch.no_grad()
def load_subtree(module, weights: Dict) -> None:
    """Load the JAX-layout trees under some of the module's top-level
    keys."""
    ours = {k: module.tree()[k] for k in weights}
    theirs = {k: convert.leaf_from_jax(v)
              for k, v in convert.flatten(weights).items()}
    for p, t in convert.matched_leaves(ours, theirs):
        p.copy_(t)


def sample_batches(buffer, n: int, batch_size: int,
                   device) -> Dict[str, torch.Tensor]:
    """n minibatches drawn from `buffer` in turn (the draws n calls of
    `sample` make), stacked on a leading axis and moved to `device` in
    one copy a key."""
    mbs = [buffer.sample(batch_size) for _ in range(n)]
    return to_tensors({k: np.stack([m[k] for m in mbs]) for k in mbs[0]},
                      device)


# -- the update ---------------------------------------------------------------

def init_sac_state(module: ContinuousPolicyModule, lr: float) -> Dict[str, Any]:
    """The update's state around `module` (its device): the critic
    targets start as copies of the critics, log_alpha at 0. On the card
    the optimizers keep their step count there too (capturable), so an
    update can be replayed as a CUDA graph (`GraphedUpdates`)."""
    dtype = next(module.parameters()).dtype
    log_alpha = torch.zeros((), dtype=dtype, device=module.device,
                            requires_grad=True)
    cap = module.device.type == "cuda"
    return {
        "module": module,
        "target": copy.deepcopy(module).requires_grad_(False),
        "log_alpha": log_alpha,
        "pi_opt": adam(subtree(module, "pi").values(), lr, capturable=cap),
        "q_opt": adam(subtree(module, ("q1", "q2")).values(), lr,
                      capturable=cap),
        "alpha_opt": adam([log_alpha], lr, capturable=cap),
    }


def sac_state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The state as the JAX package's SAC state of numpy leaves (each
    optimizer's as {"count", "mu", "nu"})."""
    m = state["module"]
    return {
        "params": m.get_weights(),
        "target": convert.tree_to_jax(
            {k: state["target"].tree()[k] for k in ("q1", "q2")}),
        "log_alpha": convert.leaf_to_jax(state["log_alpha"]),
        "pi_opt": convert.adam_to_jax(state["pi_opt"], subtree(m, "pi")),
        "q_opt": convert.adam_to_jax(state["q_opt"],
                                     subtree(m, ("q1", "q2"))),
        "alpha_opt": convert.adam_to_jax(state["alpha_opt"],
                                         {"": state["log_alpha"]}),
    }


def load_sac_state(state: Dict[str, Any], jstate: Dict[str, Any]) -> None:
    """Load a SAC (or CQL) state of the JAX package (optax's states) or
    of `sac_state_to_jax` into `state` in place."""
    m = state["module"]
    m.set_weights(jstate["params"])
    load_subtree(state["target"], jstate["target"])
    with torch.no_grad():
        state["log_alpha"].copy_(convert.leaf_from_jax(jstate["log_alpha"]))
    convert.load_adam(state["pi_opt"], subtree(m, "pi"), jstate["pi_opt"])
    convert.load_adam(state["q_opt"], subtree(m, ("q1", "q2")),
                      jstate["q_opt"])
    convert.load_adam(state["alpha_opt"], {"": state["log_alpha"]},
                      jstate["alpha_opt"])


def soft_td_target(state, batch, eps_next, gamma: float, alpha):
    """r + gamma (1 - done) (min target Q(s', a') - alpha logp(a'|s')),
    a' drawn by the current actor with the draw `eps_next`."""
    module = state["module"]
    with torch.no_grad():
        next_a, next_logp = module.sample_with_logp(batch["next_obs"],
                                                    eps=eps_next)
        tq1, tq2 = state["target"].q_values(batch["next_obs"], next_a)
        soft_next = torch.minimum(tq1, tq2) - alpha * next_logp
        return batch["rewards"] + gamma * (1.0 - batch["dones"]) * soft_next


def actor_and_temperature_step(state, batch, eps_pi, alpha, tau: float,
                               target_entropy: float):
    """The actor's step against the (already updated) critics, the
    temperature's on that pass's log-probs, then the critic targets'
    polyak sync. Returns (actor loss, alpha loss, logp)."""
    module, log_alpha = state["module"], state["log_alpha"]
    a, logp = module.sample_with_logp(batch["obs"], eps=eps_pi)
    q1, q2 = module.q_values(batch["obs"], a)
    pi_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
    step(state["pi_opt"], subtree(module, "pi").values(), pi_loss)
    logp = logp.detach()
    alpha_loss = -(log_alpha.exp() * (logp + target_entropy)).mean()
    step(state["alpha_opt"], [log_alpha], alpha_loss)
    polyak(subtree(state["target"], ("q1", "q2")),
           subtree(module, ("q1", "q2")), tau)
    return pi_loss.detach(), alpha_loss.detach(), logp


def make_sac_update(gamma: float, tau: float, target_entropy: float):
    """The SAC update: `update(state, batch, noise)` advances `state` in
    place and returns its metrics as tensors. `noise` holds the two
    standard normal draws of shape [B, action_dim]: "next" for the
    target's next actions, "pi" for the actor loss's."""

    def update(state, batch, noise):
        module = state["module"]
        alpha = state["log_alpha"].detach().exp()
        td_target = soft_td_target(state, batch, noise["next"], gamma, alpha)
        q1, q2 = module.q_values(batch["obs"], batch["actions"])
        q_loss = ((q1 - td_target) ** 2).mean() + \
            ((q2 - td_target) ** 2).mean()
        step(state["q_opt"], subtree(module, ("q1", "q2")).values(), q_loss)
        pi_loss, alpha_loss, logp = actor_and_temperature_step(
            state, batch, noise["pi"], alpha, tau, target_entropy)
        return {
            "q_loss": q_loss.detach(),
            "actor_loss": pi_loss,
            "alpha_loss": alpha_loss,
            "alpha": state["log_alpha"].detach().exp(),
            "entropy": -logp.mean(),
        }

    return update


class GraphedUpdates:
    """`update(batch, noise)` run many times on the card as replays of
    one captured CUDA graph: an update is a few hundred small launches
    whose host cost dwarfs their device time. The first three calls run
    eagerly on a side stream (they warm the ops and the optimizers'
    state up, and are real updates); the fourth is captured against
    static input buffers and every later one copies its minibatch and
    draws into those buffers and replays the graph. The replay runs the
    captured kernels on the same memory, so its results equal the eager
    update's. Anything that replaces the state's tensors (a restore)
    must drop the graph."""

    WARMUP = 3

    def __init__(self, update):
        self.update = update
        self.graph = None
        self._inputs = None
        self._metrics = None
        self._warm = 0

    def run(self, batches: Dict[str, torch.Tensor],
            noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update for each row of `batches` ([n, B, ...] tensors)
        and `noise` ([n, ...]); the last update's metrics."""
        n = len(noise)
        dev = noise.device
        m, i = {}, 0
        if self.graph is None:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                while self._warm < self.WARMUP and i < n:
                    m = self.update({k: v[i] for k, v in batches.items()},
                                    noise[i])
                    self._warm += 1
                    i += 1
            torch.cuda.current_stream(dev).wait_stream(side)
            if i == n:
                return m
            self._inputs = ({k: v[i].clone() for k, v in batches.items()},
                            noise[i].clone())
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._metrics = self.update(*self._inputs)
        static_batch, static_noise = self._inputs
        for j in range(i, n):
            for k, v in static_batch.items():
                v.copy_(batches[k][j])
            static_noise.copy_(noise[j])
            self.graph.replay()
        return {k: v.clone() for k, v in self._metrics.items()}


# -- the algorithm -------------------------------------------------------------

@dataclass
class SACConfig(ConfigEvalMixin):
    """Builder-style config (reference: SACConfig)."""

    env_creator: Optional[Callable] = None
    obs_dim: int = 3
    action_dim: int = 1
    action_low: float = -1.0
    action_high: float = 1.0
    hidden: tuple = (64, 64)
    num_env_runners: int = 1
    rollout_length: int = 200
    buffer_capacity: int = 100_000
    warmup_steps: int = 1_000
    batch_size: int = 128
    updates_per_iteration: int = 200
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    target_entropy: Optional[float] = None  # default: -action_dim
    seed: int = 0
    device: Optional[str] = None  # where the update runs; None: the card

    def environment(self, env_creator=None, obs_dim=None, action_dim=None,
                    action_low=None, action_high=None):
        for k, v in (("env_creator", env_creator), ("obs_dim", obs_dim),
                     ("action_dim", action_dim),
                     ("action_low", action_low),
                     ("action_high", action_high)):
            if v is not None:
                setattr(self, k, v)
        return self

    def env_runners(self, num_env_runners=None, rollout_length=None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_length is not None:
            self.rollout_length = rollout_length
        return self

    def training(self, lr=None, gamma=None, tau=None, batch_size=None,
                 updates_per_iteration=None, warmup_steps=None,
                 buffer_capacity=None, target_entropy=None, device=None):
        for k, v in (("lr", lr), ("gamma", gamma), ("tau", tau),
                     ("batch_size", batch_size),
                     ("updates_per_iteration", updates_per_iteration),
                     ("warmup_steps", warmup_steps),
                     ("buffer_capacity", buffer_capacity),
                     ("target_entropy", target_entropy),
                     ("device", device)):
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self) -> "SAC":
        return SAC(self)


def continuous_spec(config) -> ContinuousModuleSpec:
    return ContinuousModuleSpec(config.obs_dim, config.action_dim,
                                config.action_low, config.action_high,
                                tuple(config.hidden))


class OffPolicyContinuous(AlgorithmBase):
    """The collect -> replay -> updates loop SAC and TD3 share: one
    ContinuousTransitionRunner per `num_env_runners` on the CPU, a
    ReplayBuffer in the driver, the update on `self.device`."""

    def _start(self, config, module, module_factory, noise_seed: int):
        self.config = config
        self.device = module.device
        self.module = module
        self._module_factory = module_factory
        self.buffer = ReplayBuffer(
            config.buffer_capacity, config.obs_dim, seed=config.seed,
            action_dim=config.action_dim,
        )
        self.env_runners = [
            ContinuousTransitionRunner.options(num_cpus=0.5).remote(
                config.env_creator, module_factory,
                seed=config.seed + 1 + i,
                rollout_length=config.rollout_length,
            )
            for i in range(config.num_env_runners)
        ]
        self._gen = torch.Generator(device=self.device).manual_seed(noise_seed)
        self._steps_sampled = 0
        self._iteration = 0
        self._broadcast()

    def _broadcast(self):
        weights = self.module.get_weights()
        rt.get([r.set_weights.remote(weights) for r in self.env_runners],
               timeout=300)

    def _current_weights(self):
        return self.module.get_weights()

    def _checkpoint_extra_state(self):
        return {"steps_sampled": self._steps_sampled}

    def _restore_extra_state(self, extra):
        self._steps_sampled = extra.get("steps_sampled", self._steps_sampled)

    def _noise(self, n: int, batch_size: int) -> torch.Tensor:
        raise NotImplementedError

    def _run_updates(self, n: int) -> Dict[str, torch.Tensor]:
        """n updates on minibatches drawn in turn; the last one's metrics
        (tensors: the host reads them once)."""
        cfg = self.config
        batches = sample_batches(self.buffer, n, cfg.batch_size, self.device)
        noise = self._noise(n, cfg.batch_size)
        m = {}
        for i in range(n):
            m = self._update_one({k: v[i] for k, v in batches.items()},
                                 noise[i])
        return m

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        warm = self._steps_sampled < cfg.warmup_steps
        rollouts = rt.get(
            [r.sample.remote(random_actions=warm) for r in self.env_runners],
            timeout=600,
        )
        for b in rollouts:
            self.buffer.add_batch(b)
            self._steps_sampled += len(b["obs"])
        metrics: Dict[str, Any] = {}
        if self._steps_sampled >= cfg.warmup_steps:
            if cfg.updates_per_iteration:
                metrics = readback(self._run_updates(cfg.updates_per_iteration))
            self._broadcast()
        self._iteration += 1
        stats = rt.get(
            [r.episode_stats.remote() for r in self.env_runners], timeout=300
        )
        returns = [s["mean_return"] for s in stats if s["episodes"] > 0]
        return self._finish_iteration({
            "training_iteration": self._iteration,
            "episode_return_mean": float(np.mean(returns)) if returns else 0.0,
            "episodes_total": sum(s["episodes"] for s in stats),
            "steps_sampled": self._steps_sampled,
            **{f"learner/{k}": v for k, v in metrics.items()},
        })

    def stop(self):
        self.stop_eval_runners()
        for r in self.env_runners:
            try:
                rt.kill(r)
            except Exception:  # noqa: BLE001 — already gone
                pass


class SAC(OffPolicyContinuous):
    """Off-policy actor-critic loop: collect -> replay -> updates."""

    def __init__(self, config: SACConfig):
        assert config.env_creator is not None, "config.environment(...) first"
        spec = continuous_spec(config)
        module = ContinuousPolicyModule(spec).init(config.seed).to(
            resolve_device(config.device))
        self.state = init_sac_state(module, config.lr)
        tgt_ent = (
            config.target_entropy
            if config.target_entropy is not None
            else -float(config.action_dim)
        )
        self._update = make_sac_update(config.gamma, config.tau, tgt_ent)
        self._graphed = GraphedUpdates(self._update_one)
        self._start(config, module,
                    lambda s=spec: ContinuousPolicyModule(s), config.seed + 99)

    def _noise(self, n, batch_size):
        return torch.randn((n, 2, batch_size, self.config.action_dim),
                           generator=self._gen, device=self.device)

    def _update_one(self, batch, noise):
        return self._update(self.state, batch,
                            {"next": noise[0], "pi": noise[1]})

    def _run_updates(self, n):
        if self.device.type != "cuda":
            return super()._run_updates(n)
        cfg = self.config
        return self._graphed.run(
            sample_batches(self.buffer, n, cfg.batch_size, self.device),
            self._noise(n, cfg.batch_size))

    # AlgorithmBase state hooks: the whole SAC update state (params,
    # targets, temperature, all three optimizers) in the JAX layout.
    def _get_learner_state(self):
        return sac_state_to_jax(self.state)

    def _set_learner_state(self, state):
        load_sac_state(self.state, state)
        self._graphed = GraphedUpdates(self._update_one)
