"""CQL: conservative Q-learning for offline continuous control (the port
of ray_tpu/rl/algorithms/cql.py).

Reference analog: rllib/algorithms/cql/ (CQLConfig/CQL layered on SAC).
Kumar et al. 2020's CQL(H): the SAC twin-critic update plus a
conservative penalty that pushes Q down on out-of-distribution actions
(importance-sampled logsumexp over random + policy actions) and up on
dataset actions. Like the reference it is offline-first: training
consumes a transition Dataset (episodes_to_dataset rows with
obs/actions/rewards/next_obs/dones), no env interaction.

The update runs on the config's device with SAC's state and helpers.
Its draws are inputs: where the JAX package splits a key K ways and
vmaps the policy over them, the port takes one [K, B, d] draw for the
current states' candidates and one for the next states', and one
[K, B, d] uniform draw of random actions; the 3K candidates' Q values
come from one tower pass of K * B rows each.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.algorithms.sac import (
    actor_and_temperature_step,
    continuous_spec,
    init_sac_state,
    soft_td_target,
    subtree,
)
from ray_tpu_torch.rl.core.learner import readback, step, to_tensors
from ray_tpu_torch.rl.core.rl_module import ContinuousPolicyModule


def make_cql_update(gamma: float, tau: float, target_entropy: float,
                    cql_alpha: float, num_candidates: int):
    """The CQL update: `update(state, batch, noise)` on SAC's state.
    `noise`: "next" and "pi" [B, d] standard normal draws as SAC's;
    "rand" [K, B, d] uniform actions in [-1, 1); "cur" and "nxt"
    [K, B, d] standard normal draws for the candidates at s and s'."""
    K = num_candidates
    log_3k = math.log(3 * K)

    def tiled_q(module, obs, actions):
        """Q towers over K candidate actions a state: actions [K, B, d];
        two [K, B] grids from one pass of K * B rows."""
        B = actions.shape[1]
        obs_t = obs[None].expand(K, B, obs.shape[-1])
        q1, q2 = module.q_values(obs_t.reshape(K * B, -1),
                                 actions.reshape(K * B, -1))
        return q1.reshape(K, B), q2.reshape(K, B)

    def update(state, batch, noise):
        module = state["module"]
        d = module.spec.action_dim
        log_unif = -d * math.log(2.0)  # uniform density over [-1, 1]^d
        alpha = state["log_alpha"].detach().exp()
        td_target = soft_td_target(state, batch, noise["next"], gamma, alpha)
        with torch.no_grad():
            a_cur, logp_cur = module.sample_with_logp(batch["obs"],
                                                      eps=noise["cur"])
            a_nxt, logp_nxt = module.sample_with_logp(batch["next_obs"],
                                                      eps=noise["nxt"])
        q1, q2 = module.q_values(batch["obs"], batch["actions"])
        td_loss = ((q1 - td_target) ** 2).mean() + \
            ((q2 - td_target) ** 2).mean()
        # CQL(H): importance-sampled logsumexp over {uniform, pi(.|s),
        # pi(.|s')} candidates, minus log(3K), minus the dataset Q.
        r1, r2 = tiled_q(module, batch["obs"], noise["rand"])
        c1, c2 = tiled_q(module, batch["obs"], a_cur)
        n1, n2 = tiled_q(module, batch["obs"], a_nxt)
        cat1 = torch.cat([r1 - log_unif, c1 - logp_cur, n1 - logp_nxt])
        cat2 = torch.cat([r2 - log_unif, c2 - logp_cur, n2 - logp_nxt])
        gap1 = torch.logsumexp(cat1, dim=0) - log_3k - q1
        gap2 = torch.logsumexp(cat2, dim=0) - log_3k - q2
        cql_loss = cql_alpha * (gap1.mean() + gap2.mean())
        q_loss = td_loss + cql_loss
        step(state["q_opt"], subtree(module, ("q1", "q2")).values(), q_loss)
        pi_loss, alpha_loss, logp = actor_and_temperature_step(
            state, batch, noise["pi"], alpha, tau, target_entropy)
        return {
            "q_loss": q_loss.detach(),
            "td_loss": td_loss.detach(),
            "cql_loss": cql_loss.detach(),
            "actor_loss": pi_loss,
            "alpha_loss": alpha_loss,
            "alpha": state["log_alpha"].detach().exp(),
            "entropy": -logp.mean(),
        }

    return update


@dataclass
class CQLConfig:
    """Builder-style config (reference: CQLConfig extends SACConfig)."""

    obs_dim: int = 3
    action_dim: int = 1
    action_low: float = -1.0
    action_high: float = 1.0
    hidden: tuple = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    target_entropy: Optional[float] = None  # default: -action_dim
    cql_alpha: float = 5.0
    num_candidate_actions: int = 4  # K per candidate family (3K total)
    minibatch_size: int = 128
    seed: int = 0
    device: Optional[str] = None  # where the update runs; None: the card

    def module(self, obs_dim=None, action_dim=None, action_low=None,
               action_high=None, hidden=None):
        for k, v in (("obs_dim", obs_dim), ("action_dim", action_dim),
                     ("action_low", action_low),
                     ("action_high", action_high), ("hidden", hidden)):
            if v is not None:
                setattr(self, k, v)
        return self

    def training(self, lr=None, gamma=None, tau=None, cql_alpha=None,
                 num_candidate_actions=None, minibatch_size=None,
                 target_entropy=None, device=None):
        for k, v in (("lr", lr), ("gamma", gamma), ("tau", tau),
                     ("cql_alpha", cql_alpha),
                     ("num_candidate_actions", num_candidate_actions),
                     ("minibatch_size", minibatch_size),
                     ("target_entropy", target_entropy),
                     ("device", device)):
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self) -> "CQL":
        return CQL(self)


def _stack_rows(batch) -> Dict[str, np.ndarray]:
    """A numpy batch of transition rows whose values may arrive as object
    arrays of per-row arrays, stacked into f32 arrays."""
    def stack(col):
        return np.stack([np.asarray(x, dtype=np.float32) for x in col])

    def flat(col):
        return np.asarray([float(x) for x in col], dtype=np.float32)

    return {"obs": stack(batch["obs"]), "actions": stack(batch["actions"]),
            "rewards": flat(batch["rewards"]),
            "next_obs": stack(batch["next_obs"]),
            "dones": flat(batch["dones"])}


class CQL:
    """Offline conservative Q-learning over a transition Dataset.

    Rows need obs/actions/rewards/next_obs/dones (normalized [-1, 1]
    actions, as ContinuousTransitionRunner stores and
    episodes_to_dataset preserves).
    """

    _BATCH_KEYS = ("obs", "actions", "rewards", "next_obs", "dones")

    def __init__(self, config: CQLConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.module = ContinuousPolicyModule(continuous_spec(config)).init(
            config.seed).to(self.device)
        self.state = init_sac_state(self.module, config.lr)
        tgt_ent = (
            config.target_entropy
            if config.target_entropy is not None
            else -float(config.action_dim)
        )
        self._update = make_cql_update(
            config.gamma, config.tau, tgt_ent,
            config.cql_alpha, config.num_candidate_actions,
        )
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed + 99)
        self._np_rng = np.random.default_rng(config.seed)

    def noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """One update's draws from the algorithm's generator."""
        K, d = self.config.num_candidate_actions, self.config.action_dim
        g, dev = self._gen, self.device
        return {
            "next": torch.randn((batch_size, d), generator=g, device=dev),
            "pi": torch.randn((batch_size, d), generator=g, device=dev),
            "rand": torch.rand((K, batch_size, d), generator=g,
                               device=dev) * 2.0 - 1.0,
            "cur": torch.randn((K, batch_size, d), generator=g, device=dev),
            "nxt": torch.randn((K, batch_size, d), generator=g, device=dev),
        }

    def _step(self, mb: Dict[str, np.ndarray]):
        tb = to_tensors(mb, self.device)
        return self._update(self.state, tb, self.noise(len(mb["obs"])))

    def train_on_batch(self, batch: Dict[str, np.ndarray],
                       num_epochs: int = 1) -> Dict[str, float]:
        """Minibatch epochs of the CQL update over materialized
        transition arrays."""
        n = len(batch["obs"])
        m = {}
        for _ in range(num_epochs):
            order = self._np_rng.permutation(n)
            for s in range(0, n, self.config.minibatch_size):
                idx = order[s:s + self.config.minibatch_size]
                m = self._step({k: batch[k][idx] for k in self._BATCH_KEYS})
        return readback(m) if m else {}

    def train_on_dataset(self, ds, num_epochs: int = 1) -> Dict[str, float]:
        """Streaming epochs through the Dataset executor (the reference's
        OfflineData iter_batches loop)."""
        m = {}
        for epoch in range(num_epochs):
            shuffled = ds.random_shuffle(seed=self.config.seed + epoch)
            for batch in shuffled.iter_batches(
                batch_size=self.config.minibatch_size, batch_format="numpy"
            ):
                m = self._step(_stack_rows(batch))
        return readback(m) if m else {}

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic (scaled) policy actions for evaluation."""
        with torch.inference_mode():
            a = self.module.deterministic_action(
                torch.as_tensor(np.asarray(obs, np.float32), device=self.device))
            return self.module.scale_action(a).cpu().numpy()
