"""RLModule: the neural policy/value container (the port of
ray_tpu/rl/core/rl_module.py).

Each module is an `nn.Module` whose parameters are laid out as the JAX
module's weight tree: a top-level key such as "pi" is a child holding
the list of dense layers, and `tree()` hands the forward functions that
nested dict/list view of the parameters. `get_weights` and
`set_weights` exchange the JAX layout as numpy arrays (conv kernels
HWIO; `rl.core.convert`), so env runners, learners and checkpoints move
plain arrays as in the JAX package, and a JAX module's parameters load
into the port's module of the same spec.

Construction draws parameters from a CPU generator seeded 0; `init(seed)`
draws them again in place (the role of the JAX module's `init(rng)`).
Sampling takes an explicit `torch.Generator`; the JAX package's
`jax.random` streams cannot be matched bit for bit, so noise that the
JAX API takes as arrays (NoisyNet's `eps_in`, `eps_out`) is the port's
input too, and the continuous module's Gaussian draw may be given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.conv import (ATARI_FILTERS, TINY_FILTERS,
                                       cnn_torso_forward, init_cnn_torso)
from ray_tpu_torch.models.mlp import generator, init_mlp, mlp_forward
from ray_tpu_torch.rl.core import convert


@dataclass(frozen=True)
class RLModuleSpec:
    """Analog of RLModuleSpec: architecture + spaces."""

    obs_dim: int
    num_actions: int
    hidden: Tuple[int, ...] = (64, 64)


@dataclass(frozen=True)
class ConvModuleSpec:
    """Spec for image-observation modules: obs are (H, W, C) float
    frames; conv_filters is (out_ch, kernel, stride) per layer."""

    obs_shape: Tuple[int, int, int]
    num_actions: int
    conv_filters: Tuple[Tuple[int, int, int], ...] = TINY_FILTERS
    feature_dim: int = 128
    hidden: Tuple[int, ...] = (64,)


class _Tree(nn.Module):
    """One inner node of a weight tree: dict keys or list indices name
    its parameters and child nodes."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        self._keys = []
        for k, v in (enumerate(tree) if self._is_list else tree.items()):
            _attach(self, str(k), v)

    def tree(self):
        vals = [_view(getattr(self, k)) for k in self._keys]
        return vals if self._is_list else dict(zip(self._keys, vals))


def _attach(owner: nn.Module, key: str, value) -> None:
    if isinstance(value, torch.Tensor):
        owner.register_parameter(key, nn.Parameter(value))
    else:
        owner.add_module(key, _Tree(value))
    owner._keys.append(key)


def _view(node):
    return node.tree() if isinstance(node, _Tree) else node


class RLModule(nn.Module):
    """Base of the port's modules: the weight tree, `init`, and the
    JAX-layout weight exchange."""

    def __init__(self, spec):
        super().__init__()
        self.spec = spec
        self._keys = []
        for k, v in self._init_tree(generator(0)).items():
            _attach(self, k, v)

    def _init_tree(self, gen: torch.Generator) -> Dict:
        raise NotImplementedError

    def tree(self) -> Dict:
        """The parameters as the JAX module's tree (torch layout)."""
        return {k: _view(getattr(self, k)) for k in self._keys}

    def init(self, seed: int = 0) -> "RLModule":
        """Draw the parameters again from a generator seeded `seed`."""
        fresh = self._init_tree(generator(seed))
        with torch.no_grad():
            for p, t in convert.matched_leaves(self.tree(), fresh):
                p.copy_(t)
        return self

    def get_weights(self) -> Dict:
        """The parameters as the JAX layout's numpy tree."""
        return convert.tree_to_jax(self.tree())

    def set_weights(self, weights) -> None:
        """Load a JAX-layout tree (numpy or jax leaves) in place."""
        theirs = {k: convert.leaf_from_jax(v)
                  for k, v in convert.flatten(weights).items()}
        with torch.no_grad():
            for p, t in convert.matched_leaves(self.tree(), theirs):
                p.copy_(t)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def _categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=gen).reshape(logits.shape[:-1])


def _chosen(logp_all: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    return logp_all.gather(-1, action.long()[..., None])[..., 0]


class DiscretePolicyModule(RLModule):
    """Separate policy and value MLP towers over a shared spec."""

    def _init_tree(self, gen):
        sizes = [self.spec.obs_dim, *self.spec.hidden]
        return {
            "pi": init_mlp(gen, sizes + [self.spec.num_actions]),
            "vf": init_mlp(gen, sizes + [1]),
        }

    def forward(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.tree()
        logits = mlp_forward(p["pi"], obs)
        value = mlp_forward(p["vf"], obs)[..., 0]
        return {"action_logits": logits, "value": value}

    def action_dist(self, logits: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(logits, dim=-1)

    def sample_action(self, obs: torch.Tensor, gen: torch.Generator):
        out = self.forward(obs)
        action = _categorical(out["action_logits"], gen)
        logp = F.log_softmax(out["action_logits"], dim=-1)
        return action, _chosen(logp, action), out["value"]


def filters_for(obs_shape, conv_filters=None):
    """Resolution-based default conv filters: explicit filters win; else
    Atari-scale frames (>=64px) get the 3-layer Nature-CNN stack, tiny
    test frames the 2-layer stack."""
    if conv_filters is not None:
        return tuple(conv_filters)
    return (ATARI_FILTERS
            if min(obs_shape[0], obs_shape[1]) >= 64 else TINY_FILTERS)


class ConvPolicyModule(DiscretePolicyModule):
    """Conv torso + policy/value heads for image observations. One shared
    torso feeds both heads; sampling and the action distribution are
    inherited: they only consume forward()."""

    def _init_tree(self, gen):
        feat = self.spec.feature_dim
        sizes = [feat, *self.spec.hidden]
        return {
            "torso": init_cnn_torso(gen, self.spec.obs_shape,
                                    self.spec.conv_filters, out_dim=feat),
            "pi": init_mlp(gen, sizes + [self.spec.num_actions]),
            "vf": init_mlp(gen, sizes + [1]),
        }

    def forward(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.tree()
        feats = cnn_torso_forward(p["torso"], obs, self.spec.conv_filters)
        return {
            "action_logits": mlp_forward(p["pi"], feats),
            "value": mlp_forward(p["vf"], feats)[..., 0],
        }


class QNetworkModule(RLModule):
    """Q-network for value-based algorithms (DQN family): an MLP mapping
    observations to per-action Q values, epsilon-greedy for collection."""

    def _init_tree(self, gen):
        sizes = [self.spec.obs_dim, *self.spec.hidden]
        return {"q": init_mlp(gen, sizes + [self.spec.num_actions])}

    def forward(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"q_values": mlp_forward(self.tree()["q"], obs)}

    def sample_action(self, obs: torch.Tensor, gen: torch.Generator,
                      epsilon: float = 0.0):
        q = self.forward(obs)["q_values"]
        greedy = q.argmax(dim=-1)
        random_a = torch.randint(0, self.spec.num_actions, greedy.shape,
                                 generator=gen, device=greedy.device)
        explore = torch.rand(greedy.shape, generator=gen,
                             device=greedy.device) < epsilon
        return torch.where(explore, random_a, greedy)


class ConvQNetworkModule(QNetworkModule):
    """Conv torso + Q head for image observations (pixel DQN).
    Epsilon-greedy sampling is inherited."""

    def _init_tree(self, gen):
        feat = self.spec.feature_dim
        return {
            "torso": init_cnn_torso(gen, self.spec.obs_shape,
                                    self.spec.conv_filters, out_dim=feat),
            "q": init_mlp(gen, [feat, *self.spec.hidden,
                                self.spec.num_actions]),
        }

    def forward(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.tree()
        feats = cnn_torso_forward(p["torso"], obs, self.spec.conv_filters)
        return {"q_values": mlp_forward(p["q"], feats)}


class DuelingQNetworkModule(QNetworkModule):
    """Dueling Q-network (Wang et al. 2016): a shared trunk feeding value
    and advantage streams, Q = V + A - mean(A)."""

    def _init_tree(self, gen):
        if not self.spec.hidden:
            raise ValueError(
                "DuelingQNetworkModule needs at least one hidden layer "
                "(the value/advantage streams branch off the trunk)"
            )
        width = self.spec.hidden[-1]
        return {
            "trunk": init_mlp(gen, [self.spec.obs_dim, *self.spec.hidden]),
            "v": init_mlp(gen, [width, 1]),
            "a": init_mlp(gen, [width, self.spec.num_actions]),
        }

    def forward(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.tree()
        h = torch.relu(mlp_forward(p["trunk"], obs))
        v = mlp_forward(p["v"], h)
        a = mlp_forward(p["a"], h)
        return {"q_values": v + a - a.mean(dim=-1, keepdim=True)}


def _signed_sqrt(x):
    return x.sign() * x.abs().sqrt()


def factorized_noise(gen: torch.Generator, n_in: int, n_out: int,
                     device=None):
    """Factorized Gaussian noise (Fortunato et al. 2017): two vectors
    through f(x) = sign(x)*sqrt(|x|) whose outer product is the
    weight-noise matrix."""
    return (_signed_sqrt(torch.randn(n_in, generator=gen, device=device)),
            _signed_sqrt(torch.randn(n_out, generator=gen, device=device)))


def factorized_noise_np(rng, n_in: int, n_out: int):
    """Numpy twin of factorized_noise for driver-side batch assembly
    (same transform; keep the two in lockstep)."""
    f = lambda x: np.sign(x) * np.sqrt(np.abs(x))  # noqa: E731
    return (
        f(rng.standard_normal(n_in)).astype(np.float32),
        f(rng.standard_normal(n_out)).astype(np.float32),
    )


class NoisyQNetworkModule(QNetworkModule):
    """Q-network with a NoisyNet output layer: w = mu + sigma * (eps_out ⊗
    eps_in). The noise vectors are inputs, so the learner's loss trains
    sigma through the same batch plumbing."""

    SIGMA0 = 0.5

    def _init_tree(self, gen):
        if not self.spec.hidden:
            raise ValueError(
                "NoisyQNetworkModule needs at least one hidden layer "
                "(the noisy head sits atop the trunk)"
            )
        sizes = [self.spec.obs_dim, *self.spec.hidden]
        width = sizes[-1]
        A = self.spec.num_actions
        bound = width ** -0.5
        trunk = init_mlp(gen, sizes)
        return {
            "trunk": trunk,
            "mu_w": torch.rand((width, A), generator=gen) * 2 * bound - bound,
            "mu_b": torch.rand((A,), generator=gen) * 2 * bound - bound,
            "sigma_w": torch.full((width, A), self.SIGMA0 * bound),
            "sigma_b": torch.full((A,), self.SIGMA0 * bound),
        }

    def forward(self, obs: torch.Tensor, noise=None) -> Dict[str, torch.Tensor]:
        """noise = (eps_in (width,), eps_out (A,)) or None for the
        deterministic mu-only head (target computation, evaluation)."""
        p = self.tree()
        h = torch.relu(mlp_forward(p["trunk"], obs))
        w, b = p["mu_w"], p["mu_b"]
        if noise is not None:
            eps_in, eps_out = noise
            w = w + p["sigma_w"] * (eps_in[:, None] * eps_out[None, :])
            b = b + p["sigma_b"] * eps_out
        return {"q_values": h @ w + b}

    def sample_action(self, obs: torch.Tensor, gen: torch.Generator,
                      epsilon: float = 0.0):
        """One fresh factorized draw per call; epsilon is ignored."""
        width = self.mu_w.shape[0]
        noise = factorized_noise(gen, width, self.spec.num_actions,
                                 device=obs.device)
        return self.forward(obs, noise=noise)["q_values"].argmax(dim=-1)


class C51QNetworkModule(QNetworkModule):
    """Categorical distributional Q-network (Bellemare et al. 2017):
    logits over num_atoms fixed support atoms per action; q_values are
    the expectations under the softmax distribution."""

    def __init__(self, spec: RLModuleSpec, num_atoms: int = 51,
                 v_min: float = -10.0, v_max: float = 10.0):
        self.num_atoms = num_atoms
        super().__init__(spec)
        self.register_buffer("support",
                             torch.linspace(v_min, v_max, num_atoms),
                             persistent=False)

    def _init_tree(self, gen):
        sizes = [self.spec.obs_dim, *self.spec.hidden]
        return {"q": init_mlp(gen, sizes + [self.spec.num_actions
                                            * self.num_atoms])}

    def forward(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        flat = mlp_forward(self.tree()["q"], obs)
        logits = flat.reshape(*flat.shape[:-1], self.spec.num_actions,
                              self.num_atoms)
        probs = torch.softmax(logits, dim=-1)
        return {"q_logits": logits, "q_probs": probs,
                "q_values": (probs * self.support).sum(-1)}


def _sech2(x: torch.Tensor) -> torch.Tensor:
    """1 - tanh(x)^2 without the cancellation: 4 e^-2|x| / (1 + e^-2|x|)^2.
    The JAX package takes 1 - a^2 of the rounded tanh, where one ulp of
    a near |x| = 8 moves log(1 - a^2 + 1e-6) by up to 0.39 (ROADMAP §C);
    both equal log(sech^2 x + 1e-6) in exact arithmetic."""
    t = torch.exp(-2.0 * x.abs())
    return 4.0 * t / (1.0 + t) ** 2


@dataclass(frozen=True)
class ContinuousModuleSpec:
    """Spec for continuous-control modules (SAC family)."""

    obs_dim: int
    action_dim: int
    action_low: float = -1.0
    action_high: float = 1.0
    hidden: Tuple[int, ...] = (64, 64)


class ContinuousPolicyModule(RLModule):
    """Tanh-squashed Gaussian policy + twin Q towers (SAC's module).
    Internally actions live in [-1, 1]; `scale_action` maps to the env's
    [low, high]. Q towers consume (obs, normalized action)."""

    LOG_STD_MIN = -5.0
    LOG_STD_MAX = 2.0

    def _init_tree(self, gen):
        sizes = [self.spec.obs_dim, *self.spec.hidden]
        qin = self.spec.obs_dim + self.spec.action_dim
        qsizes = [qin, *self.spec.hidden, 1]
        return {
            "pi": init_mlp(gen, sizes + [2 * self.spec.action_dim]),
            "q1": init_mlp(gen, qsizes),
            "q2": init_mlp(gen, qsizes),
        }

    def scale_action(self, a_norm):
        lo, hi = self.spec.action_low, self.spec.action_high
        return a_norm * (hi - lo) / 2.0 + (hi + lo) / 2.0

    def _dist(self, obs: torch.Tensor):
        out = mlp_forward(self.tree()["pi"], obs)
        mu, log_std = out.chunk(2, dim=-1)
        return mu, log_std.clamp(self.LOG_STD_MIN, self.LOG_STD_MAX)

    def sample_with_logp(self, obs: torch.Tensor, gen: torch.Generator = None,
                         eps: torch.Tensor = None):
        """Reparameterized tanh-Gaussian sample + its log-prob. `eps`, the
        standard normal draw, is drawn from `gen` unless given; a draw of
        shape [K, B, d] against obs [B, D] samples K actions a state."""
        mu, log_std = self._dist(obs)
        if eps is None:
            eps = torch.randn(mu.shape, generator=gen, device=mu.device)
        pre = mu + log_std.exp() * eps
        a = torch.tanh(pre)
        # N(pre; mu, std) log-density with the tanh change of variables.
        gauss_logp = (-0.5 * eps ** 2 - log_std
                      - 0.5 * float(np.log(2.0 * np.pi))).sum(-1)
        return a, gauss_logp - torch.log(_sech2(pre) + 1e-6).sum(-1)

    def deterministic_action(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self._dist(obs)[0])

    def q_values(self, obs: torch.Tensor, a_norm: torch.Tensor):
        p = self.tree()
        x = torch.cat([obs, a_norm], dim=-1)
        return (mlp_forward(p["q1"], x)[..., 0],
                mlp_forward(p["q2"], x)[..., 0])

    def forward(self, obs: torch.Tensor):
        return {"action": self.deterministic_action(obs)}

    def sample_action(self, obs: torch.Tensor, gen: torch.Generator):
        """EnvRunner-facing: scaled action, logp, dummy value."""
        a, logp = self.sample_with_logp(obs, gen)
        return self.scale_action(a), logp, torch.zeros(obs.shape[0])


@dataclass(frozen=True)
class RecurrentModuleSpec:
    """Spec for stateful (recurrent) policies: the policy carries a
    hidden state across steps, reset at episode boundaries, and the
    learner replays sequences from the state each window started with."""

    obs_dim: int
    num_actions: int
    state_dim: int = 32
    hidden: Tuple[int, ...] = (32,)


class RecurrentPolicyModule(RLModule):
    """GRU torso + policy/value heads: forward_step (one step, rollout
    time), forward_seq (a whole [B, T] window with done-resets, learner
    time), sample_action (returns the new state for the runner)."""

    def _gru(self, gen) -> Dict:
        d, h = self.spec.obs_dim, self.spec.state_dim
        return {
            # Fused GRU weights: [z | r | candidate].
            "gru_w": torch.randn((d, 3 * h), generator=gen) * (1.0 / d) ** 0.5,
            "gru_u": torch.randn((h, 3 * h), generator=gen) * (1.0 / h) ** 0.5,
            "gru_b": torch.zeros((3 * h,)),
        }

    def _init_tree(self, gen):
        sizes = [self.spec.state_dim, *self.spec.hidden]
        return {**self._gru(gen),
                "pi": init_mlp(gen, sizes + [self.spec.num_actions]),
                "vf": init_mlp(gen, sizes + [1])}

    def initial_state(self, batch: int = 1) -> torch.Tensor:
        return torch.zeros((batch, self.spec.state_dim), device=self.device)

    def _cell(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One GRU step: x [B, D], h [B, H] -> h' [B, H]."""
        H = self.spec.state_dim
        gx = x @ self.gru_w + self.gru_b
        gh = h @ self.gru_u
        z = torch.sigmoid(gx[:, :H] + gh[:, :H])
        r = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
        cand = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
        return (1.0 - z) * h + z * cand

    def _heads(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = self.tree()
        return {"action_logits": mlp_forward(p["pi"], h),
                "value": mlp_forward(p["vf"], h)[..., 0]}

    def forward_step(self, obs: torch.Tensor, state: torch.Tensor):
        h = self._cell(obs, state)
        return self._heads(h), h

    forward = forward_step

    def forward_seq(self, obs: torch.Tensor, state0: torch.Tensor,
                    dones: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Replay a [B, T] window as it was collected: the state enters
        as state0 and resets to zero AFTER any step whose done flag is
        set, as the runner zeroes its state when the env resets."""
        h = state0
        hs = []
        for t in range(obs.shape[1]):
            if t:
                h = h * (1.0 - dones[:, t - 1])[:, None]
            h = self._cell(obs[:, t], h)
            hs.append(h)
        return self._heads(torch.stack(hs, dim=1))

    def sample_action(self, obs: torch.Tensor, gen: torch.Generator,
                      state: torch.Tensor):
        out, h = self.forward_step(obs, state)
        action = _categorical(out["action_logits"], gen)
        logp = F.log_softmax(out["action_logits"], dim=-1)
        return action, _chosen(logp, action), out["value"], h


class RecurrentQNetworkModule(RecurrentPolicyModule):
    """GRU torso + Q head (R2D2's network shape): the GRU cell and state
    plumbing of the policy variant, Q values for heads."""

    def _init_tree(self, gen):
        h = self.spec.state_dim
        return {**self._gru(gen),
                "q": init_mlp(gen, [h, *self.spec.hidden,
                                    self.spec.num_actions])}

    def _heads(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"q_values": mlp_forward(self.tree()["q"], h)}

    def sample_action(self, obs: torch.Tensor, gen: torch.Generator,
                      state: torch.Tensor, epsilon: float = 0.0):
        out, h = self.forward_step(obs, state)
        greedy = out["q_values"].argmax(dim=-1)
        random_a = torch.randint(0, self.spec.num_actions, greedy.shape,
                                 generator=gen, device=greedy.device)
        explore = torch.rand(greedy.shape, generator=gen,
                             device=greedy.device) < epsilon
        return torch.where(explore, random_a, greedy), h
