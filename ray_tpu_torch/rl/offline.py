"""Offline RL: experience IO through the port's data library + behavior
cloning (the port of ray_tpu/rl/offline.py).

Analog of the reference's offline RL stack (rllib/offline/: JsonWriter /
JsonReader / the offline data input pipeline, and the BC/MARWIL algorithm
family under rllib/algorithms/bc/): collected episodes persist as a
distributed dataset (`ray_tpu_torch.data`), and offline algorithms train
policies straight from that dataset without touching an environment.
The learner computes on the config's device (the card unless the caller
asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import data as rt_data
from ray_tpu_torch.rl.core.learner import Learner, minibatch_epochs
from ray_tpu_torch.rl.core.rl_module import DiscretePolicyModule, RLModuleSpec


def episodes_to_dataset(rollouts: List[Dict[str, np.ndarray]],
                        gamma: Optional[float] = None):
    """Flatten sampled rollout batches into a row-per-transition Dataset
    (reference: JsonWriter writing SampleBatches, rllib/offline/json_writer.py).

    Each row carries obs/action plus whatever per-step fields the rollout
    had (logp, rewards, dones, ...) so downstream offline algorithms can
    pick what they need. With `gamma`, each row additionally gets
    "returns" — the discounted return-to-go within its episode — which
    return-conditioned offline algorithms (MARWIL) train against.
    """
    rows = []
    for b in rollouts:
        T = len(b["actions"])
        step_keys = [
            k for k, v in b.items()
            if isinstance(v, np.ndarray) and v.shape[:1] == (T,)
        ]
        returns = None
        if gamma is not None and "rewards" in b:
            returns = np.zeros(T, dtype=np.float32)
            acc = float(b.get("last_value", 0.0))
            dones = b.get("dones", np.zeros(T))
            for t in range(T - 1, -1, -1):
                if dones[t]:
                    acc = 0.0
                acc = float(b["rewards"][t]) + gamma * acc
                returns[t] = acc
        for t in range(T):
            row = {k: b[k][t] for k in step_keys}
            if returns is not None:
                row["returns"] = returns[t]
            rows.append(row)
    return rt_data.from_items(rows)


def dataset_to_batch(ds, keys=("obs", "actions")) -> Dict[str, np.ndarray]:
    """Materialize a transition Dataset into stacked numpy arrays
    (reference: JsonReader producing SampleBatches)."""
    rows = ds.take_all() if hasattr(ds, "take_all") else ds.take(ds.count())
    return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in keys}


def _logp_taken(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(logits, dim=-1).gather(
        -1, actions.long()[:, None])[:, 0]


def _accuracy(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == actions.long()).float().mean()


def bc_loss(module, batch):
    """Negative log-likelihood of the dataset actions (behavior cloning;
    reference: rllib/algorithms/bc/)."""
    logits = module(batch["obs"])["action_logits"]
    loss = -_logp_taken(logits, batch["actions"]).mean()
    return loss, {"total_loss": loss,
                  "accuracy": _accuracy(logits, batch["actions"])}


@dataclass
class BCConfig:
    """Builder-style config for behavior cloning from a Dataset."""

    obs_dim: int = 4
    num_actions: int = 2
    hidden: tuple = (64, 64)
    lr: float = 1e-3
    minibatch_size: int = 128
    seed: int = 0
    device: Optional[str] = None  # the learner's device; None: the card

    def module(self, obs_dim=None, num_actions=None, hidden=None):
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        if hidden is not None:
            self.hidden = hidden
        return self

    def training(self, lr=None, minibatch_size=None, device=None):
        if lr is not None:
            self.lr = lr
        if minibatch_size is not None:
            self.minibatch_size = minibatch_size
        if device is not None:
            self.device = device
        return self

    def build(self) -> "BC":
        return BC(self)


class BC:
    """Behavior cloning over an offline transition dataset."""

    _BATCH_KEYS = ("obs", "actions")

    def __init__(self, config: BCConfig):
        self.config = config
        spec = RLModuleSpec(config.obs_dim, config.num_actions, config.hidden)
        self.module = DiscretePolicyModule(spec)
        self.learner = Learner(self.module, self._loss(), seed=config.seed,
                               lr=config.lr, device=config.device)
        self._rng = np.random.default_rng(config.seed)

    def _loss(self):
        return bc_loss

    def train_on_dataset(self, ds, num_epochs: int = 1) -> Dict[str, float]:
        """Minibatch SGD epochs over the full dataset; returns the last
        update's metrics."""
        batch = dataset_to_batch(ds)
        return self.train_on_batch(batch, num_epochs)

    def train_on_batch(self, batch: Dict[str, np.ndarray],
                       num_epochs: int = 1) -> Dict[str, float]:
        # Float columns in float32, as the JAX package's jnp arrays take
        # them (a dataset's rows may come back as float64).
        batch = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
                 for k, v in batch.items() if k in self._BATCH_KEYS}
        return minibatch_epochs(
            self.learner.update_from_batch, batch,
            num_epochs, self.config.minibatch_size, self._rng,
        )

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = self.learner.module(torch.as_tensor(
                np.asarray(obs, np.float32), device=self.learner.device))
        return out["action_logits"].argmax(dim=-1).cpu().numpy()


def marwil_loss(beta: float):
    """Monotonic advantage re-weighted imitation learning (reference:
    rllib/algorithms/marwil/ — Wang et al. 2018): BC where each action's
    log-likelihood is weighted by exp(beta * advantage), advantage
    measured against a jointly-learned value baseline. beta=0 reduces to
    plain BC."""

    def loss(module, batch):
        out = module(batch["obs"])
        logp = _logp_taken(out["action_logits"], batch["actions"])
        adv = batch["returns"] - out["value"]
        vf_loss = (adv ** 2).mean()
        # Normalized, gradient-stopped exponential weights (the c term of
        # the paper approximated by the batch advantage scale), clipped
        # for stability.
        a = adv.detach()
        scale = torch.sqrt((a ** 2).mean()) + 1e-8
        w = torch.exp(torch.clamp(beta * a / scale, -5.0, 5.0))
        policy_loss = -(w * logp).mean()
        total = policy_loss + 0.5 * vf_loss
        return total, {
            "total_loss": total, "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "accuracy": _accuracy(out["action_logits"], batch["actions"]),
            "mean_weight": w.mean(),
        }

    return loss


@dataclass
class MARWILConfig(BCConfig):
    beta: float = 1.0
    gamma: float = 0.99

    def training(self, lr=None, minibatch_size=None, beta=None, gamma=None,
                 device=None):
        super().training(lr=lr, minibatch_size=minibatch_size, device=device)
        if beta is not None:
            self.beta = beta
        if gamma is not None:
            self.gamma = gamma
        return self

    def build(self) -> "MARWIL":
        return MARWIL(self)


class MARWIL(BC):
    """Advantage-weighted offline training over a transition Dataset
    (rows need obs/actions/returns — see episodes_to_dataset(gamma=...)).
    The dataset-backed loop streams batches through the Dataset executor
    per epoch instead of materializing everything on the driver."""

    _BATCH_KEYS = ("obs", "actions", "returns")

    def _loss(self):
        return marwil_loss(self.config.beta)

    def train_on_dataset(self, ds, num_epochs: int = 1) -> Dict[str, float]:
        """Streaming epochs: shuffle + iter_batches drives the Dataset's
        executor each epoch; minibatches update as they arrive (the
        reference's OfflineData iter_batches loop, offline/offline_data.py)."""
        metrics: Dict[str, float] = {}
        for epoch in range(num_epochs):
            shuffled = ds.random_shuffle(seed=self.config.seed + epoch)
            for batch in shuffled.iter_batches(
                batch_size=self.config.minibatch_size, batch_format="numpy"
            ):
                mb = {
                    # Row values may arrive as an object array of
                    # per-row ndarrays; stack explicitly.
                    "obs": np.stack([
                        np.asarray(o, dtype=np.float32)
                        for o in batch["obs"]
                    ]),
                    "actions": np.asarray(
                        [int(a) for a in batch["actions"]], dtype=np.int32
                    ),
                    "returns": np.asarray(
                        [float(r) for r in batch["returns"]],
                        dtype=np.float32,
                    ),
                }
                metrics = self.learner.update_from_batch(mb)
        return metrics
