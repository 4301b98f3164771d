"""Env runners: collect experience with the current policy (the port of
ray_tpu/rl/env_runner.py).

Runners hold no card: their module lives on the CPU and samples under
`torch.inference_mode` with one intra-op thread (a runner holds a
fraction of a CPU, and several share a host). Each runner draws from an
explicit `torch.Generator` seeded where the JAX runner makes its
PRNGKey, and the generator's state rides the runner's checkpoint state.

Truncation semantics (gymnasium): a truncated episode ends but its final
state still has value. The on-policy runner folds that value into the
last reward — reward += gamma * V(s_final) — and marks the step done,
which is algebraically identical to bootstrapping for both GAE and
V-trace while keeping the batch schema flat. The off-policy runner
instead ships the true next_obs with dones = terminated-only, which is
already exact for Q targets.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.models.mlp import generator


def _runner_threads() -> None:
    torch.set_num_threads(1)


def _obs_tensor(obs: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(obs, dtype=np.float32))


class EpisodeTracker:
    """Episode return bookkeeping shared by all runner flavors."""

    def __init__(self):
        self.current = 0.0
        self.returns: list = []

    def add(self, reward: float):
        self.current += float(reward)

    def end_episode(self):
        self.returns.append(self.current)
        self.current = 0.0

    def stats(self) -> Dict[str, Any]:
        return {
            "episodes": len(self.returns),
            "mean_return": (
                float(np.mean(self.returns[-20:])) if self.returns else 0.0
            ),
        }


class _EnvRunnerBase:
    """Shared env-runner scaffolding: env/module setup, weight sync,
    connector pipeline, episode bookkeeping. Subclasses implement
    sample()."""

    def __init__(self, env_creator, module_factory, seed: int = 0,
                 rollout_length: int = 200, connectors=None,
                 gamma: float = 0.99):
        _runner_threads()
        self.env = env_creator()
        self.module = module_factory()
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.rng = generator(seed)
        self.params = None
        self.connectors = connectors  # ConnectorPipeline or None
        self._obs = None        # raw current observation
        self._obs_conn = None   # its connected form (computed exactly once)
        self._tracker = EpisodeTracker()

    def _connect(self, obs) -> np.ndarray:
        """Env-to-module connector pass (identity when unconfigured)."""
        if self.connectors is None:
            return np.asarray(obs, dtype=np.float32)
        return self.connectors(obs)

    def _reward(self, reward: float) -> float:
        if self.connectors is None:
            return float(reward)
        return self.connectors.transform_reward(float(reward))

    def _sample(self, obs: np.ndarray, *args):
        """The module's sample_action on one batch of observations."""
        with torch.inference_mode():
            return self.module.sample_action(_obs_tensor(obs), self.rng,
                                             *args)

    def get_connector_state(self):
        return None if self.connectors is None else self.connectors.get_state()

    def set_weights(self, weights):
        self.module.set_weights(weights)
        self.params = weights
        return True

    def get_weights(self):
        return self.module.get_weights()

    def _set_obs(self, raw):
        """Install a new current observation, connecting it exactly once
        (stateful connectors like NormalizeObs must see each state once)."""
        self._obs = raw
        self._obs_conn = self._connect(raw)

    def _begin_rollout(self):
        assert self.params is not None, "set_weights first"
        if self._obs is None:
            obs, _ = self.env.reset()
            self._set_obs(obs)

    def _advance(self, nxt, reward, terminated, truncated) -> np.ndarray:
        """Track episode returns and install the next observation. Returns
        the connected form of the true successor state (on episode end,
        that's `nxt` connected once; the env is then reset)."""
        self._tracker.add(reward)
        if terminated or truncated:
            nxt_conn = self._connect(nxt)
            self._tracker.end_episode()
            obs, _ = self.env.reset()
            self._set_obs(obs)
        else:
            self._set_obs(nxt)
            nxt_conn = self._obs_conn
        return nxt_conn

    def episode_stats(self) -> Dict[str, Any]:
        return self._tracker.stats()

    # -- checkpoint support (Algorithm.save/restore) ---------------------
    def get_runner_state(self) -> Dict[str, Any]:
        """Everything needed to resume sampling bit-exactly: generator
        state, current observation (raw + connected — reconnecting would
        double-count stateful connector statistics), episode tracker,
        connector pipeline, and the env itself when it pickles."""
        from ray_tpu_torch._vendor import cloudpickle

        state = {
            "rng": self.rng.get_state().numpy().copy(),
            "obs": self._obs,
            "obs_conn": self._obs_conn,
            "tracker": cloudpickle.dumps(self._tracker),
            "connectors": (cloudpickle.dumps(self.connectors)
                           if self.connectors is not None else None),
        }
        try:
            state["env"] = cloudpickle.dumps(self.env)
        except Exception:  # noqa: BLE001 — unpicklable env: fresh on restore
            state["env"] = None
        return state

    def set_runner_state(self, state: Dict[str, Any]):
        from ray_tpu_torch._vendor import cloudpickle

        self.rng.set_state(torch.from_numpy(np.array(state["rng"])))
        self._tracker = cloudpickle.loads(state["tracker"])
        if state.get("connectors") is not None:
            self.connectors = cloudpickle.loads(state["connectors"])
        if state.get("env") is not None:
            try:
                self.env = cloudpickle.loads(state["env"])
            except Exception:  # noqa: BLE001 — keep the fresh env
                pass
        self._obs = state.get("obs")
        self._obs_conn = state.get("obs_conn")
        return True


@rt.remote
class EnvRunner(_EnvRunnerBase):
    def sample(self) -> Dict[str, np.ndarray]:
        """One fixed-length rollout. Mid-rollout truncations bootstrap by
        folding gamma * V(s_final) into the reward (see module docstring);
        the rollout-end cut bootstraps via `last_value`/`last_obs`."""
        self._begin_rollout()
        T = self.rollout_length
        obs_buf, act_buf, logp_buf, val_buf = [], [], [], []
        rew_buf, done_buf = [], []
        for _ in range(T):
            obs = self._obs_conn
            action, logp, value = self._sample(obs[None])
            action = int(action[0])
            obs_buf.append(obs)
            act_buf.append(action)
            logp_buf.append(float(logp[0]))
            val_buf.append(float(value[0]))
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            rew = self._reward(reward)
            nxt_conn = self._advance(nxt, reward, terminated, truncated)
            if truncated and not terminated:
                # The episode was cut by a time limit, not by reaching a
                # terminal state: bootstrap its tail value into the reward.
                _, _, v_final = self._sample(nxt_conn[None])
                rew += self.gamma * float(v_final[0])
            rew_buf.append(rew)
            done_buf.append(bool(terminated or truncated))
        # Bootstrap value of the final observation. last_obs also ships so
        # off-policy consumers (V-trace) can re-bootstrap under the
        # *learner's* current params rather than the behavior policy's.
        obs = self._obs_conn
        _, _, last_value = self._sample(obs[None])
        return {
            "obs": np.stack(obs_buf),
            "actions": np.asarray(act_buf, dtype=np.int32),
            "logp": np.asarray(logp_buf, dtype=np.float32),
            "values": np.asarray(val_buf, dtype=np.float32),
            "rewards": np.asarray(rew_buf, dtype=np.float32),
            "dones": np.asarray(done_buf, dtype=np.float32),
            "last_value": float(last_value[0]),
            "last_obs": obs,
        }


def compute_gae(batch: Dict[str, np.ndarray], gamma: float = 0.99,
                lam: float = 0.95) -> Dict[str, np.ndarray]:
    """Generalized advantage estimation over one rollout."""
    rewards, values, dones = batch["rewards"], batch["values"], batch["dones"]
    T = len(rewards)
    adv = np.zeros(T, dtype=np.float32)
    last_gae = 0.0
    next_value = batch["last_value"]
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    out = dict(batch)
    out["advantages"] = adv
    out["returns"] = adv + values
    return out


@rt.remote
class TransitionEnvRunner(_EnvRunnerBase):
    """Collects (s, a, r, s', done) transitions with epsilon-greedy
    exploration for off-policy algorithms (DQN family). next_obs is the
    true successor and dones records terminated-only, so Q targets
    bootstrap correctly through time limits. With n_step > 1 the rollout
    is collapsed into n-step transitions before shipping (windows cut at
    episode ends, per-transition bootstrap ``discounts`` = gamma**m)."""

    def __init__(self, env_creator, module_factory, seed: int = 0,
                 rollout_length: int = 200, connectors=None,
                 gamma: float = 0.99, n_step: int = 1):
        super().__init__(env_creator, module_factory, seed=seed,
                         rollout_length=rollout_length,
                         connectors=connectors, gamma=gamma)
        self.n_step = n_step

    def sample(self, epsilon: float = 0.1) -> Dict[str, np.ndarray]:
        self._begin_rollout()
        T = self.rollout_length
        obs_buf, act_buf, rew_buf, next_buf = [], [], [], []
        done_buf, end_buf = [], []
        for _ in range(T):
            obs = self._obs_conn
            action = int(self._sample(obs[None], epsilon)[0])
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            obs_buf.append(obs)
            act_buf.append(action)
            rew_buf.append(self._reward(reward))
            done_buf.append(bool(terminated))
            end_buf.append(bool(terminated or truncated))
            # next_obs passes the same connector pipeline as obs; _advance
            # connects each successor state exactly once.
            next_buf.append(self._advance(nxt, reward, terminated, truncated))
        batch = {
            "obs": np.stack(obs_buf),
            "actions": np.asarray(act_buf, dtype=np.int32),
            "rewards": np.asarray(rew_buf, dtype=np.float32),
            "next_obs": np.stack(next_buf),
            "dones": np.asarray(done_buf, dtype=np.float32),
        }
        from ray_tpu_torch.rl.replay import n_step_transitions

        return n_step_transitions(
            batch, np.asarray(end_buf, dtype=bool), self.n_step, self.gamma
        )


@rt.remote
class VectorEnvRunner:
    """N envs stepped in lockstep with ONE batched policy call per step.

    sample() returns time-major arrays shaped (T, N, ...) plus per-env
    bootstrap values, which transpose directly into the (B=N, T) layout
    the V-trace losses consume.
    """

    def __init__(self, env_creator, module_factory, num_envs: int = 8,
                 seed: int = 0, rollout_length: int = 50,
                 gamma: float = 0.99):
        _runner_threads()
        self.envs = [env_creator() for _ in range(num_envs)]
        self.module = module_factory()
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.rng = generator(seed)
        self._seed0 = seed
        self.params = None
        self._trackers = [EpisodeTracker() for _ in range(num_envs)]
        self._obs: Optional[np.ndarray] = None  # (N, obs_dim)

    def set_weights(self, weights):
        self.module.set_weights(weights)
        self.params = weights
        return True

    def _reset_env(self, i: int) -> np.ndarray:
        obs, _ = self.envs[i].reset(seed=self._seed0 * 10_000 + i)
        self._seed0 += 1
        return np.asarray(obs, dtype=np.float32)

    def _sample(self, obs):
        with torch.inference_mode():
            return [t.numpy() for t in
                    self.module.sample_action(_obs_tensor(obs), self.rng)]

    def sample(self) -> Dict[str, np.ndarray]:
        assert self.params is not None, "set_weights first"
        N, T = self.num_envs, self.rollout_length
        if self._obs is None:
            self._obs = np.stack([self._reset_env(i) for i in range(N)])
        obs_dim = self._obs.shape[1]
        obs_buf = np.empty((T, N, obs_dim), dtype=np.float32)
        act_buf = np.empty((T, N), dtype=np.int32)
        logp_buf = np.empty((T, N), dtype=np.float32)
        val_buf = np.empty((T, N), dtype=np.float32)
        rew_buf = np.empty((T, N), dtype=np.float32)
        done_buf = np.empty((T, N), dtype=np.float32)
        for t in range(T):
            actions, logp, values = self._sample(self._obs)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = values
            next_obs = self._obs.copy()
            trunc_pending = []  # (env_idx, next obs)
            for i in range(N):
                nxt, reward, terminated, truncated, _ = self.envs[i].step(
                    int(actions[i])
                )
                self._trackers[i].add(float(reward))
                rew_buf[t, i] = float(reward)
                done_buf[t, i] = float(terminated or truncated)
                if terminated or truncated:
                    if truncated and not terminated:
                        trunc_pending.append(
                            (i, np.asarray(nxt, dtype=np.float32))
                        )
                    self._trackers[i].end_episode()
                    next_obs[i] = self._reset_env(i)
                else:
                    next_obs[i] = np.asarray(nxt, dtype=np.float32)
            if trunc_pending:
                # Time-limit cuts bootstrap gamma*V(s_final) into the
                # reward — ONE batched call for every truncated env.
                finals = np.stack([o for _, o in trunc_pending])
                _, _, v_fin = self._sample(finals)
                for j, (i, _) in enumerate(trunc_pending):
                    rew_buf[t, i] += self.gamma * float(v_fin[j])
            self._obs = next_obs
        _, _, last_values = self._sample(self._obs)
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "last_values": np.asarray(last_values, dtype=np.float32),
            "last_obs": self._obs.copy(),
        }

    def episode_stats(self) -> Dict[str, Any]:
        stats = [t.stats() for t in self._trackers]
        episodes = sum(s["episodes"] for s in stats)
        returns = [
            s["mean_return"] for s in stats if s["episodes"] > 0
        ]
        return {
            "episodes": episodes,
            "mean_return": float(np.mean(returns)) if returns else 0.0,
        }


@rt.remote
class ContinuousTransitionRunner:
    """Off-policy transition collector for continuous control (SAC).
    Stores NORMALIZED ([-1, 1]) actions so the learner's Q towers see the
    exact values the policy emitted; env steps receive the scaled form.
    `sample(random_actions=True)` provides the uniform warmup phase."""

    def __init__(self, env_creator, module_factory, seed: int = 0,
                 rollout_length: int = 200):
        _runner_threads()
        self.env = env_creator()
        self.module = module_factory()
        self.rollout_length = rollout_length
        self.rng = generator(seed)
        self._np_rng = np.random.default_rng(seed)
        self.params = None
        self._obs = None
        self._tracker = EpisodeTracker()

    def set_weights(self, weights):
        self.module.set_weights(weights)
        self.params = weights
        return True

    def sample(self, random_actions: bool = False) -> Dict[str, np.ndarray]:
        if self._obs is None:
            obs, _ = self.env.reset()
            self._obs = np.asarray(obs, dtype=np.float32)
        T = self.rollout_length
        adim = self.module.spec.action_dim
        obs_buf = np.empty((T, self._obs.shape[0]), dtype=np.float32)
        act_buf = np.empty((T, adim), dtype=np.float32)
        rew_buf = np.empty(T, dtype=np.float32)
        next_buf = np.empty_like(obs_buf)
        done_buf = np.empty(T, dtype=np.float32)
        for t in range(T):
            if random_actions or self.params is None:
                a_norm = self._np_rng.uniform(-1.0, 1.0, adim).astype(
                    np.float32
                )
            else:
                with torch.inference_mode():
                    a, _ = self.module.sample_with_logp(
                        _obs_tensor(self._obs[None]), self.rng)
                a_norm = a.numpy()[0]
            scaled = np.asarray(
                self.module.scale_action(a_norm), dtype=np.float64
            )
            nxt, reward, terminated, truncated, _ = self.env.step(scaled)
            self._tracker.add(float(reward))
            obs_buf[t] = self._obs
            act_buf[t] = a_norm
            rew_buf[t] = float(reward)
            next_buf[t] = np.asarray(nxt, dtype=np.float32)
            # Q targets bootstrap through time-limit truncations: dones
            # records TERMINATED only (as TransitionEnvRunner).
            done_buf[t] = float(terminated)
            if terminated or truncated:
                self._tracker.end_episode()
                obs, _ = self.env.reset()
                self._obs = np.asarray(obs, dtype=np.float32)
            else:
                self._obs = next_buf[t]
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "rewards": rew_buf,
            "next_obs": next_buf,
            "dones": done_buf,
        }

    def episode_stats(self) -> Dict[str, Any]:
        return self._tracker.stats()


@rt.remote
class RecurrentEnvRunner(_EnvRunnerBase):
    """On-policy rollouts for stateful policies: the module's hidden
    state threads through steps, resets with the env, and each window
    ships the state it STARTED with (plus dones) so the learner can
    replay the exact sequence."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._policy_state = None

    def get_runner_state(self) -> Dict[str, Any]:
        state = super().get_runner_state()
        # The GRU state is part of "resume sampling bit-exactly": a
        # zeroed state on a mid-episode observation loses the memory.
        state["policy_state"] = (
            None if self._policy_state is None
            else self._policy_state.numpy().copy()
        )
        return state

    def set_runner_state(self, state: Dict[str, Any]):
        super().set_runner_state(state)
        ps = state.get("policy_state")
        self._policy_state = None if ps is None else torch.from_numpy(
            np.array(ps, dtype=np.float32))
        return True

    def sample(self) -> Dict[str, np.ndarray]:
        self._begin_rollout()
        if self._policy_state is None:
            self._policy_state = self.module.initial_state(1)
        T = self.rollout_length
        state0 = self._policy_state.numpy()[0].copy()
        obs_buf, act_buf, logp_buf, val_buf = [], [], [], []
        rew_buf, done_buf = [], []
        for _ in range(T):
            obs = self._obs_conn
            action, logp, value, self._policy_state = self._sample(
                obs[None], self._policy_state
            )
            action = int(action[0])
            obs_buf.append(obs)
            act_buf.append(action)
            logp_buf.append(float(logp[0]))
            val_buf.append(float(value[0]))
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            rew = self._reward(reward)
            nxt_conn = self._advance(nxt, reward, terminated, truncated)
            if truncated and not terminated:
                # Bootstrap the cut tail under the state the policy
                # WOULD have had at the final observation.
                _, _, v_final, _ = self._sample(nxt_conn[None],
                                                self._policy_state)
                rew += self.gamma * float(v_final[0])
            if terminated or truncated:
                # The env reset: the policy state resets with it —
                # exactly what forward_seq's done-driven resets replay.
                self._policy_state = self.module.initial_state(1)
            rew_buf.append(rew)
            done_buf.append(bool(terminated or truncated))
        obs = self._obs_conn
        _, _, last_value, _ = self._sample(obs[None], self._policy_state)
        return {
            "obs": np.stack(obs_buf),
            "actions": np.asarray(act_buf, dtype=np.int32),
            "logp": np.asarray(logp_buf, dtype=np.float32),
            "values": np.asarray(val_buf, dtype=np.float32),
            "rewards": np.asarray(rew_buf, dtype=np.float32),
            "dones": np.asarray(done_buf, dtype=np.float32),
            "last_value": float(last_value[0]),
            "last_obs": obs,
            "state0": state0.astype(np.float32),
        }
