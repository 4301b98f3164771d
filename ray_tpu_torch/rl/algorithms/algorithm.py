"""Shared Algorithm machinery: periodic evaluation + save/restore (the
port of ray_tpu/rl/algorithms/algorithm.py).

Analog of the reference's Algorithm.evaluate flow
(rllib/algorithms/algorithm.py:795: dedicated evaluation workers with a
separate env/config, eval metrics under results["evaluation"]) and
Algorithm.save/restore (checkpointable_state: module weights + optimizer
state + counters). Every algorithm class mixes this in; configs gain the
`.evaluation(...)` builder.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rl.env_runner import _EnvRunnerBase, _obs_tensor


@rt.remote
class EvalEnvRunner(_EnvRunnerBase):
    """Dedicated evaluation runner: whole episodes under the CURRENT
    weights, optionally greedy (explore=False), never feeding training
    (reference: evaluation/worker_set.py:82 eval WorkerSet)."""

    def run_episodes(self, num_episodes: int, explore: bool = False,
                     max_steps_per_episode: int = 10_000) -> Dict[str, Any]:
        assert self.params is not None, "set_weights first"
        stateful = hasattr(self.module, "initial_state")
        returns, lengths = [], []
        for _ in range(num_episodes):
            obs, _ = self.env.reset()
            self._set_obs(obs)
            state = self.module.initial_state(1) if stateful else None
            total, steps = 0.0, 0
            while steps < max_steps_per_episode:
                obs_c = self._obs_conn
                if explore:
                    args = [state] if stateful else []
                    if self._eval_epsilon() is not None:
                        # Value modules explore epsilon-greedily; 0.05
                        # is the conventional eval epsilon (without it
                        # explore mode would silently equal greedy).
                        args.append(self._eval_epsilon())
                    out = self._sample(obs_c[None], *args)
                    # Normalize: policy modules return (a, logp, v[,
                    # state]); value modules (a[, state]) or a bare
                    # action tensor.
                    if not isinstance(out, (tuple, list)):
                        action = out
                    else:
                        action = out[0]
                        if stateful:
                            state = out[-1]
                else:
                    with torch.inference_mode():
                        action, state = self._greedy_action(
                            _obs_tensor(obs_c[None]), state)
                action = action.numpy()[0]
                if action.ndim == 0 and np.issubdtype(action.dtype, np.integer):
                    action = int(action)
                nxt, reward, terminated, truncated, _ = self.env.step(action)
                total += float(reward)
                steps += 1
                if terminated or truncated:
                    break
                self._set_obs(nxt)
            returns.append(total)
            lengths.append(steps)
        return {"returns": returns, "lengths": lengths}

    def _eval_epsilon(self):
        """0.05 for modules whose sample_action takes an epsilon (the
        value-based family), None for policy modules."""
        import inspect

        if not hasattr(self, "_eval_eps_cached"):
            try:
                params = inspect.signature(
                    self.module.sample_action
                ).parameters
                self._eval_eps_cached = 0.05 if "epsilon" in params else None
            except (TypeError, ValueError):
                self._eval_eps_cached = None
        return self._eval_eps_cached

    def _greedy_action(self, obs, state=None):
        """(greedy action, next state): argmax of the logits or Q values,
        the deterministic action for continuous modules."""
        if state is not None:  # stateful module: thread the GRU state
            out, state = self.module.forward_step(obs, state)
            logits = out.get("action_logits")
            if logits is None:  # recurrent Q module
                logits = out["q_values"]
            return logits.argmax(dim=-1), state
        if hasattr(self.module, "deterministic_action"):
            return self.module.deterministic_action(obs), None
        out = self.module.forward(obs)
        logits = out.get("action_logits")
        if logits is None:
            logits = out["q_values"]
        return logits.argmax(dim=-1), None


class ConfigEvalMixin:
    """`.evaluation(...)` builder shared by every AlgorithmConfig
    (reference: algorithm_config.py evaluation())."""

    evaluation_interval: Optional[int] = None  # iterations between evals
    evaluation_num_env_runners: int = 1
    evaluation_duration: int = 5               # episodes per eval
    evaluation_explore: bool = False
    evaluation_env_creator: Optional[Callable] = None

    def evaluation(self, evaluation_interval=None,
                   evaluation_num_env_runners=None,
                   evaluation_duration=None,
                   evaluation_explore=None,
                   evaluation_env_creator=None):
        for name, val in (
            ("evaluation_interval", evaluation_interval),
            ("evaluation_num_env_runners", evaluation_num_env_runners),
            ("evaluation_duration", evaluation_duration),
            ("evaluation_explore", evaluation_explore),
            ("evaluation_env_creator", evaluation_env_creator),
        ):
            if val is not None:
                setattr(self, name, val)
        return self

    def as_trainable(self, stop_iters: int = 10):
        """Tune adapter (reference: Algorithm IS a Tune Trainable,
        rllib/algorithms/algorithm.py:191): Tuner(config.as_trainable(),
        param_space={"lr": ...}) tunes this algorithm's fields."""
        return config_as_trainable(self, stop_iters)


class AlgorithmBase:
    """Mixin over concrete algorithms (which own `config`,
    `learner_group`, `_iteration`, `_broadcast_weights`)."""

    _eval_runners: Optional[list] = None

    # -- evaluation ------------------------------------------------------
    def _ensure_eval_runners(self):
        if self._eval_runners is not None:
            return
        cfg = self.config
        env_creator = (getattr(cfg, "evaluation_env_creator", None)
                       or cfg.env_creator)
        self._eval_runners = [
            EvalEnvRunner.options(num_cpus=0.25).remote(
                env_creator,
                self._module_factory,
                seed=getattr(cfg, "seed", 0) + 10_000 + i,
                connectors=(cfg.connectors_factory()
                            if getattr(cfg, "connectors_factory", None)
                            else None),
                gamma=getattr(cfg, "gamma", 0.99),
            )
            for i in range(max(1, getattr(cfg, "evaluation_num_env_runners", 1)))
        ]

    # Overridable state hooks (the JAX package's SAC keeps its whole
    # update state in one pytree instead of a LearnerGroup).
    def _get_learner_state(self):
        return self.learner_group.get_state()

    def _set_learner_state(self, state):
        self.learner_group.set_state(state)

    def _current_weights(self):
        return self.learner_group.get_weights()

    def evaluate(self) -> Dict[str, Any]:
        """Run evaluation_duration episodes on the dedicated runners under
        the current learner weights (reference: algorithm.py:795)."""
        self._ensure_eval_runners()
        cfg = self.config
        weights = self._current_weights()
        rt.get([r.set_weights.remote(weights) for r in self._eval_runners],
               timeout=300)
        total = max(1, getattr(cfg, "evaluation_duration", 5))
        n_runners = len(self._eval_runners)
        per = [total // n_runners + (1 if i < total % n_runners else 0)
               for i in range(n_runners)]
        outs = rt.get(
            [
                r.run_episodes.remote(
                    n, explore=getattr(cfg, "evaluation_explore", False)
                )
                for r, n in zip(self._eval_runners, per) if n > 0
            ],
            timeout=1200,
        )
        returns = [x for o in outs for x in o["returns"]]
        lengths = [x for o in outs for x in o["lengths"]]
        return {
            "episode_return_mean": float(np.mean(returns)),
            "episode_return_min": float(np.min(returns)),
            "episode_return_max": float(np.max(returns)),
            "episode_len_mean": float(np.mean(lengths)),
            "episodes_this_eval": len(returns),
        }

    def _finish_iteration(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Attach periodic evaluation to one train() result."""
        interval = getattr(self.config, "evaluation_interval", None)
        if interval and self._iteration % interval == 0:
            result["evaluation"] = self.evaluate()
        return result

    def _gather_runner_states(self):
        try:
            return rt.get(
                [r.get_runner_state.remote() for r in self.env_runners],
                timeout=300,
            )
        except Exception:  # noqa: BLE001 — runner flavor without state
            return None

    # -- checkpointing ---------------------------------------------------
    def save(self, checkpoint_dir: str) -> str:
        """Persist weights + optimizer state + counters (reference:
        Algorithm.save_checkpoint)."""
        os.makedirs(checkpoint_dir, exist_ok=True)
        state = {
            "learner_state": self._get_learner_state(),
            "iteration": self._iteration,
            "algorithm": type(self).__name__,
            "extra": self._checkpoint_extra_state(),
            # Env-runner sampling state (RNG/env/connectors) makes the
            # restored run continue the SAME trajectory stream. Runner
            # flavors without state support (vectorized) are skipped.
            "runner_states": self._gather_runner_states(),
        }
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        """Resume mid-train: learner params + optimizer state + iteration
        counter, then weight broadcast to the env runners."""
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        self._set_learner_state(state["learner_state"])
        self._iteration = state["iteration"]
        self._restore_extra_state(state.get("extra") or {})
        runner_states = state.get("runner_states") or []
        if len(runner_states) == len(self.env_runners):
            try:
                rt.get(
                    [
                        r.set_runner_state.remote(st)
                        for r, st in zip(self.env_runners, runner_states)
                    ],
                    timeout=300,
                )
            except Exception:  # noqa: BLE001 — runner flavor without state
                pass
        # Resync every env runner to the restored weights.
        weights = self._current_weights()
        rt.get(
            [r.set_weights.remote(weights) for r in self.env_runners],
            timeout=300,
        )

    def _checkpoint_extra_state(self) -> Dict[str, Any]:
        """Algorithm-specific additions (e.g. target-network params)."""
        return {}

    def _restore_extra_state(self, extra: Dict[str, Any]) -> None:
        pass

    def stop_eval_runners(self):
        for r in self._eval_runners or []:
            try:
                rt.kill(r)
            except Exception:  # noqa: BLE001
                pass
        self._eval_runners = None


def config_as_trainable(config, stop_iters: int = 10):
    """Tune adapter (reference: Algorithm IS a Tune Trainable,
    rllib/algorithms/algorithm.py:191 — Tuner(PPO, param_space=...)).

    Returns a function trainable: each trial deep-copies `config`,
    applies its sampled params (dataclass fields / non-callable config
    attributes only — builder METHODS are rejected), builds the
    algorithm, runs train() iterations reporting each result WITH an
    Algorithm.save checkpoint — so trial restarts, Tuner.restore, and
    PBT exploit resume from learned state instead of iteration 0 — and
    always stops the algorithm's actors.
    Use: Tuner(config.as_trainable(), param_space={"lr": ...}).
    """
    import copy
    import dataclasses

    def trainable(trial_config):
        import os
        import tempfile

        from ray_tpu_torch import tune as _tune
        from ray_tpu_torch.train.checkpoint import Checkpoint

        cfg = copy.deepcopy(config)
        field_names = (
            {f.name for f in dataclasses.fields(cfg)}
            if dataclasses.is_dataclass(cfg) else set()
        )
        for key, value in trial_config.items():
            settable = key in field_names or (
                hasattr(cfg, key) and not callable(getattr(cfg, key))
            )
            if not settable:
                raise ValueError(
                    f"param_space key {key!r} is not a config field of "
                    f"{type(cfg).__name__}"
                )
            setattr(cfg, key, value)
        algo = cfg.build()
        try:
            ckpt = _tune.get_checkpoint()
            if ckpt is not None:
                algo.restore(ckpt.path)
            while algo._iteration < stop_iters:
                result = algo.train()
                d = tempfile.mkdtemp(prefix="rl_trial_ckpt_")
                algo.save(d)
                _tune.report(result, checkpoint=Checkpoint.from_directory(d))
        finally:
            algo.stop()

    # tune.with_resources pins per-trial resources on the CONFIG copy
    # (the as_trainable dispatch branch); carry them onto the closure
    # the way trainer.as_trainable does.
    if getattr(config, "_tune_resources", None) is not None:
        trainable._tune_resources = dict(config._tune_resources)
    return trainable

