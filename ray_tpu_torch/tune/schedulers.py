"""Trial schedulers.

Analog of the reference's tune/schedulers: FIFO and ASHA
(async_hyperband.py), median stopping (median_stopping_rule.py), and
population based training (pbt.py).
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Callable, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"  # PBT: clone a better trial's state + mutate config


class TrialScheduler:
    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE

    def on_complete(self, trial_id: str, result: Optional[Dict] = None):
        pass


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference:
    tune/schedulers/async_hyperband.py).

    Rungs at time_attr values grace_period * reduction_factor^k; a trial
    reaching a rung stops unless its metric is in the top 1/reduction_factor
    of results recorded at that rung so far.

    Multiple brackets (the full async-HyperBand shape, reference
    async_hyperband.py `brackets` arg) assign trials round-robin to
    brackets whose grace periods grow by reduction_factor — bracket k
    starts halving at grace_period * rf^k, trading early-stopping
    aggressiveness against robustness to slow starters.
    """

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        reduction_factor: int = 4,
        max_t: int = 100,
        brackets: int = 1,
    ):
        assert mode in ("min", "max")
        assert brackets >= 1
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.reduction_factor = reduction_factor
        self.max_t = max_t
        # Per-bracket rung ladders: bracket k's first rung is
        # grace_period * rf^k.
        self.bracket_rungs: List[List[int]] = []
        for k in range(brackets):
            rungs = []
            t = grace_period * reduction_factor ** k
            while t < max_t:
                rungs.append(t)
                t *= reduction_factor
            self.bracket_rungs.append(rungs)
        # (bracket, rung value) -> recorded metrics
        self.recorded: Dict[tuple, List[float]] = defaultdict(list)
        self._passed: Dict[str, set] = defaultdict(set)
        self._bracket_of: Dict[str, int] = {}
        self._next_bracket = 0

    def _bracket(self, trial_id: str) -> int:
        if trial_id not in self._bracket_of:
            self._bracket_of[trial_id] = self._next_bracket
            self._next_bracket = (self._next_bracket + 1) % len(
                self.bracket_rungs
            )
        return self._bracket_of[trial_id]

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        bracket = self._bracket(trial_id)
        for rung in self.bracket_rungs[bracket]:
            if t >= rung and rung not in self._passed[trial_id]:
                self._passed[trial_id].add(rung)
                recorded = self.recorded[(bracket, rung)]
                recorded.append(value)
                if len(recorded) >= self.reduction_factor:
                    ordered = sorted(recorded, reverse=(self.mode == "max"))
                    cutoff_idx = max(
                        0, math.ceil(len(ordered) / self.reduction_factor) - 1
                    )
                    cutoff = ordered[cutoff_idx]
                    good = value >= cutoff if self.mode == "max" else value <= cutoff
                    if not good:
                        return STOP
        return CONTINUE


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running average falls below the median of other
    trials at the same step (reference: tune/schedulers/median_stopping_rule.py).
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.histories: Dict[str, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, result: Dict) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None:
            return CONTINUE
        self.histories[trial_id].append(value)
        if t < self.grace_period or len(self.histories) < self.min_samples:
            return CONTINUE
        import statistics

        avgs = [
            sum(h) / len(h) for tid, h in self.histories.items() if tid != trial_id and h
        ]
        if len(avgs) < self.min_samples - 1:
            return CONTINUE
        median = statistics.median(avgs)
        mine = sum(self.histories[trial_id]) / len(self.histories[trial_id])
        worse = mine > median if self.mode == "min" else mine < median
        return STOP if worse else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """Population based training (reference: tune/schedulers/pbt.py).

    Every `perturbation_interval` reported iterations a trial in the bottom
    quantile EXPLOITS a top-quantile trial — the tuner restarts it from the
    donor's checkpoint — and EXPLORES by mutating hyperparameters: with
    `resample_probability` a fresh sample from `hyperparam_mutations`,
    otherwise the value scaled by 1.2/0.8 (or a neighboring choice for
    categorical lists).
    """

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        if not hyperparam_mutations:
            raise ValueError("PBT requires hyperparam_mutations")
        if not 0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}
        self._iters: Dict[str, int] = defaultdict(int)
        self._last_perturb: Dict[str, int] = defaultdict(int)
        self._configs: Dict[str, Dict] = {}
        self._checkpoints: Dict[str, str] = {}
        self.num_exploits = 0  # observability for tests/dashboards

    # -- tuner integration hooks ----------------------------------------
    def on_trial_add(self, trial_id: str, config: Dict):
        self._configs[trial_id] = dict(config)

    def record_checkpoint(self, trial_id: str, path: str):
        self._checkpoints[trial_id] = path

    def on_complete(self, trial_id: str, result: Optional[Dict] = None):
        self._scores.pop(trial_id, None)
        self._checkpoints.pop(trial_id, None)

    # -- decisions -------------------------------------------------------
    def _quantiles(self):
        ranked = sorted(
            self._scores.items(), key=lambda kv: kv[1],
            reverse=(self.mode == "max"),
        )
        k = max(1, int(len(ranked) * self.quantile))
        if len(ranked) < 2 * k:
            return [], []
        top = [tid for tid, _ in ranked[:k]]
        bottom = [tid for tid, _ in ranked[-k:]]
        return top, bottom

    def on_result(self, trial_id: str, result: Dict) -> str:
        if self.metric not in result:
            return CONTINUE
        self._scores[trial_id] = float(result[self.metric])
        self._iters[trial_id] += 1
        if self._iters[trial_id] - self._last_perturb[trial_id] < self.interval:
            return CONTINUE
        top, bottom = self._quantiles()
        if trial_id not in bottom:
            return CONTINUE
        donors = [t for t in top if t in self._checkpoints]
        if not donors:
            return CONTINUE
        # _last_perturb is recorded in make_exploit: a failed exploit (the
        # donor finished in between) must not cost a whole interval.
        return EXPLOIT

    def make_exploit(self, trial_id: str):
        """Pick a donor; return (donor_checkpoint_path, mutated_config)."""
        top, _ = self._quantiles()
        donors = [t for t in top if t in self._checkpoints]
        if not donors:
            return None, None
        donor = self._rng.choice(donors)
        new_config = self._explore(dict(self._configs.get(donor, {})))
        self._configs[trial_id] = new_config
        self._last_perturb[trial_id] = self._iters[trial_id]
        self.num_exploits += 1
        return self._checkpoints[donor], new_config

    def _explore(self, config: Dict) -> Dict:
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_p or key not in config:
                config[key] = self._sample(spec)
            elif isinstance(spec, (list, tuple)):
                # Move to a neighboring choice.
                try:
                    idx = list(spec).index(config[key])
                except ValueError:
                    idx = self._rng.randrange(len(spec))
                step = self._rng.choice((-1, 1))
                config[key] = list(spec)[max(0, min(len(spec) - 1, idx + step))]
            elif isinstance(config[key], (int, float)):
                factor = self._rng.choice((0.8, 1.2))
                val = config[key] * factor
                config[key] = type(config[key])(val) if isinstance(
                    config[key], int) else val
            else:
                config[key] = self._sample(spec)
        return config

    def _sample(self, spec):
        if callable(spec):
            return spec()
        if isinstance(spec, (list, tuple)):
            return self._rng.choice(list(spec))
        raise TypeError(
            f"hyperparam_mutations values must be callables or lists, "
            f"got {type(spec).__name__}"
        )


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: tune/schedulers/pb2.py —
    Parker-Holder et al. 2020). PBT's exploit step stays; EXPLORE is
    model-guided instead of random: a Gaussian-process surrogate is fit
    over (hyperparams -> observed metric change) and the new config
    maximizes a UCB acquisition over candidate perturbations — directed
    search through the mutation space rather than 0.8x/1.2x coin flips.

    Numeric hyperparams declared as (low, high) tuples in
    `hyperparam_bounds` ride the GP; anything in `hyperparam_mutations`
    keeps PBT's random perturbation.
    """

    def __init__(self, *args, hyperparam_bounds: Optional[Dict] = None,
                 ucb_beta: float = 1.5, n_candidates: int = 64, **kwargs):
        bounds = dict(hyperparam_bounds or {})
        if not kwargs.get("hyperparam_mutations") and bounds:
            # PB2 with bounds only: the base class requires mutations, so
            # synthesize uniform resample specs over each bound (only used
            # while the GP is cold).
            import random as _random

            kwargs["hyperparam_mutations"] = {
                k: (lambda lo=lo, hi=hi: _random.uniform(lo, hi))
                for k, (lo, hi) in bounds.items()
            }
        super().__init__(*args, **kwargs)
        self.bounds = bounds
        self.ucb_beta = ucb_beta
        self.n_candidates = n_candidates
        # Fitness history: (hyperparam vector, metric delta) per window.
        self._gp_data: list = []
        self._prev_score: Dict[str, float] = {}

    def on_result(self, trial_id: str, result: Dict) -> str:
        if self.metric in result and self.bounds:
            score = float(result[self.metric])
            if self.mode == "min":
                score = -score  # GP always maximizes improvement
            prev = self._prev_score.get(trial_id)
            cfg = self._configs.get(trial_id, {})
            if prev is not None and all(k in cfg for k in self.bounds):
                x = [self._norm(k, cfg[k]) for k in sorted(self.bounds)]
                self._gp_data.append((x, score - prev))
                del self._gp_data[:-128]  # sliding window
            self._prev_score[trial_id] = score
        return super().on_result(trial_id, result)

    def _norm(self, key, v):
        lo, hi = self.bounds[key]
        return (float(v) - lo) / max(hi - lo, 1e-12)

    def _denorm(self, key, x):
        lo, hi = self.bounds[key]
        return lo + x * (hi - lo)

    def _explore(self, config: Dict) -> Dict:
        config = super()._explore(config)
        if not self.bounds:
            return config
        if len(self._gp_data) < 4:
            # Cold model: uniform resample inside bounds.
            for k in self.bounds:
                config[k] = self._denorm(k, self._rng.random())
            return config
        import numpy as np

        keys = sorted(self.bounds)
        X = np.asarray([x for x, _ in self._gp_data])
        y = np.asarray([d for _, d in self._gp_data])
        y = (y - y.mean()) / (y.std() + 1e-9)
        # RBF-kernel GP posterior (noise-regularized).
        ls = 0.2
        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * ls * ls))
        K = k(X, X) + 0.1 * np.eye(len(X))
        Kinv_y = np.linalg.solve(K, y)
        cand = np.asarray([
            [self._rng.random() for _ in keys]
            for _ in range(self.n_candidates)
        ])
        Ks = k(cand, X)
        mu = Ks @ Kinv_y
        var = 1.0 - np.einsum(
            "ij,ji->i", Ks, np.linalg.solve(K, Ks.T)
        ).clip(max=1.0)
        ucb = mu + self.ucb_beta * np.sqrt(var.clip(min=0.0))
        best = cand[int(np.argmax(ucb))]
        for i, key in enumerate(keys):
            config[key] = self._denorm(key, float(best[i]))
        return config
