"""Search spaces and search algorithms.

Analog of the reference's tune.search surface: sample domains
(tune/search/sample.py), grid/random generation (basic_variant.py), and
ConcurrencyLimiter.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    categories: List[Any]

    def sample(self, rng):
        return rng.choice(self.categories)


@dataclass
class GridSearch:
    values: List[Any]


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def choice(categories) -> Choice:
    return Choice(list(categories))


def grid_search(values) -> GridSearch:
    return GridSearch(list(values))


# Sentinel a searcher returns when it has nothing to suggest *right now*
# but is not exhausted (reference: Searcher.FINISHED vs. deferred
# suggestions in tune/search/search_generator.py). None still means "no
# more trials ever".
PAUSED = "__tune_paused__"


class Searcher:
    """Suggest configs one at a time (reference: tune/search/searcher.py)."""

    def suggest(self, trial_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None):
        pass


class BasicVariantGenerator(Searcher):
    """Grid x random sampling (reference: tune/search/basic_variant.py)."""

    def __init__(self, param_space: Dict, num_samples: int = 1, seed: Optional[int] = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._variants = list(self._generate())
        self._idx = 0

    def _generate(self) -> Iterator[Dict]:
        grid_keys = [
            k for k, v in self.param_space.items() if isinstance(v, GridSearch)
        ]
        grid_values = [self.param_space[k].values for k in grid_keys]
        combos = list(itertools.product(*grid_values)) if grid_keys else [()]
        for _ in range(self.num_samples):
            for combo in combos:
                config = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        config[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        config[k] = v.sample(self.rng)
                    elif callable(v) and not isinstance(v, type):
                        config[k] = v()
                    else:
                        config[k] = v
                yield config

    @property
    def total_trials(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._idx >= len(self._variants):
            return None
        config = self._variants[self._idx]
        self._idx += 1
        return config


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator search (Bergstra et al. 2011).

    The native model-based searcher — the same algorithm the reference
    reaches through its Optuna integration (tune/search/optuna/, whose
    default sampler is TPE). Completed trials split into a good quantile
    l(x) and the rest g(x); each dimension is modeled with a kernel
    density over observed values, candidates are drawn from l and ranked
    by the acquisition ratio l(x)/g(x).

    Numeric domains (Uniform/LogUniform/RandInt) use Gaussian kernels
    (log-space for LogUniform); Choice uses smoothed categorical counts.
    Falls back to random sampling until `n_startup` results exist.
    """

    def __init__(self, param_space: Dict, metric: str, mode: str = "min",
                 num_samples: int = 32, gamma: float = 0.25,
                 n_startup: int = 8, n_candidates: int = 24,
                 seed: Optional[int] = None):
        assert mode in ("min", "max")
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._suggested = 0
        self._configs: Dict[str, Dict] = {}  # trial_id -> config
        self._observations: List[tuple] = []  # (config, score)

    def _random_config(self) -> Dict:
        config = {}
        for k, v in self.param_space.items():
            if isinstance(v, GridSearch):
                config[k] = self.rng.choice(v.values)
            elif isinstance(v, Domain):
                config[k] = v.sample(self.rng)
            elif callable(v) and not isinstance(v, type):
                config[k] = v()
            else:
                config[k] = v
        return config

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        if len(self._observations) < self.n_startup:
            config = self._random_config()
        else:
            config = self._tpe_config()
        self._configs[trial_id] = config
        return config

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None):
        config = self._configs.pop(trial_id, None)
        if config is None or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score  # store as minimization
        self._observations.append((config, score))

    # -- TPE core --------------------------------------------------------
    def _split(self):
        ranked = sorted(self._observations, key=lambda cs: cs[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        return [c for c, _ in ranked[:n_good]], [c for c, _ in ranked[n_good:]]

    def _tpe_config(self) -> Dict:
        good, bad = self._split()
        best, best_score = None, -float("inf")
        for _ in range(self.n_candidates):
            cand = {}
            ratio = 0.0
            for k, dom in self.param_space.items():
                if isinstance(dom, (Uniform, LogUniform, RandInt)):
                    val, r = self._numeric_dim(k, dom, good, bad)
                elif isinstance(dom, (Choice, GridSearch)):
                    cats = dom.categories if isinstance(dom, Choice) else dom.values
                    val, r = self._categorical_dim(k, cats, good, bad)
                elif isinstance(dom, Domain):
                    val, r = dom.sample(self.rng), 0.0
                else:
                    val, r = (dom() if callable(dom) and not isinstance(dom, type)
                              else dom), 0.0
                cand[k] = val
                ratio += r
            if ratio > best_score:
                best, best_score = cand, ratio
        return best

    def _numeric_dim(self, key, dom, good, bad):
        import math

        log = isinstance(dom, LogUniform)
        to_x = (lambda v: math.log(v)) if log else (lambda v: float(v))
        lo, hi = to_x(dom.low), to_x(dom.high if not isinstance(dom, RandInt)
                                     else dom.high - 1)
        goods = [to_x(c[key]) for c in good if key in c]
        bads = [to_x(c[key]) for c in bad if key in c]
        width = max(hi - lo, 1e-12)
        # Silverman-style bandwidth from the good points' spread: a
        # domain-width-based bandwidth degenerates with few goods (kernels
        # so wide the acquisition peaks at the domain boundary).
        n = max(len(goods), 1)
        if len(goods) >= 2:
            mean = sum(goods) / n
            spread = (sum((g - mean) ** 2 for g in goods) / n) ** 0.5
            spread = spread or width * 0.05
        else:
            spread = width * 0.25
        bw = max(min(1.06 * spread * n ** -0.2, width), width * 0.02)
        # Sample from l(x): pick a good point's kernel, draw, clamp.
        center = self.rng.choice(goods) if goods else self.rng.uniform(lo, hi)
        x = min(hi, max(lo, self.rng.gauss(center, bw)))

        def kde(pts, x):
            if not pts:
                return 1.0 / width  # uniform prior
            s = sum(
                math.exp(-0.5 * ((x - p) / bw) ** 2) / (bw * 2.5066282746)
                for p in pts
            )
            # Mix with the uniform prior so g(x) never hits zero.
            return 0.9 * s / len(pts) + 0.1 / width

        ratio = math.log(kde(goods, x)) - math.log(kde(bads, x))
        val = math.exp(x) if log else x
        if isinstance(dom, RandInt):
            val = min(dom.high - 1, max(dom.low, int(round(val))))
        return val, ratio

    def _categorical_dim(self, key, cats, good, bad):
        import math

        def probs(configs):
            counts = {repr(c): 1.0 for c in cats}  # +1 smoothing
            for cfg in configs:
                if key in cfg:
                    counts[repr(cfg[key])] = counts.get(repr(cfg[key]), 1.0) + 1
            total = sum(counts.values())
            return {k: v / total for k, v in counts.items()}

        pg, pb = probs(good), probs(bad)
        # Sample category from l, score by log ratio.
        cats_list = list(cats)
        weights = [pg[repr(c)] for c in cats_list]
        val = self.rng.choices(cats_list, weights=weights, k=1)[0]
        return val, math.log(pg[repr(val)]) - math.log(pb[repr(val)])


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions (reference: tune/search/ConcurrencyLimiter)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self.live: set = set()

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if len(self.live) >= self.max_concurrent:
            return PAUSED  # at cap now; ask again after a completion
        config = self.searcher.suggest(trial_id)
        if config is not None and config is not PAUSED:
            self.live.add(trial_id)
        return config

    def on_trial_complete(self, trial_id: str, result=None):
        self.live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)


class ExternalSearcher(Searcher):
    """Adapter seam for third-party optimizers (the role of the
    reference's tune/search/ integrations — optuna/hyperopt/etc. each
    wrap an external ask/tell library behind Searcher).

    Wrap ANY object exposing `ask() -> (token, config)` and
    `tell(token, score)` (the near-universal external-optimizer
    protocol); metric extraction and min/max normalization happen here,
    so the external library always minimizes.
    """

    def __init__(self, external, metric: str, mode: str = "min",
                 num_samples: int = 32):
        assert mode in ("min", "max")
        if not callable(getattr(external, "ask", None)) or not callable(
            getattr(external, "tell", None)
        ):
            raise TypeError(
                "external optimizer must expose ask() -> (token, config) "
                "and tell(token, score)"
            )
        self.external = external
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self._suggested = 0
        self._tokens: Dict[str, Any] = {}

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._suggested >= self.num_samples:
            return None
        self._suggested += 1
        token, config = self.external.ask()
        self._tokens[trial_id] = token
        return dict(config)

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None):
        token = self._tokens.pop(trial_id, None)
        if token is None or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score
        try:
            self.external.tell(token, score)
        except Exception:  # noqa: BLE001 — a broken lib must not kill tuning
            pass


class BOHBSearcher(TPESearcher):
    """Bayesian-optimization HyperBand searcher (reference: TuneBOHB,
    tune/search/bohb/ — BOHB, Falkner et al. 2018). Pair with
    ASHAScheduler (the HyperBandForBOHB role): the scheduler provides the
    successive-halving rungs; this searcher fits its TPE model on results
    from the HIGHEST fidelity (training_iteration rung) that has enough
    observations, falling back rung-by-rung — BOHB's model-selection
    rule — instead of modeling only completed trials.
    """

    def __init__(self, param_space: Dict, metric: str, mode: str = "min",
                 time_attr: str = "training_iteration", **kwargs):
        super().__init__(param_space, metric, mode, **kwargs)
        self.time_attr = time_attr
        # rung (fidelity) -> list[(config, minimized_score)]
        self._rung_obs: Dict[int, List[tuple]] = {}

    def on_trial_result(self, trial_id: str, result: Dict):
        """Intermediate results land in their fidelity rung."""
        config = self._configs.get(trial_id)
        if config is None or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score
        rung = int(result.get(self.time_attr, 0))
        self._rung_obs.setdefault(rung, []).append((dict(config), score))
        self._refresh_model()

    def on_trial_complete(self, trial_id: str, result: Optional[Dict] = None):
        super().on_trial_complete(trial_id, result)
        self._refresh_model()

    def _refresh_model(self):
        """Model on the highest rung with >= n_startup points (BOHB's
        choose-the-best-budget rule); completed-trial observations from
        the base class stay as the fallback."""
        for rung in sorted(self._rung_obs, reverse=True):
            obs = self._rung_obs[rung]
            if len(obs) >= self.n_startup:
                self._observations = list(obs)
                return
