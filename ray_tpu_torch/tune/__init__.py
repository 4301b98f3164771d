"""ray_tpu_torch.tune: hyperparameter search (the port of ray_tpu/tune/).

Public surface mirrors the reference's ray.tune: Tuner/TuneConfig/
ResultGrid, sample domains (uniform/loguniform/choice/randint/grid_search),
schedulers (ASHA, median stopping), and tune.report inside trials.
Importing it loads no torch: a trial that trains on the card imports
torch in its own function, inside the trial actor. A trial asks for the
card as `tune.with_resources(fn, {"CPU": 1, "GPU": 1})`; the raylet
grants it a card id and sets CUDA_VISIBLE_DEVICES in the trial's worker
before any CUDA context exists.
"""

from typing import Dict, Optional

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BOHBSearcher,
    BasicVariantGenerator,
    Choice,
    ExternalSearcher,
    ConcurrencyLimiter,
    Domain,
    GridSearch,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner


def with_parameters(trainable, **large_objects):
    """Attach large constant objects to a trainable WITHOUT serializing
    them into every trial's config (reference: tune.with_parameters):
    each object goes to the object store once; trials fetch by ref.

        tuner = Tuner(tune.with_parameters(train_fn, data=big_df), ...)
        def train_fn(config, data): ...
    """
    import ray_tpu_torch as rt

    refs = {k: rt.put(v) for k, v in large_objects.items()}

    def wrapped(config):
        resolved = {k: rt.get(r) for k, r in refs.items()}
        return trainable(config, **resolved)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    if hasattr(trainable, "_tune_resources"):
        # Compose with with_resources in either order.
        wrapped._tune_resources = trainable._tune_resources
    return wrapped


def with_resources(trainable, resources: Dict[str, float]):
    """Attach per-trial resource requests to a trainable (reference:
    tune.with_resources): every trial actor of this trainable requests
    them, overriding TuneConfig.trial_resources.

        tuner = Tuner(tune.with_resources(train_fn, {"CPU": 2}), ...)
    """

    import copy
    import functools

    if hasattr(trainable, "as_trainable"):
        # Trainer objects keep their as_trainable dispatch: pin the
        # resources on a copy instead of wrapping.
        t = copy.copy(trainable)
        t._tune_resources = dict(resources)
        return t

    # functools.wraps sets __wrapped__, so the trial runner's signature
    # inspection sees the original arity — no dispatch duplication here.
    @functools.wraps(trainable)
    def wrapped(*args, **kwargs):
        return trainable(*args, **kwargs)

    wrapped._tune_resources = dict(resources)
    return wrapped


def report(metrics: Dict, checkpoint=None):
    """Report metrics from inside a trial (reference: tune.report /
    session.report)."""
    from ray_tpu_torch.tune.session_bridge import get_active_session

    get_active_session().report(metrics, checkpoint)


def get_checkpoint():
    from ray_tpu_torch.tune.session_bridge import get_active_session

    return get_active_session().get_checkpoint()


__all__ = [
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "report",
    "get_checkpoint",
    "with_parameters",
    "with_resources",
    "uniform",
    "loguniform",
    "choice",
    "randint",
    "grid_search",
    "BasicVariantGenerator",
    "ConcurrencyLimiter",
    "Searcher",
    "TPESearcher",
    "BOHBSearcher",
    "ExternalSearcher",
    "ASHAScheduler",
    "PB2",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "FIFOScheduler",
    "TrialScheduler",
    "Domain",
    "Choice",
    "GridSearch",
]
