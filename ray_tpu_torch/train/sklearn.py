"""SklearnTrainer: fit a scikit-learn estimator as a Train run (the port
of ray_tpu/train/sklearn.py; host only).

Reference analog: ray.train.sklearn.SklearnTrainer
(train/sklearn/sklearn_trainer.py) — fits the estimator in a remote
worker (sklearn releases the GIL in its C loops; parallelism comes from
the estimator's own n_jobs), scores it on the validation datasets, and
returns a Result whose checkpoint holds the fitted model. CV metrics ride
in via ``cv`` the way the reference's ``cv`` param works.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import BaseTrainer

MODEL_KEY = "model"


def _to_xy(ds, label_column: str):
    """Materialize a ray_tpu_torch.data Dataset (or pass through (X, y) /
    dict-of-arrays) into feature matrix + label vector."""
    if isinstance(ds, tuple):
        return np.asarray(ds[0]), np.asarray(ds[1])
    if hasattr(ds, "take_all"):  # Dataset
        rows = ds.take_all()
        if not rows:
            raise ValueError("dataset split is empty")
        y = np.asarray([r[label_column] for r in rows])
        feats = [
            {k: v for k, v in r.items() if k != label_column} for r in rows
        ]
        keys = sorted(feats[0])
        X = np.asarray([[f[k] for k in keys] for f in feats])
        return X, y
    if isinstance(ds, dict):
        y = np.asarray(ds[label_column])
        keys = sorted(k for k in ds if k != label_column)
        if not keys or not len(y):
            raise ValueError("dataset split is empty")
        X = np.column_stack([np.asarray(ds[k]) for k in keys])
        return X, y
    raise TypeError(f"unsupported dataset type: {type(ds)}")


@rt.remote
def _fit_task(estimator, datasets, label_column, cv, scoring):
    import pickle
    import time

    from sklearn.base import clone
    from sklearn.model_selection import cross_validate

    X, y = _to_xy(datasets["train"], label_column)
    metrics: Dict[str, Any] = {}
    if cv:
        cv_est = clone(estimator)
        t0 = time.perf_counter()
        scores = cross_validate(cv_est, X, y, cv=cv, scoring=scoring)
        metrics["cv"] = {
            k: {"mean": float(np.mean(v)), "std": float(np.std(v))}
            for k, v in scores.items()
        }
        metrics["cv_time_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    estimator.fit(X, y)
    metrics["fit_time_s"] = round(time.perf_counter() - t0, 3)
    for name, ds in datasets.items():
        if name == "train":
            continue
        Xv, yv = _to_xy(ds, label_column)
        metrics[f"{name}_score"] = float(estimator.score(Xv, yv))
        # Requested scoring metrics apply to every validation split too
        # (not only under cv — the reference scores splits with them).
        for sc in scoring or []:
            from sklearn.metrics import get_scorer

            metrics[f"{name}_{sc}"] = float(
                get_scorer(sc)(estimator, Xv, yv)
            )
    metrics["train_score"] = float(estimator.score(X, y))
    return pickle.dumps(estimator), metrics


class SklearnTrainer(BaseTrainer):
    """Fit + score an sklearn estimator in a remote worker.

    datasets: {"train": ..., "valid": ..., ...} where each entry is a
    ray_tpu_torch.data Dataset (rows of feature columns + label_column),
    a dict of column arrays or an (X, y) tuple. Extra splits are scored
    with estimator.score and land in metrics as "<name>_score".
    """

    def __init__(
        self,
        *,
        estimator,
        datasets: Dict[str, Any],
        label_column: str = "y",
        cv: Optional[int] = None,
        scoring: Optional[List[str]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config)
        assert "train" in datasets, 'datasets must include a "train" split'
        self.estimator = estimator
        self.datasets = datasets
        self.label_column = label_column
        self.cv = cv
        self.scoring = scoring

    def fit(self) -> Result:
        res = self.scaling_config.resources_per_worker or {}
        num_cpus = res.get("CPU", 1)
        try:
            blob, metrics = rt.get(
                _fit_task.options(num_cpus=num_cpus).remote(
                    self.estimator, self.datasets, self.label_column,
                    self.cv, self.scoring,
                ),
                timeout=3600,
            )
        except Exception as e:  # noqa: BLE001
            return Result(metrics={}, checkpoint=None, error=e)
        ckpt = Checkpoint.from_dict({MODEL_KEY: blob})
        return Result(metrics=metrics, checkpoint=ckpt, error=None)

    @staticmethod
    def get_model(checkpoint: Checkpoint):
        """Deserialize the fitted estimator from a Result checkpoint
        (reference: sklearn_checkpoint.SklearnCheckpoint.get_model)."""
        import pickle

        return pickle.loads(checkpoint.to_dict()[MODEL_KEY])
