"""Tuner: the experiment controller (the port of ray_tpu/tune/tuner.py).

Analog of the reference's Tuner.fit (tune/tuner.py:346) → tune.run
(tune/tune.py:234) → TuneController (tune/execution/tune_controller.py:72,
event loop step() :709) managing Trials as remote actors. Collapsed here
into one controller loop: trials run as session-carrying actors
(reference: Trainable actors in placement groups), the searcher feeds
configs, the scheduler may stop trials early, and experiment state is
snapshotted to storage for restore.

A trial's actor is launched without waiting for it to be placed: until
it is placed the trial stays PENDING, and the loop goes on polling the
running ones. So on a node with one card and `{"GPU": 1}` trials, the
next trial waits in the scheduler for the card while the loop reaps the
trial that holds it. (The JAX package waits up to 300 s inside the
launch for the actor's `run`, before the loop can kill a finished
trial's actor: there the second of several one-card trials blocks until
that wait times out.)

A trainer passed to the Tuner runs through `as_trainable()`, as in the
JAX package:
  * the trial actor runs `fit()`, which places the trainer's own gang;
    so the trial actor must not hold the card its gang needs. Leave the
    trial's resources at their default (one CPU) and give the card to
    the gang through `ScalingConfig(use_gpu=True)`: a trial actor that
    holds the only card leaves the gang waiting for it forever;
  * the trial reports once, after `fit()` returns, with the trainer's
    last metrics, so a scheduler cannot stop a trainer's trial early:
    sweep trainers with a search and no early stopping.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig
from ray_tpu_torch.tune.schedulers import (
    CONTINUE,
    EXPLOIT,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import PAUSED, BasicVariantGenerator, Searcher


@dataclass
class TuneConfig:
    """Analog of tune.TuneConfig."""

    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    trial_resources: Optional[Dict[str, float]] = None
    seed: Optional[int] = None


@rt.remote(max_concurrency=2)
class _TrialActor:
    """Runs one trial's function with a reporting session (reference:
    Trainable actor, tune/trainable/trainable.py:61).

    The function runs inside the `run` call, which returns only when the
    function does; `poll` is served beside it. So a trial stopped, or
    replaced, while its function runs ends with its worker's process,
    the card it held included: the runtime recycles a killed actor's
    worker only when no call is running, and a function on a thread of
    its own would go on training in a recycled worker. (The JAX package
    starts the function on a thread of its own and returns.)"""

    def __init__(self, trial_id: str, trial_dir: str):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self._error = None
        self._done = False
        self.session = None

    def ready(self):
        return True

    def run(self, fn, config, checkpoint):
        import inspect
        import traceback

        import ray_tpu_torch.tune.session_bridge as bridge
        from ray_tpu_torch.train.session import TrainSession

        self.session = TrainSession(
            world_rank=0,
            world_size=1,
            config=config,
            checkpoint=checkpoint,
            trial_dir=self.trial_dir,
        )
        bridge.set_active_session(self.session)
        try:
            params = list(inspect.signature(fn).parameters)
            if len(params) >= 2:
                fn(config, self.session)
            else:
                fn(config)
        except BaseException as e:  # noqa: BLE001 — reported by poll()
            self._error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
        finally:
            self._done = True
        return True

    def poll(self):
        reports = self.session.drain() if self.session else []
        return {
            "reports": [
                {
                    "metrics": r["metrics"],
                    "checkpoint_path": r["checkpoint"].path if r["checkpoint"] else None,
                }
                for r in reports
            ],
            "done": self._done,
            "error": self._error,
        }


@dataclass
class Trial:
    trial_id: str
    config: Dict
    state: str = "PENDING"  # PENDING RUNNING TERMINATED STOPPED ERROR
    actor: Any = None
    last_metrics: Dict = field(default_factory=dict)
    metrics_history: List[Dict] = field(default_factory=list)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    iteration: int = 0
    trial_dir: str = ""
    failures: int = 0
    placed: Any = None  # the ref of the actor's ready(): set once placed
    run_args: tuple = ()  # (config, checkpoint) for the actor's run()
    running: Any = None  # the ref of its run(): set when the function ends


class ResultGrid:
    """Analog of tune.ResultGrid."""

    def __init__(self, results: List[Result], trials: List[Trial],
                 metric: Optional[str], mode: str):
        self._results = results
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric)")
        candidates = [r for r in self._results if metric in (r.metrics or {})]
        if not candidates:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            candidates, key=lambda r: r.metrics[metric]
        )

    def get_dataframe(self):
        rows = []
        for t, r in zip(self._trials, self._results):
            row = {"trial_id": t.trial_id, **{f"config/{k}": v for k, v in t.config.items()}}
            row.update(r.metrics or {})
            rows.append(row)
        return rows


class Tuner:
    """Analog of tune.Tuner (tuner.py:346)."""

    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[Dict] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        # Trainers adapt via as_trainable() (reference: base_trainer.py:839).
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_state: Optional[List[Dict]] = None

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its directory
        (reference: Tuner.restore, tune/tuner.py): finished trials keep
        their recorded results; unfinished ones re-run from their newest
        checkpoint. `path` is the experiment dir (the run's
        resolved_storage_path)."""
        path = os.path.abspath(path)
        state_file = os.path.join(path, "experiment_state.json")
        with open(state_file) as f:
            state = json.load(f)
        run_config = RunConfig(
            name=os.path.basename(path),
            storage_path=os.path.dirname(path),
        )
        tuner = cls(trainable, tune_config=tune_config,
                    run_config=run_config)
        tuner._restore_state = state
        return tuner


    def fit(self) -> ResultGrid:
        tc = self.tune_config
        searcher = tc.search_alg or BasicVariantGenerator(
            self.param_space, num_samples=tc.num_samples, seed=tc.seed
        )
        scheduler = tc.scheduler or FIFOScheduler()
        exp_dir = self.run_config.resolved_storage_path()
        os.makedirs(exp_dir, exist_ok=True)

        max_concurrent = tc.max_concurrent_trials or 4
        # Per-trainable resources (tune.with_resources) win over the
        # TuneConfig default (matching the reference's precedence).
        resources = (
            getattr(self.trainable, "_tune_resources", None)
            or tc.trial_resources
            or {"CPU": 1.0}
        )

        trials: List[Trial] = []
        live: List[Trial] = []
        exhausted = False

        # Tuner.restore: completed trials keep their results; unfinished
        # ones re-queue with their recorded checkpoint. The searcher is
        # not consulted — the experiment's trial set is already decided.
        pending_restore: List[tuple] = []
        if self._restore_state is not None:
            exhausted = True
            for t in self._restore_state:
                # TERMINATED ran to completion; STOPPED was cut by the
                # scheduler on purpose — re-running it would re-spend the
                # compute early stopping deliberately saved. Both keep
                # their recorded results.
                if t["state"] in ("TERMINATED", "STOPPED"):
                    done = Trial(
                        trial_id=t["trial_id"], config=t["config"],
                        state=t["state"],
                        last_metrics=t.get("last_metrics") or {},
                        trial_dir=os.path.join(
                            exp_dir, f"trial_{t['trial_id']}"
                        ),
                    )
                    if t.get("checkpoint_path"):
                        done.checkpoint = Checkpoint.from_directory(
                            t["checkpoint_path"]
                        )
                    trials.append(done)
                else:
                    ckpt = (
                        Checkpoint.from_directory(t["checkpoint_path"])
                        if t.get("checkpoint_path") else None
                    )
                    pending_restore.append((t["trial_id"], t["config"], ckpt))

        # Controller event loop (reference: TuneController.step :709).
        while True:
            # Re-launch restored trials first, then consult the searcher.
            while pending_restore and len(live) < max_concurrent:
                trial_id, config, ckpt = pending_restore.pop(0)
                trial = Trial(trial_id=trial_id, config=config)
                trial_dir = os.path.join(exp_dir, f"trial_{trial_id}")
                os.makedirs(trial_dir, exist_ok=True)
                trial.trial_dir = trial_dir
                trial.checkpoint = ckpt
                self._launch_actor(trial, config, ckpt, resources)
                if hasattr(scheduler, "on_trial_add"):
                    scheduler.on_trial_add(trial_id, config)
                trials.append(trial)
                live.append(trial)
            # Launch new trials up to the concurrency cap.
            while not exhausted and len(live) < max_concurrent:
                trial_id = uuid.uuid4().hex[:8]
                config = searcher.suggest(trial_id)
                if config is PAUSED:
                    break  # nothing right now (e.g. ConcurrencyLimiter cap)
                if config is None:
                    exhausted = True
                    break
                trial = Trial(trial_id=trial_id, config=config)
                trial_dir = os.path.join(exp_dir, f"trial_{trial_id}")
                os.makedirs(trial_dir, exist_ok=True)
                trial.trial_dir = trial_dir
                self._launch_actor(trial, config, None, resources)
                if hasattr(scheduler, "on_trial_add"):
                    scheduler.on_trial_add(trial_id, config)
                trials.append(trial)
                live.append(trial)

            if not live and exhausted and not pending_restore:
                break

            # Poll live trials (per-trial isolation: one crashed actor
            # must not take down the controller loop).
            polls = []
            for t in live:
                try:
                    if t.state == "PENDING":
                        polls.append(self._start_if_placed(t))
                        continue
                    polls.append(rt.get(t.actor.poll.remote(), timeout=300))
                except Exception as e:  # noqa: BLE001 — actor/worker died
                    polls.append({"crashed": str(e)})
            still_live = []
            for trial, st in zip(live, polls):
                if st is None:  # not placed yet, or started this round
                    still_live.append(trial)
                    continue
                if "crashed" in st:
                    # Trial-level fault tolerance (FailureConfig.max_failures,
                    # reference air/config.py:377): restart the trial actor
                    # from its newest checkpoint. A FAILED restart keeps the
                    # trial live so the next poll retries it (counting
                    # against the same budget) — it must never abort fit().
                    trial.failures += 1
                    budget = self.run_config.failure_config.max_failures
                    if budget < 0 or trial.failures <= budget:
                        try:
                            self._restart_trial(trial, resources)
                        except Exception:  # noqa: BLE001 — retried next poll
                            pass
                        still_live.append(trial)
                    else:
                        trial.state = "ERROR"
                        trial.error = (
                            f"trial crashed {trial.failures}x "
                            f"(max_failures={budget}): {st['crashed']}"
                        )
                        try:
                            rt.kill(trial.actor)  # may be hung, not dead
                        except Exception:  # noqa: BLE001
                            pass
                        scheduler.on_complete(trial.trial_id, trial.last_metrics)
                        searcher.on_trial_complete(trial.trial_id, trial.last_metrics)
                    continue
                exploited = False
                for rep in st["reports"]:
                    trial.iteration += 1
                    metrics = dict(rep["metrics"])
                    metrics.setdefault("training_iteration", trial.iteration)
                    trial.last_metrics = metrics
                    trial.metrics_history.append(metrics)
                    if rep["checkpoint_path"]:
                        trial.checkpoint = Checkpoint.from_directory(
                            rep["checkpoint_path"]
                        )
                        if hasattr(scheduler, "record_checkpoint"):
                            scheduler.record_checkpoint(
                                trial.trial_id, rep["checkpoint_path"]
                            )
                    if hasattr(searcher, "on_trial_result"):
                        # Multi-fidelity searchers (BOHB) model
                        # intermediate rung results, not just finals.
                        searcher.on_trial_result(trial.trial_id, metrics)
                    decision = scheduler.on_result(trial.trial_id, metrics)
                    if decision == STOP and not st["done"]:
                        trial.state = "STOPPED"
                    elif decision == EXPLOIT and not st["done"]:
                        exploited = self._exploit(trial, scheduler, resources)
                        if exploited:
                            break  # fresh actor: stale reports are moot
                if exploited:
                    still_live.append(trial)
                    continue
                if st["error"]:
                    trial.state = "ERROR"
                    trial.error = st["error"]
                elif st["done"] and trial.state == "RUNNING":
                    trial.state = "TERMINATED"
                if trial.state in ("RUNNING",):
                    still_live.append(trial)
                else:
                    scheduler.on_complete(trial.trial_id, trial.last_metrics)
                    searcher.on_trial_complete(trial.trial_id, trial.last_metrics)
                    try:
                        rt.kill(trial.actor)
                    except Exception:
                        pass
            live = still_live
            self._snapshot(exp_dir, trials)
            if live or not exhausted:
                time.sleep(0.05)

        results = [
            Result(
                metrics=t.last_metrics,
                checkpoint=t.checkpoint,
                error=RuntimeError(t.error) if t.error else None,
                path=os.path.join(exp_dir, f"trial_{t.trial_id}"),
                metrics_history=t.metrics_history,
            )
            for t in trials
        ]
        return ResultGrid(results, trials, tc.metric, tc.mode)

    def _launch_actor(self, trial: Trial, config, checkpoint, resources):
        """The single trial-actor launch path (initial, exploit, restart).
        Returns at once: the trial is PENDING until the actor is placed."""
        trial.actor = _TrialActor.options(
            num_cpus=resources.get("CPU", 1.0),
            resources={k: v for k, v in resources.items() if k != "CPU"},
        ).remote(trial.trial_id, trial.trial_dir)
        trial.placed = trial.actor.ready.remote()
        trial.run_args = (config, checkpoint)
        trial.state = "PENDING"

    def _start_if_placed(self, trial: Trial):
        """Start a PENDING trial's function once its actor is placed.
        `run` goes out alone: calls sent to an actor together travel in
        one frame, whose reply waits for the slowest of them, and `run`
        returns only when the function does. So `run` is sent only after
        `ready` has answered, and a call through the runtime's event loop
        (which sends pending calls first) closes its frame before the
        trial's first poll."""
        if not rt.wait([trial.placed], timeout=0)[0]:
            return None
        rt.get(trial.placed)  # raises if the actor could not be made
        trial.running = trial.actor.run.remote(self.trainable,
                                               *trial.run_args)
        rt.nodes()
        trial.state = "RUNNING"
        return None

    def _restart_trial(self, trial: Trial, resources):
        """Replace a crashed trial actor, resuming from its checkpoint."""
        try:
            rt.kill(trial.actor)
        except Exception:  # noqa: BLE001
            pass
        self._launch_actor(trial, trial.config, trial.checkpoint, resources)

    def _exploit(self, trial: Trial, scheduler, resources) -> bool:
        """PBT exploit/explore: restart the trial from a donor's checkpoint
        with a mutated config (reference: pbt.py _exploit)."""
        ckpt_path, new_config = scheduler.make_exploit(trial.trial_id)
        if ckpt_path is None:
            return False
        try:
            rt.kill(trial.actor)
        except Exception:
            pass
        trial.config = new_config
        self._launch_actor(
            trial, new_config, Checkpoint.from_directory(ckpt_path),
            resources,
        )
        return True

    def _snapshot(self, exp_dir: str, trials: List[Trial]):
        """Experiment state snapshot (reference:
        tune/execution/experiment_state.py)."""
        state = [
            {
                "trial_id": t.trial_id,
                "config": _json_safe(t.config),
                "state": t.state,
                "last_metrics": _json_safe(t.last_metrics),
                "error": t.error,
                # Restoration point for Tuner.restore (user checkpoints
                # live wherever tune.report was given them).
                "checkpoint_path": t.checkpoint.path if t.checkpoint else None,
            }
            for t in trials
        ]
        # Write-then-rename: a driver killed mid-snapshot (the exact
        # scenario Tuner.restore exists for) must never truncate the
        # state file into unrestorability.
        path = os.path.join(exp_dir, "experiment_state.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=2)
        os.replace(tmp, path)


def _json_safe(d):
    try:
        json.dumps(d)
        return d
    except TypeError:
        return {k: str(v) for k, v in d.items()}
