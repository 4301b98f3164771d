"""The port's Tune (ray_tpu_torch.tune) held against the JAX package's,
case by case: tests/test_tune.py.

Searchers and schedulers are pure Python: the same seeded draws and the
same stream of metrics go through both packages here, and their configs
and decisions must be equal. Cases that need the runtime run in one
driver script per package (the harness of test_torch_serve_api.py), one
after the other, and each test compares the two outcomes and the
outcome the JAX test asserts:
  * the Tuner over function trainables (grid, random, a concurrency
    limiter, ASHA, errors, crashes with restarts, restore,
    with_parameters, with_resources);
  * the Tuner over a trainer: a trivial loop, and `configs.tiny` trained
    in f32 from one JAX `init_params` tree by `Tuner(JaxTrainer)` and
    `Tuner(TorchTrainer)` on the same batches, which must pick the same
    best learning rate with metrics within 2e-3 (the f32 gradient
    tolerance of tests/test_torch_train_parity.py);
  * three `{"CPU": 1, "GPU": 1}` trials on a node with one GPU (faked)
    at the default concurrency: the port runs all three, while the JAX
    package's launch waits for the second trial's actor, which waits for
    the card that the first trial's finished actor still holds;
  * a trial that ASHA stops while its function runs: the port ends it,
    the JAX package's function runs on in a recycled worker.
The PBT case carries `slow`, as its JAX counterpart does, and runs the
port alone: the JAX package's own case fails on a 4-CPU runtime here.
"""

import json
import random

import numpy as np
import pytest

from tests.test_torch_serve_api import PRELUDE, run_driver

TOL = 2e-3
# How long the one-GPU case waits, after the first trial's function
# ended, for the fit to finish: the port's remaining two trials take a
# few seconds; the JAX package's launch would wait 300 s.
ONE_GPU_WAIT_S = 10.0

DRIVER = PRELUDE + r'''
import tempfile
import threading

tune = importlib.import_module(pkg + ".tune")
train = importlib.import_module(pkg + ".train")
RunConfig = train.RunConfig
weights = sys.argv[2]
ONE_GPU_WAIT_S = float(sys.argv[3])
tmp = tempfile.mkdtemp(prefix="tune_" + pkg + "_")


def sub(name):
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    return d


def case(out, name, fn, num_cpus=4):
    """One case on a fresh runtime, as each JAX test gets its own."""
    if pkg == "ray_tpu":
        rt.init(num_cpus=num_cpus, resources={"GPU": 1})
    else:
        rt.init(num_cpus=num_cpus, num_gpus=1)
    try:
        out[name] = fn()
    except Exception as e:  # noqa: BLE001 — recorded, compared by the test
        import traceback
        traceback.print_exc()
        out[name] = ["raised", type(e).__name__, str(e)[:300]]
    if name != "one_gpu_trials":
        rt.shutdown()


def metrics(grid, keys):
    return [{k: r.metrics.get(k) for k in keys} for r in grid]


def _objective(config):
    tune = importlib.import_module(config["pkg"] + ".tune")
    tune.report({"loss": (config["x"] - 3.0) ** 2, "x": config["x"]})


def grid_search():
    d = sub("grid")
    g = tune.Tuner(_objective,
                   param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0]),
                                "pkg": pkg},
                   tune_config=tune.TuneConfig(metric="loss", mode="min"),
                   run_config=RunConfig(name="grid", storage_path=d)).fit()
    with open(os.path.join(d, "grid", "experiment_state.json")) as f:
        state = json.load(f)
    return {"results": metrics(g, ["loss", "x", "training_iteration"]),
            "best_x": g.get_best_result().metrics["x"],
            "snapshot": sorted((t["state"], t["config"]["x"]) for t in state)}


def random_search():
    g = tune.Tuner(_objective,
                   param_space={"x": tune.uniform(-1.0, 1.0), "pkg": pkg},
                   tune_config=tune.TuneConfig(metric="loss", mode="min",
                                               num_samples=5, seed=7),
                   run_config=RunConfig(name="rand",
                                        storage_path=sub("rand"))).fit()
    return [r.metrics["x"] for r in g]


def concurrency_limiter():
    searcher = tune.ConcurrencyLimiter(
        tune.BasicVariantGenerator(
            {"x": tune.grid_search([0.0, 1.0, 3.0, 5.0]), "pkg": pkg}),
        max_concurrent=2)
    g = tune.Tuner(_objective,
                   tune_config=tune.TuneConfig(metric="loss", mode="min",
                                               search_alg=searcher),
                   run_config=RunConfig(name="limited",
                                        storage_path=sub("limited"))).fit()
    return [len(g), g.get_best_result().metrics["x"]]


def _iterative(config):
    tune = importlib.import_module(config["pkg"] + ".tune")
    for i in range(1, 17):
        tune.report({"score": config["quality"] * i, "training_iteration": i})
        time.sleep(0.05)


def asha():
    g = tune.Tuner(
        _iterative,
        param_space={"quality": tune.grid_search([1.0, 0.9, 0.2, 0.1]),
                     "pkg": pkg},
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.ASHAScheduler(metric="score", mode="max",
                                         grace_period=2, reduction_factor=2,
                                         max_t=16),
            max_concurrent_trials=4),
        run_config=RunConfig(name="asha", storage_path=sub("asha"))).fit()
    return {"best": g.get_best_result().metrics["score"],
            "iters": [len(r.metrics_history) for r in g]}


def _failing(config):
    tune = importlib.import_module(config["pkg"] + ".tune")
    if config["x"] == 1:
        raise ValueError("boom")
    tune.report({"loss": 0.0})


def trial_errors():
    g = tune.Tuner(_failing,
                   param_space={"x": tune.grid_search([0, 1]), "pkg": pkg},
                   tune_config=tune.TuneConfig(metric="loss", mode="min"),
                   run_config=RunConfig(name="err",
                                        storage_path=sub("err"))).fit()
    return [len(g.errors), "boom" in str(g.errors[0]),
            g.get_best_result().metrics["loss"]]


def _trainer_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    train.report({"final": config["lr"] * 10})


def Trainer(loop, **kw):
    """JaxTrainer or TorchTrainer (gloo), the same arguments."""
    if pkg == "ray_tpu":
        return train.JaxTrainer(loop, **kw)
    return train.TorchTrainer(loop, **kw)


def tune_over_trainer():
    trainer = Trainer(_trainer_loop,
                      train_loop_config={"lr": 0.0, "pkg": pkg},
                      scaling_config=train.ScalingConfig(num_workers=1),
                      run_config=RunConfig(name="inner",
                                           storage_path=sub("inner")))
    g = tune.Tuner(trainer, param_space={"lr": tune.grid_search([0.1, 0.3])},
                   tune_config=tune.TuneConfig(metric="final", mode="max",
                                               max_concurrent_trials=1),
                   run_config=RunConfig(name="outer",
                                        storage_path=sub("outer"))).fit()
    return [len(g), round(g.get_best_result().metrics["final"], 9)]


def _crashy(config):
    import tempfile as _tf

    tune = importlib.import_module(config["pkg"] + ".tune")
    Checkpoint = importlib.import_module(
        config["pkg"] + ".train.checkpoint").Checkpoint
    step = 0
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        with open(os.path.join(ckpt.path, "s.json")) as f:
            step = json.load(f)["step"]
    first_life = ckpt is None
    for step in range(step, 8):
        d = _tf.mkdtemp()
        with open(os.path.join(d, "s.json"), "w") as f:
            json.dump({"step": step}, f)
        tune.report({"step": step}, checkpoint=Checkpoint.from_directory(d))
        time.sleep(0.05)
        if first_life and step == 3:
            os._exit(1)  # the actor's process dies


def crash_restarts():
    g = tune.Tuner(_crashy,
                   param_space={"x": tune.grid_search([1]), "pkg": pkg},
                   tune_config=tune.TuneConfig(metric="step", mode="max"),
                   run_config=RunConfig(
                       name="crashy", storage_path=sub("crashy"),
                       failure_config=train.FailureConfig(max_failures=2))
                   ).fit()
    best = g.get_best_result()
    return [best.error is None, best.metrics["step"]]


def _always_crash(config):
    tune = importlib.import_module(config["pkg"] + ".tune")
    tune.report({"step": 0})
    time.sleep(0.1)
    os._exit(1)


def crash_budget():
    g = tune.Tuner(_always_crash,
                   param_space={"x": tune.grid_search([1]), "pkg": pkg},
                   tune_config=tune.TuneConfig(metric="step", mode="max"),
                   run_config=RunConfig(
                       name="crashy2", storage_path=sub("crashy2"),
                       failure_config=train.FailureConfig(max_failures=1))
                   ).fit()
    return [len(g.errors), "crashed 2x" in str(g.errors[0])]


def _resumable(config):
    import tempfile as _tf

    tune = importlib.import_module(config["pkg"] + ".tune")
    Checkpoint = importlib.import_module(
        config["pkg"] + ".train.checkpoint").Checkpoint
    start = 0
    ckpt = tune.get_checkpoint()
    if ckpt:
        with open(os.path.join(ckpt.path, "s.json")) as f:
            start = json.load(f)["step"] + 1
    with open(config["marker"], "a") as f:
        f.write(json.dumps({"x": config["x"], "start": start}) + "\n")
    if config["x"] == 99 and start == 0:
        d = _tf.mkdtemp()
        with open(os.path.join(d, "s.json"), "w") as f:
            json.dump({"step": 3}, f)
        tune.report({"score": 0.0}, checkpoint=Checkpoint.from_directory(d))
        raise RuntimeError("simulated interruption")
    tune.report({"score": float(config["x"] + start)})


def restore():
    d = sub("resume")
    marker = os.path.join(d, "runs.jsonl")
    first = tune.Tuner(
        _resumable,
        param_space={"x": tune.grid_search([1, 2, 99]), "marker": marker,
                     "pkg": pkg},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="resume-exp", storage_path=d)).fit()
    again = tune.Tuner.restore(
        os.path.join(d, "resume-exp"), _resumable,
        tune_config=tune.TuneConfig(metric="score", mode="max")).fit()
    with open(marker) as f:
        runs = [json.loads(ln) for ln in f]
    return {"first_errors": len(first.errors), "restored": len(again),
            "restored_errors": len(again.errors),
            "best": again.get_best_result().metrics["score"],
            "runs": {str(x): [r["start"] for r in runs if r["x"] == x]
                     for x in (1, 2, 99)}}


def with_parameters():
    data = np.arange(10_000, dtype=np.float64)

    def objective(config, data):
        tune = importlib.import_module(config["pkg"] + ".tune")
        tune.report({"total": float(data.sum()) + config["x"]})

    g = tune.Tuner(tune.with_parameters(objective, data=data),
                   param_space={"x": tune.grid_search([1.0, 2.0]),
                                "pkg": pkg},
                   tune_config=tune.TuneConfig(metric="total", mode="max"),
                   run_config=RunConfig(name="params",
                                        storage_path=sub("params"))).fit()
    return sorted(r.metrics["total"] for r in g)


def with_resources():
    def train_fn(config):
        tune = importlib.import_module(config["pkg"] + ".tune")
        tune.report({"score": config["x"] * 2})

    wrapped = tune.with_resources(train_fn, {"CPU": 2})
    g = tune.Tuner(wrapped,
                   param_space={"x": tune.grid_search([1, 2]), "pkg": pkg},
                   tune_config=tune.TuneConfig(trial_resources={"CPU": 0.5}),
                   run_config=RunConfig(name="res",
                                        storage_path=sub("res"))).fit()
    return [wrapped._tune_resources, sorted(r.metrics["score"] for r in g)]


# -- configs.tiny through Tuner(JaxTrainer) and Tuner(TorchTrainer) ----------
def nest(flat):
    tree = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers/"):
            tree["layers"][k[len("layers/"):]] = v
        else:
            tree[k] = v
    return tree


def batch(step):
    rng = np.random.default_rng(2000 + step)
    return rng.integers(0, 256, size=(2, 17)).astype(np.int32)


def jax_llama_loop(config):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu import train
    from ray_tpu.models import configs
    from ray_tpu.models import transformer as tf

    cfg = configs.tiny
    params = jax.tree_util.tree_map(
        jnp.asarray, nest(dict(np.load(config["weights"]))))
    opt = optax.adamw(config["lr"], weight_decay=1e-4)
    state = opt.init(params)
    for step in range(config["steps"]):
        loss, g = jax.value_and_grad(tf.loss_fn)(
            params, jnp.asarray(batch(step)), cfg)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        train.report({"step": step, "loss": float(loss)})


def torch_llama_loop(config):
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import configs, loss_fn, params_from_jax

    torch.set_num_threads(1)
    cfg = configs.tiny
    params = params_from_jax(nest(dict(np.load(config["weights"]))), cfg,
                             device="cpu")
    leaves = [params[k] for k in sorted(params) if k != "layers"]
    leaves += [params["layers"][k] for k in sorted(params["layers"])]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=config["lr"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    for step in range(config["steps"]):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, torch.from_numpy(batch(step)).long(), cfg)
        loss.backward()
        opt.step()
        train.report({"step": step, "loss": float(loss)})


def tiny_llama_over_trainer():
    loop = jax_llama_loop if pkg == "ray_tpu" else torch_llama_loop
    trainer = Trainer(loop,
                      train_loop_config={"weights": weights, "steps": 4},
                      scaling_config=train.ScalingConfig(num_workers=1),
                      run_config=RunConfig(name="llama",
                                           storage_path=sub("llama")))
    g = tune.Tuner(trainer,
                   param_space={"lr": tune.grid_search([0.0, 3e-3])},
                   tune_config=tune.TuneConfig(metric="loss", mode="min",
                                               max_concurrent_trials=1),
                   run_config=RunConfig(name="sweep",
                                        storage_path=sub("sweep"))).fit()
    best = g.get_best_result()
    return {"errors": [str(e)[:300] for e in g.errors],
            "losses": [r.metrics["loss"] for r in g],
            "steps": [r.metrics["step"] for r in g],
            "best_lr": next(row["config/lr"] for row, r
                            in zip(g.get_dataframe(), g) if r is best)}


# -- a trial that ASHA stops while its function runs ------------------------------
def _slow_steps(config):
    tune = importlib.import_module(config["pkg"] + ".tune")
    d, q = config["dir"], config["q"]
    with open(os.path.join(d, f"pid_{q}"), "w") as f:
        f.write(str(os.getpid()))
    for i in range(1, 41):
        time.sleep(0.1)
        with open(os.path.join(d, f"q{q}"), "a") as f:
            f.write(f"{i}\n")
        tune.report({"score": q * i, "q": q})
        # The next step waits for the scheduler to let this report go on
        # (or for the fit to have returned), so a stopped trial reports
        # nothing past the step it was stopped at, however late the poll.
        while not (os.path.exists(os.path.join(d, f"go_{q}_{i}"))
                   or os.path.exists(os.path.join(d, "released"))):
            time.sleep(0.01)


def stopped_trial_stops():
    d = sub("stopped")
    schedulers = importlib.import_module(pkg + ".tune.schedulers")

    class Releasing(tune.ASHAScheduler):
        """ASHA that marks each result it does not stop."""

        def on_result(self, trial_id, result):
            decision = super().on_result(trial_id, result)
            if decision != schedulers.STOP:
                open(os.path.join(d, f"go_{result['q']}_"
                                     f"{result['training_iteration']}"),
                     "w").close()
            return decision

    g = tune.Tuner(
        _slow_steps,
        param_space={"q": tune.grid_search([1.0, 0.1]), "pkg": pkg, "dir": d},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=1,
            scheduler=Releasing(metric="score", mode="max", grace_period=2,
                                reduction_factor=2, max_t=4)),
        run_config=RunConfig(name="stopped", storage_path=d)).fit()

    def steps():
        with open(os.path.join(d, "q0.1")) as f:
            return len(f.read().split())

    at_return = steps()
    # Release the steps only once the stopped trial's process has gone
    # (or 3 s on): a function that still runs then goes on.
    with open(os.path.join(d, "pid_0.1")) as f:
        pid = int(f.read())
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except OSError:
            break
        time.sleep(0.05)
    open(os.path.join(d, "released"), "w").close()
    time.sleep(1.0)
    return {"reported": [len(r.metrics_history) for r in g],
            "stopped_early": at_return < 40,
            "ran_on_after_fit": steps() > at_return}


# -- three one-GPU trials on one GPU -------------------------------------------
def _gpu_trial(config):
    tune = importlib.import_module(config["pkg"] + ".tune")
    open(os.path.join(config["dir"], f"start_{config['i']}"), "w").close()
    tune.report({"loss": float(config["i"])})
    open(os.path.join(config["dir"], f"end_{config['i']}"), "w").close()


def one_gpu_trials():
    d = sub("gpu")
    out = {}

    def fit():
        try:
            g = tune.Tuner(
                tune.with_resources(_gpu_trial, {"CPU": 1, "GPU": 1}),
                param_space={"i": tune.grid_search([0, 1, 2]), "pkg": pkg,
                             "dir": d},
                tune_config=tune.TuneConfig(metric="loss", mode="min"),
                run_config=RunConfig(name="gpu", storage_path=d)).fit()
            out["losses"] = [r.metrics.get("loss") for r in g]
            out["errors"] = len(g.errors)
        except Exception as e:  # noqa: BLE001 — recorded
            out["raised"] = type(e).__name__

    th = threading.Thread(target=fit, daemon=True)
    th.start()
    deadline = time.monotonic() + 120
    while (not os.path.exists(os.path.join(d, "end_0"))
           and time.monotonic() < deadline):
        time.sleep(0.05)
    th.join(ONE_GPU_WAIT_S)
    out["finished"] = not th.is_alive()
    out["started"] = sorted(f for f in os.listdir(d)
                            if f.startswith("start_"))
    return out


out = {}
for name, fn, cpus in [("grid_search", grid_search, 4),
                       ("random_search", random_search, 4),
                       ("concurrency_limiter", concurrency_limiter, 4),
                       ("asha", asha, 4), ("trial_errors", trial_errors, 4),
                       ("tune_over_trainer", tune_over_trainer, 4),
                       ("crash_restarts", crash_restarts, 2),
                       ("crash_budget", crash_budget, 2),
                       ("restore", restore, 4),
                       ("with_parameters", with_parameters, 4),
                       ("with_resources", with_resources, 4),
                       ("stopped_trial_stops", stopped_trial_stops, 4),
                       ("tiny_llama_over_trainer", tiny_llama_over_trainer, 4),
                       ("one_gpu_trials", one_gpu_trials, 4)]:
    t0 = time.monotonic()
    case(out, name, fn, cpus)
    print(f"{name}: {time.monotonic() - t0:.1f} s", file=sys.stderr,
          flush=True)
print("RESULT " + json.dumps(out, sort_keys=True), flush=True)
if out["one_gpu_trials"].get("finished"):
    rt.shutdown()
else:
    # The JAX package's fit is still inside its launch's 300 s wait on
    # another thread: leave without joining it.
    try:
        rt.shutdown()
    finally:
        os._exit(0)
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from ray_tpu.models import configs as jax_configs
    from ray_tpu.models import transformer as jax_tf

    tmp = tmp_path_factory.mktemp("tune")
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jax.random.PRNGKey(0),
                                       jax_configs.tiny))
    flat = {k: v for k, v in tree.items() if k != "layers"}
    flat.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    weights = tmp / "weights.npz"
    np.savez(weights, **flat)
    return tuple(run_driver(tmp, DRIVER, pkg, str(weights),
                            str(ONE_GPU_WAIT_S), timeout=400)
                 for pkg in ("ray_tpu", "ray_tpu_torch"))


def _same(results, name, want=None):
    jax_out, port_out = results[0][name], results[1][name]
    assert port_out == jax_out
    if want is not None:
        assert port_out == want
    return port_out


# -- runtime cases -------------------------------------------------------------
def test_grid_search_finds_best(results):
    out = _same(results, "grid_search")
    assert out["best_x"] == 3.0
    assert len(out["results"]) == 4
    assert out["snapshot"] == [["TERMINATED", x] for x in (0.0, 1.0, 3.0, 5.0)]


def test_random_search_samples(results):
    xs = _same(results, "random_search")
    assert len(xs) == 5 and all(-1.0 <= x <= 1.0 for x in xs)
    assert len(set(xs)) > 1
    rng = random.Random(7)  # the generator's seeded draws, one per trial
    assert xs == [rng.uniform(-1.0, 1.0) for _ in range(5)]


def test_concurrency_limiter_with_tuner(results):
    _same(results, "concurrency_limiter", [4, 3.0])


def test_asha_stops_bad_trials(results):
    """Which trials ASHA culls depends on the order in which their
    results reach each rung (it is asynchronous), so each runtime is held
    to the JAX test's outcome; the decisions themselves are compared on
    one stream in test_schedulers_decide_alike_on_one_stream."""
    for out in (results[0]["asha"], results[1]["asha"]):
        assert out["best"] >= 0.9 * 16 * 0.9
        assert min(out["iters"]) < 16


def test_trial_errors_surface(results):
    _same(results, "trial_errors", [1, True, 0.0])


def test_tune_over_trainer(results):
    _same(results, "tune_over_trainer", [2, 3.0])


def test_trial_crash_restarts_from_checkpoint(results):
    _same(results, "crash_restarts", [True, 7])


def test_trial_crash_exhausts_budget(results):
    _same(results, "crash_budget", [1, True])


def test_tuner_restore_resumes_unfinished_trials(results):
    out = _same(results, "restore")
    assert out["first_errors"] == 1
    assert out["restored"] == 3 and out["restored_errors"] == 0
    assert out["best"] == 103.0
    assert out["runs"] == {"1": [0], "2": [0], "99": [0, 4]}


def test_with_parameters_ships_large_objects(results):
    want = float(np.arange(10_000, dtype=np.float64).sum())
    _same(results, "with_parameters", [want + 1.0, want + 2.0])


def test_with_resources_overrides_trial_resources(results):
    _same(results, "with_resources", [{"CPU": 2}, [2, 4]])


def test_a_stopped_trial_stops_running(results):
    """ASHA stops the second trial at its first rung while its function
    is still stepping; each step waits for the scheduler to let the one
    before go on, so the stopped trial reports 2 steps whatever the
    poll's pace. The port ends the trial's process with it; the JAX
    package starts the function on a thread of its own, and a killed
    actor's idle worker is recycled, so the function runs on once the
    fit has returned and releases the steps."""
    jax_out, port_out = (r["stopped_trial_stops"] for r in results)
    for out in (jax_out, port_out):
        assert out["stopped_early"]
        assert out["reported"][0] == 4 and out["reported"][1] < 4
    assert not port_out["ran_on_after_fit"]
    assert jax_out["ran_on_after_fit"]


def test_tuner_over_torch_trainer_matches_jax_trainer(results):
    """configs.tiny, f32, one worker, 4 AdamW steps at learning rates 0
    and 3e-3: the same best config, and each trial's last loss within
    TOL."""
    jax_out, port_out = (r["tiny_llama_over_trainer"] for r in results)
    assert jax_out["errors"] == [] and port_out["errors"] == []
    assert port_out["steps"] == jax_out["steps"] == [3, 3]
    np.testing.assert_allclose(port_out["losses"], jax_out["losses"],
                               rtol=TOL, atol=TOL)
    assert port_out["best_lr"] == jax_out["best_lr"]
    # The sweep sees training, and the choice is no tie within TOL.
    assert port_out["best_lr"] == 3e-3
    assert port_out["losses"][1] < port_out["losses"][0] - 2 * TOL


def test_one_gpu_trials_do_not_wait_on_a_finished_trial(results):
    """Three {"CPU": 1, "GPU": 1} trials at the default concurrency on a
    node with one GPU: the port leaves an unplaced trial PENDING and
    reaps the finished one, so all three run; the JAX package's launch
    of the second trial waits (up to 300 s) for a card that the first
    trial's finished actor holds until the launch loop ends."""
    jax_out, port_out = (r["one_gpu_trials"] for r in results)
    assert port_out["finished"] and port_out["errors"] == 0
    assert port_out["losses"] == [0.0, 1.0, 2.0]
    assert port_out["started"] == ["start_0", "start_1", "start_2"]
    assert not jax_out["finished"]
    assert jax_out["started"] == ["start_0"]


# -- pure searchers and schedulers, both packages in this process -------------
def _packages():
    import ray_tpu.tune as jax_tune

    import ray_tpu_torch.tune as port_tune

    return jax_tune, port_tune


def _drive_searcher(searcher, loss, n):
    picks = []
    for i in range(n):
        tid = f"t{i}"
        cfg = searcher.suggest(tid)
        if cfg is None:
            break
        picks.append(cfg)
        searcher.on_trial_complete(tid, {"loss": loss(cfg)})
    return picks


def test_basic_variant_generator_draws_the_same_configs():
    outs = []
    for tune in _packages():
        space = {"a": tune.grid_search([1, 2, 3]),
                 "b": tune.grid_search(["x", "y"]),
                 "lr": tune.loguniform(1e-5, 1e-1),
                 "u": tune.uniform(-2.0, 2.0), "n": tune.randint(0, 100),
                 "c": tune.choice(["adam", "sgd", "lion"]), "k": 7}
        gen = tune.BasicVariantGenerator(space, num_samples=3, seed=11)
        assert gen.total_trials == 18
        outs.append([gen.suggest(f"t{i}") for i in range(19)])
    assert outs[0] == outs[1]
    assert outs[1][-1] is None


def test_tpe_searcher_beats_random_on_quadratic():
    outs = []
    for tune in _packages():
        space = {"x": tune.uniform(-10.0, 10.0),
                 "lr": tune.loguniform(1e-5, 1.0)}
        picks = _drive_searcher(
            tune.TPESearcher(space, metric="loss", mode="min",
                             num_samples=48, n_startup=8, seed=0),
            lambda c: (c["x"] - 3.0) ** 2 + (c["lr"] - 0.01) ** 2, 48)
        outs.append(picks)
    assert outs[0] == outs[1]
    best = min((c["x"] - 3.0) ** 2 + (c["lr"] - 0.01) ** 2 for c in outs[1])
    rng = random.Random(0)
    rand_best = min((rng.uniform(-10, 10) - 3.0) ** 2 for _ in range(48))
    assert best < 1.0
    assert best <= rand_best * 1.5 + 1e-6


def test_tpe_categorical_concentrates():
    outs = []
    for tune in _packages():
        space = {"opt": tune.choice(["bad1", "bad2", "good", "bad3"])}
        picks = _drive_searcher(
            tune.TPESearcher(space, metric="loss", mode="min",
                             num_samples=64, n_startup=12, seed=1),
            lambda c: 0.0 if c["opt"] == "good" else 1.0, 64)
        outs.append([c["opt"] for c in picks])
    assert outs[0] == outs[1]
    late = outs[1][-24:]
    assert late.count("good") > len(late) * 0.5


def test_bohb_searcher_models_intermediate_rungs():
    outs = []
    for tune in _packages():
        s = tune.BOHBSearcher({"x": tune.uniform(-10.0, 10.0)},
                              metric="loss", mode="min", num_samples=64,
                              n_startup=6, seed=0)
        for i in range(13):
            tid = f"t{i}"
            x = -9.0 + 1.5 * i
            s.suggest(tid)
            s._configs[tid] = {"x": x}
            s.on_trial_result(tid, {"loss": x + 100.0,
                                    "training_iteration": 1})
            s.on_trial_result(tid, {"loss": (x - 3.0) ** 2,
                                    "training_iteration": 4})
            s.on_trial_complete(tid, {"loss": (x - 3.0) ** 2})
        assert s._observations and all(v >= 0 for _, v in s._observations)
        outs.append([s.suggest(f"m{i}")["x"] for i in range(12)])
    assert outs[0] == outs[1]
    assert sum(1 for x in outs[1] if abs(x - 3.0) < 4.0) >= 7


def test_pb2_gp_guided_explore():
    outs = []
    for tune in _packages():
        sched = tune.PB2(metric="score", mode="max", perturbation_interval=1,
                         hyperparam_bounds={"lr": (0.0, 1.0)}, seed=0)
        rng = random.Random(0)
        for t in range(8):
            tid = f"t{t}"
            lr = rng.random()
            sched.on_trial_add(tid, {"lr": lr})
            score = 0.0
            for _ in range(4):
                score += 1.0 - (lr - 0.7) ** 2
                sched.on_result(tid, {"score": score})
        outs.append([sched._explore({"lr": 0.1})["lr"] for _ in range(8)])
    assert outs[0] == outs[1]
    assert all(0.0 <= p <= 1.0 for p in outs[1])
    assert sum(1 for p in outs[1] if p > 0.4) >= 5


def test_external_searcher_adapter():
    for tune in _packages():
        class Lib:
            def __init__(self):
                self.next_token, self.told = 0, {}

            def ask(self):
                self.next_token += 1
                return self.next_token, {"x": float(self.next_token)}

            def tell(self, token, score):
                self.told[token] = score

        lib = Lib()
        s = tune.ExternalSearcher(lib, metric="loss", mode="max",
                                  num_samples=3)
        cfgs = [s.suggest(f"t{i}") for i in range(4)]
        assert [c["x"] for c in cfgs[:3]] == [1.0, 2.0, 3.0]
        assert cfgs[3] is None
        s.on_trial_complete("t0", {"loss": 5.0})
        s.on_trial_complete("t2", {"loss": 7.0})
        assert lib.told == {1: -5.0, 3: -7.0}
        with pytest.raises(TypeError):
            tune.ExternalSearcher(object(), metric="loss")


def test_concurrency_limiter_pauses_at_its_cap():
    outs = []
    for tune in _packages():
        from importlib import import_module

        paused = import_module(tune.__name__ + ".search").PAUSED
        lim = tune.ConcurrencyLimiter(
            tune.BasicVariantGenerator({"x": tune.grid_search([1, 2, 3])}),
            max_concurrent=2)
        seq = [lim.suggest("a"), lim.suggest("b"), lim.suggest("c")]
        lim.on_trial_complete("a", {})
        seq += [lim.suggest("c"), lim.suggest("d")]
        outs.append([s if s is not paused else "PAUSED" for s in seq])
    assert outs[0] == outs[1]
    assert outs[1] == [{"x": 1}, {"x": 2}, "PAUSED", {"x": 3}, "PAUSED"]


def test_asha_brackets_ladders():
    for tune in _packages():
        s = tune.ASHAScheduler(metric="m", mode="max", grace_period=1,
                               reduction_factor=4, max_t=64, brackets=3)
        assert s.bracket_rungs == [[1, 4, 16], [4, 16], [16]]
        assert [s._bracket(f"t{i}") for i in range(5)] == [0, 1, 2, 0, 1]
        assert s.on_result("t2", {"m": 0.0,
                                  "training_iteration": 4}) == "CONTINUE"


def _metric_stream(seed=5, trials=6, steps=12):
    """One synthetic stream: (trial, step, loss) in arrival order."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 2.0, trials)
    rate = rng.uniform(0.01, 0.2, trials)
    events = [(f"t{t}", s, float(base[t] * np.exp(-rate[t] * s)
                                 + rng.normal(0, 0.01)))
              for s in range(1, steps + 1) for t in range(trials)]
    order = rng.permutation(len(events))
    return [events[i] for i in sorted(order, key=lambda i: (events[i][1],
                                                            order[i]))]


@pytest.mark.parametrize("which", ["asha", "asha_brackets", "median", "pbt"])
def test_schedulers_decide_alike_on_one_stream(which):
    """ASHA (one and three brackets), median stopping and PBT see one
    synthetic stream of losses in both packages and decide the same at
    every result; PBT's exploits pick the same donors and mutations."""
    decisions = []
    for tune in _packages():
        if which == "asha":
            s = tune.ASHAScheduler(metric="loss", mode="min", grace_period=2,
                                   reduction_factor=2, max_t=12)
        elif which == "asha_brackets":
            s = tune.ASHAScheduler(metric="loss", mode="min", grace_period=1,
                                   reduction_factor=2, max_t=12, brackets=3)
        elif which == "median":
            s = tune.MedianStoppingRule(metric="loss", mode="min",
                                        grace_period=2,
                                        min_samples_required=3)
        else:
            s = tune.PopulationBasedTraining(
                metric="loss", mode="min", perturbation_interval=2,
                hyperparam_mutations={"lr": [1e-4, 3e-4, 1e-3, 3e-3],
                                      "wd": [0.0, 0.1]},
                quantile_fraction=0.34, resample_probability=0.25, seed=3)
            for t in range(6):
                s.on_trial_add(f"t{t}", {"lr": [1e-4, 3e-4, 1e-3][t % 3],
                                         "wd": 0.0})
        out, stopped = [], set()
        for tid, step, loss in _metric_stream():
            if tid in stopped:
                continue
            if which == "pbt":
                s.record_checkpoint(tid, f"/ckpt/{tid}/{step}")
            d = s.on_result(tid, {"loss": loss, "training_iteration": step})
            if d == "STOP":
                stopped.add(tid)
            elif d == "EXPLOIT":
                d = [d, *s.make_exploit(tid)]
            out.append((tid, step, d))
        decisions.append(out)
    assert decisions[0] == decisions[1]
    kinds = {d if isinstance(d, str) else d[0] for _, _, d in decisions[1]}
    assert kinds == ({"CONTINUE", "EXPLOIT"} if which == "pbt"
                     else {"CONTINUE", "STOP"})


def test_with_resources_propagates_through_as_trainable():
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.trainer import BaseTrainer

    t = tune.with_resources(BaseTrainer(), {"CPU": 3})
    assert t.as_trainable()._tune_resources == {"CPU": 3}


# -- PBT through the Tuner (slow, as tests/test_tune.py's) ---------------------
PBT_DRIVER = PRELUDE + r'''
import tempfile

tune = importlib.import_module(pkg + ".tune")
train = importlib.import_module(pkg + ".train")


def _pbt_trainable(config):
    import tempfile as _tf

    tune = importlib.import_module(config["pkg"] + ".tune")
    Checkpoint = importlib.import_module(
        config["pkg"] + ".train.checkpoint").Checkpoint
    ckpt = tune.get_checkpoint()
    step, score = 0, 0.0
    if ckpt is not None:
        with open(os.path.join(ckpt.path, "state.json")) as f:
            st = json.load(f)
        step, score = st["step"], st["score"]
    for _ in range(40):
        step += 1
        score += config["lr"]
        d = _tf.mkdtemp()
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump({"step": step, "score": score}, f)
        tune.report({"score": score, "lr": config["lr"]},
                    checkpoint=Checkpoint.from_directory(d))
        time.sleep(0.1)


rt.init(num_cpus=4)
try:
    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.1, 1.0, 10.0]},
        quantile_fraction=0.25, resample_probability=0.0, seed=0)
    g = tune.Tuner(
        _pbt_trainable,
        param_space={"lr": tune.grid_search([0.1, 0.1, 10.0, 10.0]),
                     "pkg": pkg},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=pbt, max_concurrent_trials=4),
        run_config=train.RunConfig(name="pbt",
                                   storage_path=tempfile.mkdtemp())).fit()
    out = {"exploits": pbt.num_exploits,
           "finals": sorted(r.metrics["score"] for r in g)}
finally:
    rt.shutdown()
print("RESULT " + json.dumps(out))
'''


@pytest.mark.slow
def test_pbt_exploits_and_improves(tmp_path):
    """The port's run of tests/test_tune.py's PBT case. (The JAX
    package's own case fails on a 4-CPU runtime here: an exploited
    trial's new actor is not ready within 30 s; ROADMAP §C.)"""
    out = run_driver(tmp_path, PBT_DRIVER, "ray_tpu_torch", timeout=300)
    assert out["exploits"] >= 1
    assert out["finals"][0] > 4.0, out
