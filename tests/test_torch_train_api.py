"""The port's trainer (ray_tpu_torch.train) held against the JAX package's,
case by case: tests/test_train.py, tests/test_train_fault_tolerance.py,
tests/test_flight_recorder.py and tests/test_elastic_gang.py.

Cases that need the runtime run in one driver script per package (a
subprocess under `ray_tpu` with JaxTrainer, then one under
`ray_tpu_torch` with TorchTrainer on gloo), which prints one `RESULT`
line; each test compares
the two outcomes and the outcome the JAX test asserts. Cases of pure code
(shard remapping, the resize governor, the flight recorder, backoff) run
here against both packages. Where the JAX test reaches a module the port
has not got:
  * the DCN epoch fence and op deadline: here they are checked on the
    port's torch process group (each gang epoch rendezvouses at a new
    address, and a gloo op on a silent peer raises within the group's
    timeout); tests/test_torch_train_dcn.py checks them on the port's
    util.collective DCN group against the JAX one;
  * the straggler and live-resize cases run on one node (an injected
    drain shrinks the gang, which then grows back); the straggler on a
    gang spread over two nodes of a `Cluster` is in
    tests/test_torch_cluster.py.
`test_resnet_dp_from_images` runs in this process: two TorchTrainer
workers on gloo train the port's ResNet (models/conv.py) on images that
read_images streams, as tests/test_train.py's case trains the JAX one.
Each test carries the `slow` mark where its JAX counterpart does.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.test_torch_serve_api import PRELUDE, ROOT, run_driver

DRIVER = PRELUDE + r'''
import tempfile
import threading

train = importlib.import_module(pkg + ".train")
chaos = importlib.import_module(pkg + "._private.chaos")
SLOW = sys.argv[2] == "slow"
tmp = tempfile.mkdtemp(prefix="train_" + pkg + "_")


def Trainer(loop, dp_sync=None, **kw):
    """JaxTrainer or TorchTrainer (gloo), the same arguments."""
    if pkg == "ray_tpu":
        if dp_sync is not None:
            kw["jax_config"] = train.JaxConfig(dp_sync=dp_sync)
        return train.JaxTrainer(loop, **kw)
    return train.TorchTrainer(loop, **kw)


def sub(name):
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    return d


def case(out, name, fn):
    try:
        out[name] = fn()
    except Exception as e:  # noqa: BLE001 — recorded, compared by the test
        import traceback
        traceback.print_exc()
        out[name] = ["raised", type(e).__name__, str(e)[:300]]


def _simple_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    rank = train.get_world_rank()
    for step in range(config["steps"]):
        train.report({"step": step, "rank": rank, "loss": 1.0 / (step + 1)})


def single_worker_reports():
    r = Trainer(_simple_loop, train_loop_config={"pkg": pkg, "steps": 3},
                scaling_config=train.ScalingConfig(num_workers=1),
                run_config=train.RunConfig(name="t1",
                                           storage_path=sub("t1"))).fit()
    return [r.error is None, r.metrics["step"], len(r.metrics_history)]


def _dp_loop(config):
    """Data-parallel training of a small MLP, gradients averaged over the
    gang (the JAX package's DCN group, the port's process group)."""
    train = importlib.import_module(config["pkg"] + ".train")
    rank, world = train.get_world_rank(), train.get_world_size()
    if config["pkg"] == "ray_tpu":
        import jax
        import jax.numpy as jnp
        from ray_tpu.models.mlp import init_mlp, mlp_classifier_loss

        params = init_mlp(jax.random.PRNGKey(0), [4, 16, 2])
        x = jax.random.normal(jax.random.PRNGKey(100 + rank), (32, 4))
        y = (x.sum(axis=1) > 0).astype(jnp.int32)
        grad_fn = jax.value_and_grad(mlp_classifier_loss, has_aux=True)
        for step in range(config["steps"]):
            (loss, _), grads = grad_fn(params, {"x": x, "y": y})
            if world > 1:
                grads = train.allreduce_gradients(grads)
            params = jax.tree.map(lambda p, g: p - 0.1 * g, params, grads)
            train.report({"loss": float(loss), "rank": rank, "step": step})
        return
    import torch

    torch.manual_seed(0)
    params = {"w1": torch.randn(4, 16) * 0.5, "b1": torch.zeros(16),
              "w2": torch.randn(16, 2) * 0.5, "b2": torch.zeros(2)}
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(32, 4, generator=g)
    y = (x.sum(dim=1) > 0).long()
    for step in range(config["steps"]):
        for p in params.values():
            p.requires_grad_(True)
        h = torch.relu(x @ params["w1"] + params["b1"])
        loss = torch.nn.functional.cross_entropy(h @ params["w2"]
                                                 + params["b2"], y)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        if world > 1:
            grads = train.allreduce_gradients(grads)
        params = {k: (p - 0.1 * grads[k]).detach() for k, p in params.items()}
        train.report({"loss": float(loss), "rank": rank, "step": step})


def data_parallel_two_workers():
    r = Trainer(_dp_loop, dp_sync="dcn",
                train_loop_config={"pkg": pkg, "steps": 4},
                scaling_config=train.ScalingConfig(num_workers=2),
                run_config=train.RunConfig(name="dp",
                                           storage_path=sub("dp"))).fit()
    losses = [m["loss"] for m in r.metrics_history]
    return [r.error is None, losses[-1] < losses[0]]


def _ckpt_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"] + 1
    for step in range(start, config["steps"]):
        if train.get_world_rank() == 0:
            train.report({"step": step},
                         checkpoint=train.Checkpoint.from_dict({"step": step}))
        else:
            train.report({"step": step})


def checkpoints_and_resume():
    r = Trainer(_ckpt_loop, train_loop_config={"pkg": pkg, "steps": 3},
                scaling_config=train.ScalingConfig(num_workers=1),
                run_config=train.RunConfig(
                    name="ck", storage_path=sub("ck"),
                    checkpoint_config=train.CheckpointConfig(num_to_keep=2))
                ).fit()
    r2 = Trainer(_ckpt_loop, train_loop_config={"pkg": pkg, "steps": 5},
                 scaling_config=train.ScalingConfig(num_workers=1),
                 run_config=train.RunConfig(name="ck2", storage_path=sub("ck")),
                 resume_from_checkpoint=r.checkpoint).fit()
    return [r.error is None, r.checkpoint.to_dict()["step"],
            r2.error is None, [m["step"] for m in r2.metrics_history]]


def _fail_once_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    marker = os.path.join(config["dir"], "failed_once")
    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("injected failure")
    train.report({"recovered": True})


def failure_recovery():
    r = Trainer(_fail_once_loop,
                train_loop_config={"pkg": pkg, "dir": sub("fr")},
                scaling_config=train.ScalingConfig(num_workers=1),
                run_config=train.RunConfig(
                    name="fr", storage_path=sub("fr"),
                    failure_config=train.FailureConfig(max_failures=1))).fit()
    return [r.error is None, r.metrics["recovered"]]


def _pytree_ckpt_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    if config["pkg"] == "ray_tpu":
        import jax.numpy as jnp
        tree = {"w": jnp.arange(8.0), "step": jnp.array(7)}
    else:
        import torch
        tree = {"w": torch.arange(8.0), "step": torch.tensor(7)}
    c = train.Checkpoint.from_pytree(
        tree, os.path.join(train.get_trial_dir(), "ptc"))
    train.report({"saved": True}, checkpoint=c)


def pytree_checkpoint():
    r = Trainer(_pytree_ckpt_loop, train_loop_config={"pkg": pkg},
                scaling_config=train.ScalingConfig(num_workers=1),
                run_config=train.RunConfig(name="ptc",
                                           storage_path=sub("ptc"))).fit()
    restored = r.checkpoint.to_pytree()
    return [r.error is None,
            [float(v) for v in np.asarray(restored["w"])],
            int(np.asarray(restored["step"]))]


def _uri_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    train.report({"loss": 0.5},
                 checkpoint=train.Checkpoint.from_dict({"w": 1}))


def trainer_persists_to_storage_uri():
    storage = importlib.import_module(pkg + ".train.storage")
    uri = f"file://{sub('bucket')}"
    r = Trainer(_uri_loop, train_loop_config={"pkg": pkg},
                scaling_config=train.ScalingConfig(num_workers=1),
                run_config=train.RunConfig(name="sp-test",
                                           storage_path=uri)).fit()
    names = storage.StorageContext(uri, "sp-test").list_checkpoints()
    back = storage.StorageContext(uri, "sp-test").download(names[-1])
    return [r.error is None, len(names) >= 1,
            train.Checkpoint.from_directory(back.path).to_dict()]


def torch_trainer_ddp_gloo():
    TorchTrainer = importlib.import_module(pkg + ".train.torch").TorchTrainer

    def loop(config):
        import torch
        import torch.distributed as dist
        from torch.utils.data import DataLoader, TensorDataset

        tt = importlib.import_module(config["pkg"] + ".train.torch")
        train = importlib.import_module(config["pkg"] + ".train")
        torch.manual_seed(0)
        g = torch.Generator().manual_seed(7)
        x = torch.randn(256, 4, generator=g)
        y = x @ torch.tensor([[1.0], [-2.0], [0.5], [3.0]])
        loader = tt.prepare_data_loader(
            DataLoader(TensorDataset(x, y), batch_size=32))
        model = tt.prepare_model(torch.nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        first = last = None
        for _ in range(12):
            for xb, yb in loader:
                opt.zero_grad()
                loss = ((model(xb) - yb) ** 2).mean()
                loss.backward()
                opt.step()
                first = float(loss) if first is None else first
                last = float(loss)
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        train.report({"first": first, "last": last,
                      "psum": float(flat.sum()),
                      "world": dist.get_world_size()})

    r = TorchTrainer(loop, train_loop_config={"pkg": pkg},
                     scaling_config=train.ScalingConfig(num_workers=2),
                     run_config=train.RunConfig(name="torch",
                                                storage_path=sub("torch"))
                     ).fit()
    m = r.metrics
    return [r.error is None, m["world"], m["last"] < m["first"] * 0.2]


def sklearn_fits():
    from sklearn.linear_model import LogisticRegression

    SklearnTrainer = importlib.import_module(
        pkg + ".train.sklearn").SklearnTrainer
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4)).astype(np.float64)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    r = SklearnTrainer(estimator=LogisticRegression(max_iter=200),
                       datasets={"train": (X[:150], y[:150]),
                                 "valid": (X[150:], y[150:])}, cv=3).fit()
    model = SklearnTrainer.get_model(r.checkpoint)
    return [r.error is None, r.metrics["train_score"] > 0.9,
            r.metrics["valid_score"] > 0.8,
            "test_score" in r.metrics.get("cv", {}),
            model.score(X[150:], y[150:]) == r.metrics["valid_score"],
            r.metrics["valid_score"]]


def _context_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    ctx = train.get_context()
    train.report({"rank": ctx.get_world_rank(),
                  "size": ctx.get_world_size(),
                  "local": ctx.get_local_rank()})


def sklearn_dataset_input():
    """tests/test_train.py::test_sklearn_trainer_dataset_input."""
    from sklearn.tree import DecisionTreeClassifier

    SklearnTrainer = importlib.import_module(
        pkg + ".train.sklearn").SklearnTrainer
    rt_data = importlib.import_module(pkg + ".data")
    rng = np.random.default_rng(1)
    rows = []
    for _ in range(120):
        a, b = rng.normal(), rng.normal()
        rows.append({"a": a, "b": b, "y": int(a - b > 0)})
    r = SklearnTrainer(estimator=DecisionTreeClassifier(max_depth=4),
                       datasets={"train": rt_data.from_items(rows)},
                       label_column="y").fit()
    return [r.error is None, r.metrics["train_score"]]


def get_context_facade():
    r = Trainer(_context_loop, train_loop_config={"pkg": pkg},
                scaling_config=train.ScalingConfig(num_workers=2)).fit()
    try:
        train.get_context()
        outside = "no error"
    except RuntimeError:
        outside = "RuntimeError"
    return [r.error is None, r.metrics["size"], outside]


def _die_once_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    chaos = importlib.import_module(config["pkg"] + "._private.chaos")
    with open(os.path.join(config["dir"], "attempts.log"), "a") as f:
        f.write(f"rank{train.get_world_rank()}\n")
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"] + 1
    for step in range(start, config["steps"]):
        if train.get_world_rank() == 0:
            train.report({"step": step},
                         checkpoint=train.Checkpoint.from_dict({"step": step}))
        else:
            train.report({"step": step})
        time.sleep(0.12)
        if (train.get_world_rank() == 0 and step == config["die_at"]
                and chaos.once(config["dir"], "rank0_death")):
            chaos.enable()
            chaos.die()


def rank_death_resumes():
    d = sub("ft")
    r = Trainer(_die_once_loop, dp_sync="none",
                train_loop_config={"pkg": pkg, "dir": d, "steps": 6,
                                   "die_at": 3},
                scaling_config=train.ScalingConfig(num_workers=2),
                run_config=train.RunConfig(
                    name="ft", storage_path=d,
                    checkpoint_config=train.CheckpointConfig(num_to_keep=2),
                    failure_config=train.FailureConfig(
                        max_failures=2, backoff_s=0.05, backoff_max_s=0.2))
                ).fit()
    steps = [m["step"] for m in r.metrics_history]
    with open(os.path.join(d, "attempts.log")) as f:
        attempts = sorted(f.read().splitlines())
    return [r.error is None, steps[-1], steps.count(0), attempts]


def _drain_aware_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    with open(os.path.join(config["dir"], "attempts.log"), "a") as f:
        f.write("start\n")
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"] + 1
    for step in range(start, config["steps"]):
        train.report({"step": step},
                     checkpoint=train.Checkpoint.from_dict({"step": step}))
        if train.should_stop():
            return
        time.sleep(0.12)


def drain_migration():
    d = sub("drain")
    chaos.enable()
    try:
        chaos.inject_drain([0])
        r = Trainer(_drain_aware_loop,
                    train_loop_config={"pkg": pkg, "dir": d, "steps": 6},
                    scaling_config=train.ScalingConfig(num_workers=1),
                    run_config=train.RunConfig(
                        name="drain", storage_path=d,
                        failure_config=train.FailureConfig(
                            max_failures=1, backoff_s=0.05,
                            backoff_max_s=0.2))).fit()
    finally:
        chaos.disable()
    steps = [m["step"] for m in r.metrics_history]
    with open(os.path.join(d, "attempts.log")) as f:
        attempts = f.read().splitlines()
    return [r.error is None, steps[-1], steps.count(0), len(attempts)]


def _report_then_fail_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    train.report({"step": 0, "loss": 1.0})
    train.report({"step": 1, "loss": 0.5})
    raise RuntimeError("unrecoverable user error")


def max_failures_zero():
    r = Trainer(_report_then_fail_loop, train_loop_config={"pkg": pkg},
                scaling_config=train.ScalingConfig(num_workers=1),
                run_config=train.RunConfig(
                    name="fff", storage_path=sub("fff"),
                    failure_config=train.FailureConfig(max_failures=0))
                ).fit()
    return [type(r.error).__name__, r.error.failed_ranks,
            "unrecoverable user error" in str(r.error), r.metrics,
            [m["step"] for m in r.metrics_history],
            os.path.exists(os.path.join(sub("fff"), "fff"))]


def _profiled_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    chaos = importlib.import_module(config["pkg"] + "._private.chaos")
    prof = train.StepProfiler(ring=64)
    rank = train.get_world_rank()
    if rank == config["slow_rank"]:
        chaos.enable()
        chaos.delay_steps(config["delay_s"], count=config["steps"])
    for step in range(config["steps"]):
        with prof.step(tokens=32):
            with prof.phase("compute"):
                time.sleep(0.004)
        train.report({"step": step, "rank": rank})


def straggler_attribution():
    r = Trainer(_profiled_loop,
                train_loop_config={"pkg": pkg, "steps": 8, "slow_rank": 1,
                                   "delay_s": 0.05},
                scaling_config=train.ScalingConfig(num_workers=2)).fit()
    enriched = [m for m in r.metrics_history if "train_straggler_rank" in m]
    last = enriched[-1]
    walls = {int(k): v for k, v in last["train_step_wall_by_rank"].items()}
    br = last["train_straggler_breakdown"]
    b = [m for m in r.metrics_history
         if "train_step_breakdown" in m][-1]["train_step_breakdown"]
    return [r.error is None, last["train_straggler_rank"],
            last["train_step_skew_s"] > 0.02, sorted(walls),
            walls[1] > walls[0], br["other_s"] > br["compute_s"],
            abs(b["wall_s"] - (b["data_s"] + b["compute_s"]
                               + b["collective_s"] + b["checkpoint_s"]
                               + b["other_s"])) < 1e-4]


def _elastic_loop(config):
    train = importlib.import_module(config["pkg"] + ".train")
    state = {"w": np.zeros(8, dtype=np.float64), "steps_done": 0}
    shards = train.shard_state(
        {"m": np.arange(60, dtype=np.float64)}, name="opt")
    while state["steps_done"] < config["steps"]:
        ev = train.sync_resize(state, shards)
        if ev.exiting:
            return
        state, shards = ev.state, ev.shards
        state["w"] += 1.0
        state["steps_done"] += 1
        if train.get_world_rank() == 0:
            train.report({
                "step": state["steps_done"], "world": ev.world_size,
                "opt_sum": float(sum(float(s.sum())
                                     for s in shards["opt"].slices))})
        time.sleep(0.02)


def resize_under_active_step():
    """One node: an injected drain of rank 2 shrinks the gang 3 -> 2 in
    place; with no claimant holding the bundle, it grows back to 3."""
    chaos.enable()
    try:
        holder = {}
        trainer = Trainer(
            _elastic_loop, dp_sync="none",
            train_loop_config={"pkg": pkg, "steps": 600},
            scaling_config=train.ScalingConfig(
                num_workers=3,
                elastic=train.ResizePolicy(min_world_size=2,
                                           resize_cooldown_s=1.0)),
            run_config=train.RunConfig(name="el", storage_path=sub("el")))
        t = threading.Thread(target=lambda: holder.update(r=trainer.fit()),
                             daemon=True)
        t.start()
        time.sleep(3.0)
        chaos.inject_drain([2])
        t.join(timeout=180)
        alive = t.is_alive()
    finally:
        chaos.disable()
    r = holder["r"]
    steps = [m["step"] for m in r.metrics_history]
    worlds = [m["world"] for m in r.metrics_history]
    return [alive, r.error is None, steps == list(range(1, 601)),
            sorted(set(worlds)), worlds[-1],
            r.metrics["opt_sum"] == float(np.arange(60)[:20].sum())]


out = {}
rt.init(num_cpus=8)
try:
    if SLOW:
        case(out, "data_parallel_two_workers", data_parallel_two_workers)
    else:
        for name, fn in [
                ("single_worker_reports", single_worker_reports),
                ("checkpoints_and_resume", checkpoints_and_resume),
                ("failure_recovery", failure_recovery),
                ("pytree_checkpoint", pytree_checkpoint),
                ("trainer_persists_to_storage_uri",
                 trainer_persists_to_storage_uri),
                ("torch_trainer_ddp_gloo", torch_trainer_ddp_gloo),
                ("sklearn_fits", sklearn_fits),
                ("sklearn_dataset_input", sklearn_dataset_input),
                ("get_context_facade", get_context_facade),
                ("rank_death_resumes", rank_death_resumes),
                ("drain_migration", drain_migration),
                ("max_failures_zero", max_failures_zero),
                ("straggler_attribution", straggler_attribution),
                ("resize_under_active_step", resize_under_active_step)]:
            case(out, name, fn)
finally:
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''


def _both(tmp_path_factory, which):
    tmp = tmp_path_factory.mktemp("train_api_" + which)
    return tuple(run_driver(tmp, DRIVER, pkg, which, timeout=900)
                 for pkg in ("ray_tpu", "ray_tpu_torch"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _both(tmp_path_factory, "fast")


@pytest.fixture(scope="module")
def slow_results(tmp_path_factory):
    return _both(tmp_path_factory, "slow")


def _same(results, name, expected):
    ref, out = results
    assert out[name] == ref[name]
    assert out[name] == expected


# -- tests/test_train.py ---------------------------------------------------

def test_single_worker_reports(results):
    _same(results, "single_worker_reports", [True, 2, 3])


@pytest.mark.slow
def test_data_parallel_two_workers(slow_results):
    _same(slow_results, "data_parallel_two_workers", [True, True])


def test_checkpoints_and_resume(results):
    _same(results, "checkpoints_and_resume", [True, 2, True, [3, 4]])


def test_failure_recovery(results):
    _same(results, "failure_recovery", [True, True])


def test_pytree_checkpoint(results):
    """The JAX package writes orbax, the port its flat tensor file: the
    same tree comes back."""
    _same(results, "pytree_checkpoint", [True, [float(i) for i in range(8)],
                                         7])


def test_async_checkpointer_overlaps_and_restores(tmp_path):
    import torch

    from ray_tpu_torch.train.checkpoint import AsyncCheckpointer, Checkpoint

    tree = {"w": torch.arange(1000, dtype=torch.float32).reshape(10, 100),
            "step": torch.tensor(7)}
    ck = AsyncCheckpointer()
    try:
        c1 = ck.save(str(tmp_path / "c1"), tree)
        tree2 = {k: v + 1 for k, v in tree.items()}
        ck.wait()
        c2 = ck.save(str(tmp_path / "c2"), tree2)
        # The snapshot is taken in save(): a later write to the tensors
        # does not reach the checkpoint.
        tree2["w"].add_(100)
        ck.wait()
        r1 = Checkpoint(c1.path).to_pytree()
        r2 = Checkpoint(c2.path).to_pytree()
        assert float(r1["w"][0, 1]) == 1.0 and int(r1["step"]) == 7
        assert float(r2["w"][0, 1]) == 2.0 and int(r2["step"]) == 8
    finally:
        ck.close()


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_storage_context_roundtrip(tmp_path, pkg):
    import importlib

    Checkpoint = importlib.import_module(pkg + ".train.checkpoint").Checkpoint
    StorageContext = importlib.import_module(
        pkg + ".train.storage").StorageContext
    src = tmp_path / "local_ckpt"
    (src / "nested").mkdir(parents=True)
    (src / "weights.bin").write_bytes(b"\x00\x01\x02" * 100)
    (src / "nested" / "meta.json").write_text('{"step": 7}')
    storage = StorageContext(f"file://{tmp_path}/remote", "exp1")
    uri = storage.persist(Checkpoint.from_directory(str(src)), "ckpt_000")
    assert uri.endswith("exp1/ckpt_000")
    assert storage.list_checkpoints() == ["ckpt_000"]
    back = storage.download("ckpt_000", str(tmp_path / "dl"))
    assert open(os.path.join(back.path, "weights.bin"), "rb").read() == \
        b"\x00\x01\x02" * 100
    assert "step" in open(os.path.join(back.path, "nested",
                                       "meta.json")).read()


def test_trainer_persists_to_storage_uri(results):
    _same(results, "trainer_persists_to_storage_uri", [True, True, {"w": 1}])


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_storage_retention_prunes_remote(tmp_path, pkg):
    import importlib

    ck = importlib.import_module(pkg + ".train.checkpoint")
    StorageContext = importlib.import_module(
        pkg + ".train.storage").StorageContext
    storage = StorageContext(f"file://{tmp_path}/bucket", "exp")
    mgr = ck.CheckpointManager(str(tmp_path / "local"), num_to_keep=2,
                               storage=storage)
    for step in range(4):
        mgr.register(ck.Checkpoint.from_dict({"step": step}),
                     {"step": step})
    assert storage.list_checkpoints() == ["checkpoint_000002",
                                          "checkpoint_000003"]
    assert storage.download("checkpoint_000003").to_dict() == {"step": 3}


def test_torch_trainer_ddp_gloo(results):
    _same(results, "torch_trainer_ddp_gloo", [True, 2, True])


def test_sklearn_trainer_fits_scores_and_checkpoints(results):
    ref, out = results
    assert out["sklearn_fits"] == ref["sklearn_fits"]
    assert out["sklearn_fits"][:5] == [True] * 5


def test_sklearn_trainer_dataset_input(results):
    ref, out = results
    assert out["sklearn_dataset_input"] == ref["sklearn_dataset_input"]
    ok, train_score = out["sklearn_dataset_input"]
    assert ok and train_score > 0.85


def test_get_context_facade(results):
    _same(results, "get_context_facade", [True, 2, "RuntimeError"])


@pytest.mark.slow
def test_resnet_dp_from_images(tmp_path):
    """read_images -> DataConfig streaming split -> 2-worker DP ResNet
    (the port's models/conv.py) through TorchTrainer on gloo, as the JAX
    test trains its ResNet through JaxTrainer: the loss decreases on a
    color-separable toy set and accuracy reaches 0.75."""
    from PIL import Image

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rtd
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.data_config import DataConfig

    def loop(config):
        import os

        import numpy as np
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models.conv import (ResNetConfig, init_resnet,
                                               resnet_loss)
        from ray_tpu_torch.train import allreduce_gradients
        from ray_tpu_torch.train.checkpoint import (flatten_tree,
                                                    unflatten_tree)

        cfg = ResNetConfig(num_classes=2, stage_sizes=(1, 1), width=8)
        leaves, spec = flatten_tree(init_resnet(0, cfg))  # same all ranks
        leaves = [t.requires_grad_(True) for t in leaves]
        shard = train.get_dataset_shard("train")
        for epoch in range(config["epochs"]):
            rows = list(shard.iter_rows())
            xs = np.stack([r["image"] for r in rows]).astype(
                np.float32) / 255.0
            ys = np.asarray([int(os.path.basename(r["path"]).split("_")[1])
                             for r in rows], dtype=np.int64)
            loss, metrics = resnet_loss(
                unflatten_tree(spec, leaves),
                {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}, cfg)
            grads = torch.autograd.grad(loss, leaves)
            if train.get_world_size() > 1:
                grads = flatten_tree(allreduce_gradients(
                    unflatten_tree(spec, list(grads))))[0]
            with torch.no_grad():
                for p, g in zip(leaves, grads):
                    p.sub_(config["lr"] * g)
            train.report({"epoch": epoch, "loss": float(loss),
                          "accuracy": float(metrics["accuracy"])})

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(32):
        label = i % 2
        base = np.full((16, 16, 3), 30, dtype=np.uint8)
        # class 0: red-dominant; class 1: blue-dominant (+ noise)
        base[:, :, 0 if label == 0 else 2] = 200
        noisy = np.clip(base.astype(np.int16)
                        + rng.integers(-25, 25, base.shape), 0,
                        255).astype(np.uint8)
        Image.fromarray(noisy).save(img_dir / f"img_{label}_{i:03d}.png")
    rt.init(num_cpus=4)
    try:
        ds = rtd.read_images(str(img_dir), parallelism=4)
        result = TorchTrainer(
            loop,
            train_loop_config={"epochs": 6, "lr": 0.2},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="resnet", storage_path=str(tmp_path)),
            datasets={"train": ds},
            dataset_config=DataConfig(datasets_to_split=["train"]),
        ).fit()
    finally:
        rt.shutdown()
    assert result.error is None
    losses = [m["loss"] for m in result.metrics_history if "loss" in m]
    assert losses[-1] < losses[0], losses
    accs = [m["accuracy"] for m in result.metrics_history if "accuracy" in m]
    assert max(accs) >= 0.75, accs


# -- tests/test_train_fault_tolerance.py ----------------------------------

@pytest.mark.chaos
def test_rank_death_resumes_from_checkpoint(results):
    _same(results, "rank_death_resumes",
          [True, 5, 1, ["rank0", "rank0", "rank1", "rank1"]])


class _FakeGroup:
    """The parts of a WorkerGroup that the torch backend reads, on this
    host, for two gang epochs."""

    resources_per_worker = {"CPU": 1.0}

    def __init__(self, epoch):
        self.epoch = epoch
        self.calls = []

    def __len__(self):
        return 2

    def node_ids(self):
        return [b"n", b"n"]

    def execute_single(self, rank, fn, *args, **kwargs):
        return fn(*args, **kwargs)

    def execute_with_rank(self, fn, **kwargs):
        self.calls.append(kwargs)


def _stale_join(init_method: str) -> subprocess.CompletedProcess:
    """A rank that kept an old epoch's address tries to join it."""
    code = (
        "import datetime, sys, torch.distributed as dist\n"
        "try:\n"
        f"    dist.init_process_group('gloo', init_method={init_method!r},\n"
        "        rank=1, world_size=2, timeout=datetime.timedelta(seconds=2))\n"
        "except Exception as e:\n"
        "    print('REFUSED', type(e).__name__)\n"
        "    sys.exit(0)\n"
        "print('JOINED')\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)


def test_gang_epoch_rejects_stale_rank():
    """Each gang epoch rendezvouses at its own address (rank 0 picks a
    fresh port): a zombie rank from a torn-down attempt, which knows only
    the old address, can neither find the new group nor join the old one
    (the JAX package's DCN fence stamps its rendezvous keys and ident
    frames with the epoch; tests/test_torch_train_dcn.py checks the port's
    own)."""
    from ray_tpu_torch.train.torch import TorchConfig, _init_group

    old, new = _FakeGroup(0), _FakeGroup(1)
    _init_group(old, TorchConfig())
    _init_group(new, TorchConfig())
    (a,), (b,) = old.calls, new.calls
    assert a["backend"] == b["backend"] == "gloo"
    assert a["init_method"] != b["init_method"]
    assert a["init_method"].startswith("tcp://127.0.0.1:")
    proc = _stale_join(a["init_method"])
    assert "REFUSED" in proc.stdout, proc.stdout + proc.stderr


_SILENT_PEER = r"""
import datetime, sys, time
import torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=1))
if rank == 1:
    time.sleep(8)  # connected, then silent: a preempted host
    sys.exit(0)
t0 = time.monotonic()
try:
    dist.all_reduce(torch.ones(4))
    print("COMPLETED")
except Exception as e:
    print("RAISED", type(e).__name__, round(time.monotonic() - t0, 3))
"""


def test_dcn_recv_timeout_raises_instead_of_hanging(tmp_path):
    """A peer that joins the group and then goes silent trips the group's
    timeout as an error rather than blocking the surviving rank forever
    (the JAX package's per-op DCN deadline, util.collective;
    in the port the deadline is TorchConfig.init_timeout_s)."""
    from ray_tpu_torch.train.torch import _pick_free_port

    script = tmp_path / "peer.py"
    script.write_text(_SILENT_PEER)
    port = str(_pick_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=60) for p in procs]
    line = outs[0][0].strip().splitlines()[-1]
    assert line.startswith("RAISED"), outs
    assert 0.3 <= float(line.split()[-1]) < 5.0, line


@pytest.mark.chaos
def test_drain_triggers_proactive_checkpoint_and_restart(results):
    _same(results, "drain_migration", [True, 5, 1, 2])


def test_max_failures_zero_fails_fast_with_metrics(results):
    _same(results, "max_failures_zero",
          ["TrainingFailedError", [0], True, {"step": 1, "loss": 0.5},
           [0, 1], True])


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_failure_config_backoff_schedule(pkg):
    import importlib

    FailureConfig = importlib.import_module(pkg + ".train").FailureConfig
    fc = FailureConfig(backoff_s=0.5, backoff_max_s=4.0)
    assert [fc.backoff_for_attempt(a) for a in range(5)] == \
        [0.5, 1.0, 2.0, 4.0, 4.0]
    assert FailureConfig(backoff_s=0).backoff_for_attempt(3) == 0.0


# -- tests/test_flight_recorder.py ----------------------------------------

def _profilers():
    from ray_tpu.train import StepProfiler as JaxProfiler

    from ray_tpu_torch.train import StepProfiler
    return [JaxProfiler, StepProfiler]


@pytest.mark.parametrize("which", [0, 1])
def test_step_breakdown_sums_to_wall(which):
    prof = _profilers()[which](ring=16, rank=0, emit_metrics=False)
    for _ in range(5):
        with prof.step(tokens=64):
            with prof.phase("data"):
                time.sleep(0.002)
            with prof.phase("compute"):
                time.sleep(0.004)
    recs = prof.records()
    assert len(recs) == 5
    for r in recs:
        named = (r["data_s"] + r["compute_s"] + r["collective_s"]
                 + r["checkpoint_s"] + r["other_s"])
        assert abs(r["wall_s"] - named) < 1e-6
        assert r["compute_s"] >= 0.004 and r["data_s"] >= 0.002
        assert r["tokens_per_s"] > 0


def test_ring_buffer_bounds_memory():
    outs = []
    for cls in _profilers():
        prof = cls(ring=4, rank=0, emit_metrics=False)
        for _ in range(10):
            with prof.step():
                pass
        outs.append([len(prof.records()), prof.summary()["steps"],
                     len(prof.drain_records()), prof.drain_records()])
    assert outs[0] == outs[1] == [4, 10, 4, []]


def test_collective_time_attributed_via_observer():
    """The port's allreduce_gradients attributes its own wall time to the
    step's "collective" phase (the JAX package's observer on
    util.collective), here on a gloo group of one."""
    import datetime

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import StepProfiler, allreduce_gradients
    from ray_tpu_torch.train.torch import _pick_free_port

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_pick_free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        prof = StepProfiler(ring=4, rank=0, emit_metrics=False)
        grads = {"w": torch.ones(3), "b": [torch.full((2,), 4.0)]}
        with prof.step():
            out = allreduce_gradients(grads)
        rec = prof.records()[-1]
    finally:
        dist.destroy_process_group()
    assert torch.equal(out["w"], grads["w"])
    assert torch.equal(out["b"][0], grads["b"][0])
    assert out["w"] is not grads["w"]
    assert 0 < rec["collective_s"] <= rec["wall_s"] + 1e-9


class _FeedStats:
    """A feed's counters (the data library's FeedStats: ROADMAP A6)."""

    def __init__(self):
        self.wait_s, self.stall_count = 0.0, 0

    def add_wait(self, s):
        self.wait_s += s
        self.stall_count += 1

    def snapshot(self):
        return {"wait_s": self.wait_s, "stall_count": self.stall_count}


def test_feed_wait_lands_in_data_phase():
    outs = []
    for cls in _profilers():
        stats = _FeedStats()
        prof = cls(ring=4, rank=0, emit_metrics=False)
        prof.attach_feed(stats)
        with prof.step():
            stats.add_wait(0.03)
            time.sleep(0.035)
        rec = prof.records()[-1]
        assert rec["other_s"] == pytest.approx(rec["wall_s"] - 0.03,
                                               abs=1e-6)
        with prof.step():
            pass
        outs.append([rec["feed_wait_s"], rec["feed_stalls"], rec["data_s"],
                     prof.records()[-1]["data_s"]])
    assert outs[0] == outs[1]
    assert outs[1][1:] == [1, pytest.approx(0.03), 0.0]


class _Compiled:
    """A callable with a compiled-program cache, as jax.jit has."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, x):
        self.shapes.add(np.shape(x))
        return x

    def _cache_size(self):
        return len(self.shapes)


def test_compile_counting_flags_retraces():
    outs = []
    for cls in _profilers():
        f = _Compiled()
        prof = cls(ring=8, rank=0, emit_metrics=False)
        prof.watch_jit(f)
        counts = []
        for shape in ((4,), (4,), (8,)):
            with prof.step():
                f(np.ones(shape))
            counts.append(prof.records()[-1]["compiles"])
        outs.append(counts)
    assert outs[0] == outs[1] == [1, 0, 1]


def test_mfu_estimate_uses_env_peak(monkeypatch):
    from ray_tpu_torch.train import StepProfiler, flight_recorder

    monkeypatch.setenv("RT_PEAK_FLOPS_PER_S", "1e12")
    assert flight_recorder.peak_flops_per_s() == 1e12
    prof = StepProfiler(ring=4, rank=0, emit_metrics=False,
                        flops_per_step=1e9)
    with prof.step():
        time.sleep(0.002)
    rec = prof.records()[-1]
    assert 0 < rec["mfu"] <= 1e9 / (0.002 * 1e12) + 1e-6
    monkeypatch.delenv("RT_PEAK_FLOPS_PER_S")
    # No card here: no peak, so no MFU (never a CPU number under it).
    assert flight_recorder.peak_flops_per_s() is None


def test_chaos_delay_steps_consumed_once():
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.train import StepProfiler

    chaos.enable()
    try:
        chaos.delay_steps(0.05, count=1)
        prof = StepProfiler(ring=4, rank=0, emit_metrics=False)
        t0 = time.perf_counter()
        with prof.step():
            pass
        assert time.perf_counter() - t0 >= 0.05
        t0 = time.perf_counter()
        with prof.step():
            pass
        assert time.perf_counter() - t0 < 0.04
    finally:
        chaos.disable()


def test_compute_skew_names_slowest_rank():
    from ray_tpu.train import compute_skew as jax_skew

    from ray_tpu_torch.train import compute_skew

    fast = {"steps": 10, "wall_s": 1.0, "compute_s": 0.9}
    slow = {"steps": 10, "wall_s": 3.0, "compute_s": 0.9,
            "collective_s": 2.0}
    out = compute_skew([fast, slow, None])
    assert out == jax_skew([fast, slow, None])
    assert out["straggler_rank"] == 1
    assert abs(out["skew_s"] - 0.2) < 1e-9
    assert out["straggler_breakdown"]["collective_s"] == pytest.approx(0.2)
    assert compute_skew([fast, None]) is None


def test_straggler_attribution_two_node_gang(results):
    _same(results, "straggler_attribution",
          [True, 1, True, [0, 1], True, True, True])


def test_fence_waits_for_tensors_without_loading_torch():
    """fence() of a tree of CPU tensors returns (they are computed), and
    the flight recorder never imports torch itself."""
    import torch

    code = ("import sys\n"
            "from ray_tpu_torch.train import StepProfiler\n"
            "p = StepProfiler(ring=2, rank=0, emit_metrics=False)\n"
            "with p.step() as s:\n"
            "    s.fence({'a': [1.0]})\n"
            "print('torch' in sys.modules, p.records()[-1]['compute_s'] >= 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.stdout.split() == ["False", "True"], proc.stderr
    from ray_tpu_torch.train import StepProfiler

    prof = StepProfiler(ring=2, rank=0, emit_metrics=False)
    with prof.step() as s:
        s.fence({"a": [torch.ones(2)], "b": torch.zeros(1)})
    assert prof.records()[-1]["compute_s"] >= 0


# -- tests/test_elastic_gang.py -------------------------------------------

def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "w": rng.standard_normal(67).astype(np.float64),
        "m": np.arange(64, dtype=np.float32).reshape(8, 8),
        "v": rng.randint(0, 1 << 30, size=13).astype(np.int32),
        "step": 41,
        "lr": 0.125,
    }


def _tree_equal(a, b):
    import jax

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, (int, float, bool)):
            assert type(x) is type(y) and x == y, (x, y)
        else:
            assert x.dtype == y.dtype, (x.dtype, y.dtype)
            assert np.array_equal(x, y)


@pytest.mark.parametrize("old_world,new_world",
                         [(8, 4), (8, 6), (4, 8), (3, 5)])
def test_shard_remap_bijection(old_world, new_world):
    from ray_tpu.train import ShardedState as JaxShardedState

    from ray_tpu_torch.train import ShardRemapPlan, ShardedState

    tree = _tree()
    old = {r: ShardedState.create(tree, r, old_world)
           for r in range(old_world)}
    meta = old[0].meta
    plan = ShardRemapPlan(old_world, new_world, meta["sizes"],
                          meta["dtypes"])
    new_shards = {}
    for nr in range(new_world):
        srcs = {r: old[r].slices for r in plan.sources_for(nr)}
        new_shards[nr] = plan.remap(nr, srcs)
        direct = ShardedState.create(tree, nr, new_world).slices
        ref = JaxShardedState.create(tree, nr, new_world).slices
        for got, want, r in zip(new_shards[nr], direct, ref):
            assert got.dtype == want.dtype == r.dtype
            assert np.array_equal(got, want) and np.array_equal(got, r)
    _tree_equal(ShardedState.assemble(meta, new_shards), tree)


def test_shrink_grow_roundtrip_bit_equality():
    from ray_tpu_torch.train import ShardRemapPlan, ShardedState

    tree = _tree(seed=7)
    full8 = {r: ShardedState.create(tree, r, 8) for r in range(8)}
    meta = full8[0].meta
    down = ShardRemapPlan(8, 4, meta["sizes"], meta["dtypes"])
    at4 = {nr: down.remap(nr, {r: full8[r].slices
                               for r in down.sources_for(nr)})
           for nr in range(4)}
    up = ShardRemapPlan(4, 8, meta["sizes"], meta["dtypes"])
    at8 = {nr: up.remap(nr, {r: at4[r] for r in up.sources_for(nr)})
           for nr in range(8)}
    _tree_equal(ShardedState.assemble(meta, at8), tree)
    for r in range(8):
        for got, want in zip(at8[r], full8[r].slices):
            assert got.tobytes() == want.tobytes()


def test_sharded_state_of_tensors_roundtrips_bit_for_bit():
    """The port's own case: a tree of torch tensors (bf16 among them)
    shards and reassembles to the same tensors, bit for bit."""
    import torch

    from ray_tpu_torch.train import ShardedState

    g = torch.Generator().manual_seed(0)
    tree = {"p": torch.randn(37, 3, generator=g).to(torch.bfloat16),
            "m": [torch.randn(11, generator=g), torch.arange(5)],
            "step": 3}
    shards = {r: ShardedState.create(tree, r, 4) for r in range(4)}
    back = ShardedState.assemble(shards[0].meta,
                                 {r: s.slices for r, s in shards.items()})
    assert back["p"].dtype == torch.bfloat16
    assert torch.equal(back["p"].view(torch.int16), tree["p"].view(torch.int16))
    assert torch.equal(back["m"][0], tree["m"][0])
    assert torch.equal(back["m"][1], tree["m"][1])
    assert back["step"] == 3


def test_sharded_state_save_load_roundtrip(tmp_path):
    from ray_tpu_torch.train import ShardedState

    tree = _tree(seed=3)
    for r in range(3):
        ShardedState.create(tree, r, 3).save(str(tmp_path))
    loaded = ShardedState.load_all(str(tmp_path))
    assert sorted(loaded) == [0, 1, 2]
    _tree_equal(ShardedState.assemble(
        loaded[0].meta, {r: s.slices for r, s in loaded.items()}), tree)


def test_epoch_fence_rejects_stale_rank_mid_resize():
    """A resize rebuilds the process group at a new address under the
    bumped epoch: a departed rank that still holds the old address cannot
    join (the JAX package's DCN fence, util.collective)."""
    from ray_tpu_torch.train.torch import TorchConfig, _TorchBackend

    class _Resized(_FakeGroup):
        destroyed = 0

        def execute(self, fn):
            self.destroyed += 1

    group = _Resized(0)
    backend = _TorchBackend()
    backend.on_start(group, TorchConfig())
    group.epoch = 1
    backend.on_resize(group, TorchConfig())
    before, after = group.calls
    assert group.destroyed == 1
    assert before["init_method"] != after["init_method"]
    proc = _stale_join(before["init_method"])
    assert "REFUSED" in proc.stdout, proc.stdout + proc.stderr


def test_resize_policy_cooldown_and_floor():
    from ray_tpu.train.trainer import _ResizeGovernor as JaxGovernor

    from ray_tpu_torch.train import ResizePolicy
    from ray_tpu_torch.train.trainer import _ResizeGovernor

    def trace(gov_cls):
        t = [100.0]
        gov = gov_cls(ResizePolicy(min_world_size=2, resize_cooldown_s=10.0),
                      4, clock=lambda: t[0])
        out = [gov.shrink_target(4, 1)]
        gov.note_resized()
        out += [gov.shrink_target(3, 1), gov.want_grow(3)]
        t[0] += 10.0
        out += [gov.shrink_target(3, 1), gov.shrink_target(3, 2),
                gov.shrink_target(2, 1)]
        gov.note_resized()
        t[0] += 10.0
        out += [gov.want_grow(2), gov.want_grow(4)]
        frozen = gov_cls(ResizePolicy(min_world_size=2, grow_back=False), 4,
                         clock=lambda: t[0])
        return out + [frozen.want_grow(2)]

    assert trace(_ResizeGovernor) == trace(JaxGovernor) == [
        3, None, False, 2, None, None, True, False, False]


def test_restart_shutdown_verifies_pg_release(monkeypatch):
    import ray_tpu_torch as rt
    from ray_tpu_torch.exceptions import PlacementGroupSchedulingError
    from ray_tpu_torch.train import worker_group as wg_mod

    rt.init(num_cpus=4)
    try:
        wg = wg_mod.WorkerGroup(1, {"CPU": 1})
        assert wg_mod.placement_group_state(wg._pg) == "CREATED"

        class _Jumpy:
            def __init__(self):
                self.t = 0.0

            def monotonic(self):
                self.t += 3.0
                return self.t

            def sleep(self, _):
                pass

        pg = wg._pg
        monkeypatch.setattr(wg_mod, "placement_group_state",
                            lambda _pg: "CREATED")
        monkeypatch.setattr(wg_mod, "time", _Jumpy())
        with pytest.raises(PlacementGroupSchedulingError,
                           match="still reserved after shutdown"):
            wg.shutdown(verify=True)
        monkeypatch.undo()
        deadline = time.monotonic() + 30
        while wg_mod.placement_group_state(pg) not in (None, "REMOVED"):
            assert time.monotonic() < deadline, "pg removal"
            time.sleep(0.05)
    finally:
        rt.shutdown()


def test_gpu_worker_group_holds_its_bundles_gpu():
    """A worker of ScalingConfig(use_gpu=True) holds its bundle's GPU as
    an actor: the card reads as taken while it lives and free after the
    group shuts down (one GPU faked on this host)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train.worker_group import WorkerGroup

    res = ScalingConfig(num_workers=1, use_gpu=True).worker_resources()
    assert res == {"GPU": 1.0, "CPU": 1.0}
    rt.init(num_cpus=2, num_gpus=1)
    try:
        wg = WorkerGroup(1, res)
        try:
            assert wg.execute(lambda: 7) == [7]
            assert rt.available_resources().get("GPU", 0.0) == 0.0
        finally:
            wg.shutdown(verify=True)
        deadline = time.monotonic() + 30
        while rt.available_resources().get("GPU", 0.0) != 1.0:
            assert time.monotonic() < deadline, rt.available_resources()
            time.sleep(0.1)
    finally:
        rt.shutdown()


def _cards_loop(config):
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import get_device

    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (os.environ.get("CUDA_VISIBLE_DEVICES"),
                                  str(get_device())))
    train.report({"seen": seen})


def test_gpu_trainer_workers_are_confined_to_distinct_cards(monkeypatch,
                                                            tmp_path):
    """TorchTrainer(use_gpu=True) on gloo over two (faked) cards: each
    worker holds its bundle's GPU, the raylet confines each to a
    different card, and get_device() keeps a worker whose card is faked
    on the CPU (this host has none)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rt.init(num_cpus=4, num_gpus=2)
    try:
        result = TorchTrainer(
            _cards_loop,
            backend_config=TorchConfig(backend="gloo"),
            scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
            run_config=RunConfig(name="cards", storage_path=str(tmp_path)),
        ).fit()
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    seen = result.metrics_history[-1]["seen"]
    assert sorted(v for v, _ in seen) == ["0", "1"]
    assert [d for _, d in seen] == ["cpu", "cpu"]


@pytest.mark.chaos
def test_chaos_resize_under_active_step(results):
    ref, out = results
    assert out["resize_under_active_step"] == [
        False, True, True, [2, 3], 3, True]
    assert out["resize_under_active_step"] == ref["resize_under_active_step"]
