"""The port's trainers fed by datasets (ray_tpu_torch.data), held against
the JAX package's.

* `TorchTrainer(datasets=...)` with two gloo workers against
  `JaxTrainer(datasets=...)` with two DCN workers, on the same rows and
  the same weights (configs.tiny in f32, one JAX init_params tree carried
  into the port by params_from_jax): over two epochs each rank receives
  the same rows in both, and the losses agree within 2e-3, the tolerance
  of tests/test_torch_train_parity.py (the two frameworks sum in other
  orders). A JAX worker reads `iter_batches`, the port's
  `iter_torch_batches(device="cpu")`.
* The shards an elastic resize hands the gang: `_shard_datasets(3)` then
  `_shard_datasets(2)`, as `_elastic_resize` calls them, re-split the
  rows row-exactly in both packages, and `_stop_shards` ends the old
  split's coordinator.
* A broadcast dataset and a split one over three epochs
  (tests/test_data_streaming.py::test_trainer_streaming_ingestion_multi_epoch).
* `SklearnTrainer` on Datasets gives the JAX package's fits and scores.
* The flight recorder's `data` phase reads a real DataIterator's
  FeedStats.

Both runtimes run in this process (tests/torch_data_util.py).
"""

import json
import threading

import jax
import numpy as np
import pytest

from ray_tpu.models import configs as jax_configs
from ray_tpu.models import transformer as jax_tf
from tests.torch_data_util import PACKAGES, both_runtimes, same

TOL = 2e-3  # tests/test_torch_train_parity.py
ROWS, SEQ, EPOCHS, BATCH = 16, 17, 2, 2
LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    with both_runtimes(num_cpus=8):
        yield


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


def _loops():
    """The two training loops, made here so that they travel to the
    workers by value (a module-level function would make every worker
    import this test module, JAX and both runtimes)."""

    def nest(flat):
        tree = {"layers": {}}
        for k, v in flat.items():
            if k.startswith("layers/"):
                tree["layers"][k[len("layers/"):]] = v
            else:
                tree[k] = v
        return tree

    def jax_loop(config):
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
        shard = train.get_dataset_shard("train")
        rank = train.get_world_rank()
        rows, losses = [], []
        for _ in range(config["epochs"]):
            got = []
            for b in shard.iter_batches(batch_size=config["batch"]):
                # A split's batches come through rows: the token column is
                # one array per row.
                tok = np.stack(list(b["tokens"])).astype(np.int32)
                got += [int(r) for r in b["row"]]
                loss, g = jax.value_and_grad(tf.loss_fn)(
                    params, jnp.asarray(tok), cfg)
                g = train.allreduce_gradients(g)
                updates, state = opt.update(g, state, params)
                params = optax.apply_updates(params, updates)
                losses.append(float(loss))
            rows.append(got)
        with open(f"{config['out']}/jax_rank{rank}.json", "w") as f:
            json.dump({"rows": rows, "losses": losses}, f)
        train.report({"steps": len(losses)})


    def torch_loop(config):
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
        shard = train.get_dataset_shard("train")
        rank = train.get_world_rank()
        rows, losses = [], []
        for _ in range(config["epochs"]):
            got = []
            for b in shard.iter_torch_batches(batch_size=config["batch"],
                                              device="cpu"):
                got += b["row"].tolist()
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(params, b["tokens"].long(), cfg)
                loss.backward()
                grads = train.allreduce_gradients([t.grad for t in leaves])
                for t, g in zip(leaves, grads):
                    t.grad = g
                opt.step()
                losses.append(float(loss))
            rows.append(got)
        with open(f"{config['out']}/torch_rank{rank}.json", "w") as f:
            json.dump({"rows": rows, "losses": losses}, f)
        train.report({"steps": len(losses)})

    return jax_loop, torch_loop


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    import ray_tpu.train as jt
    import ray_tpu_torch.train as tt

    tmp = tmp_path_factory.mktemp("train_data")
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jax.random.PRNGKey(0),
                                       jax_configs.tiny))
    weights = tmp / "weights.npz"
    np.savez(weights, **_flat(tree))
    rng = np.random.default_rng(3)
    arrays = {"tokens": rng.integers(0, 256, (ROWS, SEQ), dtype=np.int32),
              "row": np.arange(ROWS, dtype=np.int32)}
    config = {"weights": str(weights), "out": str(tmp), "lr": LR,
              "epochs": EPOCHS, "batch": BATCH}
    jax_loop, torch_loop = _loops()
    results = {}
    for (rt, rd), (name, trainer) in zip(PACKAGES, (
            ("jax", lambda **kw: jt.JaxTrainer(
                jax_loop, jax_config=jt.JaxConfig(dp_sync="dcn"), **kw)),
            ("torch", lambda **kw: tt.TorchTrainer(torch_loop, **kw)))):
        train = jt if name == "jax" else tt
        r = trainer(train_loop_config=config,
                    scaling_config=train.ScalingConfig(num_workers=2),
                    run_config=train.RunConfig(
                        name=name, storage_path=str(tmp / name)),
                    datasets={"train": rd.from_numpy(arrays,
                                                     parallelism=4)}).fit()
        assert r.error is None, r.error
        results[name] = [json.loads((tmp / f"{name}_rank{i}.json")
                                    .read_text()) for i in range(2)]
    return results


def test_each_rank_receives_the_same_rows_in_both(trained):
    for jax_rank, torch_rank in zip(trained["jax"], trained["torch"]):
        assert torch_rank["rows"] == jax_rank["rows"]
        assert len(torch_rank["rows"]) == EPOCHS
        # The same rows again in the second epoch.
        assert torch_rank["rows"][0] == torch_rank["rows"][1]
    per_epoch = [sorted(sum((r["rows"][e] for r in trained["torch"]), []))
                 for e in range(EPOCHS)]
    assert per_epoch == [list(range(ROWS))] * EPOCHS


def test_losses_agree_over_two_epochs(trained):
    steps = EPOCHS * ROWS // 2 // BATCH
    for jax_rank, torch_rank in zip(trained["jax"], trained["torch"]):
        assert len(torch_rank["losses"]) == len(jax_rank["losses"]) == steps
        np.testing.assert_allclose(torch_rank["losses"], jax_rank["losses"],
                                   rtol=0, atol=TOL)
    # Training moved the loss: the same rows a second time score lower.
    first = trained["torch"][0]["losses"]
    assert first[steps // 2] < first[0] - 10 * TOL


def _consume(its):
    parts = [None] * len(its)

    def run(i):
        parts[i] = [r["id"] for r in its[i].iter_rows()]

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(its))]
    [t.start() for t in ts]
    [t.join(timeout=120) for t in ts]
    assert not any(t.is_alive() for t in ts)
    return parts


def _gone(rt, actor, timeout=30.0):
    """Whether the actor stops answering within `timeout` (a kill lands
    asynchronously, so a call made at once may still be served)."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            rt.get(actor.stats.remote(), timeout=5)
        except Exception:  # noqa: BLE001 — the killed actor's error
            return True
        time.sleep(0.1)
    return False


def test_an_elastic_resize_resplits_the_dataset():
    """The shards `_elastic_resize` builds for a gang of 3 and then of 2:
    row-exact in both packages, every row covered, and the old split's
    coordinator gone after `_stop_shards`."""
    import importlib

    def pipeline(rt, rd):
        train = importlib.import_module(rt.__name__ + ".train")
        trainer = train.DataParallelTrainer(
            lambda: None,
            datasets={"train": rd.range(90, parallelism=9),
                      "val": rd.range(5, parallelism=1)},
            dataset_config=train.DataConfig(datasets_to_split=["train"]))
        sizes = []
        for n in (3, 2):
            shards = trainer._shard_datasets(n)
            parts = _consume([s["train"] for s in shards])
            sizes.append([len(p) for p in parts])
            assert sorted(sum(parts, [])) == list(range(90))
            assert all(s["val"] is trainer.datasets["val"] for s in shards)
            coord = shards[0]["train"]._coord
            trainer._stop_shards(shards)
            sizes.append(_gone(rt, coord))
        return sizes

    assert same(pipeline) == [[30, 30, 30], True, [45, 45], True]


def test_trainer_streaming_ingestion_multi_epoch(tmp_path):
    """A split dataset per epoch over three epochs and a broadcast one
    whole on every worker, through each package's trainer."""
    import importlib

    def pipeline(rt, rd):
        train = importlib.import_module(rt.__name__ + ".train")
        out = tmp_path / rt.__name__
        out.mkdir()

        def loop(config):
            import importlib
            import json

            train = importlib.import_module(config["pkg"] + ".train")
            shard = train.get_dataset_shard("train")
            val = train.get_dataset_shard("val")
            rank = train.get_world_rank()
            sums = [sum(r["id"] for r in shard.iter_rows())
                    for _ in range(3)]
            whole = sorted(r["id"] for r in val.iter_rows())
            with open(f"{config['out']}/rank{rank}.json", "w") as f:
                json.dump({"sums": sums, "val": whole}, f)
            train.report({"done": True})

        Trainer = (train.JaxTrainer if rt.__name__ == "ray_tpu"
                   else train.TorchTrainer)
        r = Trainer(loop, train_loop_config={"pkg": rt.__name__,
                                             "out": str(out)},
                    scaling_config=train.ScalingConfig(num_workers=2),
                    run_config=train.RunConfig(
                        name="stream", storage_path=str(out / "runs")),
                    datasets={"train": rd.range(40, parallelism=8),
                              "val": rd.range(5, parallelism=1)},
                    dataset_config=train.DataConfig(
                        datasets_to_split=["train"])).fit()
        ranks = [json.loads((out / f"rank{i}.json").read_text())
                 for i in range(2)]
        return [r.error is None,
                [sum(rk["sums"][e] for rk in ranks) for e in range(3)],
                [rk["val"] for rk in ranks]]

    ok, sums, vals = same(pipeline)
    assert ok and sums == [sum(range(40))] * 3
    assert vals == [list(range(5))] * 2


def test_sklearn_trainer_on_datasets_matches():
    import importlib

    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    rows = [{"a": float(a), "b": float(b), "c": float(c), "y": int(t)}
            for (a, b, c), t in zip(X, y)]

    def pipeline(rt, rd):
        sk = importlib.import_module(rt.__name__ + ".train.sklearn")
        r = sk.SklearnTrainer(
            estimator=LogisticRegression(max_iter=200),
            datasets={"train": rd.from_items(rows[:150]),
                      "valid": rd.from_items(rows[150:])},
            label_column="y", scoring=["accuracy"]).fit()
        model = sk.SklearnTrainer.get_model(r.checkpoint)
        return [r.error is None, r.metrics["train_score"],
                r.metrics["valid_score"], r.metrics["valid_accuracy"],
                model.coef_.tolist()]

    ok, train_score, valid_score, _, _ = same(pipeline)
    assert ok and train_score > 0.9 and valid_score > 0.8


def test_flight_recorder_reads_a_data_iterator():
    """attach_feed(DataIterator): each step's data phase is the feed wait
    that the iterator's FeedStats measured (no explicit data phase), and
    the steps' feed waits add up to the iterator's own."""
    import time

    import ray_tpu_torch.data as td
    from ray_tpu_torch.train import StepProfiler

    def slow(batch):
        time.sleep(0.05)
        return batch

    (it,) = td.range(64, parallelism=8).map_batches(slow).streaming_split(1)
    try:
        prof = StepProfiler(rank=0, emit_metrics=False).attach_feed(it)
        feed = it.iter_torch_batches(batch_size=8, device="cpu")
        n = 0
        for _ in range(8):
            # The step pulls its batch: a wait for it is the step's.
            with prof.step():
                n += len(next(feed)["id"])
        stats = it.feed_stats()
        assert next(feed, None) is None
    finally:
        it.stop()
    records = prof.records()
    assert n == 64 and len(records) == 8 == stats["batches"]
    assert stats["stall_count"] >= 1 and stats["wait_s"] > 0
    assert [r["data_s"] for r in records] == [r["feed_wait_s"]
                                              for r in records]
    assert sum(r["feed_wait_s"] for r in records) == pytest.approx(
        stats["wait_s"], abs=1e-9)
    assert sum(r["feed_stalls"] for r in records) == stats["stall_count"]
