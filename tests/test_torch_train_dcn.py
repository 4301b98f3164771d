"""The port's DCN data-parallel path (ray_tpu_torch.train with
util.collective) held against the JAX package's.

  * The gang-epoch fence and the per-op deadline on the port's DcnGroup,
    as tests/test_train_fault_tolerance.py and tests/test_elastic_gang.py
    check them on the JAX one (each case runs on both packages).
  * chaos.sever_dcn_peer: the rank that severs and its peer both raise
    CollectiveTimeoutError instead of hanging.
  * The flight recorder's observer puts collective time in the step's
    "collective" phase (tests/test_flight_recorder.py:70).
  * TorchConfig(dp_sync="dcn") on 2 gloo workers against JaxTrainer with
    JaxConfig(dp_sync="dcn"), configs.tiny in f32, both from one JAX
    init_params tree and the same numpy batches:
      - the same per-rank gradients (computed once with JAX here) through
        each trainer's `allreduce_gradients(grads, "train_dp")`: reduced
        results within rtol 1e-5 (they are bit-equal on this host);
      - each trainer's own gradients, reduced: within 2e-3, the f32
        gradient tolerance of tests/test_torch_train_parity.py (the two
        frameworks sum in other orders).
  * A resize rebuilds "train_dp" at the new gang epoch.
"""

import socket
import threading
import time

import numpy as np
import pytest

from tests.test_torch_collective import FakeKV
from tests.test_torch_serve_api import PRELUDE, run_driver

PKGS = ("ray_tpu", "ray_tpu_torch")


def _dcn(pkg):
    if pkg == "ray_tpu":
        from ray_tpu.exceptions import CollectiveTimeoutError
        from ray_tpu.util.collective import dcn_group
    else:
        from ray_tpu_torch.exceptions import CollectiveTimeoutError
        from ray_tpu_torch.util.collective import dcn_group
    return dcn_group, CollectiveTimeoutError


@pytest.mark.parametrize("pkg", PKGS)
def test_gang_epoch_rejects_stale_rank(pkg):
    """A zombie rank from a torn-down attempt can neither find the new
    ring in the KV nor pass the identification handshake."""
    dcn, CollectiveTimeoutError = _dcn(pkg)
    kv = FakeKV()
    fresh = dcn.DcnGroup(kv, 2, 0, "fence", timeout=0.5, epoch=1)
    stale = dcn.DcnGroup(kv, 2, 1, "fence", timeout=0.3, epoch=0)
    try:
        with pytest.raises(TimeoutError):
            stale._peer_out(0)
        s = socket.create_connection(tuple(fresh.addr), timeout=2)
        ident = dcn._IDENT.pack(1, 0, 0, 0)  # rank 1, stale epoch 0
        s.sendall(dcn._LEN.pack(len(ident)) + ident)
        with pytest.raises(CollectiveTimeoutError):
            fresh._peer_in(1)
        s.close()
        s2 = socket.create_connection(tuple(fresh.addr), timeout=2)
        ident = dcn._IDENT.pack(1, 1, 0, 0)
        s2.sendall(dcn._LEN.pack(len(ident)) + ident)
        assert fresh._peer_in(1) is not None
        s2.close()
    finally:
        fresh.destroy()
        stale.destroy()


@pytest.mark.parametrize("pkg", PKGS)
def test_dcn_recv_timeout_raises_instead_of_hanging(pkg):
    """A peer that connects and then goes silent trips the per-op socket
    deadline as a typed CollectiveTimeoutError."""
    dcn, CollectiveTimeoutError = _dcn(pkg)
    kv = FakeKV()
    g0 = dcn.DcnGroup(kv, 2, 0, "hang", timeout=2.0, epoch=0, op_timeout=0.5)
    g1 = dcn.DcnGroup(kv, 2, 1, "hang", timeout=2.0, epoch=0, op_timeout=0.5)
    try:
        g1._peer_out(0)  # connect + identify, then never send anything
        t0 = time.monotonic()
        with pytest.raises(CollectiveTimeoutError) as exc:
            g0.recv(1)
        assert 0.3 <= time.monotonic() - t0 < 5.0
        assert exc.value.peer_rank == 1
        assert exc.value.group_name == "hang"
    finally:
        g0.destroy()
        g1.destroy()


@pytest.mark.parametrize("pkg", PKGS)
def test_epoch_fence_rejects_stale_rank_mid_resize(pkg):
    """After a 4 -> 3 resize at epoch 1, the departed rank 3 (epoch 0)
    can neither find the rebuilt ring nor pass the handshake."""
    dcn, CollectiveTimeoutError = _dcn(pkg)
    kv = FakeKV()
    resized = dcn.DcnGroup(kv, 3, 0, "elastic", timeout=0.5, epoch=1)
    stale = dcn.DcnGroup(kv, 4, 3, "elastic", timeout=0.3, epoch=0)
    try:
        with pytest.raises(TimeoutError):
            stale._peer_out(0)
        s = socket.create_connection(tuple(resized.addr), timeout=2)
        s.sendall(dcn._LEN.pack(dcn._IDENT.size)
                  + dcn._IDENT.pack(3, 0, 0, 0))
        with pytest.raises(CollectiveTimeoutError):
            resized._peer_in(3)
        s.close()
        s2 = socket.create_connection(tuple(resized.addr), timeout=2)
        s2.sendall(dcn._LEN.pack(dcn._IDENT.size)
                   + dcn._IDENT.pack(2, 1, 0, 0))
        assert resized._peer_in(2) is not None
        s2.close()
    finally:
        resized.destroy()
        stale.destroy()


def test_sever_dcn_peer_raises_on_both_sides_within_the_deadline():
    """Rank 1 severs its link to rank 0 between two allreduces: rank 0's
    next op raises CollectiveTimeoutError at once (its peer closed the
    link), and rank 1's within its own deadlines, neither hanging."""
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.exceptions import CollectiveTimeoutError
    from ray_tpu_torch.util.collective import collective as col
    from ray_tpu_torch.util.collective.dcn_group import DcnGroup

    kv = FakeKV()
    groups = [DcnGroup(kv, 2, r, "train_dp", timeout=1.0, epoch=0,
                       op_timeout=1.0) for r in range(2)]
    # Rank 1 is this process's registered member of "train_dp".
    col._manager._groups["train_dp"] = groups[1]
    col._manager._meta["train_dp"] = {"backend": "dcn", "world_size": 2,
                                      "rank": 1, "epoch": 0}
    results = [None, None]

    def rank(r, sever):
        try:
            groups[r].allreduce(np.ones(8, np.float32))
            if sever:
                chaos.sever_dcn_peer(0, "train_dp")
            time.sleep(0.2)
            t0 = time.monotonic()
            try:
                groups[r].allreduce(np.ones(8, np.float32))
                results[r] = "completed"
            except CollectiveTimeoutError as e:
                results[r] = (e, time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001
            results[r] = e

    chaos.enable()
    try:
        ts = [threading.Thread(target=rank, args=(r, r == 1))
              for r in range(2)]
        [t.start() for t in ts]
        [t.join(30) for t in ts]
    finally:
        chaos.disable()
        col._manager._groups.pop("train_dp", None)
        col._manager._meta.pop("train_dp", None)
        for g in groups:
            g.destroy()
    for r in range(2):
        assert isinstance(results[r], tuple), results[r]
        err, took = results[r]
        assert err.group_name == "train_dp" and took < 5.0
    assert results[0][0].peer_rank == 1


def test_sever_dcn_peer_requires_chaos():
    from ray_tpu_torch._private import chaos

    chaos.disable()
    with pytest.raises(RuntimeError, match="RT_CHAOS"):
        chaos.sever_dcn_peer(0)


@pytest.mark.parametrize("pkg", PKGS)
def test_collective_time_attributed_via_observer(pkg):
    """The collective op wrappers report wall time into the active step
    through the observer hook — no loop annotation needed."""
    import importlib

    train = importlib.import_module(pkg + ".train")
    col = importlib.import_module(pkg + ".util.collective.collective")
    prof = train.StepProfiler(ring=4, rank=0, emit_metrics=False)
    with prof.step():
        col._observed("allreduce", lambda: time.sleep(0.01))
    rec = prof.records()[-1]
    assert rec["collective_s"] >= 0.01
    assert rec["collective_s"] <= rec["wall_s"] + 1e-9


def test_resize_rebuilds_train_dp_at_the_new_epoch():
    """on_start joins "train_dp" at the gang's epoch; on_resize leaves it
    and joins again at the bumped epoch; dp_sync="none" joins none."""
    from ray_tpu_torch.train.torch import TorchConfig, _TorchBackend
    from tests.test_torch_train_api import _FakeGroup

    class _Resized(_FakeGroup):
        destroyed = 0

        def execute(self, fn):
            self.destroyed += 1

    group = _Resized(0)
    backend = _TorchBackend()
    backend.on_start(group, TorchConfig())
    group.epoch = 1
    backend.on_resize(group, TorchConfig())
    assert [c["dcn_epoch"] for c in group.calls] == [0, 1]
    assert group.destroyed == 1
    off = _Resized(0)
    backend.on_start(off, TorchConfig(dp_sync="none"))
    assert off.calls[0]["dcn_epoch"] is None
    with pytest.raises(ValueError, match="dp_sync"):
        backend.on_start(_Resized(0), TorchConfig(dp_sync="nccl"))


def test_destroy_leaves_train_dp():
    """The worker-side teardown leaves the "train_dp" group it joined."""
    from ray_tpu_torch.train.torch import _torch_process_group_destroy
    from ray_tpu_torch.util.collective import collective as col
    from ray_tpu_torch.util.collective.dcn_group import DcnGroup

    g = DcnGroup(FakeKV(), 1, 0, "train_dp", timeout=1, epoch=3)
    col._manager._groups["train_dp"] = g
    col._manager._meta["train_dp"] = {"backend": "dcn", "world_size": 1,
                                      "rank": 0, "epoch": 3}
    assert _torch_process_group_destroy()
    with pytest.raises(ValueError, match="not initialized"):
        col.last_op_info("train_dp")


DRIVER = PRELUDE + r'''
import tempfile

train = importlib.import_module(pkg + ".train")
weights, fixed_grads, out_dir = sys.argv[2], sys.argv[3], sys.argv[4]


def nest(flat):
    tree = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers/"):
            tree["layers"][k[len("layers/"):]] = v
        else:
            tree[k] = v
    return tree


def flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({"layers/" + k: v for k, v in tree["layers"].items()})
    return out


def batch(rank):
    return np.random.default_rng(500 + rank).integers(
        0, 256, size=(2, 17)).astype(np.int32)


def loop(config):
    import os

    rank = train.get_world_rank()
    mine = nest({k[len(f"g{rank}/"):]: v
                 for k, v in np.load(config["fixed"]).items()
                 if k.startswith(f"g{rank}/")})
    seen = []
    col = importlib.import_module(config["pkg"] + ".util.collective")
    col.add_op_observer(lambda op, s, info=None: seen.append(s))
    prof = train.StepProfiler(ring=4, rank=rank, emit_metrics=False)
    if config["pkg"] == "ray_tpu":
        import jax
        import jax.numpy as jnp

        from ray_tpu.models import configs
        from ray_tpu.models import transformer as tf

        params = jax.tree_util.tree_map(
            jnp.asarray, nest(dict(np.load(config["weights"]))))
        loss, g = jax.value_and_grad(tf.loss_fn)(
            params, jnp.asarray(batch(rank)), configs.tiny)
        with prof.step():
            own = train.allreduce_gradients(g, "train_dp")
        fixed = train.allreduce_gradients(
            jax.tree_util.tree_map(jnp.asarray, mine), "train_dp")
        own = jax.tree_util.tree_map(np.asarray, own)
        fixed = jax.tree_util.tree_map(np.asarray, fixed)
    else:
        import torch

        from ray_tpu_torch.models import configs, loss_fn, params_from_jax

        torch.set_num_threads(1)
        params = params_from_jax(nest(dict(np.load(config["weights"]))),
                                 configs.tiny, device="cpu")
        leaves = [params[k] for k in params if k != "layers"] + list(
            params["layers"].values())
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(params, torch.from_numpy(batch(rank)).long(),
                       configs.tiny)
        loss.backward()
        g = {k: (v.grad if k != "layers" else
                 {kk: vv.grad for kk, vv in v.items()})
             for k, v in params.items()}
        with prof.step():
            own = train.allreduce_gradients(g, "train_dp")
        fixed = train.allreduce_gradients(
            {k: (torch.from_numpy(v) if k != "layers" else
                 {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in mine.items()}, "train_dp")
        own = {k: (v.numpy() if k != "layers" else
                   {kk: vv.numpy() for kk, vv in v.items()})
               for k, v in own.items()}
        fixed = {k: (v.numpy() if k != "layers" else
                     {kk: vv.numpy() for kk, vv in v.items()})
                 for k, v in fixed.items()}
    np.savez(os.path.join(config["out"], f"{config['pkg']}_{rank}.npz"),
             **{"own/" + k: v for k, v in flat(own).items()},
             **{"fixed/" + k: v for k, v in flat(fixed).items()})
    rec = prof.records()[-1]
    train.report({"rank": rank, "loss": float(loss),
                  "collective_s": rec["collective_s"],
                  "observed_s": sum(seen[:len(seen) // 2]),
                  "ops": len(seen)})


rt.init(num_cpus=4)
try:
    kw = dict(train_loop_config={"pkg": pkg, "weights": weights,
                                 "fixed": fixed_grads, "out": out_dir},
              scaling_config=train.ScalingConfig(num_workers=2),
              run_config=train.RunConfig(
                  name="dcn", storage_path=tempfile.mkdtemp(prefix="dcn_")))
    if pkg == "ray_tpu":
        trainer = train.JaxTrainer(
            loop, jax_config=train.JaxConfig(dp_sync="dcn"), **kw)
    else:
        trainer = train.TorchTrainer(
            loop, backend_config=train.TorchConfig(backend="gloo",
                                                   dp_sync="dcn"), **kw)
    r = trainer.fit()
finally:
    rt.shutdown()
print("RESULT " + json.dumps({
    "error": None if r.error is None else str(r.error),
    "metrics": r.metrics_history}))
'''


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import configs
    from ray_tpu.models import transformer as tf

    tmp = tmp_path_factory.mktemp("train_dcn")
    tree = jax.tree_util.tree_map(
        np.asarray, tf.init_params(jax.random.PRNGKey(0), configs.tiny))
    weights = tmp / "weights.npz"
    np.savez(weights, **_flat(tree))
    grads = {}
    for rank in range(2):
        tokens = np.random.default_rng(500 + rank).integers(
            0, 256, size=(2, 17)).astype(np.int32)
        g = jax.grad(tf.loss_fn)(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jnp.asarray(tokens), configs.tiny)
        grads.update({f"g{rank}/{k}": np.asarray(v)
                      for k, v in _flat(g).items()})
    fixed = tmp / "fixed.npz"
    np.savez(fixed, **grads)
    out = {}
    for pkg in PKGS:
        res = run_driver(tmp, DRIVER, pkg, str(weights), str(fixed),
                         str(tmp), timeout=600)
        assert res["error"] is None, res["error"]
        out[pkg] = (res["metrics"], [dict(np.load(tmp / f"{pkg}_{r}.npz"))
                                     for r in range(2)])
    return grads, out


def test_fixed_gradients_reduce_alike_through_both_trainers(runs):
    grads, out = runs
    _, jax_ranks = out["ray_tpu"]
    _, port_ranks = out["ray_tpu_torch"]
    keys = [k[len("g0/"):] for k in grads if k.startswith("g0/")]
    for r in range(2):
        for k in keys:
            want = (grads[f"g0/{k}"] + grads[f"g1/{k}"]) / 2
            np.testing.assert_allclose(port_ranks[r]["fixed/" + k],
                                       jax_ranks[r]["fixed/" + k],
                                       rtol=1e-5, atol=0, err_msg=k)
            np.testing.assert_allclose(port_ranks[r]["fixed/" + k], want,
                                       rtol=1e-5, atol=0, err_msg=k)


def test_own_gradients_reduce_alike_through_both_trainers(runs):
    _, out = runs
    _, jax_ranks = out["ray_tpu"]
    _, port_ranks = out["ray_tpu_torch"]
    for r in range(2):
        for k, v in port_ranks[r].items():
            if k.startswith("own/"):
                np.testing.assert_allclose(v, jax_ranks[r][k], rtol=0,
                                           atol=2e-3, err_msg=k)
        # Both ranks hold the same mean.
        for k, v in port_ranks[r].items():
            assert np.array_equal(v, port_ranks[0][k])


def test_collective_phase_equals_the_observed_ops(runs):
    """The flight recorder's collective share of the step is non-zero and
    equals the wall of the ops the observer saw inside the step."""
    _, out = runs
    for pkg in PKGS:
        metrics, _ = out[pkg]
        assert metrics
        for m in metrics:
            assert m["collective_s"] > 0
            assert m["ops"] > 0 and m["ops"] % 2 == 0
            assert m["collective_s"] == pytest.approx(m["observed_s"],
                                                      rel=1e-9, abs=1e-12)
