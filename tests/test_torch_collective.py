"""The port's collective layer (ray_tpu_torch.util.collective) held against
the JAX package's (ray_tpu.util.collective).

  * Both packages' DcnGroups, built in threads over an in-process KV, at
    world sizes 2, 3 and 4, in f32, f64 and bf16, for every op, both
    allreduce algorithms and int8/fp8 quantization with error feedback:
    results equal bit for bit (compared as raw bytes). The JAX
    DcnGroup's wire header carries a numpy bfloat16 array as '<V2', so
    its receiver gets a void array it cannot add; the JAX side of the
    bf16 cases reads such a frame back as bfloat16 (`_jax_bf16_wire`),
    which leaves its ring's schedule and numpy's one rounding per add as
    they are. The port tags bf16 on the wire and needs no such help.
  * The actor-level API as tests/test_collective.py uses it, on the
    port's runtime.
  * The local group on lists of CPU tensors, the hierarchical group and
    the op observer.

JAX is imported inside the tests only: the actors of this module import
it in their workers, which must not load JAX.
"""

import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt

torch.set_num_threads(1)

DTYPES = ("float32", "float64", "bfloat16")
OPS = ("allreduce_ring", "allreduce_rd", "allreduce_max_rd",
       "allreduce_min_ring", "allreduce_prod_ring", "allgather",
       "reducescatter", "broadcast", "reduce", "sendrecv", "barrier")


class FakeKV:
    """The slice of the GCS KV client DcnGroup rendezvous uses."""

    def __init__(self):
        self.d = {}
        self.lock = threading.Lock()

    def kv_put(self, k, v, ns=None, overwrite=True):
        with self.lock:
            self.d[(ns, k)] = v

    def kv_get(self, k, ns=None):
        with self.lock:
            return self.d.get((ns, k))

    def kv_del(self, k, ns=None):
        with self.lock:
            self.d.pop((ns, k), None)


def run_ring(n, make_group, fn):
    """Construct n group members on threads, run fn(group, rank) on each,
    destroy, and return (results, groups); any member's exception fails
    the call."""
    groups, errs, results = [None] * n, [None] * n, [None] * n

    def mk(r):
        try:
            groups[r] = make_group(r)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs[r] = e

    def work(r):
        try:
            results[r] = fn(groups[r], r)
        except Exception as e:  # noqa: BLE001
            errs[r] = e

    for target in (mk, work):
        threads = [threading.Thread(target=target, args=(r,))
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not any(errs), errs
    for g in groups:
        g.destroy()
    return results, groups


def dcn_ring(pkg, n, fn, name, **kw):
    if pkg == "jax":
        from ray_tpu.util.collective.dcn_group import DcnGroup
    else:
        from ray_tpu_torch.util.collective.dcn_group import DcnGroup
    kv = FakeKV()
    kw.setdefault("timeout", 15)
    kw.setdefault("op_timeout", 15)
    return run_ring(n, lambda r: DcnGroup(kv, n, r, name, epoch=0, **kw), fn)


@pytest.fixture
def jax_bf16_wire(monkeypatch):
    """Read the JAX DcnGroup's '<V2' frames back as bfloat16 (see the
    module docstring)."""
    import ml_dtypes

    from ray_tpu.util.collective import dcn_group

    orig = dcn_group._recv_frame

    def recv_frame(peer):
        out = orig(peer)
        if isinstance(out, np.ndarray) and out.dtype == np.dtype("V2"):
            out = out.view(ml_dtypes.bfloat16)
        return out

    monkeypatch.setattr(dcn_group, "_recv_frame", recv_frame)


def make_inputs(n, dtype, seed, size=1000, integer=False):
    import ml_dtypes

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal(size) * 3
        if integer:
            x = np.round(x)
        out.append(x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                            else dtype))
    return out


def bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.dtype.name, a.shape, a.view(np.uint8).tobytes()


def run_op(op, data):
    from ray_tpu_torch.util.collective.types import ReduceOp

    def fn(g, r):
        x = data[r]
        if op == "allreduce_ring":
            return [g.allreduce(x, algo="ring")]
        if op == "allreduce_rd":
            return [g.allreduce(x, algo="rd")]
        if op == "allreduce_max_rd":
            return [g.allreduce(x, op=ReduceOp.MAX, algo="rd")]
        if op == "allreduce_min_ring":
            return [g.allreduce(x, op=ReduceOp.MIN, algo="ring")]
        if op == "allreduce_prod_ring":
            return [g.allreduce(x[:64], op=ReduceOp.PRODUCT, algo="ring")]
        if op == "allgather":
            return g.allgather(x)
        if op == "reducescatter":
            return [g.reducescatter(x)]
        if op == "broadcast":
            return [g.broadcast(x, root=1)]
        if op == "reduce":
            return [g.reduce(x, root=1)]
        if op == "sendrecv":
            if r == 0:
                g.send(x, g.world_size - 1)
                return []
            if r == g.world_size - 1:
                return [g.recv(0)]
            return []
        if op == "barrier":
            g.barrier()
            return []
        raise ValueError(op)

    return fn


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            import ml_dtypes

            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return x


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_dcn_ops_bit_equal_to_the_jax_group(jax_bf16_wire, n, dtype, op):
    """Every op of the port's DcnGroup gives the JAX DcnGroup's results bit
    for bit, and the same op record (bytes included where the dtype's
    wire tag has the JAX's length)."""
    data = make_inputs(n, dtype, seed=100 * n + len(op))
    want, jg = dcn_ring("jax", n, run_op(op, data), f"j{op}")
    got, pg = dcn_ring("torch", n, run_op(op, data), f"p{op}")
    for r in range(n):
        assert len(got[r]) == len(want[r])
        for a, b in zip(got[r], want[r]):
            assert bits(_as_numpy(a)) == bits(b), (op, r)
    for p, j in zip(pg, jg):
        pi, ji = dict(p.last_op_info), dict(j.last_op_info)
        if dtype == "bfloat16":  # "bf16|..." against "<V2|..." headers
            pi.pop("bytes", None), ji.pop("bytes", None)
        elif op != "sendrecv":
            assert p.bytes_sent == j.bytes_sent
        assert pi == ji


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("scheme", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_allreduce_with_error_feedback_bit_equal(n, scheme, dtype):
    """Two EF-quantized allreduces in a row (the second folds the first's
    residual) and one without EF: bit-equal to the JAX group's."""
    data = make_inputs(n, dtype, seed=7 * n, size=1500)
    data2 = make_inputs(n, dtype, seed=7 * n + 1, size=1500)

    def fn(g, r):
        a = g.allreduce(data[r], quant=scheme, error_feedback=True,
                        ef_key="g")
        b = g.allreduce(data2[r], quant=scheme, error_feedback=True,
                        ef_key="g")
        c = g.allreduce(data2[r], quant=scheme)
        return [a, b, c], g.last_op_info

    want, _ = dcn_ring("jax", n, fn, "jq")
    got, _ = dcn_ring("torch", n, fn, "pq")
    for (ga, gi), (wa, wi) in zip(got, want):
        assert gi == wi
        for a, b in zip(ga, wa):
            assert bits(_as_numpy(a)) == bits(b)


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_quant_codes_and_scales_bit_equal_to_jax(scheme):
    """encode's codes and scales equal the JAX codec's bit for bit over
    magnitudes from 1e-30 to 1e30, block-straddling sizes and zero blocks;
    decode agrees too."""
    from ray_tpu.util.collective import quant as jq

    from ray_tpu_torch.util.collective import quant as tq

    rng = np.random.default_rng(0)
    for trial in range(24):
        size = int(rng.integers(1, 3000))
        x = (rng.standard_normal(size)
             * 10.0 ** rng.uniform(-30, 30)).astype(np.float32)
        if trial % 3 == 0:
            x[: min(size, 300)] = 0.0
        a, b = jq.encode(x, scheme), tq.encode(x, scheme)
        np.testing.assert_array_equal(b.codes.numpy(), a.codes)
        np.testing.assert_array_equal(b.scales.numpy().view(np.uint32),
                                      a.scales.view(np.uint32))
        assert (b.shape, b.dtype, b.block, b.wire_bytes) == (
            a.shape, a.dtype, a.block, a.wire_bytes)
        np.testing.assert_array_equal(
            tq.decode(b).numpy().view(np.uint32),
            jq.decode(a).view(np.uint32))
        assert tq.roundtrip_error(x, scheme) == jq.roundtrip_error(x, scheme)


def test_validate_scheme_needs_no_ml_dtypes():
    from ray_tpu_torch.util.collective import quant

    assert quant.validate_scheme("fp8") == "fp8"
    with pytest.raises(ValueError, match="unknown quant scheme"):
        quant.validate_scheme("int4")


def test_card_tensor_staging_keeps_kind_and_device():
    """A torch tensor comes back a torch tensor (bf16 too); a numpy bf16
    array comes back a numpy bf16 array."""
    import ml_dtypes

    xs = [torch.full((5,), float(r + 1), dtype=torch.bfloat16)
          for r in range(2)]
    res, _ = dcn_ring("torch", 2, lambda g, r: g.allreduce(xs[r]), "kind")
    assert all(isinstance(o, torch.Tensor) and o.dtype == torch.bfloat16
               and o.tolist() == [3.0] * 5 for o in res)
    ys = [np.full(3, r + 1, ml_dtypes.bfloat16) for r in range(2)]
    res, _ = dcn_ring("torch", 2, lambda g, r: g.allreduce(ys[r]), "kind2")
    assert all(o.dtype == ml_dtypes.bfloat16 and o.tolist() == [3.0] * 3
               for o in res)


def test_a_dead_link_raises_the_typed_error_where_jax_lets_a_bare_one_through():
    """A peer that closes its sockets (a dead or severed host): the
    survivor's next op raises CollectiveTimeoutError in the port, where
    the JAX DcnGroup raises a bare ConnectionError."""
    from ray_tpu.exceptions import CollectiveTimeoutError as JaxErr

    from ray_tpu_torch.exceptions import CollectiveTimeoutError

    def outcome(pkg):
        if pkg == "jax":
            from ray_tpu.util.collective.dcn_group import DcnGroup
        else:
            from ray_tpu_torch.util.collective.dcn_group import DcnGroup
        kv = FakeKV()
        gs = [None, None]

        def mk(r):
            gs[r] = DcnGroup(kv, 2, r, "dead", timeout=5, op_timeout=5)

        ts = [threading.Thread(target=mk, args=(r,)) for r in range(2)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        ones = np.ones(4, np.float32)
        ts = [threading.Thread(target=gs[r].allreduce, args=(ones,))
              for r in range(2)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        gs[1].destroy()  # rank 1's process dies: its sockets close
        try:
            gs[0].allreduce(ones)
            return "completed"
        except Exception as e:  # noqa: BLE001
            return e
        finally:
            gs[0].destroy()

    jax_err, port_err = outcome("jax"), outcome("torch")
    assert isinstance(jax_err, ConnectionError)
    assert not isinstance(jax_err, JaxErr)
    assert isinstance(port_err, CollectiveTimeoutError)
    assert port_err.peer_rank in (0, 1) and port_err.group_name == "dead"


# -- the local group -----------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "max", "min", "product"])
def test_local_group_on_cpu_tensors(op):
    """One CPU tensor per "device": each op equals the plain reduction,
    and each result is that device's own copy."""
    from ray_tpu_torch.util.collective.local_group import LocalGroup
    from ray_tpu_torch.util.collective.types import ReduceOp

    g = LocalGroup(4, device="cpu")
    xs = [torch.arange(6, dtype=torch.float32) + i for i in range(4)]
    outs = g.allreduce(xs, ReduceOp(op))
    fold = {"sum": sum, "max": lambda t: torch.stack(t).amax(0),
            "min": lambda t: torch.stack(t).amin(0),
            "product": lambda t: torch.stack(t).prod(0)}[op](xs)
    for o in outs:
        assert torch.equal(o, fold)
    assert outs[0].data_ptr() != outs[1].data_ptr()
    info = g.last_op_info
    assert info["tier"] == "local" and info["bytes"] == 24
    gathered = g.allgather(xs)
    assert all(torch.equal(a, b) for row in gathered for a, b in zip(row, xs))
    rs = g.reducescatter(xs)
    assert [t.tolist() for t in rs] == [
        c.tolist() for c in torch.tensor_split(sum(xs), 4)]
    assert all(torch.equal(b, xs[2]) for b in g.broadcast(xs, 2))
    g.barrier()
    with pytest.raises(ValueError, match="one tensor per device"):
        g.allreduce(xs[:3])


def test_local_group_matches_the_jax_xla_group():
    """The JAX XlaLocalGroup over 8 virtual devices and the port's local
    group over 8 CPU tensors give equal sums, maxima and slices."""
    from ray_tpu.util.collective.xla_group import XlaLocalGroup

    from ray_tpu_torch.util.collective.local_group import LocalGroup
    from ray_tpu_torch.util.collective.types import ReduceOp

    xs = [np.arange(12, dtype=np.float32) * (i + 1) for i in range(8)]
    jg, pg = XlaLocalGroup(8), LocalGroup(8, device="cpu")
    for op in (ReduceOp.SUM, ReduceOp.MAX):
        j = [np.asarray(o) for o in jg.allreduce(xs, op)]
        p = pg.allreduce(xs, op)
        assert all(np.array_equal(a, b) for a, b in zip(p, j))
    j = [np.asarray(o) for o in jg.reducescatter(xs)]
    p = pg.reducescatter(xs)
    assert all(np.array_equal(a, b) for a, b in zip(p, j))
    assert pg.last_op_info["tier"] == "local"
    assert jg.last_op_info["tier"] == "ici"


def test_local_backend_refuses_dcn_options():
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(4, 0, backend="xla", group_name="loc")
    try:
        xs = [np.full(3, float(i)) for i in range(4)]
        out = col.allreduce(xs, "loc")
        assert all(np.array_equal(o, np.full(3, 6.0)) for o in out)
        with pytest.raises(ValueError, match="DCN tier"):
            col.allreduce(xs, "loc", quant="int8")
        assert col.last_op_info("loc")["tier"] == "local"
    finally:
        col.destroy_collective_group("loc")


# -- the hierarchical group ----------------------------------------------

N_LOCAL = 4


def hier_ring(pkg, name, fn):
    if pkg == "jax":
        from ray_tpu.util.collective.hier_group import HierarchicalGroup
    else:
        from ray_tpu_torch.util.collective.hier_group import \
            HierarchicalGroup
    kv = FakeKV()
    return run_ring(2, lambda r: HierarchicalGroup(
        kv, 2, r, name, num_local_devices=N_LOCAL, epoch=0), fn)


@pytest.mark.parametrize("algo", ["hier", "ring", "rd"])
def test_hierarchical_allreduce_equals_the_flat_sum_and_jax(algo):
    data = {r: [np.arange(64, dtype=np.float32) + 64 * d + 1000 * r
                for d in range(N_LOCAL)] for r in range(2)}
    exact = sum(sum(data[r]) for r in range(2))
    got, pg = hier_ring("torch", "h" + algo,
                        lambda g, r: g.allreduce(data[r], algo=algo))
    want, jg = hier_ring("jax", "hj" + algo,
                         lambda g, r: g.allreduce(data[r], algo=algo))
    for r in range(2):
        for d in range(N_LOCAL):
            assert np.array_equal(got[r][d], exact)
            assert np.array_equal(got[r][d], np.asarray(want[r][d]))
    info = pg[0].last_op_info
    assert info["algo"] == algo and info["tier"] == "local+dcn"
    assert pg[0].dcn.bytes_sent == jg[0].dcn.bytes_sent


def test_hierarchical_quantized_broadcast_allgather_reducescatter():
    rng = np.random.default_rng(21)
    data = {r: [rng.standard_normal(1024).astype(np.float32)
                for _ in range(N_LOCAL)] for r in range(2)}

    def fn(g, r):
        q = g.allreduce(data[r], algo="hier", quant="int8")
        b = g.broadcast([np.full(2, 99.0 if r == 0 else 0.0)] * N_LOCAL, 0)
        a = g.allgather(data[r])
        s = g.reducescatter(data[r])
        return q, b, a, s

    got, _ = hier_ring("torch", "hq", fn)
    want, _ = hier_ring("jax", "hqj", fn)
    for (gq, gb, ga, gs), (wq, wb, wa, ws) in zip(got, want):
        for x, y in zip(gq, wq):
            assert bits(x) == bits(np.asarray(y))
        assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(gb, wb))
        assert all(np.array_equal(x, np.asarray(y))
                   for gr, wr in zip(ga, wa) for x, y in zip(gr, wr))
        assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(gs, ws))


# -- the observer --------------------------------------------------------

def test_observer_sees_every_op_with_its_record():
    """Every op through the API reaches an observer with the group's
    last_op_info, and the collective metrics count its bytes."""
    from ray_tpu_torch.util.collective import collective as col

    seen = []
    kv = FakeKV()
    from ray_tpu_torch.util.collective.dcn_group import DcnGroup

    g = DcnGroup(kv, 1, 0, "obs", timeout=5, op_timeout=5)
    col._manager._groups["obs"] = g
    col._manager._meta["obs"] = {"backend": "dcn", "world_size": 1,
                                 "rank": 0, "epoch": 0}

    def obs(op, seconds, info=None):
        seen.append((op, seconds, info))

    col.add_op_observer(obs)
    try:
        x = np.ones(16, np.float32)
        col.allreduce(x, "obs")
        col.allgather(x, "obs")
        col.reducescatter(x, "obs")
        col.broadcast(x, 0, "obs")
        col.reduce(x, 0, "obs")
        col.barrier("obs")
    finally:
        col.remove_op_observer(obs)
        col.destroy_collective_group("obs")
    assert [s[0] for s in seen] == ["allreduce", "allgather",
                                    "reducescatter", "broadcast", "reduce",
                                    "barrier"]
    assert all(s[1] >= 0 and s[2]["tier"] == "dcn" for s in seen)
    assert seen[0][2]["op"] == "allreduce" and seen[0][2]["dtype"] == "float32"


def test_observer_protocol_and_metrics_as_jax():
    """The three-arg and the legacy two-arg observers, and the metrics of
    an op record, as tests/test_collective_topology.py's TestObserverInfo
    checks them against the JAX package."""
    from ray_tpu_torch.util.collective import collective as col

    class G:
        last_op_info = {"op": "allreduce", "tier": "dcn", "algo": "rd",
                        "bytes": 64, "dtype": "float32", "quant": None}

    seen, legacy = [], []
    col.add_op_observer(lambda op, dt, info: seen.append((op, info)))
    col.add_op_observer(lambda op, dt: legacy.append(op))
    try:
        col._observed("allreduce", lambda: 1, G())
        col._observed("barrier", lambda: None)
    finally:
        col._op_observers.clear()
    assert seen[0] == ("allreduce", G.last_op_info)
    assert legacy == ["allreduce", "barrier"]
    mm = col._collective_metrics()
    key = mm["bytes"]._key({"tier": "dcn", "algo": "rd", "dtype": "float32"})
    with mm["bytes"]._lock:
        assert mm["bytes"]._deltas.get(key, 0) >= 64
    assert mm["seconds"].summary()["count"] >= 1


# -- the actor-level API (tests/test_collective.py's cases) ---------------

@rt.remote(num_cpus=0.5)
class CollectiveWorker:
    def init_collective(self, world_size, rank, backend, group_name):
        from ray_tpu_torch.util import collective as col

        self.col = col
        self.group = col.init_collective_group(world_size, rank, backend,
                                               group_name)
        self.rank = rank
        return True

    def do_allreduce(self, group_name="default"):
        return self.col.allreduce(np.full(1000, float(self.rank + 1)),
                                  group_name)

    def do_allgather(self, group_name="default"):
        return self.col.allgather(np.array([self.rank]), group_name)

    def do_reducescatter(self, group_name="default"):
        return self.col.reducescatter(np.arange(8, dtype=np.float64),
                                      group_name)

    def do_broadcast(self, group_name="default"):
        value = np.array([42.0]) if self.rank == 0 else np.zeros(1)
        return self.col.broadcast(value, 0, group_name)

    def do_sendrecv(self, group_name="default"):
        if self.rank == 0:
            self.col.send(np.array([7.0, 8.0]), 1, group_name)
            return None
        return self.col.recv((2,), 0, group_name).numpy()

    def do_barrier(self, group_name="default"):
        self.col.barrier(group_name)
        return True

    def do_observed_allreduce(self, group_name="default"):
        seen = []

        def obs(op, seconds, info=None):
            seen.append((op, info))

        self.col.add_op_observer(obs)
        try:
            self.col.allreduce(torch.full((1000,), 1.0), group_name)
        finally:
            self.col.remove_op_observer(obs)
        return seen

    def do_quant_allreduce(self, group_name="default"):
        out = self.col.allreduce(
            np.full(1024, float(self.rank + 1), dtype=np.float32),
            group_name, quant="int8")
        return out, self.col.last_op_info(group_name)

    def hier_allreduce(self, group_name="hier"):
        n_local = self.group.local.world_size
        tensors = [np.full(4, float(self.rank * n_local + d))
                   for d in range(n_local)]
        return self.col.allreduce(tensors, group_name), n_local

    def hier_broadcast(self, group_name="hier"):
        n_local = self.group.local.world_size
        val = 99.0 if self.rank == 0 else 0.0
        return self.col.broadcast([np.full(2, val)] * n_local, 0,
                                  group_name)[-1]


@pytest.fixture(scope="module")
def group():
    from ray_tpu_torch.util import collective as col

    rt.init(num_cpus=4)
    n = 3
    workers = [CollectiveWorker.remote() for _ in range(n)]
    col.create_collective_group(workers, n, list(range(n)), backend="dcn",
                                group_name="default")
    yield workers
    rt.shutdown()


def test_dcn_allreduce(group):
    outs = rt.get([w.do_allreduce.remote() for w in group])
    for out in outs:
        assert isinstance(out, np.ndarray)
        assert np.array_equal(out, np.full(1000, 6.0))


def test_dcn_allgather(group):
    outs = rt.get([w.do_allgather.remote() for w in group])
    for out in outs:
        assert [int(x[0]) for x in out] == [0, 1, 2]


def test_dcn_reducescatter(group):
    outs = rt.get([w.do_reducescatter.remote() for w in group])
    chunks = np.array_split(np.arange(8, dtype=np.float64) * 3, 3)
    for rank, out in enumerate(outs):
        assert np.array_equal(out, chunks[rank])


def test_dcn_broadcast(group):
    outs = rt.get([w.do_broadcast.remote() for w in group])
    assert [float(o[0]) for o in outs] == [42.0] * 3


def test_dcn_sendrecv(group):
    outs = rt.get([w.do_sendrecv.remote() for w in group[:2]])
    assert outs[0] is None
    assert np.array_equal(outs[1], [7.0, 8.0])


def test_dcn_barrier(group):
    assert all(rt.get([w.do_barrier.remote() for w in group]))


def test_dcn_ops_flow_through_observers_with_info(group):
    outs = rt.get([w.do_observed_allreduce.remote() for w in group])
    for seen in outs:
        assert len(seen) == 1
        op, info = seen[0]
        assert op == "allreduce"
        assert info["tier"] == "dcn" and info["algo"] in ("ring", "rd")
        assert info["bytes"] > 0 and info["dtype"] == "float32"


def test_dcn_quantized_allreduce_api(group):
    outs = rt.get([w.do_quant_allreduce.remote() for w in group])
    for out, info in outs:
        assert np.abs(out - 6.0).max() / 6.0 <= 1e-2
        assert info["quant"] == "int8" and info["algo"] == "ring"


def test_xla_local_allreduce():
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(8, 0, backend="xla", group_name="xla_g")
    try:
        outs = col.allreduce([np.full((4, 4), float(i)) for i in range(8)],
                             "xla_g")
        for out in outs:
            assert np.array_equal(out, np.full((4, 4), 28.0))
    finally:
        col.destroy_collective_group("xla_g")


def test_xla_local_max():
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective.types import ReduceOp

    col.init_collective_group(8, 0, backend="xla", group_name="xla_m")
    try:
        outs = col.allreduce([torch.full((16,), float(i)) for i in range(8)],
                             "xla_m", op=ReduceOp.MAX)
        assert torch.equal(outs[0], torch.full((16,), 7.0))
    finally:
        col.destroy_collective_group("xla_m")


def test_hierarchical_allreduce_and_broadcast(group):
    """Two processes x their local devices: the hierarchical allreduce
    equals the flat sum over all global ranks."""
    workers = [CollectiveWorker.remote() for _ in range(2)]
    rt.get([w.init_collective.remote(2, r, "hier", "hier")
            for r, w in enumerate(workers)], timeout=120)
    outs = rt.get([w.hier_allreduce.remote() for w in workers], timeout=120)
    n_local = outs[0][1]
    assert n_local >= 1
    want = float(sum(range(2 * n_local)))
    for per_process, _ in outs:
        for per_device in per_process:
            assert np.array_equal(per_device, np.full(4, want))
    bcast = rt.get([w.hier_broadcast.remote() for w in workers], timeout=120)
    for b in bcast:
        assert np.array_equal(b, np.full(2, 99.0))


def test_a_ring_message_larger_than_the_socket_buffers_completes():
    """Three ranks, 24 MiB a rank: every ring step sends an 8 MiB chunk,
    more than loopback's socket buffers hold. The JAX DcnGroup sends
    before it receives on every rank, so each blocks on its right
    neighbour and the op runs into its deadline; the port sends on a
    helper thread while it receives and returns the sum."""
    from ray_tpu.exceptions import CollectiveTimeoutError as JaxTimeout

    data = [np.full(6 << 20, float(r + 1), np.float32) for r in range(3)]

    def fn(g, r):
        try:
            return g.allreduce(data[r], algo="ring")
        except Exception as e:  # noqa: BLE001 — compared below
            return e

    got, _ = dcn_ring("torch", 3, fn, "big", op_timeout=30)
    assert all(np.array_equal(o, np.full(6 << 20, 6.0, np.float32))
               for o in got)
    want, _ = dcn_ring("jax", 3, fn, "bigj", op_timeout=2)
    assert all(isinstance(o, JaxTimeout) for o in want), want
