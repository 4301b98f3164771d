"""The port's topology-native collectives (ray_tpu_torch.util.collective):
the cases of tests/test_collective_topology.py, run against the port —
cost-model selection, recursive doubling, sharded hierarchical allreduce
and the quantized DCN wire — plus the select() tables of both packages
held equal over a grid of topologies and message sizes.

These run IN-PROCESS (threaded DcnGroups rendezvousing through a
dict-backed fake KV). The hierarchical group's local tier is the port's
local group over four CPU tensors, and records its tier as "local".
"""

import os
import threading

import numpy as np
import pytest

from ray_tpu_torch._private import chaos
from ray_tpu_torch.exceptions import CollectiveTimeoutError
from ray_tpu_torch.util.collective import quant
from ray_tpu_torch.util.collective.dcn_group import DcnGroup
from ray_tpu_torch.util.collective.topology import (
    ALGO_HIER,
    ALGO_RD,
    ALGO_RING,
    Topology,
)
from ray_tpu_torch.util.collective.types import ReduceOp


class FakeKV:
    """The slice of the GCS KV client DcnGroup rendezvous uses."""

    def __init__(self):
        self.d = {}
        self.lock = threading.Lock()

    def kv_put(self, k, v, ns=None):
        with self.lock:
            self.d[(ns, k)] = v

    def kv_get(self, k, ns=None):
        with self.lock:
            return self.d.get((ns, k))

    def kv_del(self, k, ns=None):
        with self.lock:
            self.d.pop((ns, k), None)


def _run_ring(n, make_group, fn):
    """Construct n group members on threads, run fn(group, rank) on each,
    destroy, and return (results, groups). Any member's exception fails
    the whole call."""
    groups, errs, results = [None] * n, [None] * n, [None] * n

    def mk(r):
        try:
            groups[r] = make_group(r)
        except Exception as e:  # noqa: BLE001 — surfaced via assert below
            errs[r] = e

    threads = [threading.Thread(target=mk, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not any(errs), errs

    def work(r):
        try:
            results[r] = fn(groups[r], r)
        except Exception as e:  # noqa: BLE001
            errs[r] = e

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g in groups:
        if g is not None:
            g.destroy()
    assert not any(errs), errs
    return results, groups


def _dcn_ring(n, fn, name, kv=None, **kw):
    kv = kv if kv is not None else FakeKV()
    kw.setdefault("timeout", 15)
    kw.setdefault("op_timeout", 15)
    return _run_ring(
        n, lambda r: DcnGroup(kv, n, r, name, epoch=0, **kw), fn
    )


# -- topology -> algorithm selection ------------------------------------

class TestSelection:
    def test_selection_table(self):
        """The modeled 2-host x 4-chip topology picks recursive doubling
        under the crossover and sharded-hier above it; a flat topology
        keeps the bandwidth-optimal ring for large messages."""
        two_tier = Topology.detect(2, n_local=4)
        cross = two_tier.crossover_nbytes()
        assert two_tier.select("allreduce", 64) == ALGO_RD
        assert two_tier.select("allreduce", cross // 2) == ALGO_RD
        assert two_tier.select("allreduce", 64 << 20) == ALGO_HIER

        flat = Topology.detect(4, n_local=1)
        assert flat.select("allreduce", 64 << 20) == ALGO_RING
        assert flat.select("allreduce", 8) == ALGO_RD
        # non-sharding collectives never pick hier
        assert two_tier.select("broadcast", 64 << 20) in (ALGO_RING, ALGO_RD)

    def test_env_override_wins_and_validates(self, monkeypatch):
        topo = Topology.detect(2, n_local=4)
        monkeypatch.setenv("RT_COLLECTIVE_ALGO", "ring")
        assert topo.select("allreduce", 8) == ALGO_RING
        monkeypatch.setenv("RT_COLLECTIVE_ALGO", "auto")
        assert topo.select("allreduce", 8) == ALGO_RD
        monkeypatch.setenv("RT_COLLECTIVE_ALGO", "warp")
        with pytest.raises(ValueError, match="RT_COLLECTIVE_ALGO"):
            topo.select("allreduce", 8)
        # forcing hier on a flat topology degrades to ring, not a crash
        monkeypatch.setenv("RT_COLLECTIVE_ALGO", "hier")
        assert Topology.detect(3, n_local=1).select("allreduce", 8) == ALGO_RING

    def test_cost_model_shape(self):
        """Sanity on the alpha-beta forms the selection rests on: rd is
        latency-bound (flat in nbytes -> wins small), ring is bandwidth-
        bound (wins large on flat), hier cuts the DCN term by n_local."""
        t = Topology.detect(2, n_local=4)
        small, large = 64.0, float(64 << 20)
        assert t.cost_rd_allreduce(small) < t.cost_ring_allreduce(small)
        assert t.cost_hier_allreduce(large) < t.cost_ring_allreduce(large)
        assert t.cost_hier_allreduce(large) < t.cost_rd_allreduce(large)
        flat = Topology.detect(2, n_local=1)
        assert flat.cost_hier_allreduce(large) == float("inf")


# -- quantized codec ----------------------------------------------------

class TestQuantCodec:
    def test_int8_roundtrip_bound(self):
        rng = np.random.default_rng(7)
        x = rng.standard_normal(5000).astype(np.float32)
        # int8 absmax/127 grid: per-element error <= scale/2 = absmax/254
        assert quant.roundtrip_error(x, "int8") <= 1.0 / 254 + 1e-6

    def test_fp8_roundtrip_bound(self):
        rng = np.random.default_rng(8)
        x = rng.standard_normal(5000).astype(np.float32)
        # e4m3: 3 mantissa bits -> relative rounding radius 2^-4
        assert quant.roundtrip_error(x, "fp8") <= 2.0 ** -4 + 1e-6

    @pytest.mark.parametrize("size", [1, 255, 256, 257, 1000])
    def test_truncated_wire_roundtrip(self, size):
        """Codes are truncated to the element count on the wire; decode
        re-pads — shapes that straddle block boundaries must survive."""
        rng = np.random.default_rng(size)
        x = rng.standard_normal(size).astype(np.float32)
        p = quant.encode(x, "int8")
        assert p.codes.numel() == size  # no pad on the wire
        out = quant.decode(p).numpy()
        assert out.shape == x.shape
        assert np.abs(out - x).max() <= np.abs(x).max() / 254 + 1e-6

    def test_wire_bytes_ratio(self):
        x = np.zeros(64 * 1024, dtype=np.float32)
        p = quant.encode(x, "int8")
        assert x.nbytes / p.wire_bytes >= 3.8

    def test_validate_scheme(self):
        with pytest.raises(ValueError, match="unknown quant scheme"):
            quant.validate_scheme("int4")


class TestErrorFeedback:
    def test_residual_bank_and_apply(self):
        ef = quant.ErrorFeedback()
        ef.add("w", 0, np.array([0.5, -0.5], dtype=np.float32), 4)
        ef.add("w", 2, np.array([1.0], dtype=np.float32), 4)
        out = ef.apply("w", np.ones(4, dtype=np.float32))
        np.testing.assert_allclose(out, [1.5, 0.5, 2.0, 1.0])
        # apply() claims the residual: second call sees none
        np.testing.assert_allclose(
            ef.apply("w", np.ones(4, dtype=np.float32)), np.ones(4)
        )

    def test_size_mismatch_drops_residual(self):
        ef = quant.ErrorFeedback()
        ef.add("w", 0, np.ones(2, dtype=np.float32), 2)
        np.testing.assert_allclose(
            ef.apply("w", np.zeros(3, dtype=np.float32)), np.zeros(3)
        )


# -- DCN transport: new algorithms --------------------------------------

class TestDcnAlgorithms:
    @pytest.mark.parametrize("n", [2, 3, 4, 5])
    def test_rd_matches_ring(self, n):
        """Recursive doubling is bit-equivalent to the ring on integer-
        valued input (both including the non-power-of-2 fold)."""
        data = [np.arange(16.0) * (r + 1) for r in range(n)]
        rd, _ = _dcn_ring(
            n, lambda g, r: g.allreduce(data[r], algo=ALGO_RD), f"rd{n}"
        )
        ring, _ = _dcn_ring(
            n, lambda g, r: g.allreduce(data[r], algo=ALGO_RING), f"ri{n}"
        )
        for a, b in zip(rd, ring):
            np.testing.assert_array_equal(a, b)

    def test_rd_max_op(self):
        res, groups = _dcn_ring(
            3,
            lambda g, r: g.allreduce(
                np.full(5, float(r)), op=ReduceOp.MAX, algo=ALGO_RD
            ),
            "rdmax",
        )
        for out in res:
            np.testing.assert_array_equal(out, np.full(5, 2.0))
        assert groups[0].last_op_info["algo"] == ALGO_RD

    def test_quantized_allreduce_bounded_and_consistent(self):
        rng = np.random.default_rng(3)
        data = [rng.standard_normal(4096).astype(np.float32)
                for _ in range(3)]
        exact = data[0] + data[1] + data[2]
        res, groups = _dcn_ring(
            3, lambda g, r: g.allreduce(data[r], quant="int8"), "q3"
        )
        for out in res:
            rel = np.abs(out - exact).max() / np.abs(exact).max()
            assert rel <= 1e-2
            # the two-pass forwards codes verbatim: every rank decodes
            # the identical result, bit for bit
            np.testing.assert_array_equal(out, res[0])
        info = groups[0].last_op_info
        assert info["quant"] == "int8" and info["algo"] == ALGO_RING

    def test_quantized_min_op(self):
        """The two-pass reduces decoded fp32, never codes — non-SUM ops
        stay correct under quantization."""
        rng = np.random.default_rng(4)
        data = [rng.standard_normal(512).astype(np.float32)
                for _ in range(3)]
        exact = np.minimum(np.minimum(data[0], data[1]), data[2])
        res, _ = _dcn_ring(
            3,
            lambda g, r: g.allreduce(data[r], op=ReduceOp.MIN, quant="int8"),
            "qmin",
        )
        rel = np.abs(res[0] - exact).max() / np.abs(exact).max()
        assert rel <= 2e-2

    def test_quant_wire_reduction(self):
        rng = np.random.default_rng(5)
        data = [rng.standard_normal(8192).astype(np.float32)
                for _ in range(2)]
        _, qg = _dcn_ring(
            2, lambda g, r: g.allreduce(data[r], quant="int8"), "qw"
        )
        _, fg = _dcn_ring(2, lambda g, r: g.allreduce(data[r]), "fw")
        ratio = fg[0].last_op_info["bytes"] / qg[0].last_op_info["bytes"]
        assert ratio >= 3.5

    def test_error_feedback_requires_sum_and_quant(self):
        g = DcnGroup(FakeKV(), 1, 0, "efv2", timeout=5, op_timeout=5)
        try:
            with pytest.raises(ValueError, match="error_feedback requires"):
                g.allreduce(np.ones(4), error_feedback=True)
            with pytest.raises(ValueError, match="EF-safe"):
                g.allreduce(np.ones(4), op=ReduceOp.MAX, quant="int8",
                            error_feedback=True)
        finally:
            g.destroy()

    def test_error_feedback_toy_sgd_converges(self):
        """EF-SGD on a toy quadratic: each 'rank' holds a shard of the
        objective, gradients cross the quantized wire. With error
        feedback the final iterate lands essentially on the fp32
        optimum; without it the quantization bias is visible."""
        n, dim, steps, lr = 2, 256, 40, 0.1
        rng = np.random.default_rng(11)
        targets = [rng.standard_normal(dim).astype(np.float32)
                   for _ in range(n)]
        opt = sum(targets) / n  # argmin of mean ||x - t_r||^2

        def sgd(g, r, ef):
            x = np.zeros(dim, dtype=np.float32)
            for _ in range(steps):
                grad = 2 * (x - targets[r])
                gsum = g.allreduce(grad, quant="int8",
                                   error_feedback=ef, ef_key="g")
                x = x - lr * (gsum / n)
            return x

        res_ef, _ = _dcn_ring(n, lambda g, r: sgd(g, r, True), "sgd_ef")
        err_ef = np.abs(res_ef[0] - opt).max()
        res_fp, _ = _dcn_ring(n, sgd_fp, "sgd_fp")
        err_fp = np.abs(res_fp[0] - opt).max()
        # EF tracks the exact-gradient trajectory to within a small
        # multiple of fp32 rounding at this scale.
        assert err_ef <= err_fp + 5e-3, (err_ef, err_fp)

    def test_rd_deadline_raises_typed_timeout(self):
        """A peer that never joins the rd exchange trips the op deadline
        as CollectiveTimeoutError — the op-deadline contract holds on the
        new algorithm path."""
        kv = FakeKV()
        groups, errs = [None] * 3, [None] * 3

        def mk(r):
            groups[r] = DcnGroup(kv, 3, r, "rddead", timeout=3, op_timeout=1)

        ts = [threading.Thread(target=mk, args=(r,)) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

        def work(r):
            # rank 2 (the fold's surplus rank) never shows up
            if r == 2:
                return
            try:
                groups[r].allreduce(np.ones(4), algo=ALGO_RD)
            except Exception as e:  # noqa: BLE001
                errs[r] = e

        ts = [threading.Thread(target=work, args=(r,)) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        for g in groups:
            g.destroy()
        # rank 0 waits on rank 2's fold contribution and must get the
        # typed error, not a hang or a bare socket.timeout
        assert isinstance(errs[0], CollectiveTimeoutError)

    def test_epoch_fence_holds_on_new_paths(self):
        """A member carrying a stale epoch cannot rendezvous with the
        new ring (keys are epoch-stamped), so no rd/quant exchange can
        ever splice attempts."""
        kv = FakeKV()
        fresh = DcnGroup(kv, 2, 0, "fence", timeout=1, op_timeout=1, epoch=2)
        try:
            with pytest.raises(TimeoutError):
                DcnGroup(kv, 2, 1, "fence", timeout=1, op_timeout=1,
                         epoch=1)._lookup(0)
        finally:
            fresh.destroy()


def sgd_fp(g, r):
    """fp32 companion loop for the EF convergence test."""
    n, dim, steps, lr = 2, 256, 40, 0.1
    rng = np.random.default_rng(11)
    targets = [rng.standard_normal(dim).astype(np.float32)
               for _ in range(n)]
    x = np.zeros(dim, dtype=np.float32)
    for _ in range(steps):
        grad = 2 * (x - targets[r])
        gsum = g.allreduce(grad)
        x = x - lr * (gsum / n)
    return x


# -- sharded hierarchical allreduce -------------------------------------

class TestShardedHier:
    N_LOCAL = 4

    def _hier(self, name, fn, kv=None):
        from ray_tpu_torch.util.collective.hier_group import HierarchicalGroup

        kv = kv if kv is not None else FakeKV()
        return _run_ring(
            2,
            lambda r: HierarchicalGroup(
                kv, 2, r, name, num_local_devices=self.N_LOCAL, epoch=0
            ),
            fn,
        )

    def _data(self):
        # integer-valued fp32: SUM must be bit-exact however it is
        # scheduled, so hier vs flat comparisons can demand equality
        return {
            r: [np.arange(64, dtype=np.float32) + 64 * d + 1000 * r
                for d in range(self.N_LOCAL)]
            for r in range(2)
        }

    def test_bit_equivalent_with_flat_ring(self):
        data = self._data()
        exact = sum(sum(data[r]) for r in range(2))
        res, groups = self._hier(
            "hbit", lambda g, r: g.allreduce(data[r], algo=ALGO_HIER)
        )
        for r in range(2):
            for d in range(self.N_LOCAL):
                np.testing.assert_array_equal(np.asarray(res[r][d]), exact)
        info = groups[0].last_op_info
        assert info["algo"] == ALGO_HIER and info["tier"] == "local+dcn"

        # flat baseline: all 8 devices as individual DCN ring members
        flat_in = [data[r][d] for r in range(2) for d in range(self.N_LOCAL)]
        flat_res, _ = _dcn_ring(
            8, lambda g, r: g.allreduce(flat_in[r], algo=ALGO_RING), "hflat"
        )
        np.testing.assert_array_equal(flat_res[0], exact)

    def test_dcn_bytes_cut_to_one_over_n_local(self):
        """The acceptance gate, in miniature: total DCN bytes of the
        sharded-hier exchange <= (1/n_local + 10%) of the flat ring in
        which every device is a DCN member."""
        size = 16 * 1024  # large enough that headers are noise
        data = {r: [np.full(size, float(r * self.N_LOCAL + d),
                            dtype=np.float32)
                    for d in range(self.N_LOCAL)] for r in range(2)}
        _, hg = self._hier(
            "hbytes", lambda g, r: g.allreduce(data[r], algo=ALGO_HIER)
        )
        hier_total = sum(g.dcn.bytes_sent for g in hg)
        flat_in = [data[r][d] for r in range(2)
                   for d in range(self.N_LOCAL)]
        _, fg = _dcn_ring(
            8, lambda g, r: g.allreduce(flat_in[r], algo=ALGO_RING), "hbf"
        )
        flat_total = sum(g.bytes_sent for g in fg)
        assert hier_total / flat_total <= 1 / self.N_LOCAL + 0.10

    def test_hier_quantized(self):
        rng = np.random.default_rng(21)
        data = {r: [rng.standard_normal(1024).astype(np.float32)
                    for _ in range(self.N_LOCAL)] for r in range(2)}
        exact = sum(sum(data[r]) for r in range(2))
        res, groups = self._hier(
            "hq",
            lambda g, r: g.allreduce(data[r], algo=ALGO_HIER, quant="int8"),
        )
        rel = (np.abs(np.asarray(res[0][0]) - exact).max()
               / np.abs(exact).max())
        assert rel <= 1e-2
        assert groups[0].last_op_info["quant"] == "int8"


# -- chaos DCN injections ------------------------------------------------

class TestChaosDcn:
    def test_requires_enabled(self):
        chaos.disable()
        with pytest.raises(RuntimeError, match="RT_CHAOS"):
            chaos.delay_dcn_send(0.1)
        with pytest.raises(RuntimeError, match="RT_CHAOS"):
            chaos.cap_dcn_bandwidth(1000)

    def test_delay_and_cap_consumed_on_send_path(self):
        chaos.enable()
        try:
            chaos.delay_dcn_send(0.05, count=2)
            assert chaos.take_dcn_send_delay() == 0.05
            assert chaos.take_dcn_send_delay() == 0.05
            assert chaos.take_dcn_send_delay() is None
            chaos.cap_dcn_bandwidth(1e6)
            assert chaos.dcn_bandwidth_cap() == 1e6
            chaos.clear()
            assert chaos.dcn_bandwidth_cap() is None
        finally:
            chaos.disable()

    def test_delay_slows_ring_deterministically(self):
        """Injected per-send latency shows up in op wall time but never
        in the byte accounting."""
        import time as time_mod

        chaos.enable()
        try:
            data = np.ones(64, dtype=np.float32)

            def timed(g, r):
                if r == 0:
                    chaos.delay_dcn_send(0.05, count=2)
                t0 = time_mod.perf_counter()
                g.allreduce(data, algo=ALGO_RING)
                return time_mod.perf_counter() - t0

            res, groups = _dcn_ring(2, timed, "cdel")
            assert max(res) >= 0.05
            # bytes identical across ranks: injection is time-only
            assert groups[0].bytes_sent == groups[1].bytes_sent
        finally:
            chaos.disable()
            chaos.clear()


# -- observer/metrics surface -------------------------------------------

class TestObserverInfo:
    def test_observer_receives_tier_algo_bytes(self):
        from ray_tpu_torch.util.collective import collective as col

        class G:
            last_op_info = {"op": "allreduce", "tier": "dcn",
                            "algo": "ring", "bytes": 123,
                            "dtype": "float32", "quant": None}

        seen = []
        col.add_op_observer(lambda op, dt, info: seen.append((op, info)))
        try:
            col._observed("allreduce", lambda: 1, G())
        finally:
            col._op_observers.clear()
        assert seen and seen[0][0] == "allreduce"
        assert seen[0][1]["tier"] == "dcn"
        assert seen[0][1]["bytes"] == 123

    def test_legacy_two_arg_observer_still_served(self):
        from ray_tpu_torch.util.collective import collective as col

        seen = []

        def legacy(op, dt):
            seen.append(op)

        col.add_op_observer(legacy)
        try:
            col._observed("barrier", lambda: None)
        finally:
            col._op_observers.clear()
        assert seen == ["barrier"]

    def test_metrics_emitted(self):
        from ray_tpu_torch.util import metrics as m
        from ray_tpu_torch.util.collective import collective as col

        class G:
            last_op_info = {"op": "allreduce", "tier": "dcn",
                            "algo": "rd", "bytes": 64,
                            "dtype": "float32", "quant": None}

        col._observed("allreduce", lambda: 1, G())
        mm = col._collective_metrics()
        assert mm["bytes"]._name == "collective_bytes_total"
        key = mm["bytes"]._key({"tier": "dcn", "algo": "rd",
                                "dtype": "float32"})
        with mm["bytes"]._lock:
            assert mm["bytes"]._deltas.get(key, 0) >= 64
        assert mm["seconds"].summary()["count"] >= 1

    def test_local_group_records_local_tier(self):
        from ray_tpu_torch.util.collective.local_group import LocalGroup

        g = LocalGroup(4, device="cpu")
        g.allreduce([np.full(8, float(i), dtype=np.float32)
                     for i in range(4)])
        info = g.last_op_info
        assert info["tier"] == "local" and info["algo"] == "host"
        assert info["bytes"] == 32


# -- both packages' cost models ------------------------------------------

SIZES = [1 << e for e in range(0, 34, 3)]


@pytest.mark.parametrize("n_procs,n_local", [(1, 1), (2, 1), (3, 1), (4, 1),
                                             (5, 1), (2, 4), (4, 8), (3, 2)])
@pytest.mark.parametrize("forced", ["", "auto", "ring", "rd", "hier"])
def test_select_table_equals_jax(monkeypatch, n_procs, n_local, forced):
    """select() for every collective and message size, the crossover and
    the cost terms equal the JAX package's on the same topology (both
    with their default link constants, and with an env override)."""
    from ray_tpu.util.collective.topology import Topology as JaxTopology

    monkeypatch.setenv("RT_COLLECTIVE_ALGO", forced)
    for env in ({}, {"RT_COLLECTIVE_DCN_GBPS": "1.5",
                     "RT_COLLECTIVE_DCN_ALPHA_S": "2e-4"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        mine = Topology.detect(n_procs, n_local=n_local)
        ref = JaxTopology.detect(n_procs, n_local=n_local)
        for op in ("allreduce", "reducescatter", "broadcast", "allgather"):
            assert ([mine.select(op, b) for b in SIZES]
                    == [ref.select(op, b) for b in SIZES])
        assert mine.crossover_nbytes() == ref.crossover_nbytes()
        for b in SIZES:
            assert mine.cost_ring_allreduce(b) == ref.cost_ring_allreduce(b)
            assert mine.cost_rd_allreduce(b) == ref.cost_rd_allreduce(b)
            assert mine.cost_hier_allreduce(b) == ref.cost_hier_allreduce(b)


def test_detect_counts_the_visible_cards(monkeypatch):
    """With no n_local, the local width is the cards this process sees
    (CUDA_VISIBLE_DEVICES), and flat with none."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
    assert Topology.detect(2).n_local == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert Topology.detect(2).n_local == 1
