"""Zygote fork-server tests: generational rotation and death notices.

The rotation defends against Linux rmap (anon_vma) chain growth: page
faults in the Nth COW-faulted sibling of one parent slow superlinearly,
so the manager re-execs a fresh zygote every `zygote_respawn_after`
forks (reference counterpart: the worker pool's process lifecycle,
src/ray/raylet/worker_pool.cc — the reference pays a full interpreter
boot per worker instead, so never hits the sibling regime).
"""

import os
import time

import pytest


def _wait_pid(zp, timeout=30.0):
    deadline = time.monotonic() + timeout
    while zp.pid is None and zp.returncode is None:
        if time.monotonic() > deadline:
            raise TimeoutError("zygote spawn never assigned a pid")
        time.sleep(0.01)
    return zp.pid


def _parent_of(pid):
    raw = open(f"/proc/{pid}/stat").read()
    return int(raw.rsplit(") ", 1)[1].split()[1])


@pytest.fixture
def low_limit(monkeypatch):
    monkeypatch.setenv("RT_ZYGOTE_RESPAWN_AFTER", "10")
    from ray_tpu_torch._private import config

    config._config = None
    yield
    config._config = None


def test_zygote_rotates_after_limit(low_limit):
    from ray_tpu_torch._private.zygote_client import ZygoteManager

    mgr = ZygoteManager()
    try:
        parents = set()
        procs = []
        for _ in range(30):
            zp = mgr.spawn({
                "PATH": os.environ.get("PATH", ""),
                "PYTHONPATH": os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))),
                # No RT_WORKER_ID: worker_main exits immediately with a
                # KeyError — the child's fate doesn't matter here, only
                # which zygote forked it.
            })
            assert zp is not None
            pid = _wait_pid(zp)
            if pid is not None:
                try:
                    parents.add(_parent_of(pid))
                except (FileNotFoundError, ProcessLookupError):
                    pass  # already exited and reaped
            procs.append(zp)
        # 30 spawns at limit 10 -> at least 3 generations served.
        assert len(parents) >= 3, parents
    finally:
        mgr.stop()


def test_zygote_death_notices_cross_generations(low_limit):
    from ray_tpu_torch._private.zygote_client import ZygoteManager

    mgr = ZygoteManager()
    try:
        procs = []
        for _ in range(25):
            zp = mgr.spawn({"PATH": os.environ.get("PATH", ""),
                            "PYTHONPATH": "/"})
            assert zp is not None
            _wait_pid(zp)
            procs.append(zp)
        # Children die fast (missing RT_WORKER_ID); every handle must
        # still learn its fate — including ones whose zygote generation
        # was retired after they were forked.
        deadline = time.monotonic() + 60
        for zp in procs:
            while zp.poll() is None:
                assert time.monotonic() < deadline, "death notice lost"
                time.sleep(0.02)
    finally:
        mgr.stop()


def test_retired_generation_closes_after_children_exit(low_limit):
    from ray_tpu_torch._private.zygote_client import ZygoteManager

    mgr = ZygoteManager()
    try:
        procs = []
        for _ in range(25):
            zp = mgr.spawn({"PATH": os.environ.get("PATH", ""),
                            "PYTHONPATH": "/"})
            assert zp is not None
            procs.append(zp)
        for zp in procs:
            while zp.poll() is None:
                time.sleep(0.02)
        # All children dead -> retired generations should drain away.
        deadline = time.monotonic() + 30
        while mgr._old and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not mgr._old, "retired zygotes lingered after last child"
    finally:
        mgr.stop()


def test_stop_is_not_counted_as_a_zygote_death():
    """stop() marks every generation retiring BEFORE closing it, so the
    reader threads' EOFs read as intentional shutdown — NOT unexpected
    deaths. Without that ordering, 3 stop/start cycles (common across
    rt.init/shutdown in one process, since the manager is process-
    shared) hit the _deaths >= 3 breaker and permanently push every
    spawn onto the slow Popen path."""
    from ray_tpu_torch._private.zygote_client import ZygoteManager

    mgr = ZygoteManager()
    try:
        for _ in range(4):  # one past the 3-death disable threshold
            assert mgr.start()
            proc = mgr.proc
            mgr.stop()
            # The reader thread sees EOF once the zygote exits; give it
            # a beat to run its accounting before the next cycle.
            deadline = time.monotonic() + 15
            while proc.poll() is None:
                assert time.monotonic() < deadline, "zygote never exited"
                time.sleep(0.02)
            time.sleep(0.1)
        assert mgr._deaths == 0
        # The breaker never tripped: the manager still serves forks.
        zp = mgr.spawn({"PATH": os.environ.get("PATH", ""),
                        "PYTHONPATH": "/"})
        assert zp is not None
    finally:
        mgr.stop()
