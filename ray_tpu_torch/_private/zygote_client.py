"""Raylet-side client for the worker fork server (zygote.py).

Exposes `ZygoteManager.spawn(env) -> ZygoteProc | None`, a synchronous,
non-blocking fork request the dispatch loop can issue in place of a
subprocess.Popen. ZygoteProc mirrors the Popen surface the raylet uses
(pid / poll / kill / terminate / wait / returncode) so WorkerHandle and
the reap loop are agnostic to how the worker was started.

The manager is deliberately loop-agnostic (plain threading, one daemon
reader thread per zygote generation, a mutex around shared state): one
PROCESS-LEVEL zygote serves every raylet/session in the process
(`get_shared_manager`). Children receive their complete environment per
spawn request, so the zygote has no per-cluster state — sharing it
across rt.init cycles saves the warm-interpreter cost on every session
(a large win for test suites and notebooks that init/shutdown
repeatedly).

Generational rotation: Linux reverse-map (anon_vma) chains grow with
the number of COW-faulted siblings forked from one parent, so page
faults in the Nth child slow superlinearly (measured on this kernel:
fork+touch-20MB goes ~24ms -> ~500ms+ with 250+ touched siblings; in
the runtime, worker boots went ~5ms -> ~27ms sys each by ~900 live
workers). The manager therefore retires a zygote after
`zygote_respawn_after` forks and re-execs a fresh one — fresh parent,
fresh chains. A retired generation stays alive (stdin open) purely to
reap and report its remaining children, and is closed once the last of
them exits. The next generation pre-warms in the background so rotation
never stalls a spawn.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, Optional


class ZygoteProc:
    """Popen-compatible handle for a zygote-forked worker.

    The pid arrives asynchronously (the fork reply is read off the
    zygote's stdout by the manager's reader thread); kill/terminate
    before the pid is known are remembered and delivered on assignment.
    """

    def __init__(self, mgr: "ZygoteManager"):
        self._mgr = mgr
        self.pid: Optional[int] = None
        self.returncode: Optional[int] = None
        self._pending_signal: Optional[int] = None

    def _assign_locked(self, pid: int) -> None:
        # _locked suffix: only ever called with the manager lock held
        # (the reader thread's fork-reply dispatch).
        self.pid = pid
        if self._pending_signal is not None:
            sig, self._pending_signal = self._pending_signal, None
            self._kill_locked(sig)

    def _fail_locked(self, rc: int) -> None:
        # _locked suffix: caller (reader-thread EOF path) holds the
        # manager lock; racing poll() writes the same field under it.
        if self.returncode is None:
            self.returncode = rc

    @staticmethod
    def _deliver(pid: int, sig: int) -> None:
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass

    def _kill_locked(self, sig: int) -> None:
        # _locked suffix: only called from _assign_locked, with the
        # manager lock held.
        if self.returncode is None and self.pid is not None:
            self._deliver(self.pid, sig)

    def _signal(self, sig: int) -> None:
        with self._mgr._lock:
            if self.returncode is not None:
                return
            if self.pid is None:
                self._pending_signal = sig
                return
            pid = self.pid
        self._deliver(pid, sig)

    def poll(self) -> Optional[int]:
        with self._mgr._lock:
            if self.returncode is None and self.pid is not None:
                rc = self._mgr._dead.pop(self.pid, None)
                if rc is not None:
                    self.returncode = rc
            return self.returncode

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("zygote-worker", timeout or 0)
            time.sleep(0.01)


class _Generation:
    """One zygote process plus its in-flight and live children."""

    __slots__ = ("proc", "pending", "spawned", "live", "retiring")

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.pending: deque[ZygoteProc] = deque()
        self.spawned = 0  # forks requested of this zygote
        self.live = 0  # children forked and not yet reported dead
        self.retiring = False  # no new spawns; close when live hits 0

    def alive(self) -> bool:
        return self.proc.poll() is None

    def close(self) -> None:
        try:
            self.proc.stdin.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            self.proc.terminate()
        except Exception:  # noqa: BLE001
            pass


class ZygoteManager:
    def __init__(self, base_env: Optional[dict] = None):
        self._base_env = dict(base_env if base_env is not None else os.environ)
        self._gen: Optional[_Generation] = None
        self._next: Optional[_Generation] = None  # pre-warming successor
        self._old: list[_Generation] = []  # retired, still reaping
        self._dead: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._deaths = 0  # unexpected zygote deaths; disable after 3

    # Kept for tests / introspection.
    @property
    def proc(self) -> Optional[subprocess.Popen]:
        return self._gen.proc if self._gen is not None else None  # rtlint: disable=RT010 — introspection-only racy read (tests)

    def alive(self) -> bool:
        return self._gen is not None and self._gen.alive()

    def _start_generation(self) -> Optional[_Generation]:
        """Exec a fresh zygote (sync, cheap — the import cost is paid
        inside the zygote, not here) and attach its reader thread."""
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.zygote"],
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=None,
                env=self._base_env,
                text=True,
                bufsize=1,
            )
        except Exception:  # noqa: BLE001 — caller falls back to Popen spawns
            return None
        gen = _Generation(proc)
        # A dedicated DAEMON thread, not run_in_executor: a blocked
        # readline in a loop's default executor is a non-daemon thread
        # that keeps the interpreter alive at exit.
        threading.Thread(
            target=self._read_loop, args=(gen,),
            name="zygote-reader", daemon=True,
        ).start()
        return gen

    def start(self) -> bool:
        if self.alive():
            return True
        self._gen = self._start_generation()
        return self._gen is not None

    def _read_loop(self, gen: _Generation) -> None:
        """Daemon thread: reads one zygote's replies, applies them under
        the manager lock."""
        proc = gen.proc
        while True:
            try:
                line = proc.stdout.readline()
            except Exception:  # noqa: BLE001
                line = ""
            if not line:
                with self._lock:
                    if not gen.retiring:
                        self._deaths += 1
                    # Pending forks never happened (retiring or not):
                    # their handles must resolve or callers poll forever.
                    while gen.pending:
                        gen.pending.popleft()._fail_locked(-1)
                    if self._gen is gen:
                        self._gen = None
                    if gen in self._old:
                        self._old.remove(gen)
                return
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            with self._lock:
                op = msg.get("op")
                if op == "spawned" and gen.pending:
                    gen.pending.popleft()._assign_locked(msg["pid"])
                    gen.live += 1
                elif op == "dead":
                    if len(self._dead) > 4096:  # unconsumed-notice backstop
                        self._dead.clear()
                    self._dead[msg["pid"]] = msg["rc"]
                    gen.live -= 1
                    if gen.retiring and gen.live <= 0 and not gen.pending:
                        # Last child reaped and no fork reply in flight:
                        # the retired zygote's only remaining job is done.
                        gen.close()
                        if gen in self._old:
                            self._old.remove(gen)

    def _rotate_locked(self) -> None:
        """Retire the current generation and promote the pre-warmed
        successor (or start one). Called under the lock."""
        gen = self._gen
        if gen is not None:
            gen.retiring = True
            if gen.live <= 0 and not gen.pending:
                gen.close()
            else:
                self._old.append(gen)
        nxt, self._next = self._next, None
        if nxt is not None and nxt.alive():
            self._gen = nxt
        else:
            self._gen = self._start_generation()

    def spawn(self, env: dict) -> Optional[ZygoteProc]:
        """Queue a fork request; returns None when the zygote can't serve
        (caller uses a normal Popen spawn).

        The whole liveness-check + enqueue + stdin write happens under
        the manager lock: with the manager process-shared, two sessions'
        threads spawning concurrently must observe the same FIFO order in
        _pending as on the pipe (else the reader assigns pids to the
        wrong handles), and must not double-start the zygote."""
        from ray_tpu_torch._private.config import get_config

        limit = max(1, get_config().zygote_respawn_after)
        with self._lock:
            if self._deaths >= 3:
                return None  # repeatedly crashing: stick to Popen spawns
            if self._gen is not None and self._gen.spawned >= limit:
                self._rotate_locked()
            if (self._gen is None or not self._gen.alive()) and not self.start():
                return None
            gen = self._gen
            # Pre-warm the successor while the current zygote still has
            # headroom: by rotation time its interpreter boot is done.
            if gen.spawned >= int(limit * 0.7) and self._next is None:
                self._next = self._start_generation()
            zp = ZygoteProc(self)
            gen.pending.append(zp)
            try:
                gen.proc.stdin.write(
                    json.dumps({"op": "spawn", "env": env}) + "\n"
                )
                gen.proc.stdin.flush()
            except Exception:  # noqa: BLE001 — zygote just died
                try:
                    gen.pending.remove(zp)
                except ValueError:
                    pass
                return None
            gen.spawned += 1
            return zp

    def stop(self) -> None:
        with self._lock:
            gens = [g for g in (self._gen, self._next, *self._old) if g]
            self._gen = None
            self._next = None
            self._old = []
            # Intentional shutdown: the reader threads will see EOF when
            # close() lands — mark every generation retiring FIRST so
            # those EOFs don't count toward _deaths (3 cumulative
            # stop/start cycles would otherwise permanently disable the
            # manager and push every spawn onto the slow Popen path).
            for g in gens:
                g.retiring = True
        for g in gens:
            g.close()


_shared: Optional[ZygoteManager] = None
_shared_lock = threading.Lock()


def get_shared_manager() -> ZygoteManager:
    """The process-level zygote: shared across raylets/sessions (children
    are fully parameterized by their per-spawn environment)."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = ZygoteManager()
            atexit.register(_shared.stop)
        return _shared
