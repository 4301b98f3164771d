"""Worker fork server (zygote).

The raylet spawns ONE zygote interpreter that pays the worker's
interpreter-start + import cost once, then `os.fork()`s per worker
request — worker spawn drops from ~300ms to single-digit ms. This plays
the role the reference's worker pool prestart plays
(src/ray/raylet/worker_pool.h:347) but makes every spawn cheap instead
of hiding latency for the first N workers.

Protocol — line-delimited JSON over the zygote's stdin/stdout:

    -> {"op": "spawn", "env": {...}}     # complete desired child environ
    <- {"op": "spawned", "pid": N}       # replies in request order
    <- {"op": "dead", "pid": N, "rc": N} # interleaved as children reap

Fork-safety rules: the zygote is strictly single-threaded, runs no event
loop, and never imports torch or touches CUDA (a CUDA context made before
the fork leaves CUDA unusable in every child; workers import torch
themselves, after the fork). stdin is consumed with raw os.read into
an explicit line buffer — buffered TextIO.readline over a selector
silently strands any second line that arrived in the same pipe read.
Children are reaped with waitpid(WNOHANG) between protocol reads (<=1s
select timeout) and death notices stream to the raylet, which owns
worker-failure handling.
"""

from __future__ import annotations

import json
import os
import selectors
import sys


def _emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _reap() -> None:
    while True:
        try:
            pid, status = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return
        _emit({"op": "dead", "pid": pid, "rc": os.waitstatus_to_exitcode(status)})


def _become_worker(env: dict) -> None:
    """Runs in the forked child; never returns."""
    rc = 1
    try:
        os.setsid()
        # fd 1 is the zygote protocol pipe — worker prints must not
        # corrupt it. Route child stdout to the inherited stderr (the
        # raylet's), and detach stdin.
        os.dup2(2, 1)
        devnull = os.open(os.devnull, os.O_RDONLY)
        os.dup2(devnull, 0)
        os.close(devnull)
        os.environ.clear()
        os.environ.update(env)
        # The interpreter read PYTHONPATH at zygote start; changes in the
        # per-worker env must land on sys.path by hand or by-reference
        # cloudpickle functions from driver-side modules won't resolve.
        for entry in reversed(
            [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        ):
            if entry not in sys.path:
                sys.path.insert(0, entry)
        # Drop config cached under the zygote's environment.
        from ray_tpu_torch._private import config as _config

        _config._config = None
        from ray_tpu_torch._private import worker_main

        worker_main.main()
        rc = 0
    except BaseException:  # noqa: BLE001 — child must never unwind into the zygote loop
        import traceback

        traceback.print_exc()
    finally:
        os._exit(rc)


def _handle(line: bytes) -> None:
    try:
        req = json.loads(line)
    except json.JSONDecodeError:
        return
    if req.get("op") == "spawn":
        pid = os.fork()
        if pid == 0:
            _become_worker(req.get("env") or {})
        _emit({"op": "spawned", "pid": pid})


def _prewarm() -> None:
    """Exercise first-use-lazy machinery pre-fork so every child inherits
    warm module state via COW instead of paying it on the boot path
    (measured: a cold ThreadPoolExecutor ctor alone costs ~8ms in a fresh
    fork; warm it's ~0.2ms)."""
    import asyncio
    import concurrent.futures

    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    ex.submit(lambda: None).result()
    ex.shutdown(wait=True)
    # Event-loop machinery (selector, policy) and the serializer's
    # first-use tables.
    asyncio.run(asyncio.sleep(0))
    from ray_tpu_torch._private import serialization as ser

    ser.deserialize_from_bytes(ser.serialize_to_bytes(([], {})))
    from ray_tpu_torch._private.protocol import pack_frame

    pack_frame({"k": "req", "i": 0, "m": "ping", "d": None})


def main() -> None:
    # Pay the import cost once, pre-fork.
    from ray_tpu_torch._private import worker_main  # noqa: F401

    _prewarm()
    # Freeze the warm heap into the GC's permanent generation: a child's
    # first collection otherwise WRITES the gc header of every inherited
    # object, COW-copying nearly the whole heap (the Instagram prefork
    # lesson). With the freeze, children dirty only what they actually
    # mutate — measured ~5.1MB -> ~2MB private-dirty per idle worker,
    # which is what bounds actor density per host (thinly-backed VMs
    # penalize every fresh page touched).
    import gc

    gc.collect()
    gc.freeze()
    _emit({"op": "ready", "pid": os.getpid()})
    fd = sys.stdin.fileno()
    sel = selectors.DefaultSelector()
    sel.register(fd, selectors.EVENT_READ)
    buf = b""
    while True:
        events = sel.select(timeout=1.0)
        _reap()
        if not events:
            continue
        try:
            chunk = os.read(fd, 1 << 16)
        except OSError:
            return
        if not chunk:
            return  # raylet closed our stdin: shut down
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            _handle(line)


if __name__ == "__main__":
    main()
