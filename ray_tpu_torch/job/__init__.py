"""Job submission SDK + CLI glue (the port of ray_tpu/job/__init__.py).

Analog of the reference's job submission stack (dashboard/modules/job/:
``JobSubmissionClient.submit_job`` sdk.py:39,129, ``JobManager``
job_manager.py:525, per-job ``JobSupervisor`` actor :140, CLI
``ray job submit``). Here the GCS keeps the job table and the head raylet acts as supervisor:
it spawns the detached driver subprocess, streams its stdout/stderr back
to the GCS, and reports terminal state — so a submitted job outlives the
submitting client.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.node import EventLoopThread
from ray_tpu_torch._private.protocol import connect

TERMINAL_STATES = ("SUCCEEDED", "FAILED", "STOPPED")


class JobSubmissionClient:
    """Lightweight GCS dialer — no raylet or object store needed."""

    def __init__(self, address: Optional[str] = None):
        import os

        if address is None:
            address = os.environ.get("RT_GCS_ADDR")
        if address is None:
            raise RuntimeError("pass address='host:port' or set RT_GCS_ADDR")
        address = address.removeprefix("rt://").removeprefix("http://")
        host, port = address.rsplit(":", 1)
        self._io = EventLoopThread("rt-job")
        self._conn = self._run(connect(host, int(port)))

    def _run(self, coro, timeout=30.0):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self._io.loop).result(timeout)

    def close(self):
        try:
            self._run(self._conn.close(), timeout=5)
        except Exception:
            pass
        self._io.stop()

    def _prepare_job_runtime_env(self, renv: Optional[Dict]) -> Optional[Dict]:
        """Resolve the job env exactly like task envs (upload working_dir /
        py_modules to the GCS KV) so the supervisor and the job's own
        workers can materialize it."""
        if not renv:
            return None
        from ray_tpu_torch.runtime_env.runtime_env import (
            GcsKvAdapter,
            prepare_runtime_env,
        )

        kv = GcsKvAdapter(self._conn, self._io.loop)
        return prepare_runtime_env(renv, kv)

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[Dict] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        runtime_env = self._prepare_job_runtime_env(runtime_env)
        r = self._run(
            self._conn.call(
                "submit_job",
                {
                    "entrypoint": entrypoint,
                    "submission_id": submission_id,
                    "runtime_env": runtime_env,
                    "metadata": metadata,
                },
            )
        )
        if not r.get("ok"):
            raise RuntimeError(r.get("error", "job submission failed"))
        return r["submission_id"]

    def get_job_status(self, submission_id: str) -> str:
        job = self.get_job_info(submission_id)
        return job["state"]

    def get_job_info(self, submission_id: str) -> dict:
        r = self._run(self._conn.call("get_job", {"submission_id": submission_id}))
        if r["job"] is None:
            raise RuntimeError(f"no such job: {submission_id}")
        job = dict(r["job"])
        for k in ("job_id", "node_id"):
            if isinstance(job.get(k), (bytes, bytearray)):
                job[k] = job[k].hex()
        return job

    def get_job_logs(self, submission_id: str) -> str:
        r = self._run(self._conn.call("job_logs", {"submission_id": submission_id}))
        if r["logs"] is None:
            raise RuntimeError(f"no such job: {submission_id}")
        return r["logs"]

    def list_jobs(self) -> List[dict]:
        jobs = self._run(self._conn.call("list_jobs", {}))["jobs"]
        out = []
        for j in jobs:
            j = dict(j)
            for k in ("job_id", "node_id"):
                if isinstance(j.get(k), (bytes, bytearray)):
                    j[k] = j[k].hex()
            out.append(j)
        return out

    def stop_job(self, submission_id: str) -> bool:
        r = self._run(self._conn.call("stop_job", {"submission_id": submission_id}))
        return bool(r.get("ok"))

    def wait_until_finished(
        self, submission_id: str, timeout: float = 300.0, poll: float = 0.25
    ) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            state = self.get_job_status(submission_id)
            if state in TERMINAL_STATES:
                return state
            time.sleep(poll)
        raise TimeoutError(f"job {submission_id} still {state} after {timeout}s")


def _submit_args(rest: List[str]) -> argparse.Namespace:
    """`rt job submit [--working-dir DIR] [--runtime-env-json JSON] --
    <entrypoint>` (reference: `ray job submit`'s options of these names;
    the JAX package's `rt job submit` takes the entrypoint alone)."""
    p = argparse.ArgumentParser(prog="rt job submit")
    p.add_argument("--working-dir")
    p.add_argument("--runtime-env-json")
    p.add_argument("entrypoint", nargs=argparse.REMAINDER)
    args = p.parse_args(rest)
    args.entrypoint = [a for a in args.entrypoint if a != "--"]
    return args


def job_cli(args, address: str):
    """Back end of `rt job ...` (scripts/scripts.py)."""
    client = JobSubmissionClient(address)
    try:
        cmd = args.job_command
        if cmd == "submit":
            sub = _submit_args(args.args)
            if not sub.entrypoint:
                sys.exit("usage: rt job submit [--working-dir DIR] "
                         "[--runtime-env-json JSON] -- <entrypoint command>")
            env = json.loads(sub.runtime_env_json or "{}")
            if sub.working_dir:
                env["working_dir"] = sub.working_dir
            sid = client.submit_job(entrypoint=" ".join(sub.entrypoint),
                                    runtime_env=env or None)
            print(f"submitted {sid}")
            return
        rest = [a for a in args.args if a != "--"]
        if cmd == "status":
            print(client.get_job_status(rest[0]))
        elif cmd == "logs":
            print(client.get_job_logs(rest[0]), end="")
        elif cmd == "list":
            for j in client.list_jobs():
                sid = j.get("submission_id") or j["job_id"][:12]
                print(f"{sid}\t{j['state']}\t{j.get('entrypoint', '')}")
        elif cmd == "stop":
            ok = client.stop_job(rest[0])
            print("stopped" if ok else "stop failed")
    finally:
        client.close()
