"""The port's job submission held against the JAX package's.

One driver script runs in a subprocess under each package, the job cases
of tests/test_state_and_jobs.py: a job's lifecycle (SUCCEEDED, its logs,
its info and the job list), a stopped job, and a failing job reported
FAILED. Each side prints one `RESULT` line; the two must be equal and
give the outcomes the JAX tests assert.
"""

import pytest

from tests.test_torch_serve_api import PRELUDE, run_driver

DRIVER = PRELUDE + r'''
worker_mod = importlib.import_module(pkg + "._private.worker")
JobSubmissionClient = importlib.import_module(pkg + ".job").JobSubmissionClient


def wait_for(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.2)
    return False


out = {}
rt.init(num_cpus=4)
client = JobSubmissionClient(worker_mod._global_node.gcs_address)
try:
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('hello from job')\"")
    state = client.wait_until_finished(sid, timeout=60)
    info = client.get_job_info(sid)
    out["lifecycle"] = [
        state, "hello from job" in client.get_job_logs(sid),
        info["entrypoint"].endswith('"print(\'hello from job\')"'),
        any(j.get("submission_id") == sid for j in client.list_jobs())]

    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; time.sleep(60)\"")
    running = wait_for(lambda: client.get_job_status(sid) == "RUNNING")
    stopped = client.stop_job(sid)
    out["stop"] = [running, stopped,
                   client.wait_until_finished(sid, timeout=30)]

    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"raise SystemExit(3)\"")
    out["failure"] = client.wait_until_finished(sid, timeout=60)
finally:
    client.close()
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jobs")
    return tuple(run_driver(tmp, DRIVER, pkg)
                 for pkg in ("ray_tpu", "ray_tpu_torch"))


def test_job_submission_lifecycle(results):
    ref, out = results
    assert out["lifecycle"] == ref["lifecycle"] == [
        "SUCCEEDED", True, True, True]


def test_job_stop(results):
    ref, out = results
    assert out["stop"] == ref["stop"] == [True, True, "STOPPED"]


def test_job_failure_reported(results):
    ref, out = results
    assert out["failure"] == ref["failure"] == "FAILED"
