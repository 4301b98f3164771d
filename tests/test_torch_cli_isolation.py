"""The port's `rt` CLI and the services `rt start` runs stand alone:

- the CLI process (`python -m ray_tpu_torch ...`) loads neither torch nor
  JAX nor any module of ray_tpu, for every read-only command, so no
  `rt status` pays torch's import;
- the GCS, raylet and dashboard that `rt start --head` spawns map no
  torch or JAX library, and their modules import none of torch, JAX or
  ray_tpu;
- `rt stop` leaves no process of the session behind;
- `util.memory.sample_once()` never creates a CUDA context, and in a
  process without torch it does not import it.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BAD = ("torch", "jax", "jaxlib", "ray_tpu")


def _env(tmp):
    env = dict(os.environ, TMPDIR=str(tmp), RT_NUM_GPUS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(ROOT), env.get("PYTHONPATH", "")] if p)
    return env


def _cli(env, *args, timeout=120):
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, (args, proc.stderr[-3000:])
    return proc.stdout


_CLI_MODULES = r"""
import runpy, sys
sys.argv = ["rt"] + sys.argv[1:]
try:
    runpy.run_module("ray_tpu_torch", run_name="__main__")
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
    print("BAD", bad, file=sys.stderr)
""" % (_BAD,)


def _maps(pid):
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(") ")[1][0] != "Z"


def _session_pids(tmp):
    """Every live process whose environment names this session's TMPDIR."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if f"TMPDIR={tmp}".encode() in env.split(b"\0") and _alive(int(entry)):
            pids.append(int(entry))
    return pids


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rt_session")
    env = _env(tmp)
    out = _cli(env, "start", "--head", "--num-cpus", "2",
               "--dashboard-port", "0")
    sess = json.loads((tmp / "ray_tpu_torch" / "session.json").read_text())
    yield env, tmp, sess, out
    _cli(env, "stop")


def test_rt_start_detects_the_gpu_and_names_no_dashboard(session):
    """`rt start --head` names the dashboard it started, which answers."""
    import urllib.request

    env, _, sess, out = session
    url = f"http://127.0.0.1:{sess['dashboard_port']}"
    assert f"dashboard: {url}" in out
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert r.read() == b"ok"
    status = _cli(env, "status")
    assert "  1/1 GPU" in status and "  2/2 CPU" in status


@pytest.mark.parametrize("args", [
    ["status"], ["list", "nodes"], ["list", "workers"], ["summary", "tasks"],
    ["memory", "--devices"], ["top"], ["stack"], ["logs"], ["config"],
    ["loadgen", "gen", os.devnull, "--duration", "2"]],
    ids=lambda a: "-".join(a))
def test_the_cli_process_loads_no_torch_jax_or_ray_tpu(session, args):
    env = session[0]
    proc = subprocess.run([sys.executable, "-c", _CLI_MODULES, *args],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stderr, proc.stderr[-3000:]


def test_rt_start_services_map_no_torch_or_jax(session):
    _, _, sess, _ = session
    assert len(sess["pids"]) == 3  # the GCS, the raylet, the dashboard
    for pid in sess["pids"]:
        maps = _maps(pid)
        assert "libtorch" not in maps and "/torch/" not in maps, pid
        assert "jaxlib" not in maps and "/jax/" not in maps, pid
    probe = ("import sys\n"
             "import ray_tpu_torch._private.gcs, ray_tpu_torch._private.raylet\n"
             "import ray_tpu_torch.dashboard.dashboard\n"
             "from ray_tpu_torch._private.node import resolve_resources\n"
             "resolve_resources()\n"
             f"print(sorted(m for m in sys.modules if m.split('.')[0] in {_BAD!r}))")
    out = subprocess.run([sys.executable, "-c", probe], env=session[0],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_rt_stop_leaves_no_process(tmp_path):
    env = _env(tmp_path)
    _cli(env, "start", "--head", "--num-cpus", "2", "--dashboard-port", "0")
    sess = json.loads((tmp_path / "ray_tpu_torch" / "session.json")
                      .read_text())
    driver = ("import os, sys, ray_tpu_torch as rt\n"
              "rt.init(address=sys.argv[1])\n"
              "@rt.remote(num_gpus=1)\n"
              "class A:\n"
              "    def pid(self):\n"
              "        return os.getpid()\n"
              "print(rt.get(A.remote().pid.remote(), timeout=120))\n")
    out = subprocess.run([sys.executable, "-c", driver, sess["gcs_address"]],
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 0
    assert len(_session_pids(tmp_path)) >= 3  # GCS, raylet, zygote, ...
    _cli(env, "stop")
    deadline = time.monotonic() + 10
    while _session_pids(tmp_path) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _session_pids(tmp_path) == []
    assert not (tmp_path / "ray_tpu_torch" / "session.json").exists()


_SAMPLE = r"""
import sys
from ray_tpu_torch.util import memory
assert memory.sample_once() == [] and memory.device_memory() == []
print("TORCH", "torch" in sys.modules)
import torch
assert memory.sample_once() == []
print("INIT", torch.cuda.is_initialized())
"""


def test_sample_once_makes_no_cuda_context():
    proc = subprocess.run([sys.executable, "-c", _SAMPLE], env=_env("/tmp"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["TORCH", "False", "INIT", "False"]
