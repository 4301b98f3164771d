"""Card-only tests of the port's operator tools: a node started by
`python -m ray_tpu_torch start` detects the card (no --num-gpus given),
and `util.memory.sample_once()` in a num_gpus=1 actor reports the
actor's own `torch.cuda.memory_allocated()` under the physical card id
the raylet granted, which `rt memory --devices` then shows. Each test
skips without a CUDA device. This file imports no JAX:

    python -m pytest tests/test_torch_gpu_cli.py -m gpu --noconftest -q
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _env(tmp):
    env = {k: v for k, v in os.environ.items() if k != "RT_NUM_GPUS"}
    env["TMPDIR"] = str(tmp)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(ROOT), env.get("PYTHONPATH", "")] if p)
    return env


def _cli(env, *args):
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, (args, proc.stderr[-3000:])
    return proc.stdout


def test_rt_start_detects_the_card(cuda_device, tmp_path):
    env = _env(tmp_path)
    _cli(env, "start", "--head", "--num-cpus", "2", "--no-dashboard")
    try:
        status = _cli(env, "status")
        n = torch.cuda.device_count()
        assert f"  {n}/{n} GPU" in status, status
    finally:
        _cli(env, "stop")


_DRIVER = r"""
import json, sys, time
import ray_tpu_torch as rt

rt.init(address=sys.argv[1])


@rt.remote(num_gpus=1)
class Holder:
    def hold(self):
        import os
        import torch
        from ray_tpu_torch.util import memory, metrics

        self.x = torch.ones((1024, 1024, 64), device="cuda")  # 256 MiB
        sample = memory.sample_once()
        metrics._flush_once()
        return {"sample": sample,
                "allocated": torch.cuda.memory_allocated(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


h = Holder.remote()
print("HOLD " + json.dumps(rt.get(h.hold.remote(), timeout=300)), flush=True)
time.sleep(3)
out = __import__("subprocess").run(
    [sys.executable, "-m", "ray_tpu_torch", "memory", "--devices",
     "--address", sys.argv[1]], capture_output=True, text=True, timeout=120)
print("MEMORY " + json.dumps(out.stdout), flush=True)
rt.kill(h)
"""


def test_sample_once_in_a_gpu_actor_reports_its_own_bytes(cuda_device,
                                                          tmp_path):
    env = _env(tmp_path)
    _cli(env, "start", "--head", "--num-cpus", "2", "--no-dashboard")
    try:
        addr = json.loads((tmp_path / "ray_tpu_torch" / "session.json")
                          .read_text())["gcs_address"]
        proc = subprocess.run([sys.executable, "-c", _DRIVER, addr], env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = dict(ln.split(" ", 1) for ln in proc.stdout.splitlines()
                     if ln.startswith(("HOLD ", "MEMORY ")))
        held = json.loads(lines["HOLD"])
        (entry,) = held["sample"]
        assert entry["device"] == f"cuda:{held['visible']}"
        assert entry["live_bytes"] == held["allocated"] >= 256 * 2**20
        assert entry["kind"] == torch.cuda.get_device_name(0)
        assert entry["bytes_limit"] > 0
        memory_out = json.loads(lines["MEMORY"])
        assert (f"cuda:{held['visible']}: {entry['live_bytes'] / 1e6:>9.1f} "
                "MB live") in memory_out, memory_out
    finally:
        _cli(env, "stop")
    time.sleep(0.5)
