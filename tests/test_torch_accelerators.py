"""GPU accelerator manager tests (no hardware required): the port's
counterpart of tests/test_accelerators.py, with GPU in place of TPU.

Detection is driven by patched env and a fake `nvidia-smi` on PATH, as
upstream Ray's python/ray/tests/accelerators/test_nvidia_gpu.py does.
"""

import os
import stat
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private.accelerators import (
    GPUAcceleratorManager,
    get_accelerator_manager,
    get_all_accelerator_managers,
)
from ray_tpu_torch._private.accelerators import gpu as gpu_mod
from ray_tpu_torch._private.node import resolve_resources

H100 = "NVIDIA H100 80GB HBM3"


def _fake_nvidia_smi(tmp_path, lines, rc=0):
    """An executable `nvidia-smi` that prints `lines` for any query and
    records its arguments."""
    tool = tmp_path / "nvidia-smi"
    body = "".join(f"echo '{ln}'\n" for ln in lines)
    tool.write_text(f"#!/bin/sh\necho \"$@\" >> {tmp_path}/args\n{body}exit {rc}\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    return tool


def _path_without_nvidia_smi() -> str:
    """PATH less any folder that holds an nvidia-smi (g++, which builds
    the store, stays reachable)."""
    return os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvidia-smi")))


@pytest.fixture
def no_gpu_env(monkeypatch, tmp_path):
    """A host with no card: no explicit count, no CUDA_VISIBLE_DEVICES, no
    nvidia-smi on PATH and no driver entries."""
    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("PATH", _path_without_nvidia_smi())
    monkeypatch.setattr(gpu_mod, "_PROC_GPUS", str(tmp_path / "no-proc"))
    yield


def _put_first_on_path(monkeypatch, d):
    monkeypatch.setenv("PATH", os.pathsep.join([str(d), _path_without_nvidia_smi()]))


@pytest.fixture
def smi_host(no_gpu_env, monkeypatch, tmp_path):
    """A host whose nvidia-smi lists two H100s."""
    d = tmp_path / "bin"
    d.mkdir()
    _fake_nvidia_smi(d, [f"0, {H100}", f"1, {H100}"])
    _put_first_on_path(monkeypatch, d)
    yield d


def test_registry():
    assert get_accelerator_manager("GPU") is GPUAcceleratorManager
    assert get_accelerator_manager("TPU") is None
    assert list(get_all_accelerator_managers()) == ["GPU"]
    assert GPUAcceleratorManager.get_resource_name() == "GPU"
    assert GPUAcceleratorManager.get_visible_accelerator_ids_env_var() == "CUDA_VISIBLE_DEVICES"


def test_no_gpu_detected(no_gpu_env):
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 0
    assert GPUAcceleratorManager.get_current_node_accelerator_type() is None
    res = resolve_resources(num_cpus=2)
    assert "GPU" not in res and res["CPU"] == 2.0


def test_detection_from_nvidia_smi(smi_host):
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 2
    assert GPUAcceleratorManager.get_current_node_accelerator_type() == "GPU-H100"
    args = (smi_host / "args").read_text().split()
    assert args == ["--query-gpu=index,name", "--format=csv,noheader"] * 2


def test_failing_nvidia_smi_falls_through(no_gpu_env, monkeypatch, tmp_path):
    d = tmp_path / "bin"
    d.mkdir()
    _fake_nvidia_smi(d, ["NVIDIA-SMI has failed"], rc=9)
    _put_first_on_path(monkeypatch, d)
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 0


def test_detection_from_proc_driver(no_gpu_env, monkeypatch, tmp_path):
    proc = tmp_path / "proc-gpus"
    for bus in ("0000:18:00.0", "0000:2a:00.0", "0000:3a:00.0"):
        (proc / bus).mkdir(parents=True)
        (proc / bus / "information").write_text(
            f"Model: \t\t {H100}\nIRQ:   \t\t 18\n")
    monkeypatch.setattr(gpu_mod, "_PROC_GPUS", str(proc))
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 3
    assert GPUAcceleratorManager.get_current_node_accelerator_type() == "GPU-H100"


@pytest.mark.parametrize("visible,count", [("0", 1), ("0,1,3", 3), ("", 0),
                                           ("NoDevFiles", 0)])
def test_cuda_visible_devices_beats_nvidia_smi(smi_host, monkeypatch, visible, count):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == count


def test_explicit_count_beats_everything(smi_host, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    monkeypatch.setenv("RT_NUM_GPUS", "5")
    assert GPUAcceleratorManager.get_current_node_num_accelerators() == 5


@pytest.mark.parametrize("name,label", [
    (H100, "GPU-H100"),
    ("NVIDIA A100-SXM4-80GB", "GPU-A100"),
    ("Tesla V100-SXM2-16GB", "GPU-V100"),
    ("", None),
])
def test_type_label(name, label):
    assert gpu_mod.gpu_type_label(name) == label


def test_resolve_resources_includes_gpu(smi_host):
    res = resolve_resources(num_cpus=4)
    assert res["CPU"] == 4.0
    assert res["GPU"] == 2.0
    assert res["GPU-H100"] == 1.0


def test_resolve_resources_explicit_num_gpus(smi_host):
    res = resolve_resources(num_cpus=1, num_gpus=1)
    assert res["GPU"] == 1.0
    assert res["GPU-H100"] == 1.0
    # An explicit 0 advertises no GPU at all.
    assert "GPU" not in resolve_resources(num_cpus=1, num_gpus=0)


@pytest.mark.parametrize("quantity,ok", [
    (0.25, True), (0.5, True), (1, True), (2, True), (8.0, True),
    (1.5, False), (0, False), (-1, False),
])
def test_gpu_quantity_validation(quantity, ok):
    valid, msg = GPUAcceleratorManager.validate_resource_request_quantity(quantity)
    assert valid is ok
    assert (msg is None) is ok
    if not ok:
        assert "fraction of one GPU or a whole number" in msg


def test_visible_ids_helpers(monkeypatch):
    # setenv first, so monkeypatch restores the variable as it found it
    # (absent included) after the helper below writes os.environ.
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert GPUAcceleratorManager.get_current_process_visible_accelerator_ids() is None
    GPUAcceleratorManager.set_current_process_visible_accelerator_ids(["0", "1"])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert GPUAcceleratorManager.get_current_process_visible_accelerator_ids() == ["0", "1"]
    GPUAcceleratorManager.set_current_process_visible_accelerator_ids([3])
    assert GPUAcceleratorManager.get_current_process_visible_accelerator_ids() == ["3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert GPUAcceleratorManager.get_current_process_visible_accelerator_ids() == []


def test_detection_never_touches_torch_cuda(smi_host):
    """The raylet and the zygote detect cards, and the zygote forks every
    worker: detection must not import torch (a CUDA context made before a
    fork leaves CUDA unusable in each child)."""
    code = (
        "import sys\n"
        "from ray_tpu_torch._private.node import resolve_resources\n"
        "r = resolve_resources(num_cpus=1)\n"
        "assert r['GPU'] == 2.0, r\n"
        "assert 'torch' not in sys.modules, sorted(sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_gpu_task_stays_pending_without_a_gpu(no_gpu_env):
    """With no card the runtime advertises no GPU, and a num_gpus task
    stays pending: it never runs on the CPU instead."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=2)
    try:
        assert "GPU" not in rt.cluster_resources()

        @rt.remote(num_gpus=1)
        def on_gpu():
            return 1

        ready, pending = rt.wait([on_gpu.remote()], timeout=2)
        assert ready == [] and len(pending) == 1
    finally:
        rt.shutdown()


def test_fake_gpu_is_scheduled_as_a_resource(no_gpu_env):
    """An explicit count of one GPU is held by a num_gpus=1 actor and
    released when it is killed."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, num_gpus=1)
    try:
        assert rt.cluster_resources()["GPU"] == 1.0

        @rt.remote(num_gpus=1)
        class Holder:
            def ping(self):
                return "pong"

        @rt.remote(num_gpus=1)
        def needs_gpu():
            return "ran"

        h = Holder.remote()
        assert rt.get(h.ping.remote(), timeout=60) == "pong"
        assert rt.available_resources().get("GPU", 0.0) == 0.0
        ref = needs_gpu.remote()
        ready, _ = rt.wait([ref], timeout=2)
        assert ready == []
        rt.kill(h)
        assert rt.get(ref, timeout=60) == "ran"
        deadline = time.monotonic() + 30
        while rt.available_resources().get("GPU", 0.0) != 1.0:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        rt.shutdown()


def test_gpu_instances_grant_whole_and_fractional_cards():
    """Whole-card grants take distinct free cards; fractions share the
    fullest card that fits; a give returns exactly what was taken."""
    g = gpu_mod.GPUInstances(3)
    a, b = g.take(1), g.take(2)
    assert a == ["0"] and b == ["1", "2"]
    g.give(b, 2)
    assert g.take(0.5) == ["1"] and g.take(0.25) == ["1"]
    assert g.take(0.5) == ["2"]  # "1" has only 0.25 left
    assert g.free() == {"0": 0.0, "1": 0.25, "2": 0.5}
    g.give(["1"], 0.25)
    assert g.free()["1"] == 0.5
    g.give(a, 1)
    assert g.take(1, prefer=["0"]) == ["0"]
    # The ids follow the raylet's own CUDA_VISIBLE_DEVICES.
    v = gpu_mod.GPUInstances(2, ["4", "6"])
    assert v.take(1, prefer=["6"]) == ["6"] and v.take(1) == ["4"]
    assert gpu_mod.GPUInstances(0).take(1) == []


def test_confine_refuses_to_move_a_made_context(monkeypatch):
    """A worker is confined through CUDA_VISIBLE_DEVICES; once its CUDA
    context exists it cannot be moved to other cards."""
    import types

    # setenv first, so monkeypatch restores the variable as it found it
    # after confine_process_to_gpus writes os.environ.
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    gpu_mod.confine_process_to_gpus(["1"])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
    assert gpu_mod.granted_gpu_ids() == ["1"]
    made = types.SimpleNamespace(
        cuda=types.SimpleNamespace(is_initialized=lambda: True))
    monkeypatch.setitem(sys.modules, "torch", made)
    gpu_mod.confine_process_to_gpus(["1"])  # the same cards: no move
    with pytest.raises(RuntimeError, match="cannot move"):
        gpu_mod.confine_process_to_gpus(["0"])
    gpu_mod.confine_process_to_gpus([])
    assert gpu_mod.granted_gpu_ids() == []
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"


def test_gpu_actors_and_tasks_see_only_their_own_cards(no_gpu_env):
    """On a node with two (faked) cards, the raylet confines each GPU
    actor and task to the cards it grants: two actors see different
    ids, and a task run after one actor dies sees the freed card."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, num_gpus=2)
    try:
        @rt.remote(num_gpus=1)
        class Holder:
            def cards(self):
                from ray_tpu_torch._private.accelerators.gpu import (
                    granted_gpu_ids)
                return os.environ.get("CUDA_VISIBLE_DEVICES"), granted_gpu_ids()

        @rt.remote(num_gpus=1)
        def task_cards():
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        h0, h1 = Holder.remote(), Holder.remote()
        (v0, g0), (v1, g1) = rt.get([h0.cards.remote(), h1.cards.remote()],
                                    timeout=60)
        assert sorted([v0, v1]) == ["0", "1"]
        assert [v0] == g0 and [v1] == g1
        ref = task_cards.remote()
        assert rt.wait([ref], timeout=2)[0] == []
        rt.kill(h0)
        assert rt.get(ref, timeout=60) == v0
    finally:
        rt.shutdown()
