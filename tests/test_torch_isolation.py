"""The PyTorch port stands alone: it loads neither JAX nor any module of
ray_tpu (serving, one training step and the runtime's worker processes
included), its serialization runs the vendored cloudpickle and msgpack,
and it never falls back to the CPU on its own. The Serve control plane
(controller, proxy, handle) loads no torch, and the zygote never makes a
CUDA context. The load generator and the dashboard only route and read:
their modules load no torch, and neither the dashboard process that `rt
start --head` spawns nor an `rt loadgen run` process maps libtorch."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SERVE_ONE = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import ray_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from ray_tpu_torch.models import configs, init_params
from ray_tpu_torch.serve.llm import LLMReplica
cfg = configs.tiny
rep = LLMReplica(lambda: (init_params(cfg, seed=0, device="cpu"), cfg),
                 num_slots=2, max_len=32, default_max_new_tokens=3)
try:
    out = rep([1, 2, 3])
finally:
    rep.shutdown()
assert len(out) == 3 and all(0 <= t < cfg.vocab_size for t in out), out
from ray_tpu_torch.models import loss_fn
params = init_params(cfg, seed=0, device="cpu")
params["layers"]["wq"].requires_grad_(True)
loss = loss_fn(params, torch.randint(0, cfg.vocab_size, (2, 9)), cfg)
loss.backward()
assert torch.isfinite(loss) and params["layers"]["wq"].grad is not None
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ray_tpu"
             or m.startswith("ray_tpu."))
print("MODULES", len(mods), "BAD", bad)
"""


def test_port_imports_and_serves_without_jax_or_ray_tpu():
    proc = subprocess.run([sys.executable, "-c", _SERVE_ONE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("MODULES")]
    assert line and line[0].endswith("BAD []"), proc.stdout
    assert int(line[0].split()[1]) >= 16


_WORKER = r"""
import os, sys
import ray_tpu_torch as rt

rt.init(num_cpus=2)
try:
    @rt.remote
    class Probe:
        def report(self):
            import cloudpickle, msgpack  # site packages, if the host has them
            from ray_tpu_torch._private import serialization, protocol, worker
            with open("/proc/self/cmdline", "rb") as f:
                cmdline = f.read().split(b"\0")
            main = sys.modules.get("ray_tpu_torch._private.worker_main")
            return {
                "bad": sorted(m for m in sys.modules
                              if m == "jax" or m.startswith("jax.")
                              or m == "ray_tpu" or m.startswith("ray_tpu.")),
                "torch": "torch" in sys.modules,
                "cmdline": [a.decode() for a in cmdline if a],
                "worker_main": main.__file__ if main else None,
                "main_file": sys.modules["__main__"].__file__,
                "ser_cloudpickle": serialization.cloudpickle.__name__,
                "worker_cloudpickle": worker.cloudpickle.__name__,
                "protocol_msgpack": protocol.msgpack.__name__,
                "site_cloudpickle": cloudpickle.__name__,
                "site_msgpack": msgpack.__name__,
            }

    print("REPORT", repr(rt.get(Probe.remote().report.remote(), timeout=120)))
    print("DRIVER_BAD", sorted(m for m in sys.modules if m == "jax"
                               or m.startswith(("jax.", "ray_tpu."))))
finally:
    rt.shutdown()
"""


@pytest.mark.parametrize("zygote", [True, False], ids=["zygote", "popen"])
def test_runtime_workers_load_no_jax_and_run_the_port(tmp_path, zygote):
    """A port worker loads neither JAX nor ray_tpu, is launched as the
    port's own worker_main (forked from the port's zygote, or exec'd
    directly), and its serialization resolves cloudpickle and msgpack to
    ray_tpu_torch._vendor even where the site packages exist."""
    import ast
    import os

    script = tmp_path / "probe.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               RT_ZYGOTE_ENABLED="1" if zygote else "0")
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = dict(ln.split(" ", 1) for ln in proc.stdout.splitlines()
                 if ln.startswith(("REPORT ", "DRIVER_BAD ")))
    rep = ast.literal_eval(lines["REPORT"])
    assert rep["bad"] == [] and lines["DRIVER_BAD"] == "[]"
    assert not rep["torch"]  # workers import torch only when user code does
    private = ROOT / "ray_tpu_torch" / "_private"
    if zygote:
        assert rep["cmdline"][1:] == ["-m", "ray_tpu_torch._private.zygote"]
        assert rep["main_file"] == str(private / "zygote.py")
        assert rep["worker_main"] == str(private / "worker_main.py")
    else:
        assert rep["cmdline"][1:] == ["-m", "ray_tpu_torch._private.worker_main"]
        assert rep["main_file"] == str(private / "worker_main.py")
    assert rep["ser_cloudpickle"] == "ray_tpu_torch._vendor.cloudpickle"
    assert rep["worker_cloudpickle"] == "ray_tpu_torch._vendor.cloudpickle"
    assert rep["protocol_msgpack"] == "ray_tpu_torch._vendor.msgpack"
    assert (rep["site_cloudpickle"], rep["site_msgpack"]) == (
        "cloudpickle", "msgpack")


def test_no_source_imports_third_party_serializers():
    """The port imports cloudpickle and msgpack only from its vendored
    copies: a bare `import msgpack` would pick the site package's C
    extension on one host and fail on another."""
    pat = re.compile(r"^\s*(import|from)\s+(cloudpickle|msgpack)\b", re.M)
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files = [f for f in files if "_vendor" not in f.parts]
    files.append(ROOT / "chip_smoke.py")
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []
    vendored = ROOT / "ray_tpu_torch" / "_vendor"
    assert (vendored / "cloudpickle" / "LICENSE").exists()
    assert (vendored / "msgpack" / "LICENSE").exists()
    assert not list(vendored.rglob("*.so"))


def test_no_source_imports_jax_or_ray_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ray_tpu)\b", re.M)
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []


_SERVE_MODULES = ["ray_tpu_torch.serve", "ray_tpu_torch.serve.autoscale",
                  "ray_tpu_torch.serve.batching",
                  "ray_tpu_torch.serve.controller",
                  "ray_tpu_torch.serve.deployment",
                  "ray_tpu_torch.serve.handle",
                  "ray_tpu_torch.serve.multiplex",
                  "ray_tpu_torch.serve.observatory",
                  "ray_tpu_torch.serve.proxy",
                  "ray_tpu_torch.serve.replica",
                  "ray_tpu_torch.serve.schema",
                  "ray_tpu_torch.serve._prefix_hash"]


@pytest.mark.parametrize("module", _SERVE_MODULES)
def test_serve_control_plane_module_imports_no_torch(module):
    """The control plane's modules load neither torch, JAX nor ray_tpu:
    the controller, the proxy and every handle import them."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu', 'aiohttp')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


_TRAIN_MODULES = ["ray_tpu_torch.runtime_env",
                  "ray_tpu_torch.runtime_env.runtime_env",
                  "ray_tpu_torch.job", "ray_tpu_torch.train"] + [
    f"ray_tpu_torch.train.{m}" for m in (
        "backend", "backend_executor", "checkpoint", "config",
        "data_config", "flight_recorder", "session", "sklearn", "storage",
        "torch", "trainer", "worker_group")]


@pytest.mark.parametrize("module", _TRAIN_MODULES)
def test_train_job_and_runtime_env_modules_import_no_jax(module):
    """runtime_env, job and train (and each train module) load neither JAX
    nor ray_tpu, and no torch: importing them must not make a CUDA context
    possible before the zygote forks; the loops import torch where they
    run."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


_TUNE_DAG_CLUSTER_MODULES = [
    "ray_tpu_torch.tune", "ray_tpu_torch.tune.search",
    "ray_tpu_torch.tune.schedulers", "ray_tpu_torch.tune.session_bridge",
    "ray_tpu_torch.tune.tuner", "ray_tpu_torch.dag",
    "ray_tpu_torch.dag.dag_node", "ray_tpu_torch.dag.compiled_dag",
    "ray_tpu_torch.experimental", "ray_tpu_torch.experimental.channel",
    "ray_tpu_torch.cluster_utils"]


@pytest.mark.parametrize("module", _TUNE_DAG_CLUSTER_MODULES)
def test_tune_dag_and_cluster_modules_import_no_jax_and_no_torch(module):
    """tune, dag, experimental and cluster_utils load neither JAX nor
    ray_tpu, and no torch: a trial, a DAG stage or a task imports torch
    where it runs, in its own worker."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


_DATA_MODULES = ["ray_tpu_torch.data"] + [
    f"ray_tpu_torch.data.{m}" for m in (
        "block", "tensor", "aggregate", "datasource", "executor", "feed",
        "dataset", "iterator", "connectors")]


@pytest.mark.parametrize("module", _DATA_MODULES)
def test_data_modules_import_no_jax_and_no_torch(module):
    """The data library loads neither JAX nor ray_tpu, and no torch: only
    iter_torch_batches and its feed to a device import it."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


_DATA_PIPELINE = r"""
import os, sys, tempfile
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from ray_tpu_torch.util import state

d = tempfile.mkdtemp()
for i in range(3):
    pq.write_table(pa.table({"x": np.arange(i * 10, i * 10 + 10)}),
                   os.path.join(d, f"part{i}.parquet"))


def probe(r):
    return {"x": r["x"], "torch": "torch" in sys.modules}


def mapped_torch(pid):
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line for line in f)


rt.init(num_cpus=2)
try:
    ds = rd.read_parquet(d).map(probe)
    rows = ds.take_all()
    (it,) = ds.streaming_split(1)
    split_rows = list(it.iter_rows())
    coords = {a["actor_id"] for a in state.list_actors()
              if a["class_name"].endswith("_SplitCoordinator")}
    coord = [mapped_torch(w["pid"]) for w in state.list_workers()
             if w["actor_id"] in coords]
    it.stop()
    print("ROWS", len(rows), len(split_rows))
    print("TASK_TORCH", any(r["torch"] for r in rows + split_rows))
    print("COORD_TORCH", coord)
    print("DRIVER_TORCH", "torch" in sys.modules)
finally:
    rt.shutdown()
"""


def test_data_pipeline_loads_no_torch(tmp_path):
    """read -> map -> take_all, and the same through streaming_split: the
    driver, the read and map tasks and the split coordinator load no
    torch (the coordinator's process maps no libtorch)."""
    import os

    script = tmp_path / "pipeline.py"
    script.write_text(_DATA_PIPELINE)
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = dict(ln.split(" ", 1) for ln in proc.stdout.splitlines()
                 if ln.split(" ", 1)[0] in ("ROWS", "TASK_TORCH",
                                            "COORD_TORCH", "DRIVER_TORCH"))
    assert lines == {"ROWS": "30 30", "TASK_TORCH": "False",
                     "COORD_TORCH": "[False]", "DRIVER_TORCH": "False"}


def test_train_job_and_runtime_env_leave_torch_unloaded():
    code = ("import sys\n"
            "import ray_tpu_torch.train, ray_tpu_torch.job, "
            "ray_tpu_torch.runtime_env\n"
            "print('torch' in sys.modules, len(ray_tpu_torch.train.__all__))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "38"]


def test_gpu_trainer_refuses_to_fall_back_to_cpu(monkeypatch):
    """ScalingConfig(use_gpu=True) makes an NCCL group, which needs a
    card: without one the worker's group init raises, it does not train
    on the CPU."""
    from ray_tpu_torch.train import ScalingConfig, TorchConfig
    from ray_tpu_torch.train.torch import _torch_process_group_init

    class Group:
        resources_per_worker = ScalingConfig(use_gpu=True).worker_resources()

    assert TorchConfig().resolved_backend(Group()) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _torch_process_group_init(0, "tcp://127.0.0.1:1", 1, "nccl", 5.0,
                                  [0])


_SERVE_PROCS = r"""
import json, os, sys, urllib.request
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.serve.controller import CONTROLLER_NAME
from ray_tpu_torch.serve.llm import llm_deployment


def loader():
    import torch
    torch.set_num_threads(1)
    from ray_tpu_torch.models import configs, init_params
    return init_params(configs.tiny, seed=0, device="cpu"), configs.tiny


def mapped(pid):
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    return {"torch": "libtorch" in maps, "cuda_driver": "libcuda.so" in maps}


def proc_info(pid):
    # (the two arguments after the interpreter, the parent pid), or None
    # for a pid that exited since /proc was listed.
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = f.read().split(b"\0")[1:3]
        with open(f"/proc/{pid}/stat") as f:
            ppid = int(f.read().rsplit(") ", 1)[1].split()[1])
    except (FileNotFoundError, ProcessLookupError):
        return None
    return argv, ppid


rt.init(num_cpus=4)
try:
    http = serve.start(port=0)["head"]["http"]
    h = serve.run(llm_deployment(loader, num_slots=2, max_len=32,
                                 default_max_new_tokens=3), name="llm")
    req = urllib.request.Request(http + "/llm",
                                 data=json.dumps({"prompt": [1, 2]}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        tokens = json.loads(r.read())["result"]
    client = worker_mod.get_client()
    info = client._run(client.raylet.call("get_info", {}), timeout=30)
    pids = {w["actor_id"]: w["pid"] for w in info["workers"] if w["actor_id"]}
    replica = rt.get(serve.get_or_create_controller().get_replicas.remote(
        "llm"), timeout=30)["replicas"][0]
    zygote = [p for p in os.listdir("/proc") if p.isdigit()
              and proc_info(p) == ([b"-m", b"ray_tpu_torch._private.zygote"],
                                   os.getpid())]
    report = {
        "tokens": tokens,
        "controller": mapped(pids[rt.get_actor(CONTROLLER_NAME)
                                  ._actor_id.binary()]),
        "proxy": mapped(pids[serve._proxy._actor_id.binary()]),
        "replica": mapped(pids[replica._actor_id.binary()]),
        "zygote": [mapped(int(p)) for p in zygote],
    }
    print("REPORT " + json.dumps(report))
finally:
    serve.shutdown()
    rt.shutdown()
"""


def test_serve_controller_and_proxy_never_load_torch(tmp_path):
    """With llm_deployment serving through the HTTP proxy, only the
    replica maps torch: the controller and the proxy, which route sealed
    user code without opening it, do not, and the zygote that forks every
    worker loads neither torch nor the CUDA driver."""
    import json
    import os

    script = tmp_path / "serve_procs.py"
    script.write_text(_SERVE_PROCS)
    env = dict(os.environ, PYTHONPATH=str(ROOT), RT_NUM_GPUS="0",
               RT_ZYGOTE_ENABLED="1")
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPORT ")]
    rep = json.loads(line[0][len("REPORT "):])
    assert len(rep["tokens"]) == 3
    assert rep["replica"]["torch"]  # the check sees torch where it is
    assert rep["controller"] == {"torch": False, "cuda_driver": False}
    assert rep["proxy"] == {"torch": False, "cuda_driver": False}
    assert rep["zygote"] == [{"torch": False, "cuda_driver": False}]


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from ray_tpu_torch.models import configs, init_params
    from ray_tpu_torch.models.generate import init_kv_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(configs.tiny, seed=0)
    with pytest.raises(RuntimeError):
        init_kv_cache(configs.tiny, 1, 8)
    params = init_params(configs.tiny, seed=0, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_missing_nvcc_raises_with_the_command(monkeypatch, tmp_path):
    from ray_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "/nonexistent/bin/nvcc")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="/nonexistent/bin/nvcc .*rmsnorm.cu"):
        _build.load("rmsnorm")
    with pytest.raises(RuntimeError, match="/nonexistent/bin/nvcc .*flash_attention.cu"):
        _build.load("flash_attention")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.kernel_names() == ["flash_attention", "rmsnorm"]


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_e1dd8ece20flash_fwd_mma_kernelILi128ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_PfiiiNS_7StridesES6_S6_S6_fi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_e1dd8ece20flash_fwd_mma_kernelILi128ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_PfiiiNS_7StridesES6_S6_S6_fi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 221 registers, used 1 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_e1dd8ece19flash_bwd_dq_kernelIfLi128ELi64ELi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iiiNS_7StridesES7_S7_S7_S7_fi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_e1dd8ece19flash_bwd_dq_kernelIfLi128ELi64ELi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iiiNS_7StridesES7_S7_S7_S7_fi
    24 bytes stack frame, 20 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 128 registers, 1024 bytes smem, 512 bytes cmem[0]
ptxas info    : Function properties for a_device_helper
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_build_report_reads_ptxas_log(monkeypatch, tmp_path):
    """The ptxas log kept beside a library gives each entry function's
    registers, spills and static shared memory; the flash report names each
    kernel's pass, route, dtype and width beside its dynamic shared memory
    (device helpers are left out)."""
    import importlib

    from ray_tpu_torch import _build
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    lib = tmp_path / "libflash_attention-0.so"
    lib.with_suffix(".log").write_text(_PTXAS_LOG)
    monkeypatch.setattr(_build, "_target", lambda name: lib)
    report = _build.ptxas_report("flash_attention")
    assert [r["registers"] for r in report] == [221, 128]
    assert report[1]["spill_stores"] == 20 and report[1]["spill_loads"] == 44
    assert report[1]["static_smem"] == 1024 and "static_smem" not in report[0]

    class Lib:
        @staticmethod
        def rt_flash_smem_bytes(pass_, dtype, d):
            return 1000 * pass_ + 100 * dtype + d

    monkeypatch.setattr(_build, "load", lambda name: Lib)
    fwd, dq = fa.kernel_report()
    assert (fwd["kernel"], fwd["pass"], fwd["route"], fwd["dtype"], fwd["d"],
            fwd["dynamic_smem"]) == ("flash_fwd_mma_kernel<128, 64>",
                                     "flash_fwd", "tensor cores", "bfloat16",
                                     128, 228)
    assert (dq["kernel"], dq["route"], dq["dtype"], dq["dynamic_smem"],
            dq["spill_loads"]) == ("flash_bwd_dq_kernel<128, 64, 64>",
                                   "CUDA cores", "float32", 1128, 44)


# The tensor-core dq kernel at d = 128 as ptxas names it for sm_90a, and
# the warpgroup dk/dv kernel beside it.
_PTXAS_LOG_DQ = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_e1dd8ece23flash_bwd_dq_mma_kernelILi128ELi64ELi1EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiiNS_7StridesES7_S7_S7_S7_fi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_e1dd8ece23flash_bwd_dq_mma_kernelILi128ELi64ELi1EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiiNS_7StridesES7_S7_S7_S7_fi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 248 registers, used 1 barriers, 512 bytes cmem[0]
"""
_PTXAS_LOG_DKV_WGMMA = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_e1dd8ece26flash_bwd_dkv_wgmma_kernelILi128ELi64ELi2EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiNS_7StridesES6_fi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__ba107a96_18_flash_attention_cu_e1dd8ece26flash_bwd_dkv_wgmma_kernelILi128ELi64ELi2EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiNS_7StridesES6_fi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 2048 bytes cmem[0]
"""


@pytest.mark.parametrize("log,want", [
    (_PTXAS_LOG_DQ, ("flash_bwd_dq_mma_kernel<128, 64, 1>", "flash_bwd_dq",
                     "tensor cores", "bfloat16", 128, 248, 0, 1228)),
    (_PTXAS_LOG_DKV_WGMMA, ("flash_bwd_dkv_wgmma_kernel<128, 64, 2>",
                            "flash_bwd_dkv", "tensor cores, wgmma",
                            "bfloat16", 128, 168, 0, 2228)),
])
def test_build_report_names_the_tensor_core_dq_kernel(monkeypatch, tmp_path,
                                                      log, want):
    """A bf16 kernel is reported under its pass and route (mma.sync's
    "tensor cores" or "tensor cores, wgmma"), with its template arguments
    (d first) and the shared memory of its pass in bf16."""
    import importlib

    from ray_tpu_torch import _build
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    lib = tmp_path / "libflash_attention-0.so"
    lib.with_suffix(".log").write_text(log)
    monkeypatch.setattr(_build, "_target", lambda name: lib)

    class Lib:
        @staticmethod
        def rt_flash_smem_bytes(pass_, dtype, d):
            return 1000 * pass_ + 100 * dtype + d

    monkeypatch.setattr(_build, "load", lambda name: Lib)
    (rec,) = fa.kernel_report()
    assert (rec["kernel"], rec["pass"], rec["route"], rec["dtype"], rec["d"],
            rec["registers"], rec["spill_stores"], rec["dynamic_smem"]) == want


_LOADGEN_DASHBOARD_MODULES = [
    "ray_tpu_torch.loadgen", "ray_tpu_torch.loadgen.workload",
    "ray_tpu_torch.loadgen.arrival", "ray_tpu_torch.loadgen.trace",
    "ray_tpu_torch.loadgen.client", "ray_tpu_torch.loadgen.reconcile",
    "ray_tpu_torch.loadgen.runner", "ray_tpu_torch.dashboard",
    "ray_tpu_torch.dashboard.dashboard", "ray_tpu_torch.dashboard.grafana",
    "ray_tpu_torch._private.http11"]


@pytest.mark.parametrize("module", _LOADGEN_DASHBOARD_MODULES)
def test_loadgen_and_dashboard_modules_import_no_torch_jax_or_ray_tpu(module):
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _maps_libtorch(pid):
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    """A node from `rt start --head` with its dashboard on a free port."""
    import json
    import os

    tmp = tmp_path_factory.mktemp("rt_head")
    env = dict(os.environ, TMPDIR=str(tmp), RT_NUM_GPUS="0",
               PYTHONPATH=str(ROOT))

    def cli(*args):
        proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, (args, proc.stderr[-3000:])
        return proc.stdout

    cli("start", "--head", "--num-cpus", "4", "--dashboard-port", "0")
    sess = json.loads((tmp / "ray_tpu_torch" / "session.json").read_text())
    yield env, sess
    cli("stop")


def test_the_dashboard_of_rt_start_maps_no_libtorch(head):
    import json
    import urllib.request

    _, sess = head
    url = f"http://127.0.0.1:{sess['dashboard_port']}"
    with urllib.request.urlopen(url + "/api/nodes", timeout=30) as r:
        assert [n["state"] for n in json.loads(r.read())] == ["ALIVE"]
    assert len(sess["pids"]) == 3
    assert not _maps_libtorch(sess["pids"][-1])


_LOADGEN_RUN = r"""
import json, os, subprocess, sys, tempfile, time
import ray_tpu_torch as rt
from ray_tpu_torch import serve

rt.init(address=sys.argv[1], num_cpus=0)


@serve.deployment(name="Sleeper")
class Sleeper:
    def __call__(self, request):
        for i in range(int(request["max_tokens"]) % 4 + 1):
            time.sleep(0.01)
            yield i


serve.run(Sleeper.bind(), name="S")
tmp = tempfile.mkdtemp()
trace = os.path.join(tmp, "trace.jsonl")
cli = [sys.executable, "-m", "ray_tpu_torch", "loadgen"]
subprocess.run(cli + ["gen", trace, "--closed", "--requests", "20",
                      "--concurrency", "4"], check=True, timeout=120)
proc = subprocess.Popen(cli + ["run", trace, "--app", "S", "--address",
                               sys.argv[1]], stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True)
reads, mapped = 0, False
while proc.poll() is None:
    try:
        with open(f"/proc/{proc.pid}/maps") as f:
            mapped |= "libtorch" in f.read()
        reads += 1
    except OSError:
        pass
    time.sleep(0.05)
out, err = proc.communicate()
serve.shutdown()
print("RESULT " + json.dumps({"rc": proc.returncode, "reads": reads,
                              "mapped": mapped, "out": out[-2000:],
                              "err": err[-2000:]}))
"""


def test_a_loadgen_run_process_maps_no_libtorch(head, tmp_path):
    import json

    env, sess = head
    script = tmp_path / "loadgen_run.py"
    script.write_text(_LOADGEN_RUN)
    proc = subprocess.run([sys.executable, str(script), sess["gcs_address"]],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[0][len("RESULT "):])
    # The CLI exits 1 exactly when the reconciler's gap gate fails, as
    # the JAX package's does; for 10 ms requests it may.
    assert res["rc"] == (0 if "-> PASS" in res["out"] else 1), res
    assert '"issued": 20' in res["out"] and '"errors": 0' in res["out"]
    assert res["reads"] > 0 and not res["mapped"], res

