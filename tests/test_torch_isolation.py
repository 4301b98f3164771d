"""The PyTorch port stands alone: it loads neither JAX nor any module of
ray_tpu (serving and one training step included), and it never falls back
to the CPU on its own."""

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


def test_no_source_imports_jax_or_ray_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ray_tpu)\b", re.M)
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []


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
