"""The PyTorch port stands alone: it loads neither JAX nor any module of
ray_tpu, and it never falls back to the CPU on its own."""

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
    assert int(line[0].split()[1]) >= 14


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
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.kernel_names() == ["rmsnorm"]
