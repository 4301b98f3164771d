"""Build the hand-written CUDA kernels in `csrc/` and load them.

Each `csrc/<name>.cu` compiles with one `nvcc` call into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
no ninja: a build takes seconds). Libraries land in `ray_tpu_torch/_build/`
under a name keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. `build_all()` starts one
`nvcc` per source at once and waits for all of them. nvcc runs with
`-Xptxas -v`; its log is kept beside the library, and `ptxas_report()`
reads each kernel's registers, static shared memory and spills from it.

Nothing here runs at import: the CPU tests import every module, and this
host may have no `nvcc` at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple:
    """Start one nvcc; returns (process, temp output, final output, cmd)."""
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"cannot build the CUDA kernel {name!r}: nvcc not found; "
            f"tried: {' '.join(cmd)}") from e
    return proc, tmp, out, cmd


def _finish(name: str, proc, tmp: Path, out: Path, cmd: List[str]) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name!r} (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> List[str]:
    """Build every kernel that is not built yet, all nvcc calls at once.
    Returns the names it compiled."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in kernel_names() if not _target(n).exists()]
        started = []
        try:
            for n in todo:
                started.append((n, *_start(n)))
        finally:
            for n, proc, tmp, out, cmd in started:
                _finish(n, proc, tmp, out, cmd)
        return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _finish(name, *_start(name))
            lib = _libs[name] = ctypes.CDLL(str(out))
    return lib


_PTXAS_PATTERNS = (
    ("stack", re.compile(r"(\d+) bytes stack frame")),
    ("spill_stores", re.compile(r"(\d+) bytes spill stores")),
    ("spill_loads", re.compile(r"(\d+) bytes spill loads")),
    ("registers", re.compile(r"Used (\d+) registers")),
    ("static_smem", re.compile(r"(\d+) bytes smem")),
)


def ptxas_report(name: str) -> List[dict]:
    """Each entry function of `csrc/<name>.cu` as ptxas reported it when
    the library was built: {"kernel": mangled name, "registers",
    "spill_stores", "spill_loads", "stack", "static_smem"} (bytes; dynamic
    shared memory is the launcher's and is not in the log)."""
    log = _target(name).with_suffix(".log").read_text()
    entries: Dict[str, dict] = {}
    kernels = []
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernels.append(m.group(1))
        m = m or re.search(r"Function properties for (\S+)", line)
        if m:
            current = entries.setdefault(m.group(1), {"kernel": m.group(1)})
            continue
        if current is None:
            continue
        for key, pat in _PTXAS_PATTERNS:
            m = pat.search(line)
            if m:
                current[key] = int(m.group(1))
    return [entries[k] for k in dict.fromkeys(kernels)]
