"""The port's native store under the sanitizers (opt-in: `pytest -m
sanitizer`), the counterpart of tests/test_native_sanitizers.py.

The JAX package's 8-thread create/seal/get/release/delete harness
(ray_tpu/native/store_thread_test.cc, read as it is) is compiled against
the port's store (ray_tpu_torch/native/object_store.cc) under
ThreadSanitizer and UndefinedBehaviorSanitizer, into the port's build
directory (ray_tpu_torch/_build/sanitizers/, not committed). Any TSan
race report or UBSan diagnostic makes the binary exit non-zero
(-fno-sanitize-recover), so a regression in the store's locking or offset
arithmetic fails the test with the sanitizer report in its message.
"""

import pathlib
import shutil
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
HARNESS = ROOT / "ray_tpu" / "native" / "store_thread_test.cc"
STORE = ROOT / "ray_tpu_torch" / "native" / "object_store.cc"
BUILD = ROOT / "ray_tpu_torch" / "_build" / "sanitizers"

pytestmark = pytest.mark.sanitizer

needs_toolchain = pytest.mark.skipif(
    shutil.which("g++") is None, reason="needs g++")

FLAGS = {
    "tsan": ["-fsanitize=thread"],
    "ubsan": ["-fsanitize=undefined", "-fno-sanitize-recover=undefined"],
}


def thread_test(kind: str) -> subprocess.CompletedProcess:
    """Build the harness against the port's store under `kind` (also
    "plain": no sanitizer) and run it."""
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = BUILD / f"store_thread_test_{kind}"
    build = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", *FLAGS.get(kind, []),
         "-fno-omit-frame-pointer", "-o", str(exe), str(HARNESS), str(STORE),
         "-lpthread", "-lrt"], capture_output=True, text=True, timeout=600)
    if build.returncode != 0:
        return build
    return subprocess.run([str(exe)], capture_output=True, text=True,
                          timeout=600)


@needs_toolchain
def test_store_stress_under_tsan():
    r = thread_test("tsan")
    assert r.returncode == 0, f"TSan run failed:\n{r.stdout}\n{r.stderr}"
    assert "STORE THREAD TESTS OK" in r.stdout
    assert "WARNING: ThreadSanitizer" not in r.stdout + r.stderr


@needs_toolchain
def test_store_stress_under_ubsan():
    r = thread_test("ubsan")
    assert r.returncode == 0, f"UBSan run failed:\n{r.stdout}\n{r.stderr}"
    assert "STORE THREAD TESTS OK" in r.stdout
    assert "runtime error" not in r.stdout + r.stderr
