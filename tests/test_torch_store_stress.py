"""Multi-process stress of the port's shared-memory object store
(ray_tpu_torch/native/object_store.cc), the counterpart of
tests/test_store_stress.py: four processes create, seal, read, release
and delete at random in one store; one process does the same against the
store built with AddressSanitizer; and the JAX package's 8-thread
harness (store_thread_test.cc) runs against the port's store under
ThreadSanitizer. The sanitizer builds go to ray_tpu_torch/_build/
sanitizers/ (not committed). `slow`, as the JAX file is.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow  # chaos/e2e tier — fast runs skip

from ray_tpu_torch._private.object_store import ObjectStore  # noqa: E402
from tests.test_torch_native_sanitizers import (  # noqa: E402
    BUILD, STORE, thread_test)

_WORKER = textwrap.dedent(
    """
    import os, random, sys, hashlib
    sys.path.insert(0, {repo!r})
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import ObjectStore
    from ray_tpu_torch.exceptions import ObjectStoreFullError

    store_name, seed, n_ops = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    rng = random.Random(seed)
    store = ObjectStore(store_name)
    mine = []  # (oid, payload_checksum, size)
    ok_reads = creates = deletes = full = 0
    for op in range(n_ops):
        r = rng.random()
        if r < 0.45 or not mine:
            # create + seal an object of random size
            oid = ObjectID.from_random()
            size = rng.randrange(64, 256 * 1024)
            payload = bytes([op % 256]) * size
            try:
                buf = store.create(oid, size)
            except ObjectStoreFullError:
                full += 1
                # delete something of ours to make progress
                if mine:
                    oid2, _, _ = mine.pop(rng.randrange(len(mine)))
                    store.delete(oid2)
                continue
            buf[:] = payload
            store.seal(oid)
            store.release(oid)
            mine.append((oid, payload[:16], size))
            creates += 1
        elif r < 0.85:
            # read-verify one of ours (it may have been LRU-evicted)
            oid, head, size = mine[rng.randrange(len(mine))]
            view = store.get(oid)
            if view is not None:
                assert len(view) == size, (len(view), size)
                assert bytes(view[:16]) == head, "payload corrupted"
                del view
                store.release(oid)
                ok_reads += 1
        else:
            idx = rng.randrange(len(mine))
            oid, _, _ = mine.pop(idx)
            store.delete(oid)
            deletes += 1
    store.close(unmap=True)
    print(f"creates={{creates}} reads={{ok_reads}} deletes={{deletes}} full={{full}}")
    """
).format(repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_multiprocess_create_get_delete_stress(tmp_path):
    name = f"/rttorch_stress_{os.getpid()}"
    store = ObjectStore(name, create=True, size=32 * 1024 * 1024)
    try:
        script = tmp_path / "stress_worker.py"
        script.write_text(_WORKER)
        procs = [
            subprocess.Popen(
                [sys.executable, str(script), name, str(seed), "400"],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                env={**os.environ},
            )
            for seed in range(4)
        ]
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, (
                f"stress worker died rc={p.returncode}\n"
                f"stdout: {out.decode()}\nstderr: {err.decode()[-2000:]}"
            )
            assert b"creates=" in out
        stats = store.stats()
        assert stats["num_objects"] >= 0  # header still consistent
    finally:
        store.destroy()


def test_stress_under_asan_if_available(tmp_path):
    """One stress worker against the port's store built with ASAN, where
    g++ and libasan exist."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    BUILD.mkdir(parents=True, exist_ok=True)
    asan_lib = BUILD / "libobject_store_asan.so"
    r = subprocess.run(
        ["g++", "-O1", "-g", "-fPIC", "-std=c++17", "-fsanitize=address",
         "-fno-omit-frame-pointer", "-shared", "-o", str(asan_lib),
         str(STORE), "-lpthread", "-lrt", "-fsanitize=address"],
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        pytest.skip(f"no ASAN toolchain: {r.stderr[-200:]}")
    p = subprocess.run(
        ["gcc", "-print-file-name=libasan.so"], capture_output=True, text=True
    )
    libasan = p.stdout.strip()
    if not libasan or not os.path.exists(libasan):
        pytest.skip("libasan.so not found")

    name = f"/rttorch_asan_{os.getpid()}"
    env = {
        **os.environ,
        "RT_STORE_LIB": str(asan_lib),
        "LD_PRELOAD": libasan,
        "ASAN_OPTIONS": "detect_leaks=0,abort_on_error=1",
    }
    boot = tmp_path / "boot.py"
    boot.write_text(
        _WORKER.replace(
            'store = ObjectStore(store_name)',
            'store = ObjectStore(store_name, create=True, '
            'size=16 * 1024 * 1024)',
        )
    )
    p = subprocess.run(
        [sys.executable, str(boot), name, "1", "600"],
        capture_output=True, timeout=300, env=env,
    )
    shm = f"/dev/shm/{name.lstrip('/')}"
    if os.path.exists(shm):
        os.unlink(shm)
    assert p.returncode == 0, (
        f"ASAN stress failed rc={p.returncode}\n"
        f"stderr: {p.stderr.decode()[-3000:]}"
    )
    assert b"AddressSanitizer" not in p.stderr


def test_multithreaded_store_under_tsan_if_available():
    """8 threads hammer create/seal/get/release/delete on one port store
    under ThreadSanitizer. Skips where the toolchain lacks
    -fsanitize=thread."""
    probe = subprocess.run(
        ["g++", "-fsanitize=thread", "-x", "c++", "-", "-o", "/dev/null"],
        input=b"int main(){return 0;}", capture_output=True,
    )
    if probe.returncode != 0:
        pytest.skip("toolchain lacks -fsanitize=thread")
    out = thread_test("tsan")
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "STORE THREAD TESTS OK" in out.stdout
    assert "WARNING: ThreadSanitizer" not in out.stderr
