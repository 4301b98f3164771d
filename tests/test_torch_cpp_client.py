"""The C++ client (cpp/) against the port's runtime: the cases of
tests/test_cpp_client.py with a ray_tpu_torch head, and the demo run
against a JAX head too, whose output must equal the port's line for line
(ids masked).

The client is built with g++ and the flags of cpp/Makefile, by
chip_smoke.py's helper, into a directory of this module's own (cpp/build/
belongs to the JAX file's `make`, which may run at the same time in
another xdist worker); cpp/ itself is used unchanged.
"""

import os
import re
import subprocess

import pytest

import ray_tpu_torch as rt


@pytest.fixture(scope="module")
def cpp_build(tmp_path_factory):
    """rt_demo and msgpack_test, built by chip_smoke.py's helper (one g++
    per source, all started together) into this module's own directory."""
    import chip_smoke

    out = tmp_path_factory.mktemp("cpp_build")
    return chip_smoke.finish_cpp_build(chip_smoke.start_cpp_build(
        str(out), ("rt_demo", "msgpack_test")))


@pytest.fixture
def rt_start():
    rt.init(num_cpus=4, num_gpus=0)
    yield rt
    rt.shutdown()


def test_rtx1_roundtrip_python_side():
    from ray_tpu._private import serialization as jax_ser
    from ray_tpu_torch._private import serialization as ser

    value = {"kind": "xlang", "nums": [1, 2, 3.5], "blob": b"\x00\x01"}
    raw = ser.serialize_xlang(value)
    assert raw[:4] == b"1XTR"  # u32 0x52545831 ("RTX1") little-endian
    assert raw == jax_ser.serialize_xlang(value)
    assert ser.deserialize_from_bytes(raw) == value


def test_rtx1_tiny_payloads():
    """RTX1 frames can be shorter than the RTP1 12-byte header — None is
    5 bytes; deserialize must dispatch on the 4-byte magic first."""
    from ray_tpu_torch._private import serialization as ser

    for value in (None, 0, 5, True, "", b""):
        assert ser.deserialize_from_bytes(ser.serialize_xlang(value)) == value


def _submit(fn_name, plain_args):
    client = rt._worker.get_client()
    spec = {
        "task_id": os.urandom(16),
        "job_id": client.job_id.binary(),
        "name": fn_name,
        "fn_name": fn_name,
        "plain_args": plain_args,
        "deps": [],
        "num_returns": 1,
        "resources": {"CPU": 1.0},
        "retriable": False,
    }
    return client._run(client.raylet.call("submit_task", spec, timeout=120))


def test_cross_language_task_returning_none(rt_start):
    """A fn_name task whose result msgpack-encodes under 12 bytes must
    round-trip."""
    from ray_tpu_torch._private import serialization as ser

    result = _submit("builtins:print", ["xlang"])
    assert result["status"] == "ok"
    assert ser.deserialize_from_bytes(result["returns"][0]["data"]) is None


def test_cross_language_task_from_python(rt_start):
    """The fn_name task path works from any frontend; drive it from Python
    by submitting a raw spec through the driver's raylet."""
    from ray_tpu_torch._private import serialization as ser

    result = _submit("math:hypot", [3.0, 4.0])
    assert result["status"] == "ok"
    [entry] = result["returns"]
    assert entry["kind"] == "inline"
    assert ser.deserialize_from_bytes(entry["data"]) == 5.0


_HEX = re.compile(r"\b[0-9a-f]{16,}\b")


def _demo_against(pkg, demo):
    """Start a head of `pkg`, name a Counter actor, run rt_demo against it;
    returns the demo's masked output lines and the counter after."""
    import importlib

    mod = importlib.import_module(pkg)
    kwargs = {"num_cpus": 4}
    if pkg == "ray_tpu_torch":
        kwargs["num_gpus"] = 0
    mod.init(**kwargs)
    try:
        @mod.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, x):
                self.n += x
                return self.n

        c = Counter.options(name="cpp-counter").remote()
        mod.get(c.add.remote(0), timeout=60)  # ready and addressable
        node = mod._node
        out = subprocess.run(
            [demo, node.gcs_host, str(node.gcs_port), "cpp-counter"],
            capture_output=True, text=True, timeout=300,
        )
        after = mod.get(c.add.remote(0), timeout=60)
    finally:
        mod.shutdown()
    assert out.returncode == 0, (pkg, out.stdout, out.stderr)
    return [_HEX.sub("<id>", ln) for ln in out.stdout.splitlines()], after


def test_cpp_demo_end_to_end(cpp_build):
    """rt_demo against a port head: KV, object put/get, cross-language
    submit, error propagation and a stateful cross-language actor call;
    the same output as against a JAX head."""
    lines, counter = _demo_against("ray_tpu_torch", cpp_build["rt_demo"])
    assert "CPP ACTOR OK" in lines
    assert "CPP CLIENT OK" in lines
    # The C++ calls mutated the SAME actor instance Python sees.
    assert counter == 42
    jax_lines, jax_counter = _demo_against("ray_tpu", cpp_build["rt_demo"])
    assert lines == jax_lines
    assert jax_counter == counter


def test_cpp_put_readable_from_python(rt_start):
    """Interop: RTX1 objects written through the client_put path (what the
    C++ client's Put does) read back identically through client_get_info /
    fetch_chunk (what its Get does), and Python's deserializer reads them."""
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch._private.ids import ObjectID

    client = rt._worker.get_client()
    oid = ObjectID.from_random()
    raw = ser.serialize_xlang({"who": "python", "n": 7})
    ok = client._run(client.raylet.call(
        "client_put", {"object_id": oid.binary(), "data": raw}, timeout=60))
    assert ok["ok"]
    info = client._run(client.raylet.call(
        "client_get_info", {"object_id": oid.binary()}, timeout=60))
    assert info["ok"] and info["size"] == len(raw)
    chunk = client._run(client.raylet.call(
        "fetch_chunk",
        {"object_id": oid.binary(), "offset": 0, "size": info["size"]},
        timeout=60))
    assert ser.deserialize_from_bytes(chunk["data"]) == {
        "who": "python", "n": 7,
    }


def test_cpp_msgpack_unit_tests(cpp_build):
    """The native codec's own unit suite (format edges, length tiers,
    truncation rejection)."""
    out = subprocess.run([cpp_build["msgpack_test"]], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "MSGPACK TESTS OK" in out.stdout
