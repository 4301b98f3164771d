"""Serialization tests of the port: tests/test_serialization.py run
against ray_tpu_torch, plus the vendored msgpack held to the installed one
(the wire bytes must not change: the C++ client and the cross-language
objects read them) and CPU torch tensors through the object format."""

import msgpack as site_msgpack
import numpy as np
import pytest
import torch

from ray_tpu._private import protocol as jax_protocol
from ray_tpu._private import serialization as jax_ser
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._vendor import msgpack


def test_roundtrip_basic():
    value = {"a": 1, "b": [1, 2, 3], "c": "hello", "d": (4, 5)}
    assert ser.deserialize_from_bytes(ser.serialize_to_bytes(value)) == value


def test_roundtrip_numpy_zero_copy():
    arr = np.random.rand(1000, 100)
    data = ser.serialize_to_bytes({"x": arr})
    out = ser.deserialize_from_bytes(data)["x"]
    assert np.array_equal(out, arr)


def test_small_arrays_inline():
    arr = np.arange(10)
    so = ser.serialize(arr)
    assert len(so.buffers) == 0  # tiny buffers ride inline


def test_large_arrays_out_of_band():
    arr = np.zeros(100_000)
    so = ser.serialize(arr)
    assert len(so.buffers) == 1


def test_closure_roundtrip():
    x = 42

    def f(y):
        return x + y

    g = ser.deserialize_from_bytes(ser.serialize_to_bytes(f))
    assert g(1) == 43


# Protocol-shaped frames: request/response/push maps with nested maps,
# bin payloads, str keys and values, ints at every msgpack width (fixint,
# uint8..uint64, negative fixint, int8..int64), floats, bools and None.
_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
         2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
         -2**31 - 1, -2**63]
FRAMES = [
    {"k": "req", "i": 7, "m": "submit_task", "d": {
        "task_id": b"\x01" * 24, "fn_key": b"\xff" * 20, "args": [b"", b"x" * 300],
        "resources": {"CPU": 1.0, "GPU": 0.5}, "name": "f", "num_returns": 1,
        "max_retries": 3, "runtime_env": None, "sampled": False}},
    {"k": "resp", "i": 2**31, "d": {"ok": True, "returns": [
        {"kind": "inline", "data": b"\x00" * 70000},
        {"kind": "store", "size": 2**33, "object_id": b"\x02" * 28}]}},
    {"k": "push", "c": "actor_update:ab", "d": {"state": "ALIVE", "nested": {
        "a": {"b": {"c": [1.5, -0.0, float("inf"), 1e-310, None, True]}}}}},
    {"ints": _INTS, "neg_map": {-5: "x", 2**40: "y"}},
    {"s": "é" * 40, "long_s": "z" * 70000, "bin8": b"b" * 255,
     "bin16": b"b" * 256, "list16": list(range(16)), "map16": {str(i): i for i in range(16)}},
    [],
    {},
    None,
]


@pytest.mark.parametrize("frame", FRAMES, ids=range(len(FRAMES)))
def test_vendored_msgpack_packs_the_same_bytes(frame):
    ours = msgpack.packb(frame, use_bin_type=True)
    assert ours == site_msgpack.packb(frame, use_bin_type=True)
    assert protocol.pack_frame(frame) == jax_protocol.pack_frame(frame)
    for data in (ours, memoryview(ours)):
        assert (msgpack.unpackb(data, raw=False, strict_map_key=False)
                == site_msgpack.unpackb(ours, raw=False, strict_map_key=False))


def test_vendored_msgpack_is_the_pure_python_fallback():
    from ray_tpu_torch._vendor.msgpack import fallback

    assert msgpack.Packer is fallback.Packer
    assert msgpack.unpackb is fallback.unpackb
    assert msgpack.__version__ == "1.1.2"


@pytest.mark.parametrize("value", [None, 5, -2**40, "s", b"\x00\x01",
                                   [1, {"a": b"x"}], {"k": 1.25}])
def test_cross_language_objects_match_the_reference(value):
    data = ser.serialize_xlang(value)
    assert data == jax_ser.serialize_xlang(value)
    assert ser.deserialize(memoryview(data)) == value
    assert jax_ser.deserialize(memoryview(data)) == value


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16,
                                   torch.int64, torch.bool])
def test_cpu_torch_tensor_roundtrip_bit_equal(dtype):
    g = torch.Generator().manual_seed(0)
    t = (torch.randn(64, 33, generator=g) * 100).to(dtype)
    value = {"t": t, "view": t[:, 1::2], "scalar": t[3, 4].clone()}
    out = ser.deserialize_from_bytes(ser.serialize_to_bytes(value))
    for k in value:
        assert out[k].dtype == value[k].dtype
        assert out[k].shape == value[k].shape
        assert torch.equal(_bits(out[k]), _bits(value[k]))


def _bits(t):
    """The tensor's bytes, so NaN and -0.0 compare by bit pattern."""
    return t.reshape(-1).contiguous().view(torch.uint8)


def test_cpu_torch_tensor_through_the_store_format_is_bit_equal():
    t = torch.arange(1 << 18, dtype=torch.float32).reshape(512, 512) / 3
    so = ser.serialize(t)
    buf = bytearray(so.total_size)
    so.write_into(memoryview(buf))
    out = ser.deserialize(memoryview(buf))
    assert torch.equal(out, t)
