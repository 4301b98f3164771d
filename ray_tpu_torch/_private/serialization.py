"""Object serialization with zero-copy buffer support.

Analog of python/ray/_private/serialization.py in the reference:
cloudpickle for arbitrary Python objects plus pickle protocol 5 out-of-band
buffers so large numpy arrays are written into (and read from) the
shared-memory object store without copies; CPU torch tensors ride torch's
own pickling.

Wire layout of a serialized object:

    u32 magic | u32 pickle_len | u32 nbuffers |
    nbuffers * u64 buffer_len |
    pickle bytes | pad to 64 | buffer0 | pad to 64 | buffer1 | ...

Buffers are 64-byte aligned so numpy views over shared memory are
vector-load friendly on the host side before a copy to the card.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, List, Tuple

from ray_tpu_torch._vendor import cloudpickle

_MAGIC = 0x52545031  # "RTP1" — pickle + out-of-band buffers
_MAGIC_XLANG = 0x52545831  # "RTX1" — msgpack payload (cross-language)
_ALIGN = 64


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class SerializedObject:
    """A serialized value: metadata pickle plus out-of-band buffers."""

    __slots__ = ("pickled", "buffers")

    def __init__(self, pickled: bytes, buffers: List[pickle.PickleBuffer]):
        self.pickled = pickled
        self.buffers = buffers

    @property
    def total_size(self) -> int:
        size = 12 + 8 * len(self.buffers)
        size = _pad(size + len(self.pickled))
        for b in self.buffers:
            size = _pad(size + len(b.raw()))
        return size

    def write_into(self, dest: memoryview) -> int:
        """Write the framed object into `dest`; returns bytes written."""
        raws = [b.raw() for b in self.buffers]
        header = struct.pack(
            f"<III{len(raws)}Q",
            _MAGIC,
            len(self.pickled),
            len(raws),
            *[len(r) for r in raws],
        )
        off = len(header)
        dest[:off] = header
        dest[off : off + len(self.pickled)] = self.pickled
        off = _pad(off + len(self.pickled))
        for r in raws:
            dest[off : off + len(r)] = r
            off = _pad(off + len(r))
        return off

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_size)
        n = self.write_into(memoryview(out))
        return bytes(out[:n])


def serialize(value: Any) -> SerializedObject:
    buffers: List[pickle.PickleBuffer] = []

    def buffer_callback(buf: pickle.PickleBuffer):
        # Only take the out-of-band path for buffers big enough to matter;
        # small ones are cheaper inline in the pickle stream.
        if buf.raw().nbytes >= 1024:
            buffers.append(buf)
            return False  # out-of-band
        return True  # in-band

    pickled = cloudpickle.dumps(
        value, protocol=pickle.HIGHEST_PROTOCOL, buffer_callback=buffer_callback
    )
    return SerializedObject(pickled, buffers)


def deserialize(data: memoryview, wrap=None) -> Any:
    """Deserialize from a framed buffer.

    Out-of-band buffers are reconstructed as memoryviews into `data` —
    zero-copy when `data` maps shared memory — each passed through
    `wrap(view)` when given. The caller is responsible for keeping the
    backing store pinned while any of them is alive (the object store
    client wraps each view in an exporter whose lifetime holds the pin).
    """
    if len(data) < 4:
        raise ValueError("corrupt serialized object (too short)")
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic == _MAGIC_XLANG:
        # Cross-language (RTX1) payloads can be tiny (5 bytes for None) —
        # decode before touching the larger RTP1 header. The memoryview
        # slice feeds msgpack without copying the payload.
        from ray_tpu_torch._vendor import msgpack

        return msgpack.unpackb(data[4:], raw=False, strict_map_key=False)
    if magic != _MAGIC:
        raise ValueError("corrupt serialized object (bad magic)")
    _, pickle_len, nbuf = struct.unpack_from("<III", data, 0)
    lens = struct.unpack_from(f"<{nbuf}Q", data, 12)
    off = 12 + 8 * nbuf
    pickled = bytes(data[off : off + pickle_len])
    off = _pad(off + pickle_len)
    bufs = []
    for ln in lens:
        view = data[off : off + ln]
        bufs.append(view if wrap is None else wrap(view))
        off = _pad(off + ln)
    return pickle.loads(pickled, buffers=bufs)


def serialize_xlang(value: Any) -> bytes:
    """Serialize as a cross-language (RTX1/msgpack) object.

    Any client that speaks msgpack — the C++ API in cpp/, or a remote
    driver in another language — can read these; `deserialize` handles
    them transparently on the Python side (the reference's cross-language
    serialization role, java/C++ <-> python object passing)."""
    from ray_tpu_torch._vendor import msgpack

    return struct.pack("<I", _MAGIC_XLANG) + msgpack.packb(
        value, use_bin_type=True
    )


def serialize_to_bytes(value: Any) -> bytes:
    return serialize(value).to_bytes()


def deserialize_from_bytes(data: bytes) -> Any:
    return deserialize(memoryview(data))
