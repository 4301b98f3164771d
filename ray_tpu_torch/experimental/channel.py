"""Mutable shared-memory channels for compiled DAGs.

Analog of the reference's ``ray.experimental.channel.Channel``
(experimental/channel.py:49) which backs compiled-DAG edges with *mutable*
plasma objects (experimental_mutable_object_put_serialized :129,
read-release :159). Here a channel is one single-producer single-consumer
slot in POSIX shared memory with sequence-number handoff: a write blocks
until the previous value is consumed; a read blocks until a value arrives.
Same-host only — exactly the compiled-DAG fast path (pipeline stages
co-located on one host); cross-host edges fall back to RPC.

Values are pickled. A CUDA tensor pickles with its `cuda` location, so
a reader without a card cannot load it: move a value to the CPU (a
tensor or a numpy array) at a stage boundary whose reader may hold no
card. A CPU tensor reads back as an equal CPU tensor.

Layout: [wseq u64][rseq u64][length u64][flags u64][payload ...]
x86/ARM store ordering + the seq handoff makes the payload visible before
the reader observes the incremented wseq.
"""

from __future__ import annotations

import pickle
import struct
import time
from multiprocessing import shared_memory
from typing import Any, Optional

_HDR = struct.Struct("<QQQQ")
_CLOSED_FLAG = 1


class ChannelClosed(Exception):
    pass


class Channel:
    """One SPSC slot. Create once (driver), attach by name elsewhere."""

    def __init__(self, name: Optional[str] = None, max_size: int = 10_000_000,
                 create: bool = False):
        if create:
            import uuid

            name = name or f"rtchan_{uuid.uuid4().hex[:16]}"
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=_HDR.size + max_size
            )
            self._shm.buf[: _HDR.size] = _HDR.pack(0, 0, 0, 0)
        else:
            assert name is not None
            self._shm = shared_memory.SharedMemory(name=name)
            # CPython's resource tracker would unlink the segment when THIS
            # process exits, yanking it from under the creator — standard
            # workaround: attachers unregister (bpo-38119).
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(self._shm._name, "shared_memory")
            except Exception:
                pass
        self.name = name
        self.max_size = self._shm.size - _HDR.size
        self._owner = create

    # -- header access ---------------------------------------------------
    # Each field is written only by its owner (writer: wseq+length, reader:
    # rseq, closer: flags) at its own offset — never a full-header rewrite,
    # which would clobber a concurrent close() with a stale snapshot.
    _WSEQ, _RSEQ, _LEN, _FLAGS = 0, 8, 16, 24

    def _hdr(self):
        return _HDR.unpack_from(self._shm.buf, 0)

    def _put_u64(self, offset: int, value: int):
        struct.pack_into("<Q", self._shm.buf, offset, value)

    # -- ops --------------------------------------------------------------
    def write(self, value: Any, timeout: float = 30.0):
        data = pickle.dumps(value, protocol=5)
        if len(data) > self.max_size:
            raise ValueError(
                f"value of {len(data)} bytes exceeds channel capacity "
                f"{self.max_size}; size the channel's max_size accordingly"
            )
        deadline = time.monotonic() + timeout
        while True:
            wseq, rseq, _, flags = self._hdr()
            if flags & _CLOSED_FLAG:
                raise ChannelClosed(self.name)
            if wseq == rseq:  # previous value consumed
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"channel {self.name} write timed out")
            time.sleep(0.0001)
        self._shm.buf[_HDR.size : _HDR.size + len(data)] = data
        self._put_u64(self._LEN, len(data))
        self._put_u64(self._WSEQ, wseq + 1)  # publish last

    def read(self, timeout: float = 30.0) -> Any:
        deadline = time.monotonic() + timeout
        while True:
            wseq, rseq, length, flags = self._hdr()
            if wseq != rseq:
                break
            if flags & _CLOSED_FLAG:
                raise ChannelClosed(self.name)
            if time.monotonic() > deadline:
                raise TimeoutError(f"channel {self.name} read timed out")
            time.sleep(0.0001)
        data = bytes(self._shm.buf[_HDR.size : _HDR.size + length])
        value = pickle.loads(data)
        self._put_u64(self._RSEQ, rseq + 1)
        return value

    def close(self):
        try:
            (flags,) = struct.unpack_from("<Q", self._shm.buf, self._FLAGS)
            self._put_u64(self._FLAGS, flags | _CLOSED_FLAG)
        except Exception:
            pass

    def destroy(self):
        self.close()
        try:
            self._shm.close()
        except Exception:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

    def detach(self):
        try:
            self._shm.close()
        except Exception:
            pass

    def __reduce__(self):
        # Attach-by-name on the receiving side.
        return (_attach, (self.name,))


def _attach(name: str) -> Channel:
    return Channel(name=name)
