"""Tensors in and out of the collective layer.

Every group takes what its caller holds: a torch tensor on any device or
a numpy array (a numpy bfloat16 array too, read through its raw 2-byte
view, so the port never imports the package that defines that dtype).
`as_torch` gives a contiguous torch tensor and a function that turns a
result back into the caller's kind, on the caller's device.

On the wire a dtype travels as a tag: numpy's dtype string ("<f4") for
every dtype numpy has, and "bf16" for bfloat16, which numpy lacks.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

BF16_TAG = "bf16"


@functools.lru_cache(maxsize=None)
def dtype_tag(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return BF16_TAG
    return torch.empty(0, dtype=dtype).numpy().dtype.str


@functools.lru_cache(maxsize=None)
def tag_dtype(tag: str) -> torch.dtype:
    if tag == BF16_TAG:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=np.dtype(tag))).dtype


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for the dtype ("float32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def _numpy_bf16():
    try:
        return np.dtype("bfloat16")  # registered where ml_dtypes is loaded
    except TypeError:
        return None


def as_torch(x) -> Tuple[torch.Tensor, Callable]:
    """(tensor, back): `x` as a contiguous torch tensor (a numpy array is
    viewed, not copied, where it is contiguous), and `back(t)` giving a
    result in the kind and on the device `x` came in."""
    if isinstance(x, torch.Tensor):
        dev = x.device

        def back(t):
            return t if t.device == dev else t.to(dev)

        return x.detach().contiguous(), back
    a = np.ascontiguousarray(x)
    bf16 = a.dtype if a.dtype.name == "bfloat16" else None
    if bf16 is not None:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)

    def back(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            np_bf16 = bf16 if bf16 is not None else _numpy_bf16()
            if np_bf16 is None:
                return t
            return t.contiguous().view(torch.int16).numpy().view(np_bf16)
        return t.numpy()

    return t, back


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of a card tensor, staged through pinned memory (the CPU
    tensor itself where it already is one)."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def raw_bytes(t: torch.Tensor) -> memoryview:
    """The bytes of a contiguous CPU tensor, without a copy."""
    flat = t.reshape(-1)
    if flat.numel() == 0:
        return memoryview(b"")
    return memoryview(flat.view(torch.uint8).numpy())


def from_bytes(buf, dtype: torch.dtype, shape) -> torch.Tensor:
    """A CPU tensor over a received buffer (bytearray), without a copy."""
    if len(buf) == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)
