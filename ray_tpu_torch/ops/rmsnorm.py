"""RMSNorm: a hand-written CUDA forward kernel and its plain PyTorch version.

Counterpart of ray_tpu/ops/rmsnorm.py. The CUDA kernel
(`csrc/rmsnorm.cu`) replaces the Pallas TPU kernel `_rmsnorm_kernel`;
`_rmsnorm_plain` is `_rmsnorm_ref`. `rmsnorm` picks by where the tensor
lies: a CPU tensor takes the plain version, a CUDA tensor always launches
the kernel (or raises) — including the per-head q/k norms, which the JAX
package sends down its jnp path explicitly.

The kernel is forward-only in this slice: a CUDA input that requires a
gradient raises NotImplementedError. The backward kernel (the port of
`_rmsnorm_bwd_kernel`) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (xf * inv * w.float()).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("rmsnorm").rt_rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _threads_for(d: int, itemsize: int) -> int:
    """Threads per row: one per 16-byte vector, in whole warps, capped at
    256 (a thread then loops over several vectors)."""
    nvec = max(1, d // (16 // itemsize))
    return min(256, max(32, -(-nvec // 32) * 32))


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel on x's current stream. x: [..., d] with a unit
    stride in its last axis; w: [d], same dtype and device."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm_cuda needs x and w on one CUDA device, got {x.device} and {w.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm_cuda takes float32 or bfloat16 x with w of the same dtype, got {x.dtype} and {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous [{d}] tensor, got shape {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "the CUDA rmsnorm kernel is forward-only; its backward kernel "
            "(port of _rmsnorm_bwd_kernel) comes with the training slice")
    x2 = x.reshape(-1, d)
    if d > 1 and x2.stride(1) != 1:
        raise ValueError("rmsnorm_cuda needs a unit stride in the last axis")
    rows = x2.shape[0]
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y.reshape(x.shape)
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"rmsnorm_cuda: x is on {x.device} but the current device is cuda:{torch.cuda.current_device()}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x2.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
                    x2.stride(0), y.stride(0), float(eps),
                    _DTYPE_CODE[x.dtype], _threads_for(d, x.element_size()),
                    stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm CUDA kernel launch failed: cudaError {err}")
    rmsnorm_cuda.launches += 1
    return y.reshape(x.shape)


rmsnorm_cuda.launches = 0


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalization over the last axis, scaled by w."""
    if x.device.type == "cuda":
        return rmsnorm_cuda(x, w, eps)
    if x.device.type == "cpu":
        return _rmsnorm_plain(x, w, eps)
    raise ValueError(f"rmsnorm runs on cuda or cpu tensors, got {x.device}")
