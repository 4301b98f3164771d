"""RMSNorm: hand-written CUDA forward and backward kernels and their plain
PyTorch versions.

Counterpart of ray_tpu/ops/rmsnorm.py. In `csrc/rmsnorm.cu`,
`rt_rmsnorm_fwd` replaces the Pallas TPU kernel `_rmsnorm_kernel` and
`rt_rmsnorm_bwd` replaces `_rmsnorm_bwd_kernel`; `_rmsnorm_plain` is
`_rmsnorm_ref` and `_rmsnorm_bwd_plain` is `_bwd`.

`rmsnorm` is a `torch.autograd.Function` (the reference's `custom_vjp`):
its forward saves (x, w) and nothing else, and its backward recomputes
the normalizer. Each wrapper picks by where the tensor lies: a CPU tensor
takes the plain version, a CUDA tensor always launches the kernel (or
raises) — including the per-head q/k norms, which the JAX package sends
down its jnp path explicitly.
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


def _rmsnorm_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       eps: float):
    """(dx, dw) of y = rmsnorm(x, w) for the cotangent g: `_bwd` of the
    reference, in f32, dx in x's dtype and dw in w's."""
    xf, gf, wf = x.float(), g.float(), w.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xf * inv
    dw = (gf * xhat).sum(dim=tuple(range(x.dim() - 1))).to(w.dtype)
    gw = gf * wf
    dx = inv * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dw


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("rmsnorm").rt_rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _bwd_kernel():
    fn = _build.load("rmsnorm").rt_rmsnorm_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# The backward's two-pass kernel keeps one f32 dw partial row per block in
# shared memory.
_BWD_MAX_D = 12288  # 48 KB of floats
# Threads per backward block, a power of two: the one-pass kernel gives a
# row to a group of them (16 at d = 128 in bf16, all 256 at d = 2048).
_BWD_THREADS = 256


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda_args(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Validate x and w for a kernel; returns x as [rows, d] rows with a
    unit stride in the last axis."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} needs x and w on one CUDA device, got {x.device} and {w.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 x with w of the same dtype, got {x.dtype} and {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous [{d}] tensor, got shape {tuple(w.shape)}")
    x2 = x.reshape(-1, d)
    if d > 1 and x2.stride(1) != 1:
        raise ValueError(f"{name} needs a unit stride in the last axis")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x is on {x.device} but the current device is cuda:{torch.cuda.current_device()}")
    return x2


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA forward kernel on x's current stream. x: [..., d]
    with a unit stride in its last axis; w: [d], same dtype and device.
    The kernel sizes its own blocks to d and its grid to the card's SMs."""
    x2 = _check_cuda_args("rmsnorm_cuda", x, w)
    rows, d = x2.shape
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y.reshape(x.shape)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x2.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
                    x2.stride(0), y.stride(0), float(eps),
                    _DTYPE_CODE[x.dtype], _sm_count(x.device.index), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm CUDA kernel launch failed: cudaError {err}")
    rmsnorm_cuda.launches += 1
    return y.reshape(x.shape)


rmsnorm_cuda.launches = 0


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6):
    """Launch the CUDA backward kernels on x's current stream: (dx, dw).
    x: [..., d] with a unit stride in its last axis; w: [d]; g: x's
    shape, dtype and device. d at most 12288."""
    if x.shape[-1] > _BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd_cuda supports d up to {_BWD_MAX_D}, got {x.shape[-1]}")
    x2 = _check_cuda_args("rmsnorm_bwd_cuda", x, w)
    rows, d = x2.shape
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x ({tuple(x.shape)}, {x.dtype}), got {tuple(g.shape)}, {g.dtype}")
    g2 = g.reshape(rows, d).contiguous()
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0:
        return dx.reshape(x.shape), torch.zeros_like(w)
    threads = _BWD_THREADS
    blocks = min(rows, _sm_count(x.device.index) * 1024 // threads)
    dw_part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _bwd_kernel()(x2.data_ptr(), w.data_ptr(), g2.data_ptr(),
                        dx.data_ptr(), dw_part.data_ptr(), dw.data_ptr(),
                        rows, d, x2.stride(0), float(eps),
                        _DTYPE_CODE[x.dtype], threads, blocks, stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm backward CUDA kernel launch failed: cudaError {err}")
    rmsnorm_bwd_cuda.launches += 1
    return dx.reshape(x.shape), dw


rmsnorm_bwd_cuda.launches = 0


def _on(x: torch.Tensor, cuda_fn, plain_fn, *args):
    if x.device.type == "cuda":
        return cuda_fn(x, *args)
    if x.device.type == "cpu":
        return plain_fn(x, *args)
    raise ValueError(f"rmsnorm runs on cuda or cpu tensors, got {x.device}")


class _RMSNorm(torch.autograd.Function):
    """The reference's custom_vjp: saves (x, w); the backward recomputes
    the normalizer from x."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _on(x, rmsnorm_cuda, _rmsnorm_plain, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _on(x, rmsnorm_bwd_cuda, _rmsnorm_bwd_plain, w,
                     g.to(x.dtype), ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalization over the last axis, scaled by w. Differentiable in
    x and w; on a CUDA tensor both directions run the kernels."""
    return _RMSNorm.apply(x, w, eps)
