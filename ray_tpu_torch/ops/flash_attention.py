"""Fused (flash) attention: hand-written CUDA kernels for the forward, dq and
dk/dv, their plain PyTorch versions, and the autograd wiring.

Counterpart of ray_tpu/ops/flash_attention.py. In `csrc/flash_attention.cu`,
`rt_flash_fwd` replaces the Pallas TPU kernel `_flash_fwd_kernel`,
`rt_flash_bwd_dq` replaces `_flash_bwd_dq_kernel` and `rt_flash_bwd_dkv`
replaces `_flash_bwd_dkv_kernel`. Every pass is bound by its products at
the training shapes, so the C entry points pick the way to the tensor
cores by what the input shows: bf16 at head_dim 64 and 128 runs
FlashAttention-3's design for Hopper (warpgroup MMA, `wgmma`, fed by TMA
through an mbarrier ring by a producer warp, one or two consumer
warpgroups a block); bf16 at 256 runs `mma.sync` kernels (FlashAttention-2's shape);
f32 runs on the CUDA cores in f32. p and ds are rounded to bf16 before
their products in both bf16 designs. `rt_flash_design` reads the choice
back, and each launch counts in `flash_kernel_launches_total{pass,
design}` beside the wrappers' `launches` integers.
`_flash_fwd_plain` and `_flash_bwd_plain` compute what those kernels
compute (same masking, same lse), over whole score matrices;
`flash_attention_plain` is `_flash_attention_xla`.

`flash_attention` takes the reference's `[batch, seq, heads, head_dim]`
layout. On a CUDA tensor it runs `_FlashAttention` (the reference's
`custom_vjp` over the kernels: it saves q, k, v, o and lse, and the
backward recomputes the probabilities from lse); on a CPU tensor it runs
`flash_attention_plain`, as the reference runs its jnp path off the TPU.
GQA/MQA repeats k and v outside the kernels, so autograd sums the group
gradients back onto the shared heads. The kernels choose their own tiles
for the card: the TPU's `attn_block_q/k` are not passed down.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Optional

import torch

from ray_tpu_torch import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------


def _valid(lq: int, lk: int, causal: bool, device) -> torch.Tensor:
    """[lq, lk] mask of the scores that count: top-left causal."""
    if not causal:
        return torch.ones((lq, lk), dtype=torch.bool, device=device)
    q_pos = torch.arange(lq, device=device)[:, None]
    k_pos = torch.arange(lk, device=device)[None, :]
    return q_pos >= k_pos


def _scale(q, scale):
    """The softmax scale: `scale`, or d^-0.5 where it is None."""
    return q.shape[-1] ** -0.5 if scale is None else scale


def _scores(q, k, causal, scale=None):
    """f32 scores [b, h, lq, lk] of the reference kernels: q scaled (by
    d^-0.5 unless `scale` is given) before the product, masked entries at
    NEG_INF."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    return s.masked_fill(~_valid(q.shape[1], k.shape[1], causal, q.device),
                         NEG_INF)


def _flash_fwd_plain(q, k, v, causal: bool = True, scale=None):
    """(o [b, lq, h, d] in q's dtype, lse [b, h, lq] f32), as
    `_flash_fwd_kernel` computes them."""
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.permute(
        0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _probs(q, k, lse, causal, scale=None):
    """p = exp(s - lse) with the forward's scores and lse [b, h, lq]."""
    return torch.exp(_scores(q, k, causal, scale) - lse[..., None])


def _flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                        scale=None):
    """dq in q's dtype, as `_flash_bwd_dq_kernel` computes it. lse, delta:
    f32 [b, h, lq]."""
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = _scale(q, scale) * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype)


def _flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                         scale=None):
    """(dk, dv) in k's and v's dtypes, as `_flash_bwd_dkv_kernel` computes
    them."""
    p = _probs(q, k, lse, causal, scale)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dk = _scale(q, scale) * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """rowsum(do * o) in f32, [b, h, lq] contiguous: outside the kernels,
    as the reference computes it."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _flash_bwd_plain(q, k, v, o, lse, do, causal: bool = True, scale=None):
    """(dq, dk, dv) in q's, k's and v's dtypes, as `_bwd_pallas` computes
    them: delta = rowsum(do * o) in f32, then the two kernels' math."""
    delta = _delta(o, do)
    dq = _flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    return (dq, *_flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                      scale))


def flash_attention_plain(q, k, v, causal: bool = True, scale=None):
    """`_flash_attention_xla`: softmax attention in f32, differentiable by
    autograd. q, k, v: [b, L, h, d] with as many heads in k, v as in q."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_valid(q.shape[1], k.shape[1], True, q.device),
                          NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_ARG_INT = [ctypes.c_int] * 5  # B, H, Lq, Lk, d
_ARG_TAIL = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]  # strides, sm_scale, causal, dtype, stream


@functools.lru_cache(maxsize=None)
def _kernel(name: str, n_ptrs: int):
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + _ARG_INT + _ARG_TAIL
    fn.restype = ctypes.c_int
    return fn


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t with a unit stride in d and every other stride positive and a
    multiple of 16 bytes, as the kernels' 16-byte loads and the TMA's
    tensor maps need; a copy only where t is not already so."""
    item = t.element_size()
    aligned = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
               and all(s > 0 and s * item % 16 == 0 for s in t.stride()[:-1]))
    if aligned:
        return t
    c = t.contiguous()
    return c if c.data_ptr() != t.data_ptr() else t.clone()


def _check(name: str, q, k, v) -> None:
    for t in (q, k, v):
        if t.dim() != 4:
            raise ValueError(f"{name} takes [batch, seq, heads, head_dim] "
                             f"tensors, got shape {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} supports float32 or bfloat16 q, k and v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} supports head_dim in {HEAD_DIMS}, got {d}")
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"{name}: k and v must be [{b}, Lk, {h}, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.shape[1] == 0 or k.shape[1] == 0 or b * h == 0 or b * h > 65535:
        raise ValueError(f"{name}: empty sequence or batch*heads outside "
                         f"[1, 65535]: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if any(t.device.type != "cuda" or t.device != q.device for t in (k, v)) \
            or q.device.type != "cuda":
        raise ValueError(f"{name} needs q, k and v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {q.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")


def _check_bwd(name: str, q, do, lse, delta) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: do must match q ({tuple(q.shape)}, "
                         f"{q.dtype}), got {tuple(do.shape)}, {do.dtype}")
    b, lq, h, _ = q.shape
    for t in (lse, delta):
        if t.shape != (b, h, lq) or t.device != q.device:
            raise ValueError(f"{name}: lse and delta must be [{b}, {h}, "
                             f"{lq}] on {q.device}, got {tuple(t.shape)}")


def _strides(*ts):
    vals = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_int64 * len(vals))(*vals)


# The passes (C entry point `rt_<pass>`) as `rt_flash_design` and
# `rt_flash_smem_bytes` number them, and the designs `rt_flash_design` names.
_PASS = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}
DESIGNS = ("cuda_cores", "mma_sync", "wgmma")


@functools.lru_cache(maxsize=None)
def _design(pass_: str, dtype_code: int, d: int) -> str:
    """The design the C entry point of `pass_` launches for a dtype and d:
    `rt_flash_design`, the dispatch's own table."""
    fn = _build.load("flash_attention").rt_flash_design
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return DESIGNS[fn(_PASS[pass_], dtype_code, d)]


@functools.lru_cache(maxsize=None)
def launch_counter(pass_: str, design: str):
    """`flash_kernel_launches_total` and its series key for one pass and
    design, made at the first launch so that importing the module starts no
    metrics flusher."""
    from ray_tpu_torch.util.metrics import Counter, get_or_create

    counter = get_or_create(
        Counter, "flash_kernel_launches_total",
        "Launches of the flash attention kernels, by pass (flash_fwd, "
        "flash_bwd_dq, flash_bwd_dkv) and the design that served it "
        "(wgmma, mma_sync, cuda_cores)", tag_keys=("pass", "design"))
    return counter, counter._key({"pass": pass_, "design": design})


def _launch(name: str, ptrs, q, k, strides, causal: bool, scale) -> None:
    b, lq, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _DTYPE_CODE[q.dtype]
    err = _kernel(name, len(ptrs))(*ptrs, b, h, lq, k.shape[1], d,
                                   ctypes.cast(strides, ctypes.c_void_p),
                                   float(_scale(q, scale)), int(causal),
                                   code, stream)
    if err != 0:
        raise RuntimeError(f"{name} CUDA kernel launch failed: cudaError {err}")
    pass_ = name.removeprefix("rt_")
    counter, key = launch_counter(pass_, _design(pass_, code, d))
    counter.inc_keyed(key)


def flash_fwd_cuda(q, k, v, causal: bool = True, scale=None):
    """The forward kernel on q's current stream: (o [b, lq, h, d] in q's
    dtype, lse [b, h, lq] f32). q: [b, lq, h, d]; k, v: [b, lk, h, d]."""
    _check("flash_fwd_cuda", q, k, v)
    q, k, v = _rows16(q), _rows16(k), _rows16(v)
    b, lq, h, _ = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o)
    _launch("rt_flash_fwd", [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), lse.data_ptr()],
            q, k, strides, causal, scale)
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = True,
                      scale=None):
    """The dq kernel: dq [b, lq, h, d] in q's dtype. lse, delta: f32
    [b, h, lq]."""
    _check("flash_bwd_dq_cuda", q, k, v)
    _check_bwd("flash_bwd_dq_cuda", q, do, lse, delta)
    q, k, v, do = _rows16(q), _rows16(k), _rows16(v), _rows16(do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = _strides(q, k, v, do, dq)
    _launch("rt_flash_bwd_dq", [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dq.data_ptr()],
            q, k, strides, causal, scale)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool = True,
                       scale=None):
    """The dk/dv kernel: (dk, dv) [b, lk, h, d] in k's dtype."""
    _check("flash_bwd_dkv_cuda", q, k, v)
    _check_bwd("flash_bwd_dkv_cuda", q, do, lse, delta)
    q, k, v, do = _rows16(q), _rows16(k), _rows16(v), _rows16(do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    strides = _strides(q, k, v, do, dk, dv)
    _launch("rt_flash_bwd_dkv", [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr()],
            q, k, strides, causal, scale)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


_ROUTE = {"_wgmma": "tensor cores, wgmma", "_mma": "tensor cores",
          "": "CUDA cores"}


def kernel_report() -> list:
    """Each flash kernel in the built library: its pass, route, dtype and
    head width, ptxas's registers, spills and stack (bytes), and the
    dynamic shared memory its launcher requests per block. Builds the
    library on first use (needs nvcc)."""
    smem = _build.load("flash_attention").rt_flash_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    out = []
    for rec in _build.ptxas_report("flash_attention"):
        pass_, route, tail = re.search(
            r"(flash_(?:fwd|bwd_dq|bwd_dkv))(_wgmma|_mma)?_kernelI(.*)",
            rec["kernel"]).groups()
        route = route or ""
        bf16 = bool(route) or tail.startswith("13__nv_bfloat16")
        args = [int(a) for a in re.findall(r"Li(\d+)E", tail)]
        out.append({
            "kernel": f"{pass_}{route}_kernel<{str(args)[1:-1]}>",
            "pass": pass_, "route": _ROUTE[route],
            "dtype": "bfloat16" if bf16 else "float32", "d": args[0],
            "registers": rec.get("registers"),
            "spill_stores": rec.get("spill_stores"),
            "spill_loads": rec.get("spill_loads"), "stack": rec.get("stack"),
            "static_smem": rec.get("static_smem", 0),
            "dynamic_smem": smem(_PASS[pass_], int(bf16), args[0]),
        })
    return out


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------


def _device_of(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return q.device.type


def flash_fwd(q, k, v, causal: bool = True, scale=None):
    """(o, lse): the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if _device_of(q) == "cuda":
        return flash_fwd_cuda(q, k, v, causal, scale)
    return _flash_fwd_plain(q, k, v, causal, scale)


def flash_bwd(q, k, v, o, lse, do, causal: bool = True, scale=None):
    """(dq, dk, dv): the two kernels on a CUDA tensor, the plain version on
    a CPU one."""
    if _device_of(q) == "cuda":
        delta = _delta(o, do)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv
    return _flash_bwd_plain(q, k, v, o, lse, do, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """The reference's `_flash_attention_pallas_core`: saves (q, k, v, o,
    lse); the backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.to(o.dtype), ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention. q, k, v: [batch, seq, heads, head_dim]. `scale`
    multiplies the scores before the softmax: head_dim^-0.5 by default.

    GQA/MQA: when k and v have fewer heads than q they are repeated per
    group before the kernels (autograd sums the group gradients back).
    """
    if k.shape[2] != q.shape[2]:
        group = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    if _device_of(q) == "cuda":
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_plain(q, k, v, causal, scale)
