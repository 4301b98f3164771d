"""The flash-attention CUDA source itself, run on the CPU.

`ray_tpu_torch/csrc/flash_attention.cu` is compiled with the host C++
compiler against the emulation below of the CUDA primitives it uses: one
OS thread per CUDA thread and a barrier per block (`__syncthreads`) and
per warp; `ldmatrix`, `mma.sync` and `__shfl_xor_sync` exchange their
operands between the 32 lanes of a warp and rebuild each fragment from
the layouts the PTX manual gives; a `cp.async` copy lands only when a
`cp.async.wait_group` retires its group, so a read before the wait sees
the stale tile. Shared memory starts as NaN bytes. The kernels, called
through their C entry points on CPU tensors, are held to the plain
versions with the tolerances of tests/test_torch_gpu.py.

This checks what the card-free tests cannot: fragment layouts, the
shared-memory swizzle, masks, strides and the copy pipeline of the
kernels as written. It cannot check the inline PTX's syntax, timing or
memory ordering on the card; the card-only tests and chip_smoke.py do.
Skips where no C++20 compiler is installed.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from ray_tpu_torch import _build
from ray_tpu_torch.ops.flash_attention import (_ARG_INT, _ARG_TAIL,
                                               _DTYPE_CODE, _delta,
                                               _flash_bwd_dkv_plain,
                                               _flash_bwd_dq_plain,
                                               _flash_fwd_plain, _strides)
from ray_tpu_torch.ops.rmsnorm import (_BWD_MAX_D, _BWD_THREADS,
                                       _rmsnorm_bwd_plain, _rmsnorm_plain)

torch.set_num_threads(1)

_EMU_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict

using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct Idx { unsigned x, y, z; };
thread_local Idx threadIdx, blockIdx, blockDim, gridDim;

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<uint16_t>((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = static_cast<uint32_t>(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
thread_local cudaError_t emu_error = cudaSuccess;
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;  // H100: 227 KB a block
}
// One resident block an SM: a launcher's `sms` is then its grid's cap.
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  cudaError_t e = emu_error;
  emu_error = cudaSuccess;
  return e;
}

[[noreturn]] inline void emu_fail(const char* what) {
  std::fprintf(stderr, "emulation: %s\n", what);
  std::abort();
}

struct Warp {
  std::barrier<> bar{32};
  uint32_t addr[32], a[32][4], b[32][2];
  float f[32];
};
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<unsigned char> smem;
  std::vector<std::unique_ptr<Warp>> warps;
  std::mutex mu;  // guards statics
  std::map<std::pair<int, size_t>, std::vector<unsigned char>> statics;
};
thread_local Block* emu_block = nullptr;
thread_local int emu_lane = 0, emu_warp = 0;
struct Copy { uint32_t dst; const void* src; int n, size; };
thread_local std::vector<std::vector<Copy>> emu_groups;  // committed, oldest first
thread_local std::vector<Copy> emu_open;

inline unsigned char* emu_smem() { return emu_block->smem.data(); }
// A static __shared__ variable (declared on source line `line`): one per
// block, NaN bytes at first.
template <typename T>
T& emu_static(int line) {
  std::lock_guard<std::mutex> lock(emu_block->mu);
  auto& buf = emu_block->statics[{line, sizeof(T)}];
  if (buf.empty()) buf.assign(sizeof(T), 0xff);
  return *reinterpret_cast<T*>(buf.data());
}
inline Warp& emu_w() { return *emu_block->warps[emu_warp]; }
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_w().bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  Warp& w = emu_w();
  w.f[emu_lane] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[emu_lane ^ off];
  w.bar.arrive_and_wait();
  return r;
}

inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) - emu_smem());
}
inline void emu_check(uint32_t at, int n) {
  if (at + n > emu_block->smem.size() || at % n) emu_fail("shared-memory access out of range or misaligned");
}
inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  if (reinterpret_cast<uintptr_t>(src) % 16) emu_fail("cp.async source not 16-byte aligned");
  emu_open.push_back({dst, src, valid ? 16 : 0, 16});
}
inline void cp_async4(uint32_t dst, const void* src, bool valid) {
  emu_open.push_back({dst, src, valid ? 4 : 0, 4});
}
inline void cp_async_commit() {
  emu_groups.push_back(emu_open);
  emu_open.clear();
}
template <int N>
inline void cp_async_wait() {
  while (static_cast<int>(emu_groups.size()) > N) {
    for (const Copy& c : emu_groups.front()) {
      emu_check(c.dst, c.size);
      std::memset(emu_smem() + c.dst, 0, c.size);  // src-size 0: zero fill
      std::memcpy(emu_smem() + c.dst, c.src, c.n);
    }
    emu_groups.erase(emu_groups.begin());
  }
}

inline uint16_t emu_half(uint32_t at) {
  emu_check(at, 2);
  uint16_t v;
  std::memcpy(&v, emu_smem() + at, 2);
  return v;
}
// ldmatrix.x4: lanes 8i..8i+7 give the row addresses of matrix i; lane l
// gets row l/4, columns 2(l%4) and +1 (.trans: rows 2(l%4), +1 of column l/4).
inline void emu_ldsm(uint32_t (&r)[4], uint32_t addr, bool trans) {
  Warp& w = emu_w();
  w.addr[emu_lane] = addr;
  w.bar.arrive_and_wait();
  const int l = emu_lane;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 8; ++j)
      if (w.addr[8 * i + j] % 16) emu_fail("ldmatrix row not 16-byte aligned");
    const uint16_t lo = trans ? emu_half(w.addr[8 * i + 2 * (l % 4)] + 2 * (l / 4))
                              : emu_half(w.addr[8 * i + l / 4] + 4 * (l % 4));
    const uint16_t hi = trans ? emu_half(w.addr[8 * i + 2 * (l % 4) + 1] + 2 * (l / 4))
                              : emu_half(w.addr[8 * i + l / 4] + 4 * (l % 4) + 2);
    r[i] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
  }
  w.bar.arrive_and_wait();
}
inline void ldsm_x4(uint32_t (&r)[4], uint32_t addr) { emu_ldsm(r, addr, false); }
inline void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) { emu_ldsm(r, addr, true); }

inline float emu_bf(uint32_t reg, int hi) {
  return __bfloat162float({static_cast<uint16_t>(hi ? reg >> 16 : reg & 0xffffu)});
}
// mma.sync.m16n8k16.row.col f32 += bf16 * bf16; lane l = 4g + t holds
// A (g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..); B (k 2t.., n g),
// (k 2t+8.., n g); C/D (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  Warp& w = emu_w();
  for (int i = 0; i < 4; ++i) w.a[emu_lane][i] = a[i];
  w.b[emu_lane][0] = b0;
  w.b[emu_lane][1] = b1;
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l)
    for (int j = 0; j < 2; ++j) {
      const int g = l / 4, t = l % 4;
      A[g][2 * t + j] = emu_bf(w.a[l][0], j);
      A[g + 8][2 * t + j] = emu_bf(w.a[l][1], j);
      A[g][2 * t + 8 + j] = emu_bf(w.a[l][2], j);
      A[g + 8][2 * t + 8 + j] = emu_bf(w.a[l][3], j);
      B[2 * t + j][g] = emu_bf(w.b[l][0], j);
      B[2 * t + 8 + j][g] = emu_bf(w.b[l][1], j);
    }
  w.bar.arrive_and_wait();
  const int g = emu_lane / 4, t = emu_lane % 4;
  for (int e = 0; e < 4; ++e) {
    double s = c[e];
    for (int k = 0; k < 16; ++k) s += static_cast<double>(A[g + 8 * (e / 2)][k]) * B[k][2 * t + e % 2];
    c[e] = static_cast<float>(s);
  }
}

template <typename Kernel, typename... Args>
void emu_launch(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, Args... args) {
  const int nt = block.x * block.y * block.z;
  if (nt % 32 || nt > 1024 || smem > 232448) { emu_error = cudaErrorInvalidValue; return; }
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block blk;
      blk.bar = std::make_unique<std::barrier<>>(nt);
      blk.smem.assign(smem, 0xff);
      for (int w = 0; w < nt / 32; ++w) blk.warps.push_back(std::make_unique<Warp>());
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; ++t)
        threads.emplace_back([&, t, bx, by] {
          emu_block = &blk;
          threadIdx = {t % block.x, t / block.x % block.y, t / (block.x * block.y)};
          blockIdx = {bx, by, 0};
          blockDim = {block.x, block.y, block.z};
          gridDim = {grid.x, grid.y, grid.z};
          emu_lane = t % 32;
          emu_warp = t / 32;
          emu_groups.clear();
          emu_open.clear();
          kernel(args...);
          for (auto& g : emu_groups)
            if (!g.empty()) emu_fail("a cp.async group was still in flight at exit");
        });
      for (auto& th : threads) th.join();
    }
}
"""

# The device helpers written in inline PTX, replaced by the emulation's.
_PTX_HELPERS = ("smem_u32", "cp_async16", "cp_async4", "cp_async_commit",
                "cp_async_wait", "ldsm_x4", "ldsm_x4_trans", "mma_bf16")


def _emulation_source(cu: str) -> str:
    src = cu.replace("#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n",
                     '#include "emu.h"\n')
    # Dynamic shared memory is the emulated block's buffer; a static
    # __shared__ variable is one per emulated block.
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_smem());", src)
    src = re.sub(r"(?m)^(\s*)__shared__ (\w+) (\w+)((?:\[[^\]]+\])*);",
                 r"\1auto& \3 = emu_static<\2\4>(__LINE__);", src)
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), ([^,]+), s>>>\(",
                 r"emu_launch(\1, dim3(\2), dim3(\3), \4, s, ", src)
    out, lines, i = [], src.split("\n"), 0
    while i < len(lines):
        m = re.match(r"__device__ __forceinline__ \w+ (\w+)\(", lines[i])
        if m and m.group(1) in _PTX_HELPERS:
            if out and out[-1].startswith("template <"):
                out.pop()
            while lines[i] != "}":
                i += 1
        else:
            out.append(lines[i])
        i += 1
    return "\n".join(out)


_I64, _VP = ctypes.c_int64, ctypes.c_void_p
# Each emulated library and the argument types of its entry points.
_ENTRY_POINTS = {
    "flash_attention": {
        name: [_VP] * n_ptrs + _ARG_INT + _ARG_TAIL
        for name, n_ptrs in (("rt_flash_fwd", 5), ("rt_flash_bwd_dq", 7),
                             ("rt_flash_bwd_dkv", 8))},
    "rmsnorm": {
        "rt_rmsnorm_fwd": [_VP] * 3 + [_I64] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, _VP],
        "rt_rmsnorm_bwd": [_VP] * 6 + [_I64] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP]},
}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Every entry point of csrc/flash_attention.cu and csrc/rmsnorm.cu,
    compiled (one g++ per source, at once) against the emulation."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    d = tmp_path_factory.mktemp("cuda_emulation")
    (d / "emu.h").write_text(_EMU_H)
    procs = {}
    for name in _ENTRY_POINTS:
        src = d / f"{name}_emu.cpp"
        src.write_text(_emulation_source(
            (_build.CSRC / f"{name}.cu").read_text()))
        # The kernels type-pun bf16 pairs through pointers, as nvcc allows.
        procs[name] = subprocess.Popen(
            [cxx, "-std=c++20", "-O2", "-fno-strict-aliasing", "-shared",
             "-fPIC", "-pthread", "-I", str(d), "-o",
             str(d / f"lib{name}_emu.so"), str(src)],
            stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0 and "barrier" in err and "No such file" \
                in err:
            pytest.skip(f"{cxx} has no C++20 <barrier>")
        assert proc.returncode == 0, err[-4000:]
        so = ctypes.CDLL(str(d / f"lib{name}_emu.so"))
        for fn_name, argtypes in _ENTRY_POINTS[name].items():
            fn = getattr(so, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[fn_name] = fn
    return fns


def _run(fns, name, tensors, q, k, causal):
    b, lq, h, d = q.shape
    strides = _strides(*(t for t in tensors if t.dim() == 4))
    err = fns[name](*(t.data_ptr() for t in tensors), b, h, lq, k.shape[1],
                    d, ctypes.cast(strides, ctypes.c_void_p), float(d ** -0.5),
                    int(causal), _DTYPE_CODE[q.dtype], None)
    assert err == 0, f"{name} returned {err}"


def _assert_close(got, want, dtype, tol):
    """tests/test_torch_gpu.py's tolerances: f32 within `tol`; bf16 within
    relative L2 4e-3 and 2^-6 max|ref|, or 1e-5 where the reference
    vanishes."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        return
    got, want = got.float(), want.float()
    worst = float((got - want).abs().max())
    if worst <= 1e-5:
        return
    assert float((got - want).norm() / want.norm()) <= 4e-3
    assert worst <= 2 ** -6 * float(want.abs().max())


def _bf16_ulp_diff(a, b) -> int:
    def ordered(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


# (causal, lq, lk, d, heads, dtype): every bf16 tensor-core instantiation
# (d = 64, 128 and 256: dk/dv's two warps per row block), causal Lq != Lk
# both ways and ragged tails; one f32 case runs the CUDA-core kernels.
@pytest.mark.parametrize("causal,lq,lk,d,h,dtype", [
    (True, 70, 129, 64, 2, "bfloat16"),
    (False, 129, 70, 128, 1, "bfloat16"),
    (True, 100, 40, 128, 1, "bfloat16"),
    (True, 129, 129, 256, 1, "bfloat16"),
    (False, 40, 70, 64, 1, "float32"),
])
def test_flash_kernels_emulated_match_plain(emulated, causal, lq, lk, d, h,
                                            dtype):
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(lq * 7 + lk + d)

    def rand(n, heads=h):
        return torch.randn((1, n, heads, d), generator=gen).to(tdt)

    q = rand(lq, 2 * h)[:, :, ::2]  # strided heads, read through strides
    k, v, do = rand(lk), rand(lk), rand(lq)
    o = torch.empty((1, lq, h, d), dtype=tdt)
    lse = torch.empty((1, h, lq))
    _run(emulated, "rt_flash_fwd", (q, k, v, o, lse), q, k, causal)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = _flash_fwd_plain(f[0], f[1], f[2], causal)
    _assert_close(o, o_ref, tdt, 2e-4)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-4, atol=2e-4)

    delta = _delta(o, do)
    dq = torch.empty_like(o)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run(emulated, "rt_flash_bwd_dq", (q, k, v, do, lse, delta, dq), q, k,
         causal)
    _run(emulated, "rt_flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), q,
         k, causal)
    _assert_close(dq, _flash_bwd_dq_plain(*f, lse, delta, causal), tdt, 2e-3)
    for got, want in zip((dk, dv),
                         _flash_bwd_dkv_plain(*f, lse, delta, causal)):
        _assert_close(got, want, tdt, 2e-3)


# (rows, d, row_pad, blocks, dtype): the RMSNorm kernels through
# rt_rmsnorm_fwd (`blocks` SMs: its grid is `blocks`, or a quarter of
# the row groups where that is more, as the emulation keeps one block an
# SM) and rt_rmsnorm_bwd (`blocks` blocks of the wrapper's threads).
# One-pass forward: groups of 8 threads, 32 rows a block, that walk four
# steps (300 x 128), 64-thread groups (1024), 128 (2048, its
# rows through a padded stride), 256 at one and at eight rows (4096), one
# vector a thread for some threads (3072), a 1024-thread group (16384);
# blocks walk rows wherever the grid is smaller than the row groups.
# Two-pass forward: a scalar tail (100 in bf16), an unaligned row stride,
# and d past the one-pass budget (12288 and 16392 in f32). One-pass
# backward: 16-thread row groups that take two steps a block (d = 128), a
# block per row with one barrier a row (2048), two vectors a thread with
# some threads owning one (3072), four (4096 in f32), x read through a
# row stride; two-pass backward: a scalar tail, an unaligned row stride,
# 12288; past 12288 it refuses. Cases of one block write dw themselves.
@pytest.mark.parametrize("rows,d,pad,blocks,dtype", [
    (37, 128, 0, 2, "bfloat16"),
    (21, 2048, 8, 4, "bfloat16"),
    (9, 3072, 0, 3, "bfloat16"),
    (5, 4096, 0, 2, "float32"),
    (6, 100, 0, 2, "bfloat16"),
    (7, 256, 1, 3, "float32"),
    (5, 128, 0, 3, "bfloat16"),
    (1, 2048, 0, 1, "float32"),
    (1, 100, 0, 1, "bfloat16"),
    (300, 128, 0, 2, "bfloat16"),
    (40, 1024, 0, 2, "bfloat16"),
    (8, 4096, 0, 2, "bfloat16"),
    (1, 4096, 0, 1, "bfloat16"),
    (3, 12288, 0, 1, "float32"),
    (2, 16384, 0, 1, "bfloat16"),
    (2, 16392, 0, 1, "float32"),
])
def test_rmsnorm_kernels_emulated_match_plain(emulated, rows, d, pad, blocks,
                                              dtype):
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(rows * 11 + d)
    x = (torch.randn((rows, d + pad), generator=gen) * 3).to(tdt)[:, :d]
    w = (torch.randn(d, generator=gen) * 0.1 + 1).to(tdt)
    g = torch.randn((rows, d), generator=gen).to(tdt)
    eps = 1e-6
    y = torch.empty((rows, d), dtype=tdt)
    err = emulated["rt_rmsnorm_fwd"](
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, x.stride(0), d,
        eps, _DTYPE_CODE[tdt], blocks, None)
    assert err == 0, f"rt_rmsnorm_fwd returned {err}"
    _assert_close(y, _rmsnorm_plain(x.float(), w.float(), eps), tdt, 1e-5)
    if tdt == torch.bfloat16:  # tests/test_torch_gpu.py's: 1 ulp of plain
        assert _bf16_ulp_diff(y, _rmsnorm_plain(x, w, eps)) <= 1

    dx = torch.empty((rows, d), dtype=tdt)
    dw = torch.empty(d, dtype=tdt)
    dw_part = torch.empty((blocks, d))
    err = emulated["rt_rmsnorm_bwd"](
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dw_part.data_ptr(), dw.data_ptr(), rows, d, x.stride(0), eps,
        _DTYPE_CODE[tdt], _BWD_THREADS, blocks, None)
    if d > _BWD_MAX_D:
        # The two-pass backward's dw row does not fit its 48 KB.
        assert err != 0, "rt_rmsnorm_bwd took a row wider than it holds"
        return
    assert err == 0, f"rt_rmsnorm_bwd returned {err}"
    want = _rmsnorm_bwd_plain(x.float(), w.float(), g.float(), eps)
    _assert_close(dx, want[0], tdt, 1e-4)
    _assert_close(dw, want[1], tdt, 1e-4)
