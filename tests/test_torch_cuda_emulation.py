"""The flash-attention CUDA source itself, run on the CPU.

`ray_tpu_torch/csrc/flash_attention.cu` is compiled with the host C++
compiler against the emulation below of the CUDA primitives it uses: one
OS thread per CUDA thread and a barrier per block (`__syncthreads`) and
per warp; `ldmatrix`, `mma.sync` and `__shfl_xor_sync` exchange their
operands between the 32 lanes of a warp and rebuild each fragment from
the layouts the PTX manual gives; a `cp.async` copy lands only when a
`cp.async.wait_group` retires its group, so a read before the wait sees
the stale tile. Hopper's: `wgmma.mma_async` reads its shared-memory
operands through the matrix descriptor with the 128-byte swizzle
(K-major or MN-major) and writes the accumulator fragment the PTX manual
gives, when a `wgmma.wait_group` retires its group (a register A operand
is taken at issue); mbarriers complete a phase on their arrivals and
transaction bytes, and a wait that never completes fails; a TMA tile load
copies its box from a host-side stand-in for the tensor map (checked as
`cuTensorMapEncodeTiled` checks it), swizzled, zeros past the tensor,
and completes its bytes on its barrier; named barriers (`bar.sync`,
`bar.arrive`) are barriers of their thread count; `setmaxnreg` does
nothing. Shared memory starts as NaN bytes. The kernels, called through
their C entry points on CPU tensors, are held to the plain versions with
the tolerances of tests/test_torch_gpu.py.

This checks what the card-free tests cannot: fragment layouts, the
shared-memory swizzle, masks, strides, the copy pipeline and the
mbarrier ring of the kernels as written. It cannot check the inline
PTX's syntax, timing or memory ordering on the card; the card-only tests
and chip_smoke.py do. Skips where no C++20 compiler is installed.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from ray_tpu_torch import _build
from ray_tpu_torch.ops.flash_attention import (_ARG_INT, _ARG_TAIL,
                                               _DTYPE_CODE, _PASS, DESIGNS,
                                               _delta,
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
#include <chrono>
#include <cmath>
#include <condition_variable>
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
#define __grid_constant__
#define CUDART_VERSION 12080

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
struct Mbar { int count, pending; long tx; unsigned phase; };
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<unsigned char> smem;
  std::vector<std::unique_ptr<Warp>> warps;
  std::mutex mu;  // guards statics, named barriers and mbarriers
  std::condition_variable cv;  // an mbarrier phase completed
  std::map<std::pair<int, size_t>, std::vector<unsigned char>> statics;
  std::map<int, std::unique_ptr<std::barrier<>>> named;
  std::map<uint32_t, Mbar> mbars;
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


// Hopper: mbarriers, TMA tile loads, named barriers, wgmma.
// An mbarrier's phase completes when its pending arrivals and its expected
// transaction bytes both reach 0; a wait for parity p returns once the
// phase count's parity differs from p. A wait that lasts a minute is a
// deadlock.
inline Mbar& emu_mbar(uint32_t bar) {
  auto it = emu_block->mbars.find(bar);
  if (it == emu_block->mbars.end()) emu_fail("mbarrier used before mbarrier.init");
  return it->second;
}
inline void emu_mbar_step(Mbar& m) {
  if (m.pending < 0) emu_fail("more arrivals on an mbarrier than its count");
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.count;
    emu_block->cv.notify_all();
  }
}
inline void mbar_init(uint32_t bar, int count) {
  emu_check(bar, 8);
  std::lock_guard<std::mutex> lock(emu_block->mu);
  emu_block->mbars[bar] = {count, count, 0, 0};
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> lock(emu_block->mu);
  Mbar& m = emu_mbar(bar);
  --m.pending;
  emu_mbar_step(m);
}
inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(emu_block->mu);
  Mbar& m = emu_mbar(bar);
  m.tx += bytes;
  --m.pending;
  emu_mbar_step(m);
}
inline void emu_complete_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(emu_block->mu);
  Mbar& m = emu_mbar(bar);
  m.tx -= bytes;
  emu_mbar_step(m);
}
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(emu_block->mu);
  Mbar& m = emu_mbar(bar);
  if (!emu_block->cv.wait_for(lock, std::chrono::seconds(60),
                              [&] { return (m.phase & 1) != parity; }))
    emu_fail("mbarrier wait never completed (deadlock)");
}
inline void named_bar_sync(int id, int threads) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(emu_block->mu);
    auto& p = emu_block->named[id];
    if (!p) p = std::make_unique<std::barrier<>>(threads);
    b = p.get();
  }
  b->arrive_and_wait();
}
inline void named_bar_arrive(int id, int threads) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(emu_block->mu);
    auto& p = emu_block->named[id];
    if (!p) p = std::make_unique<std::barrier<>>(threads);
    b = p.get();
  }
  (void)b->arrive();
}
template <int N>
inline void setmaxnreg_inc() {}
template <int N>
inline void setmaxnreg_dec() {}

// The 128-byte swizzle on shared-memory addresses: bits 4-6 (the 16-byte
// chunk of a 128-byte row) XOR bits 7-9 (the row in a 1024-byte period).
inline uint32_t emu_swz128(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

// A host-side tensor map: what cuTensorMapEncodeTiled was given, checked as
// the driver checks it.
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
struct alignas(64) CUtensorMap { uint64_t opaque[16]; };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
struct EmuMap {
  const unsigned char* base;
  uint64_t dims[4], strides[4];
  uint32_t box[4];
};
static_assert(sizeof(EmuMap) <= sizeof(CUtensorMap), "tensor map stand-in too large");
inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType dt, cuuint32_t rank,
                                 void* addr, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* es,
                                 CUtensorMapInterleave il, CUtensorMapSwizzle sw,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill oob) {
  if (dt != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank != 4 || il != CU_TENSOR_MAP_INTERLEAVE_NONE ||
      sw != CU_TENSOR_MAP_SWIZZLE_128B || oob != CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE ||
      reinterpret_cast<uintptr_t>(addr) % 16 || box[0] * 2 > 128)
    return CUDA_ERROR_INVALID_VALUE;
  EmuMap m{static_cast<const unsigned char*>(addr), {}, {2}, {}};
  for (int i = 0; i < 4; ++i) {
    if (dims[i] == 0 || box[i] == 0 || box[i] > 256 || es[i] != 1) return CUDA_ERROR_INVALID_VALUE;
    m.dims[i] = dims[i];
    m.box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16 || strides[i - 1] >= (1ull << 40)) return CUDA_ERROR_INVALID_VALUE;
      m.strides[i] = strides[i - 1];
    }
  }
  std::memcpy(map, &m, sizeof(m));
  return CUDA_SUCCESS;
}
inline cudaError_t cudaGetDriverEntryPointByVersion(const char* name, void** fn, unsigned,
                                                    unsigned long long,
                                                    cudaDriverEntryPointQueryResult* found) {
  if (std::strcmp(name, "cuTensorMapEncodeTiled")) emu_fail("unknown driver entry point");
  *fn = reinterpret_cast<void*>(&emu_encode_tiled);
  *found = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}
// cp.async.bulk.tensor: the box lands at once, swizzled, zeros where it
// leaves the tensor, and its bytes complete on the barrier.
inline void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0, int c1, int c2,
                        int c3) {
  EmuMap m;
  std::memcpy(&m, map, sizeof(m));
  if (dst % 1024) emu_fail("a 128-byte-swizzled TMA destination must be 1024-byte aligned");
  const int c[4] = {c0, c1, c2, c3};
  uint32_t n = 0;
  for (uint32_t i3 = 0; i3 < m.box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < m.box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < m.box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < m.box[0]; ++i0, ++n) {
          const int64_t at[4] = {c[0] + i0, c[1] + i1, c[2] + i2, c[3] + i3};
          uint16_t v = 0;
          bool in = true;
          int64_t off = 0;
          for (int d = 0; d < 4; ++d) {
            in = in && at[d] >= 0 && at[d] < static_cast<int64_t>(m.dims[d]);
            off += at[d] * static_cast<int64_t>(m.strides[d]);
          }
          if (in) std::memcpy(&v, m.base + off, 2);
          const uint32_t to = emu_swz128(dst + 2 * n);
          emu_check(to, 2);
          std::memcpy(emu_smem() + to, &v, 2);
        }
  emu_complete_tx(bar, 2 * n);
}

// wgmma.mma_async: issued products wait in the thread's open group until a
// commit, and run (reading shared memory then) when a wait retires their
// group. A register A operand is exchanged within the warp at issue.
struct WgOp {
  float* d;
  int regs;
  bool a_smem;
  uint64_t da, db;
  float a[16][16];  // the warp's 16 rows of a register A operand
  int scale_d;
  bool b_mn;
};
thread_local std::vector<std::vector<WgOp>> emu_wg_groups;
thread_local std::vector<WgOp> emu_wg_open;
inline float emu_desc_elem(uint64_t desc, bool mn, int i, int k) {
  if ((desc >> 62) != 1) emu_fail("wgmma descriptor without the 128-byte swizzle");
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  // K-major: row i (m or n), k in the 128-byte row; MN-major: column i in
  // 64-wide blocks lbo apart, k along the rows.
  const uint32_t lin = mn ? start + (i >> 6) * lbo + (k >> 3) * sbo + (k & 7) * 128 + 2 * (i & 63)
                          : start + (i >> 3) * sbo + (i & 7) * 128 + 2 * k;
  return __bfloat162float({emu_half(emu_swz128(lin))});
}
inline void emu_wg_run(const WgOp& op) {
  const int w = emu_warp % 4, g = emu_lane / 4, t = emu_lane % 4;
  for (int i = 0; i < op.regs; ++i) {
    const int r = g + 8 * ((i % 4) / 2), col = 8 * (i / 4) + 2 * t + i % 2;
    double sum = op.scale_d ? op.d[i] : 0.0;
    for (int k = 0; k < 16; ++k) {
      const float a = op.a_smem ? emu_desc_elem(op.da, false, 16 * w + r, k) : op.a[r][k];
      sum += static_cast<double>(a) * emu_desc_elem(op.db, op.b_mn, col, k);
    }
    op.d[i] = static_cast<float>(sum);
  }
}
template <int M>
inline void wgmma_ss(float (&d)[M], uint64_t a, uint64_t b, int scale_d) {
  WgOp op{d, M, true, a, b, {}, scale_d, false};
  emu_wg_open.push_back(op);
}
template <int M>
inline void wgmma_rs(float (&d)[M], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  Warp& w = emu_w();
  for (int i = 0; i < 4; ++i) w.a[emu_lane][i] = a[i];
  w.bar.arrive_and_wait();
  WgOp op{d, M, false, 0, b, {}, scale_d, true};
  for (int l = 0; l < 32; ++l)
    for (int j = 0; j < 2; ++j) {
      const int g = l / 4, t = l % 4;
      op.a[g][2 * t + j] = emu_bf(w.a[l][0], j);
      op.a[g + 8][2 * t + j] = emu_bf(w.a[l][1], j);
      op.a[g][2 * t + 8 + j] = emu_bf(w.a[l][2], j);
      op.a[g + 8][2 * t + 8 + j] = emu_bf(w.a[l][3], j);
    }
  w.bar.arrive_and_wait();
  emu_wg_open.push_back(op);
}
inline void wgmma_fence() {}
inline void wgmma_commit() {
  emu_wg_groups.push_back(emu_wg_open);
  emu_wg_open.clear();
}
template <int N>
inline void wgmma_wait() {
  while (static_cast<int>(emu_wg_groups.size()) > N) {
    for (const WgOp& op : emu_wg_groups.front()) emu_wg_run(op);
    emu_wg_groups.erase(emu_wg_groups.begin());
  }
}
template <int M>
inline void fence_acc(float (&)[M]) {}

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
          emu_wg_groups.clear();
          emu_wg_open.clear();
          kernel(args...);
          for (auto& g : emu_groups)
            if (!g.empty()) emu_fail("a cp.async group was still in flight at exit");
          if (!emu_wg_groups.empty() || !emu_wg_open.empty())
            emu_fail("a wgmma group was still in flight at exit");
        });
      for (auto& th : threads) th.join();
    }
}
"""

# The device helpers written in inline PTX, replaced by the emulation's.
_PTX_HELPERS = ("smem_u32", "cp_async16", "cp_async4", "cp_async_commit",
                "cp_async_wait", "ldsm_x4", "ldsm_x4_trans", "mma_bf16",
                "mbar_init", "mbar_fence_init", "mbar_arrive", "mbar_expect_tx",
                "mbar_wait", "tma_load_4d", "named_bar_sync", "named_bar_arrive",
                "setmaxnreg_inc", "setmaxnreg_dec", "wgmma_fence",
                "wgmma_commit", "wgmma_wait", "fence_acc", "wgmma_ss",
                "wgmma_rs")


def _emulation_source(cu: str) -> str:
    src = re.sub(r"(#include <cuda\w*\.h>\n)+", '#include "emu.h"\n', cu,
                 count=1)
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
                             ("rt_flash_bwd_dkv", 8))} | {
        "rt_flash_design": [ctypes.c_int] * 3},
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


def _run(fns, name, tensors, q, k, causal, scale=None):
    b, lq, h, d = q.shape
    strides = _strides(*(t for t in tensors if t.dim() == 4))
    scale = d ** -0.5 if scale is None else scale
    err = fns[name](*(t.data_ptr() for t in tensors), b, h, lq, k.shape[1],
                    d, ctypes.cast(strides, ctypes.c_void_p), float(scale),
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


# Latent attention's softmax scale at d = 128 (2.2058 x 128^-0.5).
_MLA_SCALE = 2.2058 * 128 ** -0.5


# (causal, lq, lk, d, heads, dtype, scale, v_width): bf16 at d = 64 and
# 128 runs the warpgroup kernels (wgmma, TMA, mbarriers), at d = 256 the
# mma.sync kernels (dk/dv's two warps per row block); causal Lq != Lk both
# ways and ragged tails; rings that wrap (more kv or q tiles than stages);
# latent attention's scale with v a view of the first 128 of 256 columns a
# head; one f32 case runs the CUDA-core kernels.
@pytest.mark.parametrize("causal,lq,lk,d,h,dtype,scale,v_width", [
    (True, 70, 129, 64, 2, "bfloat16", None, 64),
    (False, 129, 70, 128, 1, "bfloat16", None, 128),
    (True, 100, 40, 128, 1, "bfloat16", None, 128),
    (True, 129, 129, 256, 1, "bfloat16", None, 256),
    (False, 40, 70, 64, 1, "float32", None, 64),
    (True, 300, 200, 128, 1, "bfloat16", _MLA_SCALE, 256),
    (False, 64, 300, 64, 1, "bfloat16", None, 64),
])
def test_flash_kernels_emulated_match_plain(emulated, causal, lq, lk, d, h,
                                            dtype, scale, v_width):
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(lq * 7 + lk + d)

    def rand(n, heads=h, width=d):
        return torch.randn((1, n, heads, width), generator=gen).to(tdt)

    q = rand(lq, 2 * h)[:, :, ::2]  # strided heads, read through strides
    k, do = rand(lk), rand(lq)
    v = rand(lk, width=v_width)[..., :d]  # a head stride of v_width
    o = torch.empty((1, lq, h, d), dtype=tdt)
    lse = torch.empty((1, h, lq))
    _run(emulated, "rt_flash_fwd", (q, k, v, o, lse), q, k, causal, scale)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = _flash_fwd_plain(f[0], f[1], f[2], causal, scale)
    _assert_close(o, o_ref, tdt, 2e-4)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-4, atol=2e-4)

    delta = _delta(o, do)
    dq = torch.empty_like(o)
    dk, dv = torch.empty_like(k), torch.empty_like(k)
    _run(emulated, "rt_flash_bwd_dq", (q, k, v, do, lse, delta, dq), q, k,
         causal, scale)
    _run(emulated, "rt_flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), q,
         k, causal, scale)
    _assert_close(dq, _flash_bwd_dq_plain(*f, lse, delta, causal, scale), tdt,
                  2e-3)
    for got, want in zip((dk, dv),
                         _flash_bwd_dkv_plain(*f, lse, delta, causal, scale)):
        _assert_close(got, want, tdt, 2e-3)


# (dtype, d, design): the design rt_flash_design names for every pass, the
# one the entry points launch and the wrapper counts.
@pytest.mark.parametrize("dtype,d,design", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"),
    ("bfloat16", 256, "mma_sync"), ("float32", 64, "cuda_cores"),
    ("float32", 128, "cuda_cores"), ("float32", 256, "cuda_cores"),
])
def test_flash_design_by_dtype_and_width(emulated, dtype, d, design):
    code = _DTYPE_CODE[getattr(torch, dtype)]
    assert [DESIGNS[emulated["rt_flash_design"](p, code, d)]
            for p in _PASS.values()] == [design] * 3
    assert emulated["rt_flash_design"](0, code, 96) == -1


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
