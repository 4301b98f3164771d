// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward: replaces the Pallas TPU kernel
// ray_tpu/ops/rmsnorm.py::_rmsnorm_kernel (ray_tpu/ops/rmsnorm.py:49,
// launched by _rmsnorm_pallas_fwd2). Computes, per row of a [rows, d] input,
//     y = bf16_or_f32( f32(x) * rsqrt(mean(f32(x)^2) + eps) * f32(w) )
// multiplying x * inv first and then * w, in f32, rounding once at the
// end (the order of ray_tpu/ops/rmsnorm.py::_rmsnorm_ref).
//
// What bounds it: bytes. The function reads x and w once and writes y
// once: 2 * rows * d * itemsize + d * itemsize bytes, 20 us at 8192 x 2048
// in bf16 at the H100's 3.35 TB/s. At 8 decode rows and d = 4096 that is
// 139 KB, 0.04 us: there a launch waits on its memory round trips, and
// the least time is the launch itself, not the bytes.
//
// The design (rmsnorm_fwd_kernel): one pass over x. Where every row is
// whole aligned 16-byte vectors and a thread holds at most kFwdVpt (2) of
// them (d up to 16384 in bf16 and 8192 in f32), a row is owned by a
// group of tpr threads, the least power of two that leaves each at most
// two vectors: 8 threads at d = 128 in bf16 (32 rows at a time in a
// 256-thread block), 128 at 2048, 256 at 4096 (and at 2048 in f32), up to
// 1024. A thread starts its loads of the first row's x and of w together
// and keeps both in registers; it loads the next row's x before it
// reduces this row's sum of squares (shuffles within a warp; one barrier
// when a row spans warps), and writes y from the registers. So x is read
// once from device memory, and a launch of a few rows waits on one memory
// round trip, not two. The grid is the blocks the card keeps resident at
// once (the occupancy query, times the SMs), or a quarter of the row
// groups where that is more; each block walks rows (step * gridDim.x +
// blockIdx.x) * groups + group and keeps w in registers across them, so w
// is read once a block, not once a row. Two vectors, not four: four held
// the row in 64 registers and spilled in the 1024-thread bound, with half
// the blocks resident. Every other row (a scalar tail, an unaligned row
// or row stride, d above that) takes the two-pass kernel
// (rmsnorm_fwd_two_pass_kernel): a block walks rows one at a time, sums
// the squares, then reads x again with w and writes y. Neither kernel
// allocates anything.
//
// Backward: replaces ray_tpu/ops/rmsnorm.py::_rmsnorm_bwd_kernel (launched
// by _rmsnorm_pallas_bwd2). Per row, recomputing the normalizer from x:
//     inv = rsqrt(mean(x^2) + eps), xhat = x * inv, gw = g * w,
//     dx  = inv * (gw - xhat * mean(gw * xhat))          (x's dtype)
// and across rows dw = sum_rows(g * xhat) in f32, rounded to w's dtype.
//
// What bounds it: bytes. It reads x and g and writes dx (3 * rows * d *
// itemsize) plus w and dw once: at 8192 x 2048 bf16, 100.7 MB, 30 us at
// 3.35 TB/s. The f32 partials of dw add 2 * blocks * d * 4 bytes, a few
// per cent at that shape.
//
// The hazard: the Pallas kernel adds every grid step's dw into one (8, d)
// f32 block, correct only because a TPU grid runs in order. GPU blocks run
// concurrently, so here every block owns one f32 partial row of dw, and a
// second small kernel (rmsnorm_dw_reduce_kernel) sums the partials column
// by column in a fixed order, with compensated sums. No atomics: dw is the
// same from run to run. A launch whose rows fit one block (a few rows) has
// that block write dw itself and skips the second kernel: at 1 to 5 rows
// the two launches, not the bytes, are the time.
//
// The design (rmsnorm_bwd_kernel): one pass over x and g. Where every row
// is whole aligned 16-byte vectors and a thread holds at most kMaxVpt of
// them (d up to 8192 in bf16 and 4096 in f32 at 256 threads), a row is
// owned by a group of threads, a power of two: 16 threads at d = 128 in
// bf16 (16 rows at a time in a 256-thread block), the whole block at d =
// 2048, each thread one vector. A thread keeps its x, g and w vectors in
// registers across the row's reduction, so x and g are read once from
// device memory; both row sums (x^2 and g*w*x) come from that one read and
// one reduction (shuffles within a warp; one barrier when a row spans
// warps). A thread owns the same columns of every row, so its part of dw
// stays in f32 registers and is written out once, at the end. The next
// row's x and g are loaded before the current row's reduction, so a load
// is in flight while the block waits at its barrier. Every other row (a
// scalar tail, an unaligned row, d above that) takes the two-pass kernel
// (rmsnorm_bwd_two_pass_kernel): a block walks its rows one at a time,
// reads x, g and w, reduces, reads them again for dx and adds its dw into
// shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxVpt = 4;  // 16-byte vectors of x and of g a thread holds (one-pass backward)
// The one-pass forward: a row's group is the least power of two of
// threads (up to 1024) that leaves each at most kFwdVpt 16-byte vectors,
// in blocks of up to kFwdThreads threads; a block walks about kFwdSteps
// steps of rows where the resident blocks would walk more.
constexpr int kFwdVpt = 2;
constexpr int kFwdThreads = 256;
constexpr int kFwdSteps = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kMaxThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (nwarps == 1) return v;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nwarps ? partial[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

// One pass, for rows of whole 16-byte vectors, at most VPT of them a
// thread. A group of tpr threads (a power of two that divides blockDim.x)
// owns one row at a time; thread l of a group owns vectors l, l + tpr, ...
// (below nvec) of every row it touches, so its w stays in registers. The
// groups of a block take rows (step * gridDim.x + blockIdx.x) * groups +
// group, step = 0, 1, ...; the loop's bound is the same for every thread
// of the block, so its barriers match. Each thread loads the next row's x
// before the current row's sum is reduced. A group's sum is reduced by
// shuffles where it fits in a warp, else through one barrier (per-warp
// sums in shared memory, double-buffered by step).
template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                       int64_t rows, int64_t d, int64_t x_stride, int64_t y_stride, float eps,
                       int tpr) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float wsum[2][kMaxThreads / 32];
  const int64_t nvec = d / kVec;
  const int groups = blockDim.x / tpr;
  const int gi = threadIdx.x / tpr, gl = threadIdx.x % tpr;
  const int warp = threadIdx.x >> 5;
  const int64_t step_rows = static_cast<int64_t>(gridDim.x) * groups;

  bool own[VPT];
  uint4 xv[VPT], xn[VPT], wv[VPT];
  int64_t base = static_cast<int64_t>(blockIdx.x) * groups;
  // The first row's x and w, all in flight before any is used.
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    own[i] = gl + i * tpr < nvec;
    xv[i] = own[i] && base + gi < rows
                ? reinterpret_cast<const uint4*>(x + (base + gi) * x_stride)[gl + i * tpr]
                : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    wv[i] = own[i] ? reinterpret_cast<const uint4*>(w)[gl + i * tpr] : make_uint4(0, 0, 0, 0);

  for (int step = 0; base < rows; base += step_rows, ++step) {
    const int64_t row = base + gi;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const T* v = reinterpret_cast<const T*>(&xv[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f32(v[j]);
        ss += f * f;
      }
    }
    // The next row's x, in flight during this row's reduction and store.
    const int64_t next = row + step_rows;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      xn[i] = own[i] && next < rows
                  ? reinterpret_cast<const uint4*>(x + next * x_stride)[gl + i * tpr]
                  : make_uint4(0, 0, 0, 0);
    if (tpr <= 32) {
      for (int off = tpr >> 1; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    } else {
      float* ws = wsum[step & 1];
      ss = warp_sum(ss);
      if ((threadIdx.x & 31) == 0) ws[warp] = ss;
      __syncthreads();
      ss = 0.0f;
      for (int k = gi * (tpr >> 5); k < (gi + 1) * (tpr >> 5); ++k) ss += ws[k];
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (!own[i]) continue;
        const T* xs = reinterpret_cast<const T*>(&xv[i]);
        const T* wr = reinterpret_cast<const T*>(&wv[i]);
        uint4 out;
        T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kVec; ++j) ov[j] = from_f32<T>(to_f32(xs[j]) * inv * to_f32(wr[j]));
        reinterpret_cast<uint4*>(y + row * y_stride)[gl + i * tpr] = out;
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) xv[i] = xn[i];
  }
}

// Two passes, for every other row (a scalar tail, an unaligned row or row
// stride, or more vectors than a thread holds): rows blockIdx.x, blockIdx.x
// + gridDim.x, ..., one at a time. The first pass sums the squares (16-byte
// loads where this row allows them, scalars otherwise), the second reads x
// again with w and writes y.
template <typename T>
__global__ void rmsnorm_fwd_two_pass_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                            T* __restrict__ y, int64_t rows, int64_t d,
                                            int64_t x_stride, int64_t y_stride, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * x_stride;
    T* yr = y + row * y_stride;
    const bool vec_ok =
        ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(w) |
          reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
    const int64_t nvec = vec_ok ? d / kVec : 0;
    const int64_t tail = nvec * kVec;

    float ss = 0.0f;
    for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float f = to_f32(v[j]);
        ss += f * f;
      }
    }
    for (int64_t i = tail + threadIdx.x; i < d; i += blockDim.x) {
      float f = to_f32(xr[i]);
      ss += f * f;
    }
    ss = block_sum(ss);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

    for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
      uint4 xraw = reinterpret_cast<const uint4*>(xr)[i];
      uint4 wraw = reinterpret_cast<const uint4*>(w)[i];
      uint4 out;
      const T* xv = reinterpret_cast<const T*>(&xraw);
      const T* wv = reinterpret_cast<const T*>(&wraw);
      T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < kVec; ++j) ov[j] = from_f32<T>(to_f32(xv[j]) * inv * to_f32(wv[j]));
      reinterpret_cast<uint4*>(yr)[i] = out;
    }
    for (int64_t i = tail + threadIdx.x; i < d; i += blockDim.x) {
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(w[i]));
    }
  }
}


// Sum of two values over the block; every thread gets both totals.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 partial2[kMaxThreads / 32];
  __shared__ float2 total2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (nwarps == 1) return make_float2(a, b);
  if (lane == 0) partial2[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 s = lane < nwarps ? partial2[lane] : make_float2(0.0f, 0.0f);
    s.x = warp_sum(s.x);
    s.y = warp_sum(s.y);
    if (lane == 0) total2 = s;
  }
  __syncthreads();
  return total2;
}

// One pass, for rows of whole 16-byte vectors, at most kMaxVpt of them a
// thread. A group of tpr threads (a power of two that divides blockDim.x)
// owns one row at a time; thread l of a group owns vectors l, l + tpr, ...
// (below nvec) of every row it touches, so its w and its part of dw stay in
// registers. The groups of a block take rows (step * gridDim.x + blockIdx.x)
// * groups + group, step = 0, 1, ...; each thread loads the next row's x and
// g before the current row's sums are reduced. A group's sums are reduced
// by shuffles where it fits in a warp, else through one barrier (per-warp
// sums, double-buffered by row). The block's f32 dw partial goes to
// dw_part[blockIdx.x * d]; with several groups it is summed over them in a
// fixed order through dynamic shared memory (groups * d floats). A launch
// of one block writes dw itself (dw_one, rounded once) instead.
template <typename T, int VPT>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                   const T* __restrict__ g, T* __restrict__ dx,
                                   float* __restrict__ dw_part, T* __restrict__ dw_one,
                                   int64_t rows, int64_t d, int64_t x_stride, float eps,
                                   int tpr) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) float red[];
  __shared__ float2 wsum[2][kMaxThreads / 32];
  const int64_t nvec = d / kVec;
  const int groups = blockDim.x / tpr;
  const int gi = threadIdx.x / tpr, gl = threadIdx.x % tpr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  bool own[VPT];
  uint4 wv[VPT];
  float dwp[VPT][kVec];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    own[i] = gl + i * tpr < nvec;
    wv[i] = own[i] ? reinterpret_cast<const uint4*>(w)[gl + i * tpr] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dwp[i][j] = 0.0f;
  }
  auto first_of = [&](int64_t step) { return (step * gridDim.x + blockIdx.x) * groups; };
  auto load = [&](int64_t row, uint4 (&xv)[VPT], uint4 (&gv)[VPT]) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const bool ok = own[i] && row < rows;
      xv[i] = ok ? reinterpret_cast<const uint4*>(x + row * x_stride)[gl + i * tpr]
                 : make_uint4(0, 0, 0, 0);
      gv[i] = ok ? reinterpret_cast<const uint4*>(g + row * d)[gl + i * tpr]
                 : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 xc[VPT], gc[VPT], xn[VPT], gn[VPT];
  load(first_of(0) + gi, xc, gc);
  for (int64_t step = 0; first_of(step) < rows; ++step) {
    const int64_t row = first_of(step) + gi;
    float ss = 0.0f, sgwx = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const T* xv = reinterpret_cast<const T*>(&xc[i]);
      const T* gv = reinterpret_cast<const T*>(&gc[i]);
      const T* ww = reinterpret_cast<const T*>(&wv[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xf = to_f32(xv[j]);
        ss += xf * xf;
        sgwx += to_f32(gv[j]) * to_f32(ww[j]) * xf;
      }
    }
    load(first_of(step + 1) + gi, xn, gn);  // in flight during the reduction
    if (tpr <= 32) {
      for (int off = tpr >> 1; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        sgwx += __shfl_xor_sync(0xffffffffu, sgwx, off);
      }
    } else {
      float2* ws = wsum[step & 1];
      ss = warp_sum(ss);
      sgwx = warp_sum(sgwx);
      if (lane == 0) ws[warp] = make_float2(ss, sgwx);
      __syncthreads();
      ss = sgwx = 0.0f;
      for (int k = gi * (tpr >> 5); k < (gi + 1) * (tpr >> 5); ++k) {
        ss += ws[k].x;
        sgwx += ws[k].y;
      }
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    // mean(gw * xhat) = inv * mean(gw * x)
    const float mean_gwx = inv * sgwx / static_cast<float>(d);
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (!own[i]) continue;
        const T* xv = reinterpret_cast<const T*>(&xc[i]);
        const T* gv = reinterpret_cast<const T*>(&gc[i]);
        const T* ww = reinterpret_cast<const T*>(&wv[i]);
        uint4 out;
        T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xhat = to_f32(xv[j]) * inv;
          const float gf = to_f32(gv[j]);
          const float gw = gf * to_f32(ww[j]);
          ov[j] = from_f32<T>(inv * (gw - xhat * mean_gwx));
          dwp[i][j] += gf * xhat;
        }
        reinterpret_cast<uint4*>(dx + row * d)[gl + i * tpr] = out;
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      xc[i] = xn[i];
      gc[i] = gn[i];
    }
  }

  float* part = dw_part + static_cast<int64_t>(blockIdx.x) * d;
  float* mine = groups == 1 ? part : red + static_cast<int64_t>(gi) * d;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (!own[i]) continue;
    const int64_t c0 = static_cast<int64_t>(gl + i * tpr) * kVec;
    if (groups == 1 && dw_one != nullptr) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dw_one[c0 + j] = from_f32<T>(dwp[i][j]);
      continue;
    }
    float4* at = reinterpret_cast<float4*>(mine + c0);
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      at[j / 4] = make_float4(dwp[i][j], dwp[i][j + 1], dwp[i][j + 2], dwp[i][j + 3]);
  }
  if (groups == 1) return;
  __syncthreads();
  for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
    float sum = 0.0f;
    for (int k = 0; k < groups; ++k) sum += red[k * d + c];
    if (dw_one != nullptr)
      dw_one[c] = from_f32<T>(sum);
    else
      part[c] = sum;
  }
}

// Two passes, for every other row (a scalar tail, an unaligned row, or more
// vectors than a thread holds): dx for rows blockIdx.x, blockIdx.x +
// gridDim.x, ...; the block's f32 dw partial (sum over its rows of g * xhat)
// goes to dw_part[blockIdx.x * d] (to dw_one, rounded, in a launch of one
// block). Dynamic shared memory: d floats.
template <typename T>
__global__ void rmsnorm_bwd_two_pass_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                            const T* __restrict__ g, T* __restrict__ dx,
                                            float* __restrict__ dw_part, T* __restrict__ dw_one,
                                            int64_t rows, int64_t d, int64_t x_stride,
                                            float eps) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float sdw[];
  for (int64_t i = threadIdx.x; i < d; i += blockDim.x) sdw[i] = 0.0f;
  // A column's owner thread differs between the scalar and the 16-byte
  // paths (and so between rows of other alignment): a barrier separates
  // every row's updates of sdw from the next one's.
  __syncthreads();
  // g and dx are contiguous [rows, d]; w is contiguous [d].
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * x_stride;
    const T* gr = g + row * d;
    T* dxr = dx + row * d;
    const bool vec_ok =
        ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(w) |
          reinterpret_cast<uintptr_t>(gr) | reinterpret_cast<uintptr_t>(dxr)) & 15) == 0;
    const int64_t nvec = vec_ok ? d / kVec : 0;
    const int64_t tail = nvec * kVec;

    float ss = 0.0f, sgwx = 0.0f;
    for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
      uint4 xraw = reinterpret_cast<const uint4*>(xr)[i];
      uint4 graw = reinterpret_cast<const uint4*>(gr)[i];
      uint4 wraw = reinterpret_cast<const uint4*>(w)[i];
      const T* xv = reinterpret_cast<const T*>(&xraw);
      const T* gv = reinterpret_cast<const T*>(&graw);
      const T* wv = reinterpret_cast<const T*>(&wraw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xf = to_f32(xv[j]);
        ss += xf * xf;
        sgwx += to_f32(gv[j]) * to_f32(wv[j]) * xf;
      }
    }
    for (int64_t i = tail + threadIdx.x; i < d; i += blockDim.x) {
      const float xf = to_f32(xr[i]);
      ss += xf * xf;
      sgwx += to_f32(gr[i]) * to_f32(w[i]) * xf;
    }
    const float2 sums = block_sum2(ss, sgwx);
    const float inv = rsqrtf(sums.x / static_cast<float>(d) + eps);
    // mean(gw * xhat) = inv * mean(gw * x)
    const float mean_gwx = inv * sums.y / static_cast<float>(d);

    for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
      uint4 xraw = reinterpret_cast<const uint4*>(xr)[i];
      uint4 graw = reinterpret_cast<const uint4*>(gr)[i];
      uint4 wraw = reinterpret_cast<const uint4*>(w)[i];
      uint4 out;
      const T* xv = reinterpret_cast<const T*>(&xraw);
      const T* gv = reinterpret_cast<const T*>(&graw);
      const T* wv = reinterpret_cast<const T*>(&wraw);
      T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xhat = to_f32(xv[j]) * inv;
        const float gf = to_f32(gv[j]);
        const float gw = gf * to_f32(wv[j]);
        ov[j] = from_f32<T>(inv * (gw - xhat * mean_gwx));
        sdw[i * kVec + j] += gf * xhat;
      }
      reinterpret_cast<uint4*>(dxr)[i] = out;
    }
    for (int64_t i = tail + threadIdx.x; i < d; i += blockDim.x) {
      const float xhat = to_f32(xr[i]) * inv;
      const float gf = to_f32(gr[i]);
      const float gw = gf * to_f32(w[i]);
      dxr[i] = from_f32<T>(inv * (gw - xhat * mean_gwx));
      sdw[i] += gf * xhat;
    }
    __syncthreads();
  }
  float* part = dw_part + static_cast<int64_t>(blockIdx.x) * d;
  for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
    if (dw_one != nullptr)
      dw_one[i] = from_f32<T>(sdw[i]);
    else
      part[i] = sdw[i];
  }
}

// dw[c] = sum over the nparts partial rows of column c, in a fixed order:
// a block takes 32 columns; its 8 thread rows each sum every 8th partial
// with Kahan compensation (thousands of partials at head-width rows, whose
// plain running sum would lose digits), then one thread adds the 8.
template <typename T>
__global__ void rmsnorm_dw_reduce_kernel(const float* __restrict__ dw_part,
                                         T* __restrict__ dw, int64_t nparts, int64_t d) {
  __shared__ float acc[8][33];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x;
  float s = 0.0f, comp = 0.0f;
  if (c < d) {
    for (int64_t p = threadIdx.y; p < nparts; p += 8) {
      const float y = dw_part[p * d + c] - comp;
      const float t = s + y;
      comp = (t - s) - y;
      s = t;
    }
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += acc[i][threadIdx.x];
    dw[c] = from_f32<T>(total);
  }
}

// Launch a row kernel with `smem` bytes of dynamic shared memory. Dynamic
// and static shared memory together above 48 KB need the kernel's opt-in
// (the two-pass kernel at d = 12288 takes 48 KB of dynamic and a few
// hundred bytes of static shared memory).
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t s,
                Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, s>>>(args...);
  return 0;
}

// Blocks of `threads` threads that one SM keeps resident for `kernel`,
// from the occupancy query, kept in `cache` (indexed by threads / 32):
// the query costs host time that a launch of a few rows should not pay
// twice. Returns 0 or the query's error.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, std::atomic<int>* cache, int* per_sm) {
  *per_sm = cache[threads / 32].load(std::memory_order_relaxed);
  if (*per_sm > 0) return 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*per_sm < 1) *per_sm = 1;
  cache[threads / 32].store(*per_sm, std::memory_order_relaxed);
  return 0;
}

// One cache of resident blocks per forward kernel: VPT 1..kFwdVpt for the
// one-pass kernel, 0 for the two-pass one.
template <typename T, int VPT>
std::atomic<int>* fwd_cache() {
  static std::atomic<int> cache[kMaxThreads / 32 + 1];
  return cache;
}

// Launch `kernel` on the blocks the card keeps resident at once (sms
// times the blocks an SM holds), or on wanted / kFwdSteps blocks where
// that is more, and never on more than `wanted`: each block walks rows.
// On the H100 a grid of exactly the resident blocks left the shapes that
// stream from device memory 1-5% slower (its tail: no block is left to
// take an idle SM's place); a grid of one step a block reloads w from L2
// once a row group, which an input held in L2 pays for.
template <typename T, int VPT, typename Kernel, typename... Args>
int launch_resident(Kernel kernel, int64_t wanted, int threads, int sms, cudaStream_t s,
                    Args... args) {
  int per_sm = 0;
  const int err = resident_blocks(kernel, threads, fwd_cache<T, VPT>(), &per_sm);
  if (err != 0) return err;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t stepped = (wanted + kFwdSteps - 1) / kFwdSteps;
  const int64_t cap = resident > stepped ? resident : stepped;
  const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
  kernel<<<blocks, threads, 0, s>>>(args...);
  return 0;
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, int64_t rows, int64_t d, int64_t x_stride,
               int64_t y_stride, float eps, int sms, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  const int64_t nvec = d / kVec;
  int tpr = 1;
  while (static_cast<int64_t>(tpr) * kFwdVpt < nvec && tpr < kMaxThreads) tpr <<= 1;
  const int64_t vpt = (nvec + tpr - 1) / tpr;
  const bool one_pass =
      d % kVec == 0 && vpt <= kFwdVpt &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(y)) & 15) == 0 &&
      (x_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
      (y_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  if (!one_pass) {
    // A thread per 16-byte vector, in whole warps, at most 256 a row.
    const int64_t n = nvec > 0 ? nvec : 1;
    const int threads = static_cast<int>(n >= 256 ? 256 : (n + 31) / 32 * 32);
    return launch_resident<T, 0>(rmsnorm_fwd_two_pass_kernel<T>, rows, threads, sms, s, xt, wt,
                                 yt, rows, d, x_stride, y_stride, eps);
  }
  // At least a warp a block; up to 256 threads while there are rows to
  // fill them (tpr itself where a row needs more).
  int threads = tpr < 32 ? 32 : tpr;
  while (threads < kFwdThreads && threads < rows * tpr) threads <<= 1;
  const int64_t groups = threads / tpr;
  const int64_t wanted = (rows + groups - 1) / groups;
  if (vpt == 1)
    return launch_resident<T, 1>(rmsnorm_fwd_kernel<T, 1>, wanted, threads, sms, s, xt, wt, yt,
                                 rows, d, x_stride, y_stride, eps, tpr);
  return launch_resident<T, 2>(rmsnorm_fwd_kernel<T, 2>, wanted, threads, sms, s, xt, wt, yt,
                               rows, d, x_stride, y_stride, eps, tpr);
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* g, void* dx, float* dw_part, void* dw,
               int64_t rows, int64_t d, int64_t x_stride, float eps, int threads, int blocks,
               cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const int64_t nvec = d / kVec;
  int tpr = 1;
  while (tpr < nvec && tpr < threads) tpr <<= 1;
  const int64_t vpt = (nvec + tpr - 1) / tpr;
  const size_t red = tpr < threads ? static_cast<size_t>(threads / tpr) * d * sizeof(float) : 0;
  const bool one_pass =
      d % kVec == 0 && (threads & (threads - 1)) == 0 && vpt <= kMaxVpt && red <= 48 * 1024 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx)) & 15) == 0 &&
      (x_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  // Blocks that get rows; a launch of one block writes dw itself and needs
  // no reduction.
  const int64_t per_block = one_pass ? threads / tpr : 1;
  const int64_t wanted = (rows + per_block - 1) / per_block;
  const int used = static_cast<int>(wanted < blocks ? wanted : blocks);
  T* dw_one = used == 1 ? static_cast<T*>(dw) : nullptr;
  int err = 0;
  if (!one_pass) {
    const size_t smem = static_cast<size_t>(d) * sizeof(float);
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_rows(rmsnorm_bwd_two_pass_kernel<T>, used, threads, smem, s, xt, wt, gt, dxt,
                      dw_part, dw_one, rows, d, x_stride, eps);
  } else if (vpt == 1) {
    err = launch_rows(rmsnorm_bwd_kernel<T, 1>, used, threads, red, s, xt, wt, gt, dxt, dw_part,
                      dw_one, rows, d, x_stride, eps, tpr);
  } else if (vpt == 2) {
    err = launch_rows(rmsnorm_bwd_kernel<T, 2>, used, threads, red, s, xt, wt, gt, dxt, dw_part,
                      dw_one, rows, d, x_stride, eps, tpr);
  } else if (vpt == 3) {
    err = launch_rows(rmsnorm_bwd_kernel<T, 3>, used, threads, red, s, xt, wt, gt, dxt, dw_part,
                      dw_one, rows, d, x_stride, eps, tpr);
  } else {
    err = launch_rows(rmsnorm_bwd_kernel<T, 4>, used, threads, red, s, xt, wt, gt, dxt, dw_part,
                      dw_one, rows, d, x_stride, eps, tpr);
  }
  if (err != 0) return err;
  if (used > 1) {
    const dim3 rgrid(static_cast<unsigned>((d + 31) / 32));
    const dim3 rblock(32, 8);
    rmsnorm_dw_reduce_kernel<T><<<rgrid, rblock, 0, s>>>(dw_part, static_cast<T*>(dw), used, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; sms: the card's SM count (the grid
// is sized from it, see launch_resident). Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller raises on anything else.
// The one-pass kernel where every row is whole aligned 16-byte vectors, at
// most kFwdVpt of them a thread of a 1024-thread group; the two-pass
// kernel otherwise.
extern "C" int rt_rmsnorm_fwd(const void* x, const void* w, void* y, int64_t rows,
                              int64_t d, int64_t x_stride, int64_t y_stride, float eps,
                              int dtype, int sms, void* stream) {
  if (rows <= 0 || d <= 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    err = launch_fwd<float>(x, w, y, rows, d, x_stride, y_stride, eps, sms, s);
  else if (dtype == 1)
    err = launch_fwd<__nv_bfloat16>(x, w, y, rows, d, x_stride, y_stride, eps, sms, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// Backward. x: rows with stride x_stride; g, dx: contiguous [rows, d];
// dw_part: f32 scratch of blocks * d; dw: [d] in x's dtype. dtype as in
// rt_rmsnorm_fwd. Launches the row kernel on at most `blocks` blocks (no
// more than have rows to take) and then, unless that is one block, the
// reduction, both on `stream`; returns cudaGetLastError(). The row kernel is
// the one-pass kernel where every row is whole aligned 16-byte vectors, at
// most kMaxVpt of them a thread, and `threads` is a power of two; the
// two-pass kernel otherwise.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* w, const void* g, void* dx,
                              float* dw_part, void* dw, int64_t rows, int64_t d,
                              int64_t x_stride, float eps, int dtype, int threads,
                              int blocks, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, w, g, dx, dw_part, dw, rows, d, x_stride, eps, threads, blocks,
                             s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w, g, dx, dw_part, dw, rows, d, x_stride, eps, threads,
                                     blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
