// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward: replaces the Pallas TPU kernel
// ray_tpu/ops/rmsnorm.py::_rmsnorm_kernel (launched by
// _rmsnorm_pallas_fwd2). Computes, per row of a [rows, d] input,
//     y = bf16_or_f32( f32(x) * rsqrt(mean(f32(x)^2) + eps) * f32(w) )
// multiplying x * inv first and then * w, in f32, rounding once at the
// end (the order of ray_tpu/ops/rmsnorm.py::_rmsnorm_ref).
//
// What bounds it: bytes. The function reads x and w once and writes y
// once: 2 * rows * d * itemsize + d * itemsize bytes. At 8 decode rows and
// d = 4096 in bf16 that is 139 KB, about 0.04 us at the H100's 3.35 TB/s,
// so at serving shapes the kernel is launch-bound, not memory-bound.
//
// Design (simple first; a fast design is later work): one block per row,
// blockDim a multiple of 32 chosen by the caller (a single warp for
// head_dim-sized rows). Each thread loads 16 bytes at a time where the row,
// w and y are 16-byte aligned, with a scalar tail otherwise. The sum of
// squares is in f32, reduced with warp shuffles and then across warps
// through shared memory. The second pass re-reads x (the row is in L1/L2)
// and writes y. The kernel allocates nothing.
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
// The hazard and the design: the Pallas kernel adds every grid step's dw
// into one (8, d) f32 block, correct only because a TPU grid runs in order.
// GPU blocks run concurrently, so here every block owns one f32 partial
// row of dw. A block takes rows b, b + gridDim.x, ... (one whole row at a
// time, so dx of a row is one block's work, with the forward's 16-byte
// loads); each thread adds g * xhat of the columns it touches into the
// block's partial, kept in shared memory, and writes it out at the end. A
// second small kernel sums the partials column by column in a fixed order,
// with compensated sums. No atomics: dw is the same from run to run. Both row sums the backward
// needs (x^2 and g*w*x) come from one pass and one block reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

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

template <typename T>
__global__ void rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                   T* __restrict__ y, int64_t d, int64_t x_stride,
                                   int64_t y_stride, float eps) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int64_t row = blockIdx.x;
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

// dx for rows blockIdx.x, blockIdx.x + gridDim.x, ...; the block's f32 dw
// partial (sum over its rows of g * xhat) goes to dw_part[blockIdx.x * d].
// Dynamic shared memory: d floats.
template <typename T>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                   const T* __restrict__ g, T* __restrict__ dx,
                                   float* __restrict__ dw_part, int64_t rows, int64_t d,
                                   int64_t x_stride, float eps) {
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
  for (int64_t i = threadIdx.x; i < d; i += blockDim.x) part[i] = sdw[i];
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller raises on anything else.
extern "C" int rt_rmsnorm_fwd(const void* x, const void* w, void* y, int64_t rows,
                              int64_t d, int64_t x_stride, int64_t y_stride, float eps,
                              int dtype, int threads, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(rows));
  dim3 block(static_cast<unsigned>(threads));
  if (dtype == 0) {
    rmsnorm_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), d,
        x_stride, y_stride, eps);
  } else if (dtype == 1) {
    rmsnorm_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), d, x_stride, y_stride, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward. x: rows with stride x_stride; g, dx: contiguous [rows, d];
// dw_part: f32 scratch of blocks * d; dw: [d] in x's dtype. dtype as in
// rt_rmsnorm_fwd. Launches the row kernel on `blocks` blocks and then the
// reduction, both on `stream`; returns cudaGetLastError().
extern "C" int rt_rmsnorm_bwd(const void* x, const void* w, const void* g, void* dx,
                              float* dw_part, void* dw, int64_t rows, int64_t d,
                              int64_t x_stride, float eps, int dtype, int threads,
                              int blocks, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 rgrid(static_cast<unsigned>((d + 31) / 32));
  const dim3 rblock(32, 8);
  if (dtype == 0) {
    rmsnorm_bwd_kernel<float><<<blocks, threads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(g), static_cast<float*>(dx), dw_part, rows, d, x_stride,
        eps);
    rmsnorm_dw_reduce_kernel<float><<<rgrid, rblock, 0, s>>>(dw_part, static_cast<float*>(dw),
                                                          blocks, d);
  } else if (dtype == 1) {
    rmsnorm_bwd_kernel<__nv_bfloat16><<<blocks, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dx), dw_part, rows,
        d, x_stride, eps);
    rmsnorm_dw_reduce_kernel<__nv_bfloat16><<<rgrid, rblock, 0, s>>>(
        dw_part, static_cast<__nv_bfloat16*>(dw), blocks, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
