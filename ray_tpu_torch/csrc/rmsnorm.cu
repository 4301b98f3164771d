// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/rmsnorm.py::_rmsnorm_kernel
// (launched by _rmsnorm_pallas_fwd2). Computes, per row of a [rows, d]
// input,
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
