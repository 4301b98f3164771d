// Flash attention for Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   rt_flash_fwd     <- _flash_fwd_kernel     (launched by _fwd_pallas)
//   rt_flash_bwd_dq  <- _flash_bwd_dq_kernel  (first pallas_call of _bwd_pallas)
//   rt_flash_bwd_dkv <- _flash_bwd_dkv_kernel (second pallas_call of _bwd_pallas)
// with the reference's arithmetic: sm_scale = d^-0.5; scores of positions
// at or beyond the true Lq/Lk, and above the top-left causal diagonal
// (q_pos < k_pos), are -1e30; the forward keeps an online softmax (m, l, o
// in f32) and writes o in the input dtype and lse = m + log(max(l, 1e-20))
// in f32; the backward recomputes p = exp(s - lse) tile by tile (p is never
// stored), ds = p * (do v^T - delta) with delta = rowsum(do * o) computed
// by the caller, dq = sm_scale * ds k, dv = p^T do, dk = sm_scale * ds^T q,
// each accumulated in f32 and rounded once.
//
// What bounds them: at the training shape ([b*h = 128, L = 1024, d = 128],
// bf16, causal) the forward does 4 * 128 * 128 * (1024 * 1025 / 2) = 34.4
// GFLOP of products against 134 MB of q, k, v and o: the tensor cores'
// 989 TFLOP/s would take 35 us and the bytes 40 us, so the bound is the
// bytes, and the backward's 2.5x the products and ~1.7x the bytes land on
// the same line. These kernels do not come near it: they multiply on the
// CUDA cores in f32 (67 TFLOP/s at best), so they are bound by the FMA
// rate and by shared-memory bandwidth, at milliseconds per call. That is
// the simple design this port starts from; a tensor-core (mma/wgmma)
// design is the next step for each of them.
//
// Design. Threads: 256 per block as a 16 x 16 grid (ty = tid / 16,
// tx = tid % 16). A block owns one (batch, head) pair and one tile of
// rows: BQ query rows (forward, dq) or BK key rows (dk/dv), and loops over
// the tiles of the other side - kv tiles up to the diagonal for the
// forward and dq, q tiles from floor(kv_start / BQ) for dk/dv - the loop
// inside the block that replaces the TPU's sequential grid axis. Tiles
// are read straight from the [b, L, h, d] layout through strides (no
// transposed or padded copy), 16 bytes per thread, converted to f32 and
// kept in shared memory with rows padded by 4 floats, so the 16-byte
// shared loads of the products meet no bank conflicts. Rows past the
// true length are filled with zeros, and their scores masked, in the
// kernel. Every product is one of two register-blocked micro-kernels:
// A.B^T contracting over d (scores), where a thread holds rows ty + 16i
// and columns tx + 16j, so a score row lives in 16 lanes of one warp and
// its max and sum are warp shuffles; and A.B contracting over a tile
// (p.v, ds.k, p^T.do, ds^T.q), where a thread holds rows ty + 16i and
// columns 4tx + 64j + e of the d-wide result. Tiles are 64 x 64 for
// d = 64 and 128 and 32 x 32 for d = 256, to stay inside 227 KB of shared
// memory. The forward reuses one buffer for K and then V, and visits the
// longest causal q tiles first. Nothing is allocated here: the wrapper
// hands in every output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;  // floats of padding per shared-memory row
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, l, h;  // elements; the d axis has stride 1
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Four consecutive elements of a row, rounded once from f32.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// ROWS rows of width D, starting at row row0 of a sequence of length len,
// from `base` (already at this batch and head; row stride ls elements)
// into dst[ROWS][D + kPad] as f32 times `scale`. Rows at or beyond len are
// zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ base, int64_t ls,
                                          int row0, int len, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int id = threadIdx.x; id < ROWS * kChunks; id += kThreads) {
    const int r = id / kChunks;
    const int c = (id % kChunks) * kVec;
    float* out = dst + r * (D + kPad) + c;
    const int row = row0 + r;
    if (row < len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + row * ls + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        store4(out + j, to_f32(v[j]) * scale, to_f32(v[j + 1]) * scale,
               to_f32(v[j + 2]) * scale, to_f32(v[j + 3]) * scale);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; j += 4) store4(out + j, 0.f, 0.f, 0.f, 0.f);
    }
  }
}

// acc[i][j] += sum_c A[ty + 16i][c] * B[tx + 16j][c] over c < D.
// A: [>= 16 RM][D + kPad], B: [>= 16 CN][D + kPad] in shared memory.
template <int D, int RM, int CN>
__device__ __forceinline__ void mma_nt(float (&acc)[RM][CN], const float* A, const float* B,
                                       int ty, int tx) {
  constexpr int S = D + kPad;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * S + c);
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * S + c);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4j + e] += sum_k A[ty + 16i][k] * B[k][4tx + 64j + e] over k < KD.
// A: [>= 16 RM][KD + kPad], B: [KD][D + kPad] in shared memory.
template <int KD, int D, int RM>
__device__ __forceinline__ void mma_nn(float (&acc)[RM][D / 16], const float* A,
                                       const float* B, int ty, int tx) {
  constexpr int SA = KD + kPad;
  constexpr int SB = D + kPad;
  constexpr int NJ = D / 64;
#pragma unroll 2
  for (int k = 0; k < KD; k += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * SA + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(B + (k + kk) * SB + 4 * tx + 64 * j);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = comp(a[i], kk);
          acc[i][4 * j + 0] = fmaf(av, b.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(av, b.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(av, b.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(av, b.w, acc[i][4 * j + 3]);
        }
      }
    }
  }
}

// Max and sum over the 16 lanes that share a ty (one half of a warp).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool valid_pos(int qpos, int kpos, int Lq, int Lk, int causal) {
  return qpos < Lq && kpos < Lk && (!causal || qpos >= kpos);
}

// Rows [row0, row0 + 16 RM) of a [rows][D] f32 accumulator held as
// acc[i][4j + e] (row ty + 16i, column 4tx + 64j + e), times `scale`, to
// out (at this batch and head, row stride ls), rows below len only.
template <typename T, int D, int RM>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int64_t ls, int row0, int len,
                                           const float (&acc)[RM][D / 16], const float (&scale)[RM],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= len) continue;
    T* o = out + row * ls;
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
      store4(o + 4 * tx + 64 * j, acc[i][4 * j] * scale[i], acc[i][4 * j + 1] * scale[i],
             acc[i][4 * j + 2] * scale[i], acc[i][4 * j + 3] * scale[i]);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, batch * head).
// Shared memory: Q [BQ][D+4] (pre-scaled by sm_scale, as the reference
// scales q), K then V [BK][D+4], P [BQ][BK+4].
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int H, int Lq, int Lk,
                     Strides qs, Strides ks, Strides vs, Strides os, float sm_scale, int causal) {
  constexpr int RM = BQ / 16, CN = BK / 16, DN = D / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + BQ * (D + kPad);
  float* sP = sKV + BK * (D + kPad);

  const int n_qt = (Lq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  load_tile<T, D, BQ>(sQ, qb, qs.l, q0, Lq, sm_scale);

  float acc[RM][DN];
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (Lk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's V and P are no longer read
    load_tile<T, D, BK>(sKV, kb, ks.l, k0, Lk, 1.0f);
    __syncthreads();
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    mma_nt<D, RM, CN>(s, sQ, sKV, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        if (!valid_pos(qpos, k0 + tx + 16 * j, Lq, Lk, causal)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every score read K: reuse the buffer for V
    load_tile<T, D, BK>(sKV, vb, vs.l, k0, Lk, 1.0f);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sP[(ty + 16 * i) * (BK + kPad) + tx + 16 * j] = s[i][j];
    __syncthreads();
    mma_nn<BK, D, RM>(acc, sP, sKV, ty, tx);
  }

  float inv_l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float l_safe = fmaxf(l[i], 1e-20f);
    inv_l[i] = 1.0f / l_safe;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < Lq) lse[static_cast<int64_t>(bh) * Lq + row] = m[i] + logf(l_safe);
  }
  store_rows<T, D, RM>(o + b * os.b + h * os.h, os.l, q0, Lq, acc, inv_l, ty, tx);
}

// ---------------------------------------------------------------------------
// dq: one block per (q tile, batch * head), over kv tiles up to the
// diagonal. Shared memory: Q (pre-scaled), dO [BQ][D+4]; K, V [BK][D+4];
// dS [BQ][BK+4].
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int Lq, int Lk, Strides qs, Strides ks,
                        Strides vs, Strides dos, Strides dqs, float sm_scale, int causal) {
  constexpr int RM = BQ / 16, CN = BK / 16, DN = D / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + BQ * (D + kPad);
  float* sK = sDO + BQ * (D + kPad);
  float* sV = sK + BK * (D + kPad);
  float* sDS = sV + BK * (D + kPad);

  const int n_qt = (Lq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  load_tile<T, D, BQ>(sQ, q + b * qs.b + h * qs.h, qs.l, q0, Lq, sm_scale);
  load_tile<T, D, BQ>(sDO, dout + b * dos.b + h * dos.h, dos.l, q0, Lq, 1.0f);
  // Rows past Lq carry lse = 0 and delta = 0, as the reference pads them.
  float row_lse[RM], row_delta[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    const int64_t at = static_cast<int64_t>(bh) * Lq + row;
    row_lse[i] = row < Lq ? lse[at] : 0.f;
    row_delta[i] = row < Lq ? delta[at] : 0.f;
  }

  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;

  int n_kv = (Lk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, D, BK>(sK, kb, ks.l, k0, Lk, 1.0f);
    load_tile<T, D, BK>(sV, vb, vs.l, k0, Lk, 1.0f);
    __syncthreads();
    float p[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) p[i][j] = dp[i][j] = 0.f;
    mma_nt<D, RM, CN>(p, sQ, sK, ty, tx);
    mma_nt<D, RM, CN>(dp, sDO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float s = valid_pos(qpos, k0 + tx + 16 * j, Lq, Lk, causal) ? p[i][j] : kNegInf;
        const float pij = expf(s - row_lse[i]);
        sDS[(ty + 16 * i) * (BK + kPad) + tx + 16 * j] = pij * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    mma_nn<BK, D, RM>(acc, sDS, sK, ty, tx);
  }
  float scale[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) scale[i] = sm_scale;
  store_rows<T, D, RM>(dq + b * dqs.b + h * dqs.h, dqs.l, q0, Lq, acc, scale, ty, tx);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (kv tile, batch * head), over q tiles from the
// first that reaches the tile's first key. Shared memory: K, V [BK][D+4];
// Q, dO [BQ][D+4]; P^T then dS^T [BK][BQ+4]; lse, delta [BQ].
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk,
                         Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                         Strides dvs, float sm_scale, int causal) {
  constexpr int RK = BK / 16, CQ = BQ / 16, DN = D / 16;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * (D + kPad);
  float* sQ = sV + BK * (D + kPad);
  float* sDO = sQ + BQ * (D + kPad);
  float* sPT = sDO + BQ * (D + kPad);
  float* sLse = sPT + BK * (BQ + kPad);
  float* sDelta = sLse + BQ;

  const int k0 = static_cast<int>(blockIdx.x) * BK;  // diagonal tiles, the longest, first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;

  load_tile<T, D, BK>(sK, k + b * ks.b + h * ks.h, ks.l, k0, Lk, 1.0f);
  load_tile<T, D, BK>(sV, v + b * vs.b + h * vs.h, vs.l, k0, Lk, 1.0f);

  float dk_acc[RK][DN], dv_acc[RK][DN];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (Lq + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, D, BQ>(sQ, qb, qs.l, q0, Lq, 1.0f);
    load_tile<T, D, BQ>(sDO, dob, dos.l, q0, Lq, 1.0f);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int row = q0 + r;
      const int64_t at = static_cast<int64_t>(bh) * Lq + row;
      sLse[r] = row < Lq ? lse[at] : 0.f;
      sDelta[r] = row < Lq ? delta[at] : 0.f;
    }
    __syncthreads();
    float p[RK][CQ], ds[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) p[i][j] = ds[i][j] = 0.f;
    mma_nt<D, RK, CQ>(p, sK, sQ, ty, tx);   // s^T, unscaled
    mma_nt<D, RK, CQ>(ds, sV, sDO, ty, tx);  // dp^T
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        const int c = tx + 16 * j;
        const float s = valid_pos(q0 + c, kpos, Lq, Lk, causal) ? sm_scale * p[i][j] : kNegInf;
        p[i][j] = expf(s - sLse[c]);
        ds[i][j] = p[i][j] * (ds[i][j] - sDelta[c]);
        sPT[(ty + 16 * i) * (BQ + kPad) + c] = p[i][j];
      }
    }
    __syncthreads();
    mma_nn<BQ, D, RK>(dv_acc, sPT, sDO, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) sPT[(ty + 16 * i) * (BQ + kPad) + tx + 16 * j] = ds[i][j];
    __syncthreads();
    mma_nn<BQ, D, RK>(dk_acc, sPT, sQ, ty, tx);
  }
  float s_dk[RK], s_dv[RK];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    s_dk[i] = sm_scale;
    s_dv[i] = 1.0f;
  }
  store_rows<T, D, RK>(dk + b * dks.b + h * dks.h, dks.l, k0, Lk, dk_acc, s_dk, ty, tx);
  store_rows<T, D, RK>(dv + b * dvs.b + h * dvs.h, dvs.l, k0, Lk, dv_acc, s_dv, ty, tx);
}

// ---------------------------------------------------------------------------
// Host side.

template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

constexpr size_t fwd_smem(int D, int BQ, int BK) {
  return sizeof(float) * ((BQ + BK) * (D + kPad) + BQ * (BK + kPad));
}
constexpr size_t dq_smem(int D, int BQ, int BK) {
  return sizeof(float) * (2 * (BQ + BK) * (D + kPad) + BQ * (BK + kPad));
}
constexpr size_t dkv_smem(int D, int BQ, int BK) {
  return sizeof(float) * (2 * (BQ + BK) * (D + kPad) + BK * (BQ + kPad) + 2 * BQ);
}

Strides strides_at(const int64_t* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int Lq, int Lk, const int64_t* st, float sm_scale, int causal, cudaStream_t s) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  constexpr size_t smem = fwd_smem(D, BQ, BK);
  auto kernel = flash_fwd_kernel<T, D, BQ, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Lq, Lk, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int H, int Lq, int Lk, const int64_t* st,
              float sm_scale, int causal, cudaStream_t s) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  constexpr size_t smem = dq_smem(D, BQ, BK);
  auto kernel = flash_bwd_dq_kernel<T, D, BQ, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Lq, Lk,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Lq, int Lk,
               const int64_t* st, float sm_scale, int causal, cudaStream_t s) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  constexpr size_t smem = dkv_smem(D, BQ, BK);
  auto kernel = flash_bwd_dkv_kernel<T, D, BQ, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + BK - 1) / BK, B * H);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Lq,
      Lk, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int H, int Lq, int Lk) {
  return B > 0 && H > 0 && Lq > 0 && Lk > 0 && static_cast<int64_t>(B) * H <= 65535;
}

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16; d in {64, 128, 256};
// tensors laid out [B, L, H, d] with the d axis contiguous and 16-byte
// aligned rows; `strides` holds (batch, seq, head) strides in elements,
// three per tensor in the order of the tensor arguments; lse and delta are
// contiguous f32 [B * H, Lq]. Launches on `stream`, returns a cudaError_t
// (0 on success): cudaErrorInvalidValue for a shape, d or dtype outside
// the above.

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int H, int Lq, int Lk, int d, const int64_t* strides,
                            float sm_scale, int causal, int dtype, void* stream) {
  if (!shape_ok(B, H, Lq, Lk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_FWD(T, D) launch_fwd<T, D>(q, k, v, o, lse, B, H, Lq, Lk, strides, sm_scale, causal, s)
  if (dtype == 0 && d == 64) return RT_FWD(float, 64);
  if (dtype == 0 && d == 128) return RT_FWD(float, 128);
  if (dtype == 0 && d == 256) return RT_FWD(float, 256);
  if (dtype == 1 && d == 64) return RT_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) return RT_FWD(__nv_bfloat16, 128);
  if (dtype == 1 && d == 256) return RT_FWD(__nv_bfloat16, 256);
#undef RT_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, void* dq, int B, int H,
                               int Lq, int Lk, int d, const int64_t* strides, float sm_scale,
                               int causal, int dtype, void* stream) {
  if (!shape_ok(B, H, Lq, Lk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_DQ(T, D) \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq, B, H, Lq, Lk, strides, sm_scale, causal, s)
  if (dtype == 0 && d == 64) return RT_DQ(float, 64);
  if (dtype == 0 && d == 128) return RT_DQ(float, 128);
  if (dtype == 0 && d == 256) return RT_DQ(float, 256);
  if (dtype == 1 && d == 64) return RT_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) return RT_DQ(__nv_bfloat16, 128);
  if (dtype == 1 && d == 256) return RT_DQ(__nv_bfloat16, 256);
#undef RT_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dk, void* dv, int B,
                                int H, int Lq, int Lk, int d, const int64_t* strides,
                                float sm_scale, int causal, int dtype, void* stream) {
  if (!shape_ok(B, H, Lq, Lk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_DKV(T, D) \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq, Lk, strides, sm_scale, causal, s)
  if (dtype == 0 && d == 64) return RT_DKV(float, 64);
  if (dtype == 0 && d == 128) return RT_DKV(float, 128);
  if (dtype == 0 && d == 256) return RT_DKV(float, 256);
  if (dtype == 1 && d == 64) return RT_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) return RT_DKV(__nv_bfloat16, 128);
  if (dtype == 1 && d == 256) return RT_DKV(__nv_bfloat16, 256);
#undef RT_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
