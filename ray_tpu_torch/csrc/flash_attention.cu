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
// each accumulated in f32 and rounded once. No atomics: every output
// element is summed by one thread in a fixed order, so results repeat
// bit for bit.
//
// Each entry point picks its kernel by dtype:
//   bf16 forward, bf16 dk/dv -> tensor-core kernels (flash_fwd_mma_kernel,
//                               flash_bwd_dkv_mma_kernel);
//   f32 forward, f32 dk/dv, dq in both dtypes -> CUDA-core kernels
//                               (flash_fwd_kernel, flash_bwd_dkv_kernel,
//                               flash_bwd_dq_kernel).
// The tensor cores have no full-precision f32 product (TF32 keeps about
// three decimal digits), so f32 stays on the CUDA cores.
//
// What bounds them. At the training shape ([b*h = 128, L = 1024, d = 128],
// bf16, causal) the forward does 4 * 128 * 128 * (1024 * 1025 / 2) = 34.4
// GFLOP of products against 134 MB of q, k, v and o: 35 us at the tensor
// cores' 989 TFLOP/s and 40 us at 3.35 TB/s, so its bound is the bytes; dk/dv
// does twice the products (68.8 GFLOP, 70 us) against ~1.7x the bytes and
// is bound by the operations. Both are far above the line where the
// tensor cores, not memory, limit: what matters is that every product runs
// on the tensor cores and that the operands reach them without stalls.
// The CUDA-core kernels multiply in f32 FMA (67 TFLOP/s at best) and are
// bound by that rate and by shared-memory bandwidth.
//
// Tensor-core design (bf16), the same for the forward and dk/dv:
// - Products are mma.sync.m16n8k16 (bf16 in, f32 accumulate). A warp owns
//   16 rows of the block's tile; operands come from shared memory through
//   ldmatrix.x4 (.trans where the tile is row-major along the reduced axis:
//   V in p v, dO and Q in dv += p^T do and dk += ds^T q).
// - Tiles stay bf16 in shared memory (half the bytes of f32, so more fits),
//   stored as 16-byte chunks XOR-swizzled by row % 8: the eight rows that
//   one ldmatrix phase reads fall on distinct banks.
// - Streamed tiles (K, V for the forward; Q, dO, lse, delta for dk/dv) are
//   copied with cp.async into a two-stage ring: tile j + 1 is in flight
//   while tile j is multiplied. Rows at or beyond Lq / Lk are zero-filled by
//   the copy itself (src-size 0) and their scores masked. [b, L, h, d]
//   inputs are read through their strides; no padded or transposed copy.
// - The f32 accumulator of one product, rounded to bf16, is the A operand
//   of the next (the C layout of two n8 tiles is the A layout of one k16
//   slice): p (forward) and p^T, ds^T (dk/dv) never touch shared memory.
// - Softmax in registers: scores scaled by sm_scale * log2(e) in f32 (q is
//   not pre-scaled in bf16), exp2f, row max and sum over the quad of lanes
//   that share a row (__shfl_xor_sync 1 and 2).
// - Forward: 4 warps, 64 q rows (16 per warp) per block; kv tiles of 64
//   rows for d = 64 and 128 and 32 for d = 256 (o alone takes 128 f32
//   registers a thread at d = 256). Q is loaded once and stays in shared
//   memory; o stays in f32 registers; the longest causal q tiles go first.
// - dk/dv: one block per (64 kv rows, batch * head); K and V stay resident,
//   S^T = K Q^T and dP^T = V dO^T are computed with kv rows as the warp's
//   rows so that p^T and ds^T sit in registers as A operands; lse and delta
//   are per column (q) and ride in shared memory with each q tile. q tiles
//   are 64 rows at d = 64 and 32 at d = 128 and 256 (dk and dv take 2 * d / 8
//   * 4 f32 registers a thread). At d = 256 two warps share each 16 kv rows,
//   each owning half of dk and dv's columns, and both compute the full
//   S^T and dP^T (8 warps; the score products are done twice).
// - Outputs are staged through the warp's own rows of shared memory and
//   written with 16-byte stores.
//
// CUDA-core design (f32, and dq): threads 256 per block as a 16 x 16 grid
// (ty = tid / 16, tx = tid % 16). A block owns one (batch, head) pair and
// one tile of rows: BQ query rows (forward, dq) or BK key rows (dk/dv), and
// loops over the tiles of the other side - kv tiles up to the diagonal for
// the forward and dq, q tiles from floor(kv_start / BQ) for dk/dv - the
// loop inside the block that replaces the TPU's sequential grid axis.
// Tiles are read through strides 16 bytes per thread, converted to f32 and
// kept in shared memory with rows padded by 4 floats. Every product is one
// of two register-blocked micro-kernels: A.B^T contracting over d (scores),
// where a thread holds rows ty + 16i and columns tx + 16j, so a score row
// lives in 16 lanes of one warp and its max and sum are warp shuffles; and
// A.B contracting over a tile (p.v, ds.k, p^T.do, ds^T.q), where a thread
// holds rows ty + 16i and columns 4tx + 64j + e of the d-wide result.
// Tiles are 64 x 64 for d = 64 and 128 and 32 x 32 for d = 256.
//
// Nothing is allocated here: the wrapper hands in every output.

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
// CUDA-core kernels: the f32 forward and dk/dv, and dq for both dtypes.
//
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
// Tensor-core kernels (bf16): mma.sync m16n8k16, ldmatrix, cp.async.

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMmaWarps = 4;   // warps along the block's rows (16 rows each)
constexpr int kFwdBQ = 64;     // forward: q rows per block
constexpr int kDkvBK = 64;     // dk/dv: kv rows per block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a [rows][D] bf16
// tile whose chunks are XOR-swizzled by row % 8 (D >= 64, so a row holds at
// least 8 chunks and the XOR stays inside it).
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * (D * 2) + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate. Fragments, for
// lane = 4g + t: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)},
// b = {(k 2t.., n g), (k 2t + 8.., n g)}, c = {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of one k16 slice from two adjacent n8 accumulator tiles,
// rounded to bf16: c0 holds columns 0-7 of the slice, c1 columns 8-15.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Per-lane ldmatrix.x4 address (byte offset in a swizzled tile) of a
// 16 x 16 block at row r0, chunk c0:
// - lds_rows: matrices (rows 0-7, chunk 0), (8-15, 0), (0-7, 1), (8-15, 1).
//   Without .trans that is mma's A fragment of rows r0.. and k columns
//   8 c0..; with .trans, the B fragments (b0, b1) of the n8 tiles c0 and
//   c0 + 1 of a tile whose rows are the reduced (k) axis.
// - lds_b: matrices (rows 0-7, chunk 0), (0-7, 1), (8-15, 0), (8-15, 1):
//   the B fragments (b0, b1) of the n8 tiles r0 and r0 + 8 of a tile whose
//   rows are n and whose chunks run along k.
template <int D>
__device__ __forceinline__ uint32_t lds_rows(int r0, int c0, int lane) {
  return swz<D>(r0 + (lane & 15), c0 + (lane >> 4));
}
template <int D>
__device__ __forceinline__ uint32_t lds_b(int r0, int c0, int lane) {
  return swz<D>(r0 + (lane & 7) + ((lane >> 4) << 3), c0 + ((lane >> 3) & 1));
}

// Issue the copies of ROWS rows of width D (rows row0.. of a sequence of
// length len, row stride ls elements) into the swizzled tile at dst.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void cp_tile(uint32_t dst, const bf16* __restrict__ base, int64_t ls,
                                        int row0, int len) {
  constexpr int kChunks = D / 8;
  static_assert((ROWS * kChunks) % NT == 0, "tile chunks must divide among the threads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / NT; ++i) {
    const int id = static_cast<int>(threadIdx.x) + i * NT;
    const int r = id / kChunks, c = id % kChunks;
    const int row = row0 + r;
    const bool ok = row < len;
    cp_async16(dst + swz<D>(r, c), ok ? base + row * ls + c * 8 : base, ok);
  }
}

// Write ROWS rows of a staged swizzled tile (generic pointer src) to out
// (row stride ls), rows row0 + r < len only, 16 bytes per store.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void store_tile(bf16* __restrict__ out, int64_t ls, int row0, int len,
                                           const unsigned char* src, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    if (row < len)
      *reinterpret_cast<uint4*>(out + row * ls + c * 8) =
          *reinterpret_cast<const uint4*>(src + swz<D>(r, c));
  }
}

// Forward: one block per (64 q rows, batch * head), 4 warps of 16 rows.
// Shared memory: Q [64][D]; K [2][BK][D]; V [2][BK][D], bf16, swizzled.
template <int D, int BK>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int Lq, int Lk, Strides qs, Strides ks,
                         Strides vs, Strides os, float sm_scale, int causal) {
  constexpr int NT = kMmaWarps * 32, BQ = kFwdBQ;
  constexpr int NS = BK / 8;  // n8 tiles of a warp's score rows
  constexpr int ND = D / 8;   // n8 tiles of a warp's o rows
  constexpr uint32_t kTileK = BK * D * 2;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t sQ = smem_u32(smem_mma);
  const uint32_t sK = sQ + BQ * D * 2, sV = sK + 2 * kTileK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  int n_kv = (Lk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  // Groups in flight, oldest first: {Q, K[0]}, {V[0]}; each iteration t
  // then commits {K[t + 1]} and {V[t + 1]} (empty past the last tile).
  cp_tile<D, BQ, NT>(sQ, q + b * qs.b + h * qs.h, qs.l, q0, Lq);
  cp_tile<D, BK, NT>(sK, kb, ks.l, 0, Lk);
  cp_async_commit();
  cp_tile<D, BK, NT>(sV, vb, vs.l, 0, Lk);
  cp_async_commit();

  const int wr = warp * 16;  // this warp's first row of the tile
  const int qpos[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float scale2 = sm_scale * kLog2e;
  float acc[ND][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    const uint32_t sKt = sK + (t & 1) * kTileK, sVt = sV + (t & 1) * kTileK;
    cp_async_wait<1>();  // Q and K[t] have landed; V[t] may be in flight
    __syncthreads();     // ... for every thread; K[t - 1]'s stage is free
    if (t + 1 < n_kv) cp_tile<D, BK, NT>(sK + ((t + 1) & 1) * kTileK, kb, ks.l, k0 + BK, Lk);
    cp_async_commit();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      ldsm_x4(a, sQ + lds_rows<D>(wr, 2 * kc, lane));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bb[4];
        ldsm_x4(bb, sKt + lds_b<D>(16 * j, 2 * kc, lane));
        mma_bf16(s[2 * j], a, bb[0], bb[1]);
        mma_bf16(s[2 * j + 1], a, bb[2], bb[3]);
      }
    }
    // Scale into log2 units; mask only tiles that cross Lk or the diagonal
    // (rows past Lq are never written, their zero-filled q gives finite s).
    const bool edge = k0 + BK > Lk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok = !edge || valid_pos(qpos[e >> 1], kpos, Lq, Lk, causal);
        s[j][e] = ok ? s[j][e] * scale2 : kNegInf;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
        rs += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * corr + rs;  // this lane's part of the row; summed at the end
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    cp_async_wait<1>();  // V[t] has landed; K[t + 1] may be in flight
    __syncthreads();     // ... for every thread; V[t - 1]'s stage is free
    if (t + 1 < n_kv) cp_tile<D, BK, NT>(sV + ((t + 1) & 1) * kTileK, vb, vs.l, k0 + BK, Lk);
    cp_async_commit();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);  // p, rounded to bf16, in registers
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, sVt + lds_rows<D>(16 * kc, 2 * j, lane));
        mma_bf16(acc[2 * j], a, bb[0], bb[1]);
        mma_bf16(acc[2 * j + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float l_safe = fmaxf(l[r], 1e-20f);
    inv[r] = 1.0f / l_safe;
    if (t4 == 0 && qpos[r] < Lq)
      lse[static_cast<int64_t>(bh) * Lq + qpos[r]] = m[r] * kLn2 + logf(l_safe);
  }
  // Only this warp reads its 16 rows of Q: stage o there.
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(smem_mma + swz<D>(wr + g + 8 * r, n) + 4 * t4) =
          pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  __syncwarp();
  store_tile<D, 16, 32>(o + b * os.b + h * os.h, os.l, q0 + wr, Lq, smem_mma + wr * D * 2,
                        lane);
}

// dk, dv: one block per (64 kv rows, batch * head), over q tiles from the
// first that reaches the block's first key. 4 * DSPLIT warps: warp w owns
// kv rows 16 (w % 4).. and the n8 tiles (w / 4) NDW.. of dk and dv.
// Shared memory: K, V [64][D] resident; two stages of {Q [BQ][D],
// dO [BQ][D], lse [BQ], delta [BQ]}.
template <int D, int BQ, int DSPLIT>
__global__ void __launch_bounds__(kMmaWarps * 32 * DSPLIT)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq, int Lk,
                             Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                             Strides dvs, float sm_scale, int causal) {
  constexpr int NT = kMmaWarps * 32 * DSPLIT, BK = kDkvBK;
  constexpr int NQ = BQ / 8;              // n8 tiles of a warp's S^T rows
  constexpr int NDW = D / 8 / DSPLIT;     // n8 tiles of a warp's dk, dv rows
  constexpr uint32_t kTileK = BK * D * 2, kTileQ = BQ * D * 2;
  constexpr uint32_t kStage = 2 * kTileQ + 2 * BQ * 4;
  static_assert(BQ <= NT, "one thread per q row of lse and delta");
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t sK = smem_u32(smem_mma), sV = sK + kTileK, sStage = sV + kTileK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp % kMmaWarps) * 16;
  const int c_own = (warp / kMmaWarps) * NDW;
  const int k0 = static_cast<int>(blockIdx.x) * BK;  // diagonal tiles, the longest, first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const float* lse_b = lse + static_cast<int64_t>(bh) * Lq;
  const float* delta_b = delta + static_cast<int64_t>(bh) * Lq;

  // q tile qt into stage `st`: Q, dO, and lse, delta (0 past Lq, as the
  // reference pads them).
  auto load_q_tile = [&](int qt, uint32_t st) {
    const int q0 = qt * BQ;
    cp_tile<D, BQ, NT>(st, qb, qs.l, q0, Lq);
    cp_tile<D, BQ, NT>(st + kTileQ, dob, dos.l, q0, Lq);
    if (static_cast<int>(threadIdx.x) < BQ) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < Lq;
      cp_async4(st + 2 * kTileQ + 4 * threadIdx.x, lse_b + (ok ? row : 0), ok);
      cp_async4(st + 2 * kTileQ + 4 * (BQ + threadIdx.x), delta_b + (ok ? row : 0), ok);
    }
  };

  const int n_qt = (Lq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  cp_tile<D, BK, NT>(sK, k + b * ks.b + h * ks.h, ks.l, k0, Lk);
  cp_tile<D, BK, NT>(sV, v + b * vs.b + h * vs.h, vs.l, k0, Lk);
  if (qt0 < n_qt) load_q_tile(qt0, sStage);
  cp_async_commit();

  const int kpos[2] = {k0 + wr + g, k0 + wr + g + 8};
  const float scale2 = sm_scale * kLog2e;
  float dk_acc[NDW][4], dv_acc[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    const uint32_t st = sStage + ((qt - qt0) & 1) * kStage;
    cp_async_wait<0>();  // this tile (and K, V) have landed
    __syncthreads();     // ... for every thread; the other stage is free
    if (qt + 1 < n_qt) load_q_tile(qt + 1, sStage + ((qt - qt0 + 1) & 1) * kStage);
    cp_async_commit();

    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, sK + lds_rows<D>(wr, 2 * kc, lane));
      ldsm_x4(av, sV + lds_rows<D>(wr, 2 * kc, lane));
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, st + lds_b<D>(16 * j, 2 * kc, lane));
        ldsm_x4(bo, st + kTileQ + lds_b<D>(16 * j, 2 * kc, lane));
        mma_bf16(sT[2 * j], ak, bq[0], bq[1]);  // s^T, unscaled
        mma_bf16(sT[2 * j + 1], ak, bq[2], bq[3]);
        mma_bf16(dpT[2 * j], av, bo[0], bo[1]);  // dp^T
        mma_bf16(dpT[2 * j + 1], av, bo[2], bo[3]);
      }
    }
    // p^T = exp(s - lse) and ds^T = p^T (dp^T - delta), per column q.
    const bool edge = q0 + BQ > Lq || k0 + BK > Lk || (causal && k0 + BK - 1 > q0);
    const unsigned char* stats = smem_mma + (st - sK) + 2 * kTileQ;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 ls = *reinterpret_cast<const float2*>(stats + 4 * c);
      const float2 dl = *reinterpret_cast<const float2*>(stats + 4 * (BQ + c));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = ((e & 1) ? ls.y : ls.x) * kLog2e;
        const float dlt = (e & 1) ? dl.y : dl.x;
        const bool ok = !edge || valid_pos(q0 + c + (e & 1), kpos[e >> 1], Lq, Lk, causal);
        const float p = ok ? exp2f(sT[j][e] * scale2 - lse2) : 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - dlt);
      }
    }
    // dv += p^T dO and dk += ds^T Q over this tile's q rows, the A operands
    // straight from registers.
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t ap[4], as[4];
      acc_to_a(ap, sT[2 * kc], sT[2 * kc + 1]);
      acc_to_a(as, dpT[2 * kc], dpT[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < NDW / 2; ++j) {
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, st + kTileQ + lds_rows<D>(16 * kc, c_own + 2 * j, lane));
        mma_bf16(dv_acc[2 * j], ap, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * j + 1], ap, bo[2], bo[3]);
        ldsm_x4_trans(bq, st + lds_rows<D>(16 * kc, c_own + 2 * j, lane));
        mma_bf16(dk_acc[2 * j], as, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * j + 1], as, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with K and V: stage dk, dv there
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t at = swz<D>(wr + g + 8 * r, c_own + n) + 4 * t4;
      *reinterpret_cast<uint32_t*>(smem_mma + at) =
          pack_bf16(dk_acc[n][2 * r] * sm_scale, dk_acc[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(smem_mma + kTileK + at) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  __syncthreads();
  store_tile<D, BK, NT>(dk + b * dks.b + h * dks.h, dks.l, k0, Lk, smem_mma, threadIdx.x);
  store_tile<D, BK, NT>(dv + b * dvs.b + h * dvs.h, dvs.l, k0, Lk, smem_mma + kTileK,
                        threadIdx.x);
}

// ---------------------------------------------------------------------------
// Host side.

// CUDA-core tiles (f32, and dq).
template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

// Tensor-core tiles: the forward's kv rows per stage; dk/dv's q rows per
// stage and warps per 16 kv rows.
template <int D> struct FwdMma;
template <> struct FwdMma<64> { static constexpr int BK = 64; };
template <> struct FwdMma<128> { static constexpr int BK = 64; };
template <> struct FwdMma<256> { static constexpr int BK = 32; };
template <int D> struct DkvMma;
template <> struct DkvMma<64> { static constexpr int BQ = 64, DSPLIT = 1; };
template <> struct DkvMma<128> { static constexpr int BQ = 32, DSPLIT = 1; };
template <> struct DkvMma<256> { static constexpr int BQ = 32, DSPLIT = 2; };

constexpr size_t fwd_smem(int D, int BQ, int BK) {
  return sizeof(float) * ((BQ + BK) * (D + kPad) + BQ * (BK + kPad));
}
constexpr size_t dq_smem(int D, int BQ, int BK) {
  return sizeof(float) * (2 * (BQ + BK) * (D + kPad) + BQ * (BK + kPad));
}
constexpr size_t dkv_smem(int D, int BQ, int BK) {
  return sizeof(float) * (2 * (BQ + BK) * (D + kPad) + BK * (BQ + kPad) + 2 * BQ);
}
// bf16 Q, two stages of K and V.
constexpr size_t fwd_mma_smem(int D, int BK) { return 2 * (kFwdBQ * D + 4 * BK * D); }
// bf16 K and V, two stages of {Q, dO (bf16), lse, delta (f32)}.
constexpr size_t dkv_mma_smem(int D, int BQ) {
  return 2 * 2 * kDkvBK * D + 2 * (2 * 2 * BQ * D + 2 * 4 * BQ);
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

template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int Lq, int Lk, const int64_t* st, float sm_scale, int causal,
                   cudaStream_t s) {
  constexpr int BK = FwdMma<D>::BK;
  constexpr size_t smem = fwd_mma_smem(D, BK);
  auto kernel = flash_fwd_mma_kernel<D, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + kFwdBQ - 1) / kFwdBQ, B * H);
  kernel<<<grid, kMmaWarps * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, Lq, Lk, strides_at(st, 0), strides_at(st, 1),
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

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int B, int H, int Lq,
                   int Lk, const int64_t* st, float sm_scale, int causal, cudaStream_t s) {
  constexpr int BQ = DkvMma<D>::BQ, DSPLIT = DkvMma<D>::DSPLIT;
  constexpr size_t smem = dkv_mma_smem(D, BQ);
  auto kernel = flash_bwd_dkv_mma_kernel<D, BQ, DSPLIT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + kDkvBK - 1) / kDkvBK, B * H);
  kernel<<<grid, kMmaWarps * 32 * DSPLIT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, Lq, Lk, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int H, int Lq, int Lk) {
  return B > 0 && H > 0 && Lq > 0 && Lk > 0 && static_cast<int64_t>(B) * H <= 65535;
}

template <int D>
long long smem_of(int pass, int dtype) {
  if (pass == 0) return dtype == 1 ? fwd_mma_smem(D, FwdMma<D>::BK)
                                   : fwd_smem(D, Tiles<D>::BQ, Tiles<D>::BK);
  if (pass == 1) return dq_smem(D, Tiles<D>::BQ, Tiles<D>::BK);
  if (pass == 2) return dtype == 1 ? dkv_mma_smem(D, DkvMma<D>::BQ)
                                   : dkv_smem(D, Tiles<D>::BQ, Tiles<D>::BK);
  return -1;
}

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16; d in {64, 128, 256};
// tensors laid out [B, L, H, d] with the d axis contiguous and 16-byte
// aligned rows; `strides` holds (batch, seq, head) strides in elements,
// three per tensor in the order of the tensor arguments; lse and delta are
// contiguous f32 [B * H, Lq]. Launches on `stream`, returns a cudaError_t
// (0 on success): cudaErrorInvalidValue for a shape, d or dtype outside
// the above. bf16 forward and dk/dv run on the tensor cores, the rest on
// the CUDA cores (see the top of this file).

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int H, int Lq, int Lk, int d, const int64_t* strides,
                            float sm_scale, int causal, int dtype, void* stream) {
  if (!shape_ok(B, H, Lq, Lk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_FWD(T, D) launch_fwd<T, D>(q, k, v, o, lse, B, H, Lq, Lk, strides, sm_scale, causal, s)
#define RT_FWD_MMA(D) \
  launch_fwd_mma<D>(q, k, v, o, lse, B, H, Lq, Lk, strides, sm_scale, causal, s)
  if (dtype == 0 && d == 64) return RT_FWD(float, 64);
  if (dtype == 0 && d == 128) return RT_FWD(float, 128);
  if (dtype == 0 && d == 256) return RT_FWD(float, 256);
  if (dtype == 1 && d == 64) return RT_FWD_MMA(64);
  if (dtype == 1 && d == 128) return RT_FWD_MMA(128);
  if (dtype == 1 && d == 256) return RT_FWD_MMA(256);
#undef RT_FWD_MMA
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
#define RT_DKV_MMA(D) \
  launch_dkv_mma<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq, Lk, strides, sm_scale, causal, s)
  if (dtype == 0 && d == 64) return RT_DKV(float, 64);
  if (dtype == 0 && d == 128) return RT_DKV(float, 128);
  if (dtype == 0 && d == 256) return RT_DKV(float, 256);
  if (dtype == 1 && d == 64) return RT_DKV_MMA(64);
  if (dtype == 1 && d == 128) return RT_DKV_MMA(128);
  if (dtype == 1 && d == 256) return RT_DKV_MMA(256);
#undef RT_DKV_MMA
#undef RT_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory, in bytes, that one block of a pass (0 forward,
// 1 dq, 2 dk/dv) launches with for a dtype and d; -1 outside the above.
// Host-only: for build reports.
extern "C" long long rt_flash_smem_bytes(int pass, int dtype, int d) {
  if (dtype != 0 && dtype != 1) return -1;
  if (d == 64) return smem_of<64>(pass, dtype);
  if (d == 128) return smem_of<128>(pass, dtype);
  if (d == 256) return smem_of<256>(pass, dtype);
  return -1;
}
