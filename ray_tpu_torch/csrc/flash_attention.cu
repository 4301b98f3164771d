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
// Each entry point picks its kernel by dtype and head width (kBf16Design,
// read back by rt_flash_design):
//   bf16, d = 64 and 128 -> warpgroup kernels (flash_fwd_wgmma_kernel,
//           flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel);
//   bf16, d = 256 -> mma.sync kernels (flash_fwd_mma_kernel,
//           flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel), whose
//           accumulators do not fit the warpgroup kernels' register plan;
//   f32  -> CUDA-core kernels (flash_fwd_kernel, flash_bwd_dq_kernel,
//           flash_bwd_dkv_kernel).
// The tensor cores have no full-precision f32 product (TF32 keeps about
// three decimal digits), so f32 stays on the CUDA cores.
//
// What bounds them. At the training shapes (bf16, causal, d = 128) every
// pass is bound by its products: at [4, 8192, 32, 128] the forward does
// 2 * 2 * 128 * 128 * (8192 * 8193 / 2) = 2.2 TFLOP (2.22 ms at the tensor
// cores' 989 TFLOP/s) against 1.07 GB of q, k, v and o (0.32 ms at 3.35
// TB/s); dq does three products a score (3.34 ms) and dk/dv four (4.45 ms).
// At [4, 1024, 32, 128] the bounds are 35, 52 and 70 us. What matters is
// that the products run at the tensor cores' rate: Hopper reaches it only
// with warpgroup MMA (wgmma.mma_async, sm_90a), which mma.sync reaches a
// fraction of, and with operands that arrive without stalling the warps that
// multiply. The CUDA-core kernels multiply in f32 FMA (67 TFLOP/s at best)
// and are bound by that rate and by shared-memory bandwidth.
//
// Warpgroup design (bf16, d = 64 and 128), FlashAttention-3's shape:
// - A block is one or two consumer warpgroups, each owning 64 resident
//   rows (q rows for the forward and dq, kv rows for dk/dv), and one
//   producer warpgroup whose single thread (dk/dv: whose first warp) issues
//   TMA loads (cp.async.bulk.tensor) into a ring of shared-memory stages;
//   full and empty mbarriers hand each stage between them. setmaxnreg
//   gives the producer 24 registers a thread and the consumers the rest
//   of the SM's: 240 with two consumers, 232 with one, whose blocks run
//   two to an SM.
// - Inputs are read through their strides with no padded or transposed
//   copy: a TMA tensor map per tensor describes the [B, L, H, d] view as
//   (d, L, H, B) (so v may be a view with a head stride of 256, as latent
//   attention's is), encoded on the host per launch with
//   cuTensorMapEncodeTiled taken from the driver through
//   cudaGetDriverEntryPoint (no -lcuda). A box is 64 columns (128 bytes) x
//   the tile's rows with the 128-byte swizzle, so a tile lands as
//   [d / 64][rows][64]; rows past Lq or Lk arrive as zeros.
// - Products are wgmma m64nNk16, bf16 in, f32 accumulate. Score products
//   take both operands from shared memory, K-major (d along k); the
//   products that reduce over a tile's rows (p V, ds K, p^T dO, ds^T Q)
//   take their A operand from registers - the f32 accumulator of the score
//   product, rounded to bf16, is in wgmma's A layout - and B as the same
//   shared tile read MN-major. p, ds, p^T and ds^T never touch shared
//   memory.
// - Softmax in registers as before: scores scaled by sm_scale * log2(e) in
//   f32, exp2f, row max and sum over the quad of lanes that share a row.
//   Only tiles that cross Lk or a warp's diagonal are masked; the longest
//   causal tiles go first.
// - Forward: 128 q rows a block, kv tiles of 128 rows in two stages. A
//   consumer computes s of tile t while o += p V of tile t - 1 is in flight,
//   and the two consumers take turns issuing their products (named
//   barriers), so one's softmax runs while the other's products do.
// - dk/dv: 128 kv rows a block with K and V resident; q tiles of 64 rows
//   (Q, dO, and lse and delta staged by the producer warp) stream through
//   two stages. S^T = K Q^T and dP^T = V dO^T put the kv rows on the
//   accumulators' rows, so p^T and ds^T are A operands from registers.
// - dq: 64 q rows a block (one consumer, two blocks an SM) with Q and dO
//   resident; kv tiles of 64 rows in two stages. p is computed while dP is
//   in flight, and dq += ds K finishes while the next tile's S and dP are
//   issued. With two consumers a block dq took 9.0 ms at [4, 8192, 32,
//   128] against 8.1 with one (H100 80GB HBM3, 700 W).
// - Outputs are staged through the consumer's own resident rows, which no
//   one reads any more, and written with 16-byte stores.
//
// mma.sync design (bf16, d = 256), the same for the forward, dq and dk/dv:
// - Products are mma.sync.m16n8k16 (bf16 in, f32 accumulate). A warp owns
//   16 rows of the block's tile; operands come from shared memory through
//   ldmatrix.x4 (.trans where the tile is row-major along the reduced axis:
//   V in p v, dO and Q in dv += p^T do and dk += ds^T q).
// - Tiles stay bf16 in shared memory (half the bytes of f32, so more fits),
//   stored as 16-byte chunks XOR-swizzled by row % 8: the eight rows that
//   one ldmatrix phase reads fall on distinct banks.
// - Streamed tiles (K, V for the forward and dq; Q, dO, lse, delta for dk/dv) are
//   copied with cp.async into a two-stage ring: tile j + 1 is in flight
//   while tile j is multiplied. Rows at or beyond Lq / Lk are zero-filled by
//   the copy itself (src-size 0) and their scores masked. [b, L, h, d]
//   inputs are read through their strides; no padded or transposed copy.
// - The f32 accumulator of one product, rounded to bf16, is the A operand
//   of the next (the C layout of two n8 tiles is the A layout of one k16
//   slice): p (forward), ds (dq) and p^T, ds^T (dk/dv) never touch shared
//   memory.
// - Softmax in registers: scores scaled by sm_scale * log2(e) in f32 (q is
//   not pre-scaled in bf16), exp2f, row max and sum over the quad of lanes
//   that share a row (__shfl_xor_sync 1 and 2).
// - Forward: 4 warps, 64 q rows (16 per warp) per block; kv tiles of 32
//   rows (o alone takes 128 f32 registers a thread). Q is loaded once and
//   stays in shared memory; o stays in f32 registers; the longest causal q
//   tiles go first.
// - dk/dv: one block per (64 kv rows, batch * head); K and V stay resident,
//   S^T = K Q^T and dP^T = V dO^T are computed with kv rows as the warp's
//   rows so that p^T and ds^T sit in registers as A operands; lse and delta
//   are per column (q) and ride in shared memory with each q tile of 32
//   rows. Two warps share each 16 kv rows, each owning half of dk and dv's
//   columns, and both compute the full S^T and dP^T (8 warps; the score
//   products are done twice).
// - dq: one block per (64 q rows, batch * head); the longest causal q
//   tiles go first. Q and dO stay resident; K and V of one kv tile (32
//   rows) land together as one cp.async group while the previous tile is
//   multiplied. Per tile a warp computes S = Q K^T and dP = dO V^T (K and V
//   as B operands), p = exp2(s * sm_scale * log2(e) - lse * log2(e)) and
//   ds = p (dp - delta) in f32 registers (lse and delta of the thread's two
//   rows held in registers, 0 past Lq), then dq += ds K with ds as the A
//   operand and K read again from the same tile with ldmatrix.trans. dq
//   stays in f32 registers and is scaled by sm_scale once at the end. Two
//   warps share each 16 q rows, each owning half of dq's columns, and both
//   compute the full S and dP (8 warps), so dq stays at 64 f32 registers a
//   thread.
// - Outputs are staged through shared memory that no warp reads any more
//   (the warp's own Q rows in the forward; Q in dq; K and V in dk/dv) and
//   written with 16-byte stores.
//
// CUDA-core design (f32): threads 256 per block as a 16 x 16 grid
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

#include <cuda.h>
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
// CUDA-core kernels (f32): the forward, dq and dk/dv.
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
constexpr int kDqBQ = 64;      // dq: q rows per block

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

// dq: one block per (64 q rows, batch * head), over kv tiles up to the
// diagonal. 4 * DSPLIT warps: warp w owns q rows 16 (w % 4).. and the n8
// tiles (w / 4) NDW.. of dq. Shared memory: Q, dO [64][D] resident; two
// stages of {K [BK][D], V [BK][D]}.
template <int D, int BK, int DSPLIT>
__global__ void __launch_bounds__(kMmaWarps * 32 * DSPLIT)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dq, int H, int Lq, int Lk, Strides qs, Strides ks,
                            Strides vs, Strides dos, Strides dqs, float sm_scale, int causal) {
  constexpr int NT = kMmaWarps * 32 * DSPLIT, BQ = kDqBQ;
  constexpr int NS = BK / 8;           // n8 tiles of a warp's S and dP rows
  constexpr int NDW = D / 8 / DSPLIT;  // n8 tiles of a warp's dq rows
  constexpr uint32_t kTileQ = BQ * D * 2, kTileK = BK * D * 2;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t sQ = smem_u32(smem_mma), sDO = sQ + kTileQ, sKV = sDO + kTileQ;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp % kMmaWarps) * 16;
  const int c_own = (warp / kMmaWarps) * NDW;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  int n_kv = (Lk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  // Stage st of the ring holds K then V of one kv tile; one group per tile.
  auto load_kv = [&](int t, int st) {
    const uint32_t at = sKV + st * 2 * kTileK;
    cp_tile<D, BK, NT>(at, kb, ks.l, t * BK, Lk);
    cp_tile<D, BK, NT>(at + kTileK, vb, vs.l, t * BK, Lk);
  };
  cp_tile<D, BQ, NT>(sQ, q + b * qs.b + h * qs.h, qs.l, q0, Lq);
  cp_tile<D, BQ, NT>(sDO, dout + b * dos.b + h * dos.h, dos.l, q0, Lq);
  load_kv(0, 0);
  cp_async_commit();

  // This thread's rows g and g + 8 of the warp's 16: lse (in log2 units)
  // and delta; 0 past Lq, as the reference pads them.
  const int qpos[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = static_cast<int64_t>(bh) * Lq + qpos[r];
    lse2[r] = qpos[r] < Lq ? lse[at] * kLog2e : 0.f;
    dlt[r] = qpos[r] < Lq ? delta[at] : 0.f;
  }
  const float scale2 = sm_scale * kLog2e;
  float acc[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    const uint32_t sKt = sKV + (t & 1) * 2 * kTileK, sVt = sKt + kTileK;
    cp_async_wait<0>();  // Q, dO and this tile have landed
    __syncthreads();     // ... for every thread; the other stage is free
    if (t + 1 < n_kv) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows, unscaled.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, sQ + lds_rows<D>(wr, 2 * kc, lane));
      ldsm_x4(ao, sDO + lds_rows<D>(wr, 2 * kc, lane));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, sKt + lds_b<D>(16 * j, 2 * kc, lane));
        ldsm_x4(bv, sVt + lds_b<D>(16 * j, 2 * kc, lane));
        mma_bf16(s[2 * j], aq, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * j], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * j + 1], ao, bv[2], bv[3]);
      }
    }
    // p = exp(s * sm_scale - lse), masked scores at -1e30; ds = p (dp - delta),
    // in place of dp. Only tiles that cross Lk or the diagonal are masked.
    const bool edge = k0 + BK > Lk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok = !edge || valid_pos(qpos[r], kpos, Lq, Lk, causal);
        const float p = exp2f((ok ? s[j][e] * scale2 : kNegInf) - lse2[r]);
        dp[j][e] = p * (dp[j][e] - dlt[r]);
      }
    // dq += ds K over this tile's kv rows: ds from registers (rounded to
    // bf16), K read again as the B operand along kv.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < NDW / 2; ++j) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, sKt + lds_rows<D>(16 * kc, c_own + 2 * j, lane));
        mma_bf16(acc[2 * j], a, bb[0], bb[1]);
        mma_bf16(acc[2 * j + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with Q: stage dq there
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(smem_mma + swz<D>(wr + g + 8 * r, c_own + n) + 4 * t4) =
          pack_bf16(acc[n][2 * r] * sm_scale, acc[n][2 * r + 1] * sm_scale);
  __syncthreads();
  store_tile<D, BQ, NT>(dq + b * dqs.b + h * dqs.h, dqs.l, q0, Lq, smem_mma, threadIdx.x);
}

// ---------------------------------------------------------------------------
// Warpgroup kernels (bf16, d = 64 and 128): wgmma fed by TMA through an
// mbarrier ring, a producer warpgroup and one or two consumer warpgroups a
// block.

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kStages = 2;       // stages of a ring: a tile lands while the last is multiplied

// A block of NC consumer warpgroups, 64 resident rows each, then the
// producer's warpgroup. With one consumer two blocks share an SM. Either
// way the producer keeps 24 registers a thread and the consumers take what
// fills the SM's 65,536.
template <int NC>
struct Wg {
  static constexpr int kThreads = (NC + 1) * kWgThreads;
  static constexpr int kRows = 64 * NC;
  static constexpr int kConsumerWarps = 4 * NC;  // arrivals that free a ring stage
  static constexpr int kBlocksPerSm = NC == 1 ? 2 : 1;
  static constexpr int kConsumerRegs = NC == 1 ? 232 : 240;
};

// Tiles in shared memory are [d / 64][rows][64] bf16: 128-byte rows of one
// 64-wide column block, as one TMA box of 64 x rows lands with the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)). Each tile starts
// 1024-byte aligned, the swizzle's period. Byte offset of 16-byte chunk
// `chunk` (of d / 8) of row `row` in such a tile of `rows` rows:
__device__ __forceinline__ uint32_t swz128(int rows, int row, int chunk) {
  return static_cast<uint32_t>((chunk >> 3) * rows * 128 + row * 128 +
                               (((chunk & 7) ^ (row & 7)) << 4));
}

// wgmma's shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// Rows row0.. of a tile as a K-major operand (rows along m or n, d along k),
// slice kc of d (16 wide): 8-row groups 1024 bytes apart; a slice starts 32
// bytes into its 128-byte rows.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int row0, int kc) {
  return gmma_desc(tile + (kc >> 2) * rows * 128 + row0 * 128 + (kc & 3) * 32, 16, 1024);
}
// A tile as an MN-major B operand (rows along k, d along n), slice kc of its
// rows (16): 64-wide column blocks rows * 128 bytes apart (leading offset),
// 8-row groups 1024 bytes apart (stride offset).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int kc) {
  return gmma_desc(tile + kc * 16 * 128, rows * 128, 1024);
}

// mbarriers: init, arrive, arrive with the bytes a TMA load will bring,
// wait for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// The barriers' initialisation, visible to every thread and to the TMA unit.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::
                   : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One TMA box (64 x rows of a [d, L, H, B] tensor map) into shared memory at
// dst, its bytes counted on `bar`; rows past L arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Barrier `id` among `threads` threads (not the block's): wait there, or
// arrive without waiting.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Registers a thread of the calling warpgroup may hold from here on.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma's ordering: fence before products that read registers written since
// the last ones; commit the issued products as a group; wait until at most N
// groups are in flight. fence_acc keeps the compiler from moving reads or
// writes of an accumulator across them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The warpgroup's d[64 x N] (+)= a[64 x 16] b[16 x N], bf16 in, f32
// accumulate, N = 2 * (registers of d); scale_d = 0 drops d's old value.
// wgmma_ss: a and b in shared memory, both K-major. wgmma_rs: a in registers
// (mma.sync's A fragment for each warp's 16 rows), b MN-major. d's fragment:
// register 4j + e of lane 4g + t in warp w holds row 16w + g + 8(e / 2),
// column 8j + 2t + e % 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// TMA loads of rows row0.. (a box of 64 x ROWS per 64 columns of d) of head
// h, batch b into the tile at dst, counted on `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row0, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_4d(dst + c * ROWS * 128, map, bar, 64 * c, row0, h, b);
}

// The A operand of k slice kc (16 columns) of a warpgroup accumulator, rounded
// to bf16: n8 tiles 2kc and 2kc + 1.
template <int M>
__device__ __forceinline__ void acc_to_a_wg(uint32_t (&a)[4], const float (&c)[M], int kc) {
  a[0] = pack_bf16(c[8 * kc], c[8 * kc + 1]);
  a[1] = pack_bf16(c[8 * kc + 2], c[8 * kc + 3]);
  a[2] = pack_bf16(c[8 * kc + 4], c[8 * kc + 5]);
  a[3] = pack_bf16(c[8 * kc + 6], c[8 * kc + 7]);
}

// A warpgroup's 64 rows of a d-wide f32 accumulator (times scale, rounded to
// bf16) into rows 64 wg.. of a resident tile that no warp reads any more,
// then 16-byte stores of those rows below len to out (row stride ls).
template <int D>
__device__ __forceinline__ void store_wg_rows(bf16* __restrict__ out, int64_t ls, int row0,
                                              int len, unsigned char* tile, int rows, int wg,
                                              const float (&acc)[D / 2], const float (&scale)[2]) {
  const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3, wr = 64 * wg + 16 * warp;
  named_bar_sync(1 + wg, kWgThreads);  // every product of the warpgroup is done
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(tile + swz128(rows, wr + g + 8 * r, n) + 4 * t4) =
          pack_bf16(acc[4 * n + 2 * r] * scale[r], acc[4 * n + 2 * r + 1] * scale[r]);
  named_bar_sync(1 + wg, kWgThreads);
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < 64 * kChunks; i += kWgThreads) {
    const int r = 64 * wg + i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    if (row < len)
      *reinterpret_cast<uint4*>(out + row * ls + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz128(rows, r, c));
  }
}

// Shared memory of the warpgroup kernels, from a 1024-byte-aligned base:
// resident tiles, then kStages ring stages, then the mbarriers (the
// launchers add 1024 bytes of slack for the alignment).
template <int RESIDENT, int STAGE>
struct WgSmem {
  static constexpr uint32_t kRing = RESIDENT;
  static constexpr uint32_t kBars = RESIDENT + kStages * STAGE;
};

// Forward: one block per (64 NC q rows, batch * head). Consumer warpgroup
// wg owns q rows 64 wg..; the producer streams K and V tiles of BK rows
// through kStages stages. Shared memory: Q [d/64][64 NC][64]; stages of K,
// V [d/64][BK][64]; barriers q_full, k_full[S], v_full[S], k_empty[S],
// v_empty[S].
template <int D, int BK, int NC>
__global__ void __launch_bounds__(Wg<NC>::kThreads, Wg<NC>::kBlocksPerSm)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                           float* __restrict__ lse, int H, int Lq, int Lk, Strides os,
                           float sm_scale, int causal) {
  constexpr int BQ = Wg<NC>::kRows;
  constexpr uint32_t kTileQ = BQ * D * 2, kTileK = BK * D * 2;
  using L = WgSmem<kTileQ, 2 * kTileK>;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const uint32_t raw = smem_u32(smem_wg), base = (raw + 1023) & ~1023u;
  unsigned char* tiles = smem_wg + (base - raw);
  const uint32_t sQ = base, sKV = base + L::kRing, bars = base + L::kBars;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  const int n_qt = (Lq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  int n_kv = (Lk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  const int wg = threadIdx.x / kWgThreads;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), Wg<NC>::kConsumerWarps);
      mbar_init(v_empty(s), Wg<NC>::kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, kTileQ);
      tma_tile<D, BQ>(sQ, &tq, q_full, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int st = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        const uint32_t sK = sKV + st * 2 * kTileK;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_expect_tx(k_full(st), kTileK);
        tma_tile<D, BK>(sK, &tk, k_full(st), t * BK, h, b);
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_expect_tx(v_full(st), kTileK);
        tma_tile<D, BK>(sK + kTileK, &tv, v_full(st), t * BK, h, b);
      }
    }
  } else {
    setmaxnreg_inc<Wg<NC>::kConsumerRegs>();
    const int g = lane >> 2, t4 = lane & 3;
    const int wr = 64 * wg + 16 * warp;  // this warp's first row of the tile
    const int qpos[2] = {q0 + wr + g, q0 + wr + g + 8};
    const float scale2 = sm_scale * kLog2e;
    float acc[D / 2], s[BK / 2], corr[2];
    uint32_t pa[BK / 16][4];  // p of the last tile, bf16, as the A operand of p V
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    auto stage = [](int t) { return t % kStages; };
    auto phase = [](int t) { return static_cast<uint32_t>((t / kStages) & 1); };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto issue_s = [&](int t) {  // s = Q K_t^T
      const uint32_t sK = sKV + stage(t) * 2 * kTileK;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss(s, desc_kmajor(sQ, BQ, 64 * wg, kc), desc_kmajor(sK, BK, 0, kc), kc > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int t) {  // o += p V_t, V MN-major from the stage
      const uint32_t sV = sKV + stage(t) * 2 * kTileK + kTileK;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs(acc, pa[kc], desc_mnmajor(sV, BK, kc), 1);
      wgmma_commit();
    };
    // p = exp2(s * scale2 - m) in place of kv tile t's scores, with m the
    // running row max in log2 units and corr = exp2(m_old - m); masks only
    // tiles that cross Lk or the diagonal of this warp's rows (rows past Lq
    // are never written).
    auto softmax = [&](int t) {
      const int k0 = t * BK;
      if (k0 + BK > Lk || (causal && k0 + BK - 1 > q0 + wr)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!valid_pos(qpos[e >> 1], k0 + 8 * j + 2 * t4 + (e & 1), Lq, Lk, causal))
              s[4 * j + e] = kNegInf;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale2);
        corr[r] = exp2f(m[r] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          s[4 * j + 2 * r] = exp2f(fmaf(s[4 * j + 2 * r], scale2, -m_new));
          s[4 * j + 2 * r + 1] = exp2f(fmaf(s[4 * j + 2 * r + 1], scale2, -m_new));
          rs += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
        }
        l[r] = l[r] * corr[r] + rs;  // this lane's part of the row; summed at the end
        m[r] = m_new;
      }
    };
    auto to_pa = [&] {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) acc_to_a_wg(pa[kc], s, kc);
    };

    // The two consumer warpgroups take turns issuing their products (named
    // barriers 3 and 4, warpgroup 0 first), so that one's softmax runs
    // while the other's products do. Within a warpgroup, s of tile t is
    // computed while o += p V of tile t - 1 is in flight.
    const int my_turn = 3 + wg, their_turn = 4 - wg;
    auto take_turn = [&] {
      if constexpr (NC == 2) named_bar_sync(my_turn, 2 * kWgThreads);
    };
    auto pass_turn = [&] {
      if constexpr (NC == 2) named_bar_arrive(their_turn, 2 * kWgThreads);
    };
    if (wg == 1) pass_turn();
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    take_turn();
    wgmma_fence();
    issue_s(0);
    pass_turn();
    wgmma_wait<0>();
    fence_acc(s);
    release(k_empty(0));
    softmax(0);
    to_pa();
    for (int t = 1; t < n_kv; ++t) {
      mbar_wait(k_full(stage(t)), phase(t));
      mbar_wait(v_full(stage(t - 1)), phase(t - 1));
      take_turn();
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      pass_turn();
      wgmma_wait<1>();  // s of tile t has landed; o += p V of t - 1 may be in flight
      fence_acc(s);
      release(k_empty(stage(t)));
      softmax(t);
      wgmma_wait<0>();
      fence_acc(acc);
      release(v_empty(stage(t - 1)));
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * n + 2 * r] *= corr[r];
          acc[4 * n + 2 * r + 1] *= corr[r];
        }
      to_pa();
    }
    mbar_wait(v_full(stage(n_kv - 1)), phase(n_kv - 1));
    take_turn();
    wgmma_fence();
    issue_pv(n_kv - 1);
    pass_turn();
    wgmma_wait<0>();
    fence_acc(acc);
    release(v_empty(stage(n_kv - 1)));
    if (wg == 0) take_turn();  // warpgroup 1's last turn

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
    // Only this warpgroup reads its 64 rows of Q: stage o there.
    store_wg_rows<D>(o + b * os.b + h * os.h, os.l, q0, Lq, tiles, BQ, wg, acc, inv);
  }
}

// dk, dv: one block per (64 NC kv rows, batch * head), over q tiles of BQ
// rows from the first that reaches the block's first key. Consumer warpgroup wg
// owns kv rows 64 wg..; S^T = K Q^T and dP^T = V dO^T put the kv rows on the
// accumulators' rows, so p^T and ds^T are A operands from registers for
// dv += p^T dO and dk += ds^T Q (dO and Q MN-major). The producer warp
// stages lse and delta of each q tile beside its Q and dO (0 past Lq, as the
// reference pads them). Shared memory: K, V [d/64][64 NC][64] resident; stages
// of {Q, dO [d/64][BQ][64], lse [BQ], delta [BQ]}; barriers kv_full, full[S]
// (the producer warp's 32 lanes and the TMA bytes), empty[S].
template <int D, int BQ, int NC>
__global__ void __launch_bounds__(Wg<NC>::kThreads, Wg<NC>::kBlocksPerSm)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq,
                               int Lk, Strides dks, Strides dvs, float sm_scale, int causal) {
  constexpr int BK = Wg<NC>::kRows;
  constexpr uint32_t kTileK = BK * D * 2, kTileQ = BQ * D * 2;
  // lse and delta after Q and dO, padded so the next stage stays 1024-byte aligned.
  constexpr uint32_t kStageBytes = 2 * kTileQ + (2 * BQ * 4 + 1023) / 1024 * 1024;
  using L = WgSmem<2 * kTileK, kStageBytes>;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const uint32_t raw = smem_u32(smem_wg), base = (raw + 1023) & ~1023u;
  unsigned char* tiles = smem_wg + (base - raw);
  const uint32_t sK = base, sV = base + kTileK, sStage = base + L::kRing;
  const uint32_t bars = base + L::kBars, kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int k0 = static_cast<int>(blockIdx.x) * BK;  // diagonal tiles, the longest, first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int qt0 = causal ? min(k0 / BQ, n_qt) : 0;
  const int wg = threadIdx.x / kWgThreads;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), Wg<NC>::kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer warp: lane 0 issues the loads, all stage the statistics
    setmaxnreg_dec<24>();
    if (warp == 0) {
      const float* lse_b = lse + static_cast<int64_t>(bh) * Lq;
      const float* delta_b = delta + static_cast<int64_t>(bh) * Lq;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kTileK);
        tma_tile<D, BK>(sK, &tk, kv_full, k0, h, b);
        tma_tile<D, BK>(sV, &tv, kv_full, k0, h, b);
      }
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int i = qt - qt0, st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const uint32_t at = sStage + st * kStageBytes;
        mbar_wait(empty(st), ph ^ 1);
        float* stats = reinterpret_cast<float*>(tiles + (at - base) + 2 * kTileQ);
        for (int r = lane; r < BQ; r += 32) {
          const int row = qt * BQ + r;
          stats[r] = row < Lq ? lse_b[row] : 0.f;
          stats[BQ + r] = row < Lq ? delta_b[row] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(st), 2 * kTileQ);
          tma_tile<D, BQ>(at, &tq, full(st), qt * BQ, h, b);
          tma_tile<D, BQ>(at + kTileQ, &tdo, full(st), qt * BQ, h, b);
        } else {
          mbar_arrive(full(st));
        }
      }
    }
  } else {
    setmaxnreg_inc<Wg<NC>::kConsumerRegs>();
    const int g = lane >> 2, t4 = lane & 3;
    const int wr = 64 * wg + 16 * warp;  // this warp's first kv row of the block
    const int kpos[2] = {k0 + wr + g, k0 + wr + g + 8};
    const float scale2 = sm_scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ, i = qt - qt0, st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint32_t sQ = sStage + st * kStageBytes, sDO = sQ + kTileQ;
      float sT[BQ / 2], dpT[BQ / 2];
      mbar_wait(full(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)  // s^T, unscaled
        wgmma_ss(sT, desc_kmajor(sK, BK, 64 * wg, kc), desc_kmajor(sQ, BQ, 0, kc), kc > 0);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)  // dp^T
        wgmma_ss(dpT, desc_kmajor(sV, BK, 64 * wg, kc), desc_kmajor(sDO, BQ, 0, kc), kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sT);
      fence_acc(dpT);

      // p^T = exp(s - lse) and ds^T = p^T (dp^T - delta), per column q.
      const bool edge = q0 + BQ > Lq || k0 + wr + 16 > Lk || (causal && k0 + wr + 15 > q0);
      const unsigned char* stats = tiles + (sQ - base) + 2 * kTileQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int c = 8 * j + 2 * t4;
        const float2 ls = *reinterpret_cast<const float2*>(stats + 4 * c);
        const float2 dl = *reinterpret_cast<const float2*>(stats + 4 * (BQ + c));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse2 = ((e & 1) ? ls.y : ls.x) * kLog2e;
          const float dlt = (e & 1) ? dl.y : dl.x;
          const bool ok = !edge || valid_pos(q0 + c + (e & 1), kpos[e >> 1], Lq, Lk, causal);
          const float p = ok ? exp2f(sT[4 * j + e] * scale2 - lse2) : 0.f;
          sT[4 * j + e] = p;
          dpT[4 * j + e] = p * (dpT[4 * j + e] - dlt);
        }
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        acc_to_a_wg(pa[kc], sT, kc);
        acc_to_a_wg(da[kc], dpT, kc);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs(dv_acc, pa[kc], desc_mnmajor(sDO, BQ, kc), 1);
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs(dk_acc, da[kc], desc_mnmajor(sQ, BQ, kc), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv_acc);
      fence_acc(dk_acc);
      release(empty(st));
    }
    // Only this warpgroup reads its 64 rows of K and V: stage dk, dv there.
    const float s_dk[2] = {sm_scale, sm_scale}, s_dv[2] = {1.f, 1.f};
    store_wg_rows<D>(dk + b * dks.b + h * dks.h, dks.l, k0, Lk, tiles, BK, wg, dk_acc, s_dk);
    store_wg_rows<D>(dv + b * dvs.b + h * dvs.h, dvs.l, k0, Lk, tiles + kTileK, BK, wg, dv_acc,
                     s_dv);
  }
}

// dq: one block per (64 NC q rows, batch * head), over kv tiles of BK rows
// up to the diagonal. Consumer warpgroup wg owns q rows 64 wg..: S = Q K^T
// and dP = dO V^T from shared memory, ds = p (dp - delta) in registers as
// the A operand of dq += ds K (K MN-major). Shared memory: Q, dO
// [d/64][64 NC][64] resident; stages of {K, V [d/64][BK][64]}; barriers
// q_full, full[S], empty[S].
template <int D, int BK, int NC>
__global__ void __launch_bounds__(Wg<NC>::kThreads, Wg<NC>::kBlocksPerSm)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int H, int Lq, int Lk, Strides dqs,
                              float sm_scale, int causal) {
  constexpr int BQ = Wg<NC>::kRows;
  constexpr uint32_t kTileQ = BQ * D * 2, kTileK = BK * D * 2;
  using L = WgSmem<2 * kTileQ, 2 * kTileK>;
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const uint32_t raw = smem_u32(smem_wg), base = (raw + 1023) & ~1023u;
  unsigned char* tiles = smem_wg + (base - raw);
  const uint32_t sQ = base, sDO = base + kTileQ, sKV = base + L::kRing;
  const uint32_t bars = base + L::kBars, q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int n_qt = (Lq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  int n_kv = (Lk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  const int wg = threadIdx.x / kWgThreads;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), Wg<NC>::kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, 2 * kTileQ);
      tma_tile<D, BQ>(sQ, &tq, q_full, q0, h, b);
      tma_tile<D, BQ>(sDO, &tdo, q_full, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int st = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        const uint32_t at = sKV + st * 2 * kTileK;
        mbar_wait(empty(st), ph ^ 1);
        mbar_expect_tx(full(st), 2 * kTileK);
        tma_tile<D, BK>(at, &tk, full(st), t * BK, h, b);
        tma_tile<D, BK>(at + kTileK, &tv, full(st), t * BK, h, b);
      }
    }
  } else {
    setmaxnreg_inc<Wg<NC>::kConsumerRegs>();
    const int g = lane >> 2, t4 = lane & 3;
    const int wr = 64 * wg + 16 * warp;  // this warp's first row of the tile
    const int qpos[2] = {q0 + wr + g, q0 + wr + g + 8};
    // lse (in log2 units) and delta of this thread's two rows; 0 past Lq, as
    // the reference pads them.
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t at = static_cast<int64_t>(bh) * Lq + qpos[r];
      lse2[r] = qpos[r] < Lq ? lse[at] * kLog2e : 0.f;
      dlt[r] = qpos[r] < Lq ? delta[at] : 0.f;
    }
    const float scale2 = sm_scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);

    // Per kv tile, within the warpgroup: p is computed while dP is in
    // flight, and dq += ds K finishes while the next tile's S and dP are
    // issued.
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    uint32_t da[BK / 16][4];
    for (int t = 0; t < n_kv; ++t) {
      const int k0 = t * BK, st = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const uint32_t sK = sKV + st * 2 * kTileK, sV = sK + kTileK;
      float s[BK / 2], dp[BK / 2];
      mbar_wait(full(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss(s, desc_kmajor(sQ, BQ, 64 * wg, kc), desc_kmajor(sK, BK, 0, kc), kc > 0);
      wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss(dp, desc_kmajor(sDO, BQ, 64 * wg, kc), desc_kmajor(sV, BK, 0, kc), kc > 0);
      wgmma_commit();
      wgmma_wait<1>();  // s (and the last tile's dq) have landed
      fence_acc(s);
      fence_acc(acc);
      if (t > 0) release(empty((t - 1) % kStages));
      // p = exp(s * sm_scale - lse), masked scores at -1e30; only tiles that
      // cross Lk or the diagonal of this warp's rows are masked.
      const bool edge = k0 + BK > Lk || (causal && k0 + BK - 1 > q0 + wr);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          const bool ok = !edge || valid_pos(qpos[r], kpos, Lq, Lk, causal);
          s[4 * j + e] = exp2f((ok ? s[4 * j + e] * scale2 : kNegInf) - lse2[r]);
        }
      wgmma_wait<0>();  // dp has landed
      fence_acc(dp);
      // ds = p (dp - delta), rounded to bf16 as the A operand of dq += ds K.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dlt[e >> 1]);
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) acc_to_a_wg(da[kc], dp, kc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs(acc, da[kc], desc_mnmajor(sK, BK, kc), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release(empty((n_kv - 1) % kStages));
    // Only this warpgroup reads its 64 rows of Q: stage dq there.
    const float scale[2] = {sm_scale, sm_scale};
    store_wg_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.l, q0, Lq, tiles, BQ, wg, acc, scale);
  }
}

// ---------------------------------------------------------------------------
// Host side.

// CUDA-core tiles (f32).
template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

// mma.sync tiles (d = 256): the forward's kv rows per stage; dk/dv's q rows
// per stage and warps per 16 kv rows; dq's kv rows per stage and warps per
// 16 q rows.
template <int D> struct FwdMma;
template <> struct FwdMma<256> { static constexpr int BK = 32; };
template <int D> struct DkvMma;
template <> struct DkvMma<256> { static constexpr int BQ = 32, DSPLIT = 2; };
template <int D> struct DqMma;
template <> struct DqMma<256> { static constexpr int BK = 32, DSPLIT = 2; };

// Warpgroup tiles: the forward's and dq's kv rows per ring stage, dk/dv's q
// rows per stage, and the consumer warpgroups a block (the resident side
// is 64 rows a consumer).
template <int D> struct FwdWg { static constexpr int BK = 128, NC = 2; };
template <int D> struct DqWg { static constexpr int BK = 64, NC = 1; };
template <int D> struct DkvWg { static constexpr int BQ = 64, NC = 2; };

// How every pass multiplies bf16 at each d: the warpgroup kernels at d = 64
// and 128 (each beats mma.sync there on the card); mma.sync at 256, whose
// accumulators do not fit the warpgroup kernels' register plan. f32 runs on
// the CUDA cores.
enum Design { kCudaCores = 0, kMmaSync = 1, kWgmma = 2 };
template <int D>
constexpr int kBf16Design = D == 256 ? kMmaSync : kWgmma;

// WgSmem's bytes for each warpgroup kernel, as the kernels lay them out
// (`rows` resident rows), and 1024 bytes of slack for the alignment.
constexpr size_t fwd_wg_smem(int D, int BK, int rows) {
  return 2 * (rows * D + kStages * 2 * BK * D) + 8 * (1 + 4 * kStages) + 1024;
}
constexpr size_t dq_wg_smem(int D, int BK, int rows) {
  return 2 * (2 * rows * D + kStages * 2 * BK * D) + 8 * (1 + 2 * kStages) + 1024;
}
constexpr size_t dkv_wg_smem(int D, int BQ, int rows) {
  return 2 * 2 * rows * D + kStages * (2 * 2 * BQ * D + (2 * BQ * 4 + 1023) / 1024 * 1024) +
         8 * (1 + 2 * kStages) + 1024;
}

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
// bf16 Q and dO, two stages of K and V.
constexpr size_t dq_mma_smem(int D, int BK) { return 2 * (2 * kDqBQ * D + 2 * 2 * BK * D); }

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

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int B, int H, int Lq, int Lk,
                  const int64_t* st, float sm_scale, int causal, cudaStream_t s) {
  constexpr int BK = DqMma<D>::BK, DSPLIT = DqMma<D>::DSPLIT;
  constexpr size_t smem = dq_mma_smem(D, BK);
  auto kernel = flash_bwd_dq_mma_kernel<D, BK, DSPLIT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + kDqBQ - 1) / kDqBQ, B * H);
  kernel<<<grid, kMmaWarps * 32 * DSPLIT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Lq, Lk,
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda; null where the driver has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [B, L, H, D] bf16 tensor read through its strides (elements) as a TMA
// tensor map over (d, L, H, B): boxes of 64 columns x `rows` rows with the
// 128-byte swizzle; rows past L read as zeros. False where the driver
// refuses it.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int D, Strides st,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.l * 2),
                                 static_cast<cuuint64_t>(st.h * 2),
                                 static_cast<cuuint64_t>(st.b * 2)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_fwd_wg(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                  int Lq, int Lk, const int64_t* st, float sm_scale, int causal, cudaStream_t s) {
  constexpr int BK = FwdWg<D>::BK, NC = FwdWg<D>::NC;
  constexpr int BQ = Wg<NC>::kRows;
  constexpr size_t smem = fwd_wg_smem(D, BK, BQ);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, H, Lq, D, strides_at(st, 0), BQ) ||
      !tensor_map(&tk, k, B, H, Lk, D, strides_at(st, 1), BK) ||
      !tensor_map(&tv, v, B, H, Lk, D, strides_at(st, 2), BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_wgmma_kernel<D, BK, NC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kernel<<<grid, Wg<NC>::kThreads, smem, s>>>(tq, tk, tv, static_cast<bf16*>(o), lse, H, Lq, Lk,
                                      strides_at(st, 3), sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_wg(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* dq, int B, int H, int Lq, int Lk, const int64_t* st,
                 float sm_scale, int causal, cudaStream_t s) {
  constexpr int BK = DqWg<D>::BK, NC = DqWg<D>::NC;
  constexpr int BQ = Wg<NC>::kRows;
  constexpr size_t smem = dq_wg_smem(D, BK, BQ);
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, B, H, Lq, D, strides_at(st, 0), BQ) ||
      !tensor_map(&tk, k, B, H, Lk, D, strides_at(st, 1), BK) ||
      !tensor_map(&tv, v, B, H, Lk, D, strides_at(st, 2), BK) ||
      !tensor_map(&tdo, dout, B, H, Lq, D, strides_at(st, 3), BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dq_wgmma_kernel<D, BK, NC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kernel<<<grid, Wg<NC>::kThreads, smem, s>>>(tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), H, Lq,
                                      Lk, strides_at(st, 4), sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_wg(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int B, int H, int Lq,
                  int Lk, const int64_t* st, float sm_scale, int causal, cudaStream_t s) {
  constexpr int BQ = DkvWg<D>::BQ, NC = DkvWg<D>::NC;
  constexpr int BK = Wg<NC>::kRows;
  constexpr size_t smem = dkv_wg_smem(D, BQ, BK);
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, B, H, Lq, D, strides_at(st, 0), BQ) ||
      !tensor_map(&tk, k, B, H, Lk, D, strides_at(st, 1), BK) ||
      !tensor_map(&tv, v, B, H, Lk, D, strides_at(st, 2), BK) ||
      !tensor_map(&tdo, dout, B, H, Lq, D, strides_at(st, 3), BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, BQ, NC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + BK - 1) / BK, B * H);
  kernel<<<grid, Wg<NC>::kThreads, smem, s>>>(tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
                                      static_cast<bf16*>(dv), H, Lq, Lk, strides_at(st, 4),
                                      strides_at(st, 5), sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at one d: the design kBf16Design names.
template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int Lq, int Lk, const int64_t* st, float sm_scale, int causal, cudaStream_t s) {
  if constexpr (kBf16Design<D> == kWgmma)
    return launch_fwd_wg<D>(q, k, v, o, lse, B, H, Lq, Lk, st, sm_scale, causal, s);
  else
    return launch_fwd_mma<D>(q, k, v, o, lse, B, H, Lq, Lk, st, sm_scale, causal, s);
}
template <int D>
int dq_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dq, int B, int H, int Lq, int Lk, const int64_t* st,
            float sm_scale, int causal, cudaStream_t s) {
  if constexpr (kBf16Design<D> == kWgmma)
    return launch_dq_wg<D>(q, k, v, dout, lse, delta, dq, B, H, Lq, Lk, st, sm_scale, causal, s);
  else
    return launch_dq_mma<D>(q, k, v, dout, lse, delta, dq, B, H, Lq, Lk, st, sm_scale, causal,
                            s);
}
template <int D>
int dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, void* dk, void* dv, int B, int H, int Lq, int Lk,
             const int64_t* st, float sm_scale, int causal, cudaStream_t s) {
  if constexpr (kBf16Design<D> == kWgmma)
    return launch_dkv_wg<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq, Lk, st, sm_scale,
                            causal, s);
  else
    return launch_dkv_mma<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq, Lk, st, sm_scale,
                             causal, s);
}

bool shape_ok(int B, int H, int Lq, int Lk) {
  return B > 0 && H > 0 && Lq > 0 && Lk > 0 && static_cast<int64_t>(B) * H <= 65535;
}

template <int D>
int design_of(int pass, int dtype) {
  if (pass < 0 || pass > 2) return -1;
  return dtype == 0 ? kCudaCores : kBf16Design<D>;
}

template <int D>
long long smem_of(int pass, int dtype) {
  if (dtype == 0) {
    if (pass == 0) return fwd_smem(D, Tiles<D>::BQ, Tiles<D>::BK);
    if (pass == 1) return dq_smem(D, Tiles<D>::BQ, Tiles<D>::BK);
    if (pass == 2) return dkv_smem(D, Tiles<D>::BQ, Tiles<D>::BK);
    return -1;
  }
  if (pass == 0) {
    if constexpr (kBf16Design<D> == kWgmma)
      return fwd_wg_smem(D, FwdWg<D>::BK, Wg<FwdWg<D>::NC>::kRows);
    else
      return fwd_mma_smem(D, FwdMma<D>::BK);
  }
  if (pass == 1) {
    if constexpr (kBf16Design<D> == kWgmma)
      return dq_wg_smem(D, DqWg<D>::BK, Wg<DqWg<D>::NC>::kRows);
    else
      return dq_mma_smem(D, DqMma<D>::BK);
  }
  if (pass == 2) {
    if constexpr (kBf16Design<D> == kWgmma)
      return dkv_wg_smem(D, DkvWg<D>::BQ, Wg<DkvWg<D>::NC>::kRows);
    else
      return dkv_mma_smem(D, DkvMma<D>::BQ);
  }
  return -1;
}

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16; d in {64, 128, 256};
// tensors laid out [B, L, H, d] with the d axis contiguous and 16-byte
// aligned rows; `strides` holds (batch, seq, head) strides in elements,
// three per tensor in the order of the tensor arguments; lse and delta are
// contiguous f32 [B * H, Lq]. Launches on `stream`, returns a cudaError_t
// (0 on success): cudaErrorInvalidValue for a shape, d or dtype outside
// the above. bf16 runs on the tensor cores, f32 on the CUDA cores (see the
// top of this file).

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int H, int Lq, int Lk, int d, const int64_t* strides,
                            float sm_scale, int causal, int dtype, void* stream) {
  if (!shape_ok(B, H, Lq, Lk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_FWD(T, D) launch_fwd<T, D>(q, k, v, o, lse, B, H, Lq, Lk, strides, sm_scale, causal, s)
#define RT_FWD_BF16(D) \
  fwd_bf16<D>(q, k, v, o, lse, B, H, Lq, Lk, strides, sm_scale, causal, s)
  if (dtype == 0 && d == 64) return RT_FWD(float, 64);
  if (dtype == 0 && d == 128) return RT_FWD(float, 128);
  if (dtype == 0 && d == 256) return RT_FWD(float, 256);
  if (dtype == 1 && d == 64) return RT_FWD_BF16(64);
  if (dtype == 1 && d == 128) return RT_FWD_BF16(128);
  if (dtype == 1 && d == 256) return RT_FWD_BF16(256);
#undef RT_FWD_BF16
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
#define RT_DQ_BF16(D) \
  dq_bf16<D>(q, k, v, dout, lse, delta, dq, B, H, Lq, Lk, strides, sm_scale, causal, s)
  if (dtype == 0 && d == 64) return RT_DQ(float, 64);
  if (dtype == 0 && d == 128) return RT_DQ(float, 128);
  if (dtype == 0 && d == 256) return RT_DQ(float, 256);
  if (dtype == 1 && d == 64) return RT_DQ_BF16(64);
  if (dtype == 1 && d == 128) return RT_DQ_BF16(128);
  if (dtype == 1 && d == 256) return RT_DQ_BF16(256);
#undef RT_DQ_BF16
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
#define RT_DKV_BF16(D) \
  dkv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Lq, Lk, strides, sm_scale, causal, s)
  if (dtype == 0 && d == 64) return RT_DKV(float, 64);
  if (dtype == 0 && d == 128) return RT_DKV(float, 128);
  if (dtype == 0 && d == 256) return RT_DKV(float, 256);
  if (dtype == 1 && d == 64) return RT_DKV_BF16(64);
  if (dtype == 1 && d == 128) return RT_DKV_BF16(128);
  if (dtype == 1 && d == 256) return RT_DKV_BF16(256);
#undef RT_DKV_BF16
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

// The design that serves a pass (0 forward, 1 dq, 2 dk/dv) for a dtype and
// d: 0 CUDA cores, 1 mma.sync, 2 wgmma; -1 outside the above. Host-only: the
// wrapper counts each launch under it.
extern "C" int rt_flash_design(int pass, int dtype, int d) {
  if (dtype != 0 && dtype != 1) return -1;
  if (d == 64) return design_of<64>(pass, dtype);
  if (d == 128) return design_of<128>(pass, dtype);
  if (d == 256) return design_of<256>(pass, dtype);
  return -1;
}
