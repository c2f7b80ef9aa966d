// Flash attention forward and backward for Hopper (sm_90a), plain C interface.
//
// Replaces the three TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_attention_fwd      <- `_fwd_kernel`      (launched by `_flash_fwd`)
//   flash_attention_bwd_dq   <- `_bwd_dq_kernel`   (launched by `_flash_bwd`)
//   flash_attention_bwd_dkv  <- `_bwd_dkv_kernel`  (launched by `_flash_bwd`)
// Same functions: blockwise attention with an f32 online softmax, causal or
// not, the causal mask bottom-right aligned (query row i sees key column j
// iff j <= i + (Sk - Sq)); the forward also writes the per-row logsumexp;
// the backward recomputes P = exp(S - lse) per tile and takes
// dQ = scale * sum_k P o (dP - delta) K, dV = sum_q P^T dO and
// dK = scale * sum_q dS^T Q, with delta = rowsum(dO o O) computed by the
// caller. Two deliberate differences from the TPU kernels:
//   * a row that sees no key (causal, Sq > Sk) gets O = 0, lse = -inf and
//     zero gradients (the TPU kernel gives it the mean of V);
//   * any Sq and Sk: the tail tiles are masked, nothing has to divide.
//
// Layouts (contiguous, row-major): q, o, dout, dq (B, Sq, H, D); k, v, dk,
// dv (B, Sk, H, D); lse, delta (B, H, Sq) f32. bf16 or f32 in and out.
// In bf16 every product rounds its probability-like operand (P, dS) to
// bf16 first, as the TPU kernels do.
//
// What bounds them on the H100: at the training shapes (S = 2048, D = 128)
// each K/V tile is reused by many query rows, so the work is operations,
// not bytes (4 * D flops per visible (row, column) pair in the forward,
// 1.5x that in dq and 2x in dkv), and the bound is the bf16 tensor-core
// rate. Two designs, chosen by dtype (a stated route, not a fallback):
//
// bf16: tensor cores (`flash_fwd_kernel_tc`, `flash_bwd_dq_kernel_tc`,
// `flash_bwd_dkv_kernel_tc`). A CTA is two consumer warpgroups and one
// producer warp. The producer's lane 0 brings tiles into shared memory
// with TMA (4-D tensor maps over (D, H, S, B), zero-filled past the
// sequence end) through a two-stage ring of mbarriers, so the next tile's
// copy overlaps this tile's math. The consumers multiply with wgmma
// (bf16 in, f32 accumulators in registers; hopper.cuh):
//   * forward: a CTA owns 128 query rows (64 per warpgroup), handed out
//     longest-first, and loops over key tiles of 128 up to the causal
//     bound. S = Q K^T from shared memory (both K-major); the online
//     softmax runs on the accumulator fragment (a row lives in one quad
//     of lanes); P is rounded to bf16 in registers and is the register A
//     operand of O += P V, V read MN-major (transposed) from shared memory.
//   * dQ: the forward's shape. A CTA owns 128 query rows (64 per
//     warpgroup), longest first; Q and dO stay resident (TMA), each
//     thread keeps the lse and delta of its two rows in registers, and K
//     and V tiles of 64 keys stream through the ring up to the causal
//     bound. S = Q K^T and dP = dO V^T from shared memory (K-major);
//     dS = P o (dP - delta), masked by position on diagonal and tail
//     tiles, is rounded to bf16 in registers, as `_bwd_dq_kernel` rounds
//     it, and is the A operand of dQ += dS K, K read MN-major. scale * dQ
//     is written once. 64-key tiles keep dQ, S and dP (64 + 32 + 32 f32
//     at D = 128) in registers; dQ is not fused into dK/dV with atomics,
//     so it stays deterministic.
//   * dK/dV: a CTA owns 128 keys (64 per warpgroup) whose K and V tiles
//     stay resident, and loops over q tiles of 64 rows that can see them;
//     Q, dO (TMA) and their lse, delta slices (loaded by the producer
//     warp: an lse row is not 16-byte aligned for TMA) arrive through the
//     ring. S^T = K Q^T and dP^T = V dO^T from shared memory; P^T =
//     exp(scale S^T - lse), masked by position on diagonal and tail tiles;
//     dS^T = P^T o (dP^T - delta); dV += P^T dO and dK += dS^T Q with P^T
//     and dS^T rounded to bf16 register A operands, as the TPU kernel
//     rounds them before its products. scale * dK and dV are written once.
// Each warpgroup waits for its own products before the softmax step, and
// the two warpgroups of a CTA fill each other's gaps. ptxas holds these
// kernels to 168 registers a thread; at D = 128 the dK/dV consumer (dK,
// dV, S^T, dP^T: 64 + 64 + 32 + 32 f32) spills a few hundred bytes.
// Measured and left out, since none changed the time (PERF.md): a
// producer warpgroup handing registers over with setmaxnreg (ptxas kept
// 168), 32-row q tiles (92 bytes of spill), and issuing the forward's
// next S product before waiting for this tile's P V product.
//
// f32: plain f32 FMAs on the CUDA cores (`flash_fwd_kernel`,
// `flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`); f32 on the tensor cores
// would go through TF32 and lose the 1e-4 parity with the CPU. One CTA
// per (q or k tile of 64 rows, b*h); tiles are staged into shared memory
// as f32 with 16-byte global loads (rows past the sequence end
// zero-filled and masked). A thread owns a 4 x 8 (fwd, dq;
// 128 threads) or 2 x 8 (dkv; 256 threads) block of the 64 x 64 score
// tile -- rows rg + R*i, columns cg + 8*j -- and reads its operands as
// float4 along D (the padded row stride D + 4 keeps those loads free of
// bank conflicts). Probabilities go through shared memory for the P.V-type
// products, whose outputs stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBR = 64;   // rows of the score tile owned by a CTA
constexpr int kBC = 64;   // columns of the score tile per loop iteration
constexpr int kCG = 8;    // column groups: a thread owns columns cg + 8 j
constexpr int kCPT = kBC / kCG;   // score columns per thread
constexpr int kLDP = kBC + 1;     // row stride of the probability tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;      // fwd: o; dq: dq; dkv: dk
  void* out1;      // dkv: dv
  float* lse_out;  // fwd
  int B, H, Sq, Sk;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// 16 bytes of T -> floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// Rows [row0, row0 + kBR) of a (.., S, H, D) tensor at (b, h) -> dst
// [kBR][D + 4] f32; rows at or past S are zero.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int row0,
                                          int S, int H) {
  constexpr int LD = D + 4;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;   // 16-byte chunks per row
  const size_t rs = (size_t)H * D;
#pragma unroll
  for (int e = threadIdx.x; e < kBR * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR;
    float f[VEC];
    if (row0 + r < S) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          base + (size_t)(row0 + r) * rs + c * VEC);
      unpack(u, f, T());
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c * VEC + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

// acc[i][j] = A[rg + RS*i, :] . B[cg + 8*j, :] over D (both [64][D + 4])
template <int D, int RPT, int RS>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         float (&acc)[RPT][kCPT], int rg,
                                         int cg) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < kCPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RPT], b[kCPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg + RS * i) * LD + d);
#pragma unroll
    for (int j = 0; j < kCPT; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (cg + kCG * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// Output columns of a thread: OPT = D / 8 of them, in VW-wide runs; run q
// holds columns q * 8 * VW + cg * VW + [0, VW).
template <int D>
struct Cols {
  static constexpr int OPT = D / kCG;
  static constexpr int VW = OPT >= 4 ? 4 : OPT;
  static constexpr int RUNS = OPT / VW;
  __device__ static __forceinline__ int col(int jj, int cg) {
    return (jj / VW) * (kCG * VW) + cg * VW + jj % VW;
  }
};

// o[i][jj] += sum_c P[rg + RS*i][c] * V[c][col(jj)]  (P [64][65], V [64][D+4])
template <int D, int RPT, int RS>
__device__ __forceinline__ void tile_pv(const float* P, const float* V,
                                        float (&o)[RPT][D / kCG], int rg,
                                        int cg) {
  using C = Cols<D>;
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int c = 0; c < kBC; ++c) {
    float p[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) p[i] = P[(rg + RS * i) * kLDP + c];
    float vv[C::OPT];
#pragma unroll
    for (int q = 0; q < C::RUNS; ++q) {
      const float* src = V + c * LD + q * (kCG * C::VW) + cg * C::VW;
      if constexpr (C::VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(src);
        vv[q * 4] = t.x;
        vv[q * 4 + 1] = t.y;
        vv[q * 4 + 2] = t.z;
        vv[q * 4 + 3] = t.w;
      } else {
#pragma unroll
        for (int e = 0; e < C::VW; ++e) vv[q * C::VW + e] = src[e];
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < C::OPT; ++jj) o[i][jj] = fmaf(p[i], vv[jj], o[i][jj]);
  }
}

// max / sum over the 8 lanes that share a row group (consecutive lanes)
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// rows of a thread's o/dq/dk/dv block -> global (row stride H * D)
template <typename T, int D, int RPT, int RS>
__device__ __forceinline__ void store_rows(T* base, const float (&o)[RPT][D / kCG],
                                           float mul_by_row[RPT], int row0,
                                           int S, int H, int rg, int cg) {
  using C = Cols<D>;
  const size_t rs = (size_t)H * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + rg + RS * i;
    if (row >= S) continue;
    T* dst = base + (size_t)row * rs;
#pragma unroll
    for (int jj = 0; jj < C::OPT; ++jj)
      dst[C::col(jj, cg)] = from_f<T>(o[i][jj] * mul_by_row[i]);
  }
}

constexpr int kFwdThreads = 128;
constexpr int kDkvThreads = 256;

// ---------------------------------------------------------------------------
// K2: forward
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_kernel(Params p) {
  constexpr int NT = kFwdThreads, RS = NT / kCG, RPT = kBR / RS;
  constexpr int LD = D + 4, OPT = D / kCG;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBR * LD;
  float* Vs = Ks + kBC * LD;
  float* Ps = Vs + kBC * LD;

  const int tid = threadIdx.x, rg = tid / kCG, cg = tid % kCG;
  const int nqt = (p.Sq + kBR - 1) / kBR;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * kBR;   // longest rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int off = p.Sk - p.Sq;
  const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.Sq * p.H + h) * D;
  const T* k = static_cast<const T*>(p.k) + ((size_t)b * p.Sk * p.H + h) * D;
  const T* v = static_cast<const T*>(p.v) + ((size_t)b * p.Sk * p.H + h) * D;
  const int kend = p.causal ? min(p.Sk, q0 + kBR + off) : p.Sk;

  load_tile<T, D, NT>(Qs, q, q0, p.Sq, p.H);
  float m[RPT], l[RPT], o[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < OPT; ++jj) o[i][jj] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBC) {
    __syncthreads();   // the previous tile is done with Ks, Vs, Ps
    load_tile<T, D, NT>(Ks, k, k0, p.Sk, p.H);
    load_tile<T, D, NT>(Vs, v, k0, p.Sk, p.H);
    __syncthreads();
    float s[RPT][kCPT];
    tile_dot<D, RPT, RS>(Qs, Ks, s, rg, cg);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + rg + RS * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const int col = k0 + cg + kCG * j;
        const bool vis =
            row < p.Sq && col < p.Sk && (!p.causal || col <= row + off);
        s[i][j] = vis ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCPT; ++j) s[i][j] = 0.f;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) o[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < kCPT; ++j)
        Ps[(rg + RS * i) * kLDP + cg + kCG * j] = s[i][j];
    }
    __syncthreads();
    tile_pv<D, RPT, RS>(Ps, Vs, o, rg, cg);
  }

  float inv[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    const int row = q0 + rg + RS * i;
    if (cg == 0 && row < p.Sq)
      p.lse_out[(size_t)bh * p.Sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
  T* out = static_cast<T*>(p.out0) + ((size_t)b * p.Sq * p.H + h) * D;
  store_rows<T, D, RPT, RS>(out, o, inv, q0, p.Sq, p.H, rg, cg);
}

// ---------------------------------------------------------------------------
// K3: dQ
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int NT = kFwdThreads, RS = NT / kCG, RPT = kBR / RS;
  constexpr int LD = D + 4, OPT = D / kCG;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBR * LD;
  float* Ks = dOs + kBR * LD;
  float* Vs = Ks + kBC * LD;
  float* Ps = Vs + kBC * LD;

  const int tid = threadIdx.x, rg = tid / kCG, cg = tid % kCG;
  const int nqt = (p.Sq + kBR - 1) / kBR;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * kBR;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int off = p.Sk - p.Sq;
  const size_t qoff = ((size_t)b * p.Sq * p.H + h) * D;
  const size_t koff = ((size_t)b * p.Sk * p.H + h) * D;
  const T* k = static_cast<const T*>(p.k) + koff;
  const T* v = static_cast<const T*>(p.v) + koff;
  const int kend = p.causal ? min(p.Sk, q0 + kBR + off) : p.Sk;

  load_tile<T, D, NT>(Qs, static_cast<const T*>(p.q) + qoff, q0, p.Sq, p.H);
  load_tile<T, D, NT>(dOs, static_cast<const T*>(p.dout) + qoff, q0, p.Sq,
                      p.H);
  float lse[RPT], dlt[RPT], dq[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + RS * i;
    lse[i] = row < p.Sq ? p.lse_in[(size_t)bh * p.Sq + row] : 0.f;
    dlt[i] = row < p.Sq ? p.delta[(size_t)bh * p.Sq + row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < OPT; ++jj) dq[i][jj] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBC) {
    __syncthreads();
    load_tile<T, D, NT>(Ks, k, k0, p.Sk, p.H);
    load_tile<T, D, NT>(Vs, v, k0, p.Sk, p.H);
    __syncthreads();
    float s[RPT][kCPT], dp[RPT][kCPT];
    tile_dot<D, RPT, RS>(Qs, Ks, s, rg, cg);
    tile_dot<D, RPT, RS>(dOs, Vs, dp, rg, cg);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + rg + RS * i;
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const int col = k0 + cg + kCG * j;
        const bool vis =
            row < p.Sq && col < p.Sk && (!p.causal || col <= row + off);
        const float pr = vis ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        Ps[(rg + RS * i) * kLDP + cg + kCG * j] = pr * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();
    tile_pv<D, RPT, RS>(Ps, Ks, dq, rg, cg);
  }

  float sc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) sc[i] = p.scale;
  store_rows<T, D, RPT, RS>(static_cast<T*>(p.out0) + qoff, dq, sc, q0, p.Sq,
                            p.H, rg, cg);
}

// ---------------------------------------------------------------------------
// K4: dK and dV
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int NT = kDkvThreads, RS = NT / kCG, RPT = kBR / RS;
  constexpr int LD = D + 4, OPT = D / kCG;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // rows: this CTA's keys
  float* Vs = Ks + kBR * LD;
  float* Qs = Vs + kBR * LD;                      // columns: a q tile
  float* dOs = Qs + kBC * LD;
  float* Ps = dOs + kBC * LD;                     // P^T, then dS^T
  float* lse_s = Ps + kBR * kLDP;
  float* dlt_s = lse_s + kBC;

  const int tid = threadIdx.x, rg = tid / kCG, cg = tid % kCG;
  const int k0 = blockIdx.x * kBR;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int off = p.Sk - p.Sq;
  const size_t qoff = ((size_t)b * p.Sq * p.H + h) * D;
  const size_t koff = ((size_t)b * p.Sk * p.H + h) * D;
  const T* q = static_cast<const T*>(p.q) + qoff;
  const T* dout = static_cast<const T*>(p.dout) + qoff;
  // first q row that sees key k0 is k0 - off (causal)
  const int qbeg = p.causal ? (max(0, k0 - off) / kBC) * kBC : 0;

  load_tile<T, D, NT>(Ks, static_cast<const T*>(p.k) + koff, k0, p.Sk, p.H);
  load_tile<T, D, NT>(Vs, static_cast<const T*>(p.v) + koff, k0, p.Sk, p.H);
  float dk[RPT][OPT], dv[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < OPT; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  for (int q0 = qbeg; q0 < p.Sq; q0 += kBC) {
    __syncthreads();
    load_tile<T, D, NT>(Qs, q, q0, p.Sq, p.H);
    load_tile<T, D, NT>(dOs, dout, q0, p.Sq, p.H);
    if (tid < kBC) {
      const int row = q0 + tid;
      lse_s[tid] = row < p.Sq ? p.lse_in[(size_t)bh * p.Sq + row] : 0.f;
      dlt_s[tid] = row < p.Sq ? p.delta[(size_t)bh * p.Sq + row] : 0.f;
    }
    __syncthreads();
    float st[RPT][kCPT], dpt[RPT][kCPT];
    tile_dot<D, RPT, RS>(Ks, Qs, st, rg, cg);    // S^T[key][query]
    tile_dot<D, RPT, RS>(Vs, dOs, dpt, rg, cg);  // dP^T[key][query]
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int key = k0 + rg + RS * i;
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const int c = cg + kCG * j, row = q0 + c;
        const bool vis =
            key < p.Sk && row < p.Sq && (!p.causal || key <= row + off);
        const float pr = vis ? expf(st[i][j] * p.scale - lse_s[c]) : 0.f;
        Ps[(rg + RS * i) * kLDP + c] = pr;
        st[i][j] = pr * (dpt[i][j] - dlt_s[c]);   // dS^T
      }
    }
    __syncthreads();
    tile_pv<D, RPT, RS>(Ps, dOs, dv, rg, cg);     // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < kCPT; ++j)
        Ps[(rg + RS * i) * kLDP + cg + kCG * j] = st[i][j];
    __syncthreads();
    tile_pv<D, RPT, RS>(Ps, Qs, dk, rg, cg);      // dK += dS^T Q
  }

  float sc[RPT], one[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    sc[i] = p.scale;
    one[i] = 1.f;
  }
  store_rows<T, D, RPT, RS>(static_cast<T*>(p.out0) + koff, dk, sc, k0, p.Sk,
                            p.H, rg, cg);
  store_rows<T, D, RPT, RS>(static_cast<T*>(p.out1) + koff, dv, one, k0, p.Sk,
                            p.H, rg, cg);
}

// ---------------------------------------------------------------------------
// K2 and K4 in bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kConsumers = 2;                       // warpgroups doing math
constexpr int kTcThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kStages = 2;                          // TMA ring depth
constexpr int kFwdBM = 128;   // fwd: query rows per CTA
constexpr int kFwdBN = 128;   // fwd: keys per k tile
constexpr int kDkvBN = 128;   // dkv: keys per CTA
constexpr int kDkvBM = 64;    // dkv: query rows per q tile
constexpr int kDqBM = 128;    // dq: query rows per CTA
constexpr int kDqBN = 64;     // dq: keys per k tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bytes of dynamic shared memory: 1 KB of alignment slack, the tiles, the
// lse / delta slices (dkv) and the mbarriers
template <int D>
constexpr size_t tc_fwd_smem() {
  using T = hopper::Tile<D>;
  return 1024 + T::bytes(kFwdBM) + 2 * kStages * T::bytes(kFwdBN) + 64;
}
template <int D>
constexpr size_t tc_dq_smem() {
  using T = hopper::Tile<D>;
  return 1024 + 2 * T::bytes(kDqBM) + 2 * kStages * T::bytes(kDqBN) + 64;
}
template <int D>
constexpr size_t tc_dkv_smem() {
  using T = hopper::Tile<D>;
  return 1024 + 2 * T::bytes(kDkvBN) + 2 * kStages * T::bytes(kDkvBM) +
         2 * kStages * kDkvBM * sizeof(float) + 64;
}

// the thread's rows of a [64 x D] f32 accumulator (rows row0, row0 + 8),
// times mul0 / mul1, -> bf16 rows of a (.., S, H, D) tensor at `base`
template <int D>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* base,
                                               const float (&acc)[D / 2],
                                               int row0, float mul0,
                                               float mul1, int S, int H,
                                               int t) {
  const size_t rs = (size_t)H * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    const float mul = half ? mul1 : mul0;
    uint32_t* dst = reinterpret_cast<uint32_t*>(base + (size_t)row * rs);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      dst[(8 * i + 2 * t) / 2] = hopper::pack_bf16(
          acc[4 * i + 2 * half] * mul, acc[4 * i + 2 * half + 1] * mul);
  }
}

// K2, bf16: grid (B * H, q tiles of 128, longest first)
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Params p) {
  using T = hopper::Tile<D>;
  using namespace hopper;
  constexpr int BM = kFwdBM, BN = kFwdBN;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t sQ = smem_u32(sm);
  const uint32_t sK = sQ + T::bytes(BM);              // kStages tiles
  const uint32_t sV = sK + kStages * T::bytes(BN);    // kStages tiles
  const uint32_t bar = sV + kStages * T::bytes(BN);   // q, full[2], empty[2]
  const uint32_t q_full = bar;
  auto full = [&](int st) { return bar + 8 + 8 * st; };
  auto empty = [&](int st) { return bar + 8 + 8 * kStages + 8 * st; };

  const int nqt = (p.Sq + BM - 1) / BM;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * BM;   // longest rows first
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int off = p.Sk - p.Sq;
  const int kend = p.causal ? min(p.Sk, q0 + BM + off) : p.Sk;
  const int nkt = kend > 0 ? (kend + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {   // producer warp: lane 0 issues every copy
    if (threadIdx.x % 32 == 0 && nkt > 0) {
      mbar_expect_tx(q_full, T::bytes(BM));
      for (int x = 0; x < T::NBOX; ++x)
        tma_load_4d(sQ + x * BM * T::RB, &tq, x * T::C, h, q0, b, q_full);
      for (int it = 0; it < nkt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full(st), 2 * T::bytes(BN));
        for (int x = 0; x < T::NBOX; ++x) {
          const uint32_t o = st * T::bytes(BN) + x * BN * T::RB;
          tma_load_4d(sK + o, &tk, x * T::C, h, it * BN, b, full(st));
          tma_load_4d(sV + o, &tv, x * T::C, h, it * BN, b, full(st));
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows wq0 .. wq0 + 63; this thread's rows
  // r0 and r0 + 8, columns 8 i + 2 t (+1) of each accumulator
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + 64 * wg;
  const int r0 = wq0 + 16 * w + g;
  const float sl2 = p.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // log2 domain

  if (nkt > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < nkt; ++it) {
    const int st = it % kStages, k0 = it * BN;
    mbar_wait(full(st), (it / kStages) & 1);
    // a key tile wholly above this warpgroup's diagonal is skipped
    if (!(p.causal && k0 > wq0 + 63 + off)) {
      const uint32_t kt = sK + st * T::bytes(BN), vt = sV + st * T::bytes(BN);
      float s[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(s, desc_kmajor<D>(sQ, BM, 64 * wg, kk),
                     desc_kmajor<D>(kt, BN, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      if (k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > wq0 + off)) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * i + 2 * t + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (col >= p.Sk || (p.causal && col > row + off))
              s[4 * i + e] = -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
      float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]) * sl2);
        alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = exp2f(fmaf(s[4 * i + e], sl2, -base[e >> 1]));
          s[4 * i + e] = pr;
          sum[e >> 1] += pr;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * i + e] *= alpha[e >> 1];

      uint32_t pa[BN / 16][4];
      to_a_operand<BN / 16>(s, pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wgmma_rs<D>(o, pa[j], desc_mnmajor<D>(vt, BN, j));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
    }
    if (tid == 0) mbar_arrive(empty(st));
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = r0 + 8 * r;
    if (t == 0 && row < p.Sq)
      p.lse_out[(size_t)bh * p.Sq + row] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out0) +
                       ((size_t)b * p.Sq * p.H + h) * D;
  store_acc_rows<D>(out, o, r0, inv[0], inv[1], p.Sq, p.H, t);
}

// K3, bf16: grid (B * H, q tiles of 128, longest first). Q and dO stay
// resident; K and V tiles of 64 keys stream through the ring up to the
// causal bound. Per tile: S = Q K^T and dP = dO V^T (both K-major from
// shared memory), dS = P o (dP - delta) rounded to bf16 in registers (as
// `_bwd_dq_kernel` rounds it), then dQ += dS K with K read MN-major.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_kernel_tc(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           Params p) {
  using T = hopper::Tile<D>;
  using namespace hopper;
  constexpr int BM = kDqBM, BN = kDqBN;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t sQ = smem_u32(sm);
  const uint32_t sdO = sQ + T::bytes(BM);
  const uint32_t sK = sdO + T::bytes(BM);             // kStages tiles
  const uint32_t sV = sK + kStages * T::bytes(BN);    // kStages tiles
  const uint32_t bar = sV + kStages * T::bytes(BN);   // q, full[2], empty[2]
  const uint32_t q_full = bar;
  auto full = [&](int st) { return bar + 8 + 8 * st; };
  auto empty = [&](int st) { return bar + 8 + 8 * kStages + 8 * st; };

  const int nqt = (p.Sq + BM - 1) / BM;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * BM;   // longest rows first
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int off = p.Sk - p.Sq;
  const int kend = p.causal ? min(p.Sk, q0 + BM + off) : p.Sk;
  const int nkt = kend > 0 ? (kend + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {   // producer warp: lane 0 issues every copy
    if (threadIdx.x % 32 == 0 && nkt > 0) {
      mbar_expect_tx(q_full, 2 * T::bytes(BM));
      for (int x = 0; x < T::NBOX; ++x) {
        tma_load_4d(sQ + x * BM * T::RB, &tq, x * T::C, h, q0, b, q_full);
        tma_load_4d(sdO + x * BM * T::RB, &tdo, x * T::C, h, q0, b, q_full);
      }
      for (int it = 0; it < nkt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full(st), 2 * T::bytes(BN));
        for (int x = 0; x < T::NBOX; ++x) {
          const uint32_t o = st * T::bytes(BN) + x * BN * T::RB;
          tma_load_4d(sK + o, &tk, x * T::C, h, it * BN, b, full(st));
          tma_load_4d(sV + o, &tv, x * T::C, h, it * BN, b, full(st));
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows wq0 .. wq0 + 63; this thread's rows
  // r0 and r0 + 8 (their lse, in the log2 domain, and delta sit in
  // registers), key columns 8 i + 2 t (+1) of the score fragments
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq0 = q0 + 64 * wg;
  const int r0 = wq0 + 16 * w + g;
  const float sl2 = p.scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const bool in = row < p.Sq;
    lse2[r] = in ? p.lse_in[(size_t)bh * p.Sq + row] * kLog2e : 0.f;
    dlt[r] = in ? p.delta[(size_t)bh * p.Sq + row] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (nkt > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < nkt; ++it) {
    const int st = it % kStages, k0 = it * BN;
    mbar_wait(full(st), (it / kStages) & 1);
    // a key tile wholly above this warpgroup's diagonal is skipped
    if (!(p.causal && k0 > wq0 + 63 + off)) {
      const uint32_t kt = sK + st * T::bytes(BN), vt = sV + st * T::bytes(BN);
      float s[BN / 2], dp[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(s, desc_kmajor<D>(sQ, BM, 64 * wg, kk),
                     desc_kmajor<D>(kt, BN, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(dp, desc_kmajor<D>(sdO, BM, 64 * wg, kk),
                     desc_kmajor<D>(vt, BN, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // rows past Sq read zeros and lse = delta = 0, so their dS is 0; a
      // row that sees no key (lse = -inf) lies in a masked tile
      const bool mask = k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > wq0 + off);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(fmaf(s[4 * i + e], sl2, -lse2[e >> 1]));
          if (mask) {
            const int col = k0 + 8 * i + 2 * t + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (col >= p.Sk || (p.causal && col > row + off)) pr = 0.f;
          }
          s[4 * i + e] = pr * (dp[4 * i + e] - dlt[e >> 1]);   // dS
        }
      uint32_t da[BN / 16][4];
      to_a_operand<BN / 16>(s, da);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wgmma_rs<D>(dq, da[j], desc_mnmajor<D>(kt, BN, j));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      fence_regs(da);
    }
    if (tid == 0) mbar_arrive(empty(st));
  }

  const size_t qoff = ((size_t)b * p.Sq * p.H + h) * D;
  store_acc_rows<D>(static_cast<__nv_bfloat16*>(p.out0) + qoff, dq, r0,
                    p.scale, p.scale, p.Sq, p.H, t);
}

// K4, bf16: grid (B * H, key tiles of 128; tile 0, which the most q rows
// see, first)
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkv_kernel_tc(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            Params p) {
  using T = hopper::Tile<D>;
  using namespace hopper;
  constexpr int BN = kDkvBN, BM = kDkvBM;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t sK = smem_u32(sm);
  const uint32_t sV = sK + T::bytes(BN);
  const uint32_t sQ = sV + T::bytes(BN);               // kStages tiles
  const uint32_t sdO = sQ + kStages * T::bytes(BM);    // kStages tiles
  const int stat_off = 2 * T::bytes(BN) + 2 * kStages * T::bytes(BM);
  float* lse_s = reinterpret_cast<float*>(sm + stat_off);   // [kStages][BM]
  float* dlt_s = lse_s + kStages * BM;                      // [kStages][BM]
  const uint32_t bar = smem_u32(dlt_s + kStages * BM);
  const uint32_t kv_full = bar;
  auto full = [&](int st) { return bar + 8 + 8 * st; };
  auto empty = [&](int st) { return bar + 8 + 8 * kStages + 8 * st; };

  const int k0 = (int)blockIdx.y * BN;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int off = p.Sk - p.Sq;
  // first q row that sees key k0 is k0 - off (causal)
  const int qbeg = p.causal ? (max(0, k0 - off) / BM) * BM : 0;
  const int nqt = qbeg < p.Sq ? (p.Sq - qbeg + BM - 1) / BM : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 32);   // the producer warp's lanes
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {   // producer warp
    const int lane = threadIdx.x % 32;
    if (nqt == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * T::bytes(BN));
      for (int x = 0; x < T::NBOX; ++x) {
        tma_load_4d(sK + x * BN * T::RB, &tk, x * T::C, h, k0, b, kv_full);
        tma_load_4d(sV + x * BN * T::RB, &tv, x * T::C, h, k0, b, kv_full);
      }
    }
    for (int it = 0; it < nqt; ++it) {
      const int st = it % kStages, q0 = qbeg + it * BM;
      if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
      for (int r = lane; r < BM; r += 32) {
        const int row = q0 + r;
        const bool in = row < p.Sq;
        lse_s[st * BM + r] =
            in ? p.lse_in[(size_t)bh * p.Sq + row] * kLog2e : 0.f;
        dlt_s[st * BM + r] = in ? p.delta[(size_t)bh * p.Sq + row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full(st), 2 * T::bytes(BM));
        for (int x = 0; x < T::NBOX; ++x) {
          const uint32_t o = st * T::bytes(BM) + x * BM * T::RB;
          tma_load_4d(sQ + o, &tq, x * T::C, h, q0, b, full(st));
          tma_load_4d(sdO + o, &tdo, x * T::C, h, q0, b, full(st));
        }
      } else {
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // consumer warpgroup wg: keys kw0 .. kw0 + 63; this thread's keys kr0
  // and kr0 + 8, q columns 8 i + 2 t (+1) of the score fragments
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 64 * wg;
  const int kr0 = kw0 + 16 * w + g;
  const float sl2 = p.scale * kLog2e;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (nqt > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < nqt; ++it) {
    const int st = it % kStages, q0 = qbeg + it * BM;
    mbar_wait(full(st), (it / kStages) & 1);
    // a q tile wholly below this warpgroup's diagonal is skipped
    if (!(p.causal && q0 + BM - 1 + off < kw0)) {
      const uint32_t qt = sQ + st * T::bytes(BM);
      const uint32_t dot = sdO + st * T::bytes(BM);
      const float* lse_t = lse_s + st * BM;
      const float* dlt_t = dlt_s + st * BM;
      float s[BM / 2], dp[BM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM>(s, desc_kmajor<D>(sK, BN, 64 * wg, kk),
                     desc_kmajor<D>(qt, BM, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM>(dp, desc_kmajor<D>(sV, BN, 64 * wg, kk),
                     desc_kmajor<D>(dot, BM, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      const bool mask =
          q0 + BM > p.Sq || (p.causal && kw0 + 63 > q0 + off);
#pragma unroll
      for (int i = 0; i < BM / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * i + 2 * t + (e & 1);
          float pr = exp2f(fmaf(s[4 * i + e], sl2, -lse_t[c]));
          if (mask) {
            const int row = q0 + c, key = kr0 + 8 * (e >> 1);
            if (row >= p.Sq || (p.causal && key > row + off)) pr = 0.f;
          }
          s[4 * i + e] = pr;                                // P^T
          dp[4 * i + e] = pr * (dp[4 * i + e] - dlt_t[c]);  // dS^T
        }
      uint32_t pa[BM / 16][4], da[BM / 16][4];
      to_a_operand<BM / 16>(s, pa);
      to_a_operand<BM / 16>(dp, da);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BM / 16; ++j)
        wgmma_rs<D>(dv, pa[j], desc_mnmajor<D>(dot, BM, j));
#pragma unroll
      for (int j = 0; j < BM / 16; ++j)
        wgmma_rs<D>(dk, da[j], desc_mnmajor<D>(qt, BM, j));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
    }
    if (tid == 0) mbar_arrive(empty(st));
  }

  const size_t koff = ((size_t)b * p.Sk * p.H + h) * D;
  store_acc_rows<D>(static_cast<__nv_bfloat16*>(p.out0) + koff, dk, kr0,
                    p.scale, p.scale, p.Sk, p.H, t);
  store_acc_rows<D>(static_cast<__nv_bfloat16*>(p.out1) + koff, dv, kr0, 1.f,
                    1.f, p.Sk, p.H, t);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

// dynamic shared memory of the f32-FMA kernels
size_t fma_smem_bytes(int kernel, int D) {
  const size_t ld = D + 4, tile = (size_t)kBR * ld, ptile = (size_t)kBR * kLDP;
  switch (kernel) {
    case kFwd: return sizeof(float) * (3 * tile + ptile);
    case kDq: return sizeof(float) * (4 * tile + ptile);
    case kDkv: return sizeof(float) * (4 * tile + ptile + 2 * kBC);
  }
  return 0;
}

template <int D>
size_t tc_smem_bytes(int kernel) {
  return kernel == kFwd  ? tc_fwd_smem<D>()
         : kernel == kDq ? tc_dq_smem<D>()
                         : tc_dkv_smem<D>();
}

// successful launches by route (0 FMA, 1 tensor cores) and kernel, so a
// caller can show which route a call took
long long route_launches[2][3] = {};

template <typename KernelFn>
int launch(KernelFn fn, int kernel, int D, int threads, const Params& p,
           cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(kernel, D);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kernel == kDkv ? p.Sk : p.Sq;
  const dim3 grid((rows + kBR - 1) / kBR, p.B * p.H);
  fn<<<grid, threads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++route_launches[0][kernel];
  return (int)err;
}

// K2 (kernel kFwd), K3 (kDq) or K4 (kDkv) in bf16 on the tensor cores:
// one tensor map per operand, encoded on the host for this launch
template <int D>
int launch_tc(int kernel, const Params& p, cudaStream_t stream) {
  using hopper::encode_bshd;
  const int q_rows = kernel == kFwd ? kFwdBM : kernel == kDq ? kDqBM : kDkvBM;
  const int k_rows = kernel == kFwd ? kFwdBN : kernel == kDq ? kDqBN : kDkvBN;
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_bshd(&tq, p.q, p.B, p.Sq, p.H, D, q_rows);
  if (!err) err = encode_bshd(&tk, p.k, p.B, p.Sk, p.H, D, k_rows);
  if (!err) err = encode_bshd(&tv, p.v, p.B, p.Sk, p.H, D, k_rows);
  if (!err && kernel != kFwd)
    err = encode_bshd(&tdo, p.dout, p.B, p.Sq, p.H, D, q_rows);
  if (err) return err;
  const size_t smem = tc_smem_bytes<D>(kernel);
  const int tiles = kernel == kDkv ? (p.Sk + k_rows - 1) / k_rows
                                   : (p.Sq + q_rows - 1) / q_rows;
  const dim3 grid(p.B * p.H, tiles);
  cudaError_t e;
  if (kernel == kFwd) {
    e = cudaFuncSetAttribute(flash_fwd_kernel_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_kernel_tc<D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, p);
  } else if (kernel == kDq) {
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_kernel_tc<D><<<grid, kTcThreads, smem, stream>>>(
        tq, tk, tv, tdo, p);
  } else {
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dkv_kernel_tc<D><<<grid, kTcThreads, smem, stream>>>(
        tq, tk, tv, tdo, p);
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) ++route_launches[1][kernel];
  return (int)e;
}

template <typename T, int D>
int dispatch_kernel(int kernel, const Params& p, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_tc<D>(kernel, p, s);
  } else {
    switch (kernel) {
      case kFwd:
        return launch(flash_fwd_kernel<T, D>, kernel, D, kFwdThreads, p, s);
      case kDq:
        return launch(flash_bwd_dq_kernel<T, D>, kernel, D, kFwdThreads, p,
                      s);
      case kDkv:
        return launch(flash_bwd_dkv_kernel<T, D>, kernel, D, kDkvThreads, p,
                      s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(int kernel, int D, const Params& p, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_kernel<T, 16>(kernel, p, s);
    case 32: return dispatch_kernel<T, 32>(kernel, p, s);
    case 64: return dispatch_kernel<T, 64>(kernel, p, s);
    case 128: return dispatch_kernel<T, 128>(kernel, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the route is chosen by dtype (0 f32, 1 bf16): every bf16 kernel on the
// tensor cores, every f32 kernel on the f32-FMA kernels
size_t smem_bytes(int kernel, int D, int dtype) {
  if (dtype != 1) return fma_smem_bytes(kernel, D);
  switch (D) {
    case 16: return tc_smem_bytes<16>(kernel);
    case 32: return tc_smem_bytes<32>(kernel);
    case 64: return tc_smem_bytes<64>(kernel);
    case 128: return tc_smem_bytes<128>(kernel);
  }
  return 0;
}

int run(int kernel, const Params& p, int D, int dtype, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Sq <= 0 || p.Sk <= 0 || p.B * p.H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(kernel, D, p, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(kernel, D, p, s);
  return (int)cudaErrorInvalidValue;
}

Params make(const void* q, const void* k, const void* v, int B, int H,
            int Sq, int Sk, float scale, int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// All functions: dtype 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128};
// B * H <= 65535; Sq, Sk > 0; every pointer on one device, contiguous and
// 16-byte aligned (the caller checks). Each returns a cudaError_t
// (0 = success) and launches on `stream` without synchronising.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int H, int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, void* stream) {
  Params p = make(q, k, v, B, H, Sq, Sk, scale, causal);
  p.out0 = o;
  p.lse_out = lse;
  return run(kFwd, p, D, dtype, stream);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int B, int H, int Sq, int Sk,
                                      int D, float scale, int causal,
                                      int dtype, void* stream) {
  Params p = make(q, k, v, B, H, Sq, Sk, scale, causal);
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.out0 = dq;
  return run(kDq, p, D, dtype, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D, float scale,
                                       int causal, int dtype, void* stream) {
  Params p = make(q, k, v, B, H, Sq, Sk, scale, causal);
  p.dout = dout;
  p.lse_in = lse;
  p.delta = delta;
  p.out0 = dk;
  p.out1 = dv;
  return run(kDkv, p, D, dtype, stream);
}

// Dynamic shared memory one CTA of `kernel` (0 fwd, 1 dq, 2 dkv) takes at
// head dim D for `dtype` (ptxas reports only static shared memory).
extern "C" size_t flash_attention_smem_bytes(int kernel, int D, int dtype) {
  return smem_bytes(kernel, D, dtype);
}

// Successful launches so far of `kernel` (0 fwd, 1 dq, 2 dkv) by route:
// tensor_cores 1 for the wgmma kernels, 0 for the f32-FMA kernels.
extern "C" long long flash_attention_route_launches(int kernel,
                                                    int tensor_cores) {
  if (kernel < 0 || kernel > 2 || tensor_cores < 0 || tensor_cores > 1)
    return -1;
  return route_launches[tensor_cores][kernel];
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
