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
// dv (B, Sk, H, D); lse, delta (B, H, Sq) f32. bf16 or f32 in and out; all
// arithmetic in f32.
//
// Design. A TPU grid runs in order and carries the softmax state in VMEM
// scratch between grid steps; Hopper CTAs run in no order, so each CTA owns
// one output tile and loops over the other sequence inside the kernel:
//   * fwd and dq: one CTA per (q tile of 64 rows, b*h), looping over the k
//     tiles of 64 that the causal bound lets through; the q tiles are
//     handed out longest-first so the causal triangle's long rows start
//     early;
//   * dkv: one CTA per (k tile of 64 rows, b*h), looping over the q tiles
//     that can see it.
// Tiles are staged into shared memory as f32 with 16-byte global loads
// (rows past the sequence end are zero-filled and masked). A thread owns a
// 4 x 8 (fwd, dq; 128 threads) or 2 x 8 (dkv; 256 threads) block of the
// 64 x 64 score tile -- rows rg + R*i, columns cg + 8*j -- and reads its
// operands as float4 along D, so each shared-memory load feeds 4-8 FMAs
// (the padded row stride D + 4 keeps those loads free of bank conflicts).
// Probabilities go through shared memory for the P.V-type products, whose
// outputs (O, dQ, dK, dV) stay in registers: the thread's rows times D/8
// columns.
//
// What bounds it on the H100: at the training shapes (S = 2048, D = 128)
// each K/V tile is reused by 64 query rows, so the work is operations, not
// bytes (about 4 * D flops per visible (row, column) pair in the forward,
// 1.5x that in dq and 2x in dkv). This first version runs them as plain
// f32 FMAs, far below the bf16 tensor-core rate the bound assumes; mma /
// wgmma tiles with a TMA pipeline are the planned redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T -> floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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
// launch
// ---------------------------------------------------------------------------
enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

size_t smem_bytes(int kernel, int D) {
  const size_t ld = D + 4, tile = (size_t)kBR * ld, ptile = (size_t)kBR * kLDP;
  switch (kernel) {
    case kFwd: return sizeof(float) * (3 * tile + ptile);
    case kDq: return sizeof(float) * (4 * tile + ptile);
    case kDkv: return sizeof(float) * (4 * tile + ptile + 2 * kBC);
  }
  return 0;
}

template <typename KernelFn>
int launch(KernelFn fn, int kernel, int D, int threads, const Params& p,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(kernel, D);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kernel == kDkv ? p.Sk : p.Sq;
  const dim3 grid((rows + kBR - 1) / kBR, p.B * p.H);
  fn<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_kernel(int kernel, const Params& p, cudaStream_t s) {
  switch (kernel) {
    case kFwd:
      return launch(flash_fwd_kernel<T, D>, kernel, D, kFwdThreads, p, s);
    case kDq:
      return launch(flash_bwd_dq_kernel<T, D>, kernel, D, kFwdThreads, p, s);
    case kDkv:
      return launch(flash_bwd_dkv_kernel<T, D>, kernel, D, kDkvThreads, p, s);
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
// head dim D (ptxas reports only static shared memory).
extern "C" size_t flash_attention_smem_bytes(int kernel, int D) {
  return smem_bytes(kernel, D);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
