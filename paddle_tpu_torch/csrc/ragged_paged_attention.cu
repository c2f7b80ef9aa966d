// Ragged paged attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_ragged_kernel` of
// paddle_tpu/ops/pallas/ragged_paged_attention.py (launched by
// `_ragged_attend_pallas`). Same function: every query row of a
// ragged-packed token stream attends causally to its sequence slot's
// paged KV cache, up to and including its own absolute position
// (rows of slot i sit at positions ctx[i]-nq .. ctx[i]-1). GQA: query
// head h reads kv-head h / (H / KH). Online softmax in f32. Rows outside
// a live slot (at or past cu[num_seqs]) are written as exact zeros.
//
// Inputs (all device pointers, row-major, contiguous):
//   q            (T, H, D)          bf16 or f32
//   key/value    (NB, BS, KH, D)    same dtype as q, already holding
//                                   this step's new K/V (written first)
//   block_tables (S, MB) int32      -1 pads
//   cu_seqlens   (S+1,) int32       cu[0] == 0
//   context_lens (S,) int32         cache length per slot after the step
//   num_seqs     (1,) int32         live slots; read on the device so a
//                                   CUDA graph can capture the step
//   out          (T, H, D)          q's dtype
//
// Design. The TPU kernel walks a sequential grid (slot, q block, kv
// block) and carries its softmax state in scratch between grid steps;
// Hopper blocks run in parallel in no order, so here one CTA owns one
// (q tile, kv-head) pair and walks the kv pages in a loop instead:
//   * grid.y = kv-head; grid.x enumerates the live q tiles of all slots
//     (tile -> slot found by a scan of cu_seqlens), followed by tiles
//     that zero the padding rows [cu[num_seqs], T). The wrapper sizes
//     grid.x = ceil(T / BQ) + S + 1, which covers both in every case.
//   * a q tile is BQ = 64 / (H / KH) rows x the H / KH query heads that
//     share the CTA's kv-head (64 query vectors), so each K/V page is
//     read from device memory once per CTA, not once per head.
//   * the loop walks cache positions [0, last causal position of the
//     tile] in chunks of 64 (64 / BS pages); -1 table entries are
//     masked. Scores, softmax state (m, l) and probabilities live in
//     shared memory; the output accumulator lives in registers.
//
// What bounds it on the H100: decode rows are one query row per slot,
// so the kernel reads each slot's whole KV once for very little
// arithmetic (4 * H * D flops per cached position against
// 2 * KH * D * 2 bytes): device-memory bytes bound it. Prefill chunks
// carry up to 64 query vectors per page and are bound by arithmetic.
// This first version uses plain f32 FMA arithmetic, no tensor cores, no
// TMA/cp.async double buffering, and one CTA per (slot, kv-head) for a
// decode row, so S x KH CTAs underfill the 132 SMs at small batch.
// wgmma for QK^T and PV, a TMA/mbarrier page pipeline and split-KV
// (flash-decoding) are the planned redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQV = 64;    // query vectors (rows x heads) per CTA
constexpr int kKC = 64;       // cache positions per loop iteration
constexpr int kMaxD = 128;
constexpr int kAccPerThread = kMaxQV * kMaxD / kThreads;   // 32

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* kc;
  const void* vc;
  const int* bt;
  const int* cu;
  const int* ctx;
  const int* ns;
  void* out;
  int T, H, KH, D, NB, BS, S, MB;
  int rep;   // H / KH
  int BQ;    // q rows per tile: kMaxQV / rep
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ragged_paged_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int Dp = D + 1;   // padded row stride: conflict-free column reads
  float* Qs = smem;                       // [kMaxQV][Dp]
  float* Ks = Qs + kMaxQV * Dp;           // [kKC][Dp]
  float* Vs = Ks + kKC * Dp;              // [kKC][D]
  float* Ps = Vs + kKC * D;               // [kMaxQV][kKC] scores -> probs
  float* m_s = Ps + kMaxQV * kKC;         // running max per query vector
  float* l_s = m_s + kMaxQV;              // running sum
  float* a_s = l_s + kMaxQV;              // this chunk's rescale factor
  int* pg_s = reinterpret_cast<int*>(a_s + kMaxQV);   // chunk's pages

  const int tid = threadIdx.x;
  const int g = blockIdx.y;               // kv-head
  const int tile = blockIdx.x;
  const int rep = p.rep;
  const int BQ = p.BQ;
  const T* q = static_cast<const T*>(p.q);
  const T* kc = static_cast<const T*>(p.kc);
  const T* vc = static_cast<const T*>(p.vc);
  T* out = static_cast<T*>(p.out);

  const int ns = min(max(p.ns[0], 0), p.S);
  const int cu_ns = min(max(p.cu[ns], 0), p.T);

  // which live (slot, q tile) this CTA owns, if any
  int slot = -1, qb = 0, live_tiles = 0;
  for (int i = 0; i < ns; ++i) {
    const int nq = max(p.cu[i + 1] - p.cu[i], 0);
    const int nt = (nq + BQ - 1) / BQ;
    if (tile < live_tiles + nt) {
      slot = i;
      qb = tile - live_tiles;
      break;
    }
    live_tiles += nt;
  }

  if (slot < 0) {
    // padding tile: zero rows [cu_ns + k * BQ, + BQ) for this kv-head's
    // query heads (out is allocated uninitialised by the wrapper)
    const int r0 = cu_ns + (tile - live_tiles) * BQ;
    const int r1 = min(r0 + BQ, p.T);
    const int n = (r1 - r0) * rep * D;
    for (int e = tid; e < n; e += kThreads) {
      const int d = e % D;
      const int hh = (e / D) % rep;
      const int r = r0 + e / (D * rep);
      out[((size_t)r * p.H + g * rep + hh) * D + d] = from_f<T>(0.f);
    }
    return;
  }

  const int cu_i = p.cu[slot];
  const int nq = p.cu[slot + 1] - cu_i;
  const int ctx = p.ctx[slot];
  const int row0 = qb * BQ;               // slot-local index of row 0
  const int nrows = min(min(BQ, nq - row0), p.T - (cu_i + row0));
  const int nqv = nrows * rep;            // query vector qv = r * rep + hh
  const int first_pos = ctx - nq + row0;  // absolute position of row 0
  const int kv_end = first_pos + nrows;   // causal bound: cols < kv_end

  for (int e = tid; e < nqv * D; e += kThreads) {
    const int qv = e / D, d = e % D;
    const int r = qv / rep, hh = qv % rep;
    Qs[qv * Dp + d] =
        to_f<T>(q[((size_t)(cu_i + row0 + r) * p.H + g * rep + hh) * D + d]);
  }
  if (tid < kMaxQV) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;

  const int* bt = p.bt + (size_t)slot * p.MB;
  const int warp = tid / 32, lane = tid % 32;

  for (int c0 = 0; c0 < kv_end; c0 += kKC) {
    const int ncols = min(kKC, kv_end - c0);
    const int npg = (ncols + p.BS - 1) / p.BS;
    __syncthreads();   // the previous chunk is done with Ks, Vs, Ps
    if (tid < npg) {
      const int j = c0 / p.BS + tid;
      const int b = j < p.MB ? bt[j] : -1;
      pg_s[tid] = (b >= 0 && b < p.NB) ? b : -1;
    }
    __syncthreads();
    for (int e = tid; e < ncols * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int b = pg_s[c / p.BS];
      float kx = 0.f, vx = 0.f;
      if (b >= 0) {
        const size_t off =
            (((size_t)b * p.BS + (c % p.BS)) * p.KH + g) * D + d;
        kx = to_f<T>(kc[off]);
        vx = to_f<T>(vc[off]);
      }
      Ks[c * Dp + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    // scores, masked to col <= qpos and to pages that exist
    for (int e = tid; e < nqv * kKC; e += kThreads) {
      const int qv = e / kKC, c = e % kKC;
      const int col = c0 + c;
      float s = -INFINITY;
      if (c < ncols && col <= first_pos + qv / rep && pg_s[c / p.BS] >= 0) {
        const float* qr = Qs + qv * Dp;
        const float* kr = Ks + c * Dp;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s = a * p.scale;
      }
      Ps[e] = s;
    }
    __syncthreads();

    // online softmax: one warp per query vector, two columns per lane
    for (int qv = warp; qv < nqv; qv += kWarps) {
      float* pr = Ps + qv * kKC;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = m_s[qv];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
        alpha = expf(m_old - m_new);
      }
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        m_s[qv] = m_new;
        l_s[qv] = alpha * l_s[qv] + sum;
        a_s[qv] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; each thread owns fixed (qv, d) outputs
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int o = tid + j * kThreads;
      if (o < nqv * D) {
        const int qv = o / D, d = o % D;
        const float* pr = Ps + qv * kKC;
        float a = acc[j] * a_s[qv];
        for (int c = 0; c < ncols; ++c) a = fmaf(pr[c], Vs[c * D + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int o = tid + j * kThreads;
    if (o < nqv * D) {
      const int qv = o / D, d = o % D;
      const float l = l_s[qv];
      const float v = l > 0.f ? acc[j] / l : 0.f;
      const int r = qv / rep, hh = qv % rep;
      out[((size_t)(cu_i + row0 + r) * p.H + g * rep + hh) * D + d] =
          from_f<T>(v);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kMaxQV * (D + 1) + (size_t)kKC * (D + 1) +
                          (size_t)kKC * D + (size_t)kMaxQV * kKC +
                          3 * (size_t)kMaxQV) +
         sizeof(int) * kKC;
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_paged_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + p.BQ - 1) / p.BQ + p.S + 1, p.KH);
  ragged_paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
// The caller checks shapes: H % KH == 0, H / KH <= 64, D <= 128,
// 64 % BS == 0, every pointer on one device and contiguous.
extern "C" int ragged_paged_attention_fwd(
    const void* q, const void* key_cache, const void* value_cache,
    const void* block_tables, const void* cu_seqlens,
    const void* context_lens, const void* num_seqs, void* out, int T, int H,
    int KH, int D, int NB, int BS, int S, int MB, float scale, int dtype,
    void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kMaxQV || D <= 0 || D > kMaxD ||
      BS <= 0 || kKC % BS != 0 || T <= 0 || S <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kc = key_cache;
  p.vc = value_cache;
  p.bt = static_cast<const int*>(block_tables);
  p.cu = static_cast<const int*>(cu_seqlens);
  p.ctx = static_cast<const int*>(context_lens);
  p.ns = static_cast<const int*>(num_seqs);
  p.out = out;
  p.T = T;
  p.H = H;
  p.KH = KH;
  p.D = D;
  p.NB = NB;
  p.BS = BS;
  p.S = S;
  p.MB = MB;
  p.rep = H / KH;
  p.BQ = kMaxQV / p.rep;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one CTA takes at head dim D (ptxas reports only
// static shared memory).
extern "C" size_t ragged_paged_attention_smem_bytes(int D) {
  return smem_bytes(D);
}

extern "C" const char* ragged_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
