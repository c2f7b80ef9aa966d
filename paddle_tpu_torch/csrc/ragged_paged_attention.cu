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
//   host key/value (NHB, BS, KH, D) optional second pool (the device
//                                   mirror of a tiered engine's host tier):
//                                   a table entry e with NB <= e < NB + NHB
//                                   names its page e - NB; null, NHB = 0
//                                   without one
//   block_tables (S, MB) int32      -1 pads
//   cu_seqlens   (S+1,) int32       cu[0] == 0
//   context_lens (S,) int32         cache length per slot after the step
//   num_seqs     (1,) int32         live slots; read on the device so a
//                                   CUDA graph can capture the step
//   out          (T, H, D)          q's dtype
//   o_part       (nsplit, T, H, D)  f32 scratch, bf16 with nsplit > 1 only
//   ml_part      (nsplit, T, H, 2)  f32 scratch, the same
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
//     read from device memory once per CTA, not once per head, and a
//     decode row still fills the 64 rows of a wgmma.
//   * the loop walks cache positions [0, last causal position of the
//     tile] in chunks of 64 (64 / BS pages); -1 table entries, and
//     entries at or past NB + NHB, are masked. An entry below NB reads
//     the cache, one in [NB, NB + NHB) the second pool: the base pointer
//     is chosen per page, so nothing but the page's reads changes.
//
// What bounds it on the H100: decode rows are one query row per slot,
// so the kernel reads each slot's whole KV once for very little
// arithmetic (4 * H * D flops per cached position against
// 2 * KH * D * 2 bytes): device-memory bytes bound it. Prefill chunks
// carry up to 64 query vectors per page and are bound by operations.
// Two designs, chosen by dtype (a stated route, not a fallback):
//
// bf16: tensor cores (`ragged_attention_tc_kernel`). One consumer
// warpgroup and two producer warps per CTA. The producers gather each
// chunk's K and V rows page by page with 16-byte cp.async copies into
// the swizzled tile layout wgmma reads (hopper.cuh), zero-filling
// positions past the chunk's bound and pages that are -1, and hand
// chunks over through a two-stage mbarrier ring, so the next chunk's
// copies overlap this chunk's math. Issuing the copies is what a chunk
// waits on: one producer warp measured slower than two in every batch,
// and four (which must cap the consumer's registers to keep two CTAs an
// SM) no faster. Two stages keep the CTA at 83 KB of shared memory at
// D = 128, two CTAs an SM; four stages (one CTA an SM) measured slower
// in both regimes. (A TMA box per
// page would need each page to start on a 128-byte boundary of the tile,
// which small block sizes at small head dims do not give, and would load
// positions past the bound, which may hold anything; zero-filled rows
// keep 0 * V finite in P V.)
// S = Q K^T is a wgmma from shared memory; the online softmax runs in f32
// registers on the accumulator fragment, as in the flash forward; P is
// rounded to bf16 in registers (as the TPU kernel rounds it) and is the A
// operand of O += P V, V read MN-major. Decode batches give too few
// (q tile, kv-head) CTAs to fill 132 SMs, so the wrapper cuts each slot's
// cache range into splits of a fixed length (flash-decoding), chosen from
// shapes the host knows (T, S, KH, MB x BS, the SM count); grid.z is the
// split. With more than one split a CTA writes its unnormalised O and its
// (m, l) to f32 scratch and `ragged_combine_kernel` merges the splits of
// each row; a CTA whose split starts past its tile's causal bound exits.
// With one split the CTA writes the output itself. num_seqs and the index
// arrays are read on the device only.
//
// f32: plain f32 FMAs (`ragged_paged_attention_kernel`); the tensor cores
// would take f32 as TF32 and lose the 1e-4 card-vs-CPU parity. Scores,
// softmax state and probabilities live in shared memory, the output
// accumulator in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQV = 64;    // query vectors (rows x heads) per CTA
constexpr int kKC = 64;       // cache positions per loop iteration
constexpr int kMaxD = 128;
constexpr int kAccPerThread = kMaxQV * kMaxD / kThreads;   // 32

struct Params {
  const void* q;
  const void* kc;
  const void* vc;
  const void* hkc;  // second pool (NHB pages) or null
  const void* hvc;
  const int* bt;
  const int* cu;
  const int* ctx;
  const int* ns;
  void* out;
  float* o_part;    // tensor cores, nsplit > 1: (nsplit, T, H, D)
  float* ml_part;   // (nsplit, T, H, 2): running max (log2 units), sum
  int T, H, KH, D, NB, NHB, BS, S, MB;
  int rep;      // H / KH
  int BQ;       // q rows per tile: kMaxQV / rep
  int split;    // cache positions per split (a multiple of kKC)
  int nsplit;
  float scale;
};

// The live q tile a CTA owns: its slot (-1 for a padding tile) and the
// tile's rows. Every row of slot i sits at position ctx[i] - nq + local.
struct TileRows {
  int slot, cu_i, row0, nrows, first_pos, kv_end;
  int pad_row0;   // padding tile: its first row
};

__device__ __forceinline__ TileRows find_tile(const Params& p, int tile) {
  TileRows r = {-1, 0, 0, 0, 0, 0, 0};
  const int ns = min(max(p.ns[0], 0), p.S);
  int live_tiles = 0;
  for (int i = 0; i < ns; ++i) {
    const int nq = max(p.cu[i + 1] - p.cu[i], 0);
    const int nt = (nq + p.BQ - 1) / p.BQ;
    if (tile < live_tiles + nt) {
      const int qb = tile - live_tiles;
      r.slot = i;
      r.cu_i = p.cu[i];
      r.row0 = qb * p.BQ;               // slot-local index of row 0
      r.nrows = min(min(p.BQ, nq - r.row0), p.T - (r.cu_i + r.row0));
      r.first_pos = p.ctx[i] - nq + r.row0;
      r.kv_end = r.first_pos + r.nrows;   // causal bound: cols < kv_end
      return r;
    }
    live_tiles += nt;
  }
  r.pad_row0 = min(max(p.cu[ns], 0), p.T) + (tile - live_tiles) * p.BQ;
  return r;
}

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
  const int rep = p.rep;
  const float* q = static_cast<const float*>(p.q);
  const float* kc = static_cast<const float*>(p.kc);
  const float* vc = static_cast<const float*>(p.vc);
  const float* hkc = static_cast<const float*>(p.hkc);
  const float* hvc = static_cast<const float*>(p.hvc);
  float* out = static_cast<float*>(p.out);

  const TileRows tr = find_tile(p, blockIdx.x);
  if (tr.slot < 0) {
    // padding tile: zero rows [pad_row0, + BQ) for this kv-head's query
    // heads (out is allocated uninitialised by the wrapper)
    const int r1 = min(tr.pad_row0 + p.BQ, p.T);
    const int n = max(r1 - tr.pad_row0, 0) * rep * D;
    for (int e = tid; e < n; e += kThreads) {
      const int d = e % D;
      const int hh = (e / D) % rep;
      const int r = tr.pad_row0 + e / (D * rep);
      out[((size_t)r * p.H + g * rep + hh) * D + d] = 0.f;
    }
    return;
  }

  const int slot = tr.slot, cu_i = tr.cu_i, row0 = tr.row0;
  const int nqv = tr.nrows * rep;         // query vector qv = r * rep + hh
  const int first_pos = tr.first_pos;     // absolute position of row 0
  const int kv_end = tr.kv_end;           // causal bound: cols < kv_end

  for (int e = tid; e < nqv * D; e += kThreads) {
    const int qv = e / D, d = e % D;
    const int r = qv / rep, hh = qv % rep;
    Qs[qv * Dp + d] =
        q[((size_t)(cu_i + row0 + r) * p.H + g * rep + hh) * D + d];
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
      pg_s[tid] = (b >= 0 && b < p.NB + p.NHB) ? b : -1;
    }
    __syncthreads();
    for (int e = tid; e < ncols * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int b = pg_s[c / p.BS];
      float kx = 0.f, vx = 0.f;
      if (b >= 0) {
        const bool dev = b < p.NB;
        const size_t off =
            (((size_t)(dev ? b : b - p.NB) * p.BS + (c % p.BS)) * p.KH +
             g) * D + d;
        kx = dev ? kc[off] : hkc[off];
        vx = dev ? vc[off] : hvc[off];
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
      out[((size_t)(cu_i + row0 + r) * p.H + g * rep + hh) * D + d] = v;
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kMaxQV * (D + 1) + (size_t)kKC * (D + 1) +
                          (size_t)kKC * D + (size_t)kMaxQV * kKC +
                          3 * (size_t)kMaxQV) +
         sizeof(int) * kKC;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kProducerWarps = 2;      // gather the K/V chunks
constexpr int kTcThreads = 128 + 32 * kProducerWarps;
constexpr int kStages = 2;             // chunks in the ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  using T = hopper::Tile<D>;
  // 1 KB of alignment slack, Q, the K and V stages, the mbarriers and
  // the column masks
  return 1024 + T::bytes(kMaxQV) + 2 * kStages * T::bytes(kKC) +
         24 * kStages;
}

// cache position `pos` of `slot`: its row at kv-head g in the two pools
// laid end to end (rows of the (NB, BS, KH, D) cache, then those of the
// (NHB, BS, KH, D) second pool), or -1 when the position is past `cend`,
// past the block table or on a page that is -1 (or out of range)
__device__ __forceinline__ int cache_row(const Params& p, int slot, int pos,
                                         int cend, int g) {
  const int j = pos / p.BS;
  if (pos >= cend || j >= p.MB) return -1;
  const int b = p.bt[(size_t)slot * p.MB + j];
  if (b < 0 || b >= p.NB + p.NHB) return -1;
  return (b * p.BS + pos % p.BS) * p.KH + g;
}

// grid (live q tiles + padding tiles, KH, nsplit)
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    ragged_attention_tc_kernel(Params p) {
  using T = hopper::Tile<D>;
  using namespace hopper;
  constexpr int KC = kKC, QV = kMaxQV;
  const int g = blockIdx.y, z = blockIdx.z, rep = p.rep;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);

  const TileRows tr = find_tile(p, blockIdx.x);
  if (tr.slot < 0) {
    // padding tile: zero rows [pad_row0, + BQ) for this kv-head's query
    // heads; with splits the combine kernel writes every row instead
    if (p.nsplit > 1 || z > 0) return;
    const int r1 = min(tr.pad_row0 + p.BQ, p.T);
    const int n = max(r1 - tr.pad_row0, 0) * rep * (D / 2);
    for (int e = threadIdx.x; e < n; e += kTcThreads) {
      const int d2 = e % (D / 2), hh = (e / (D / 2)) % rep;
      const int r = tr.pad_row0 + e / ((D / 2) * rep);
      reinterpret_cast<uint32_t*>(
          out + ((size_t)r * p.H + g * rep + hh) * D)[d2] = 0u;
    }
    return;
  }
  // this split's cache positions; split 0 always runs, so that a tile
  // that sees no position still writes its zeros (or empty partials)
  const int cbeg = z * p.split;
  const int cend = min(tr.kv_end, cbeg + p.split);
  if (z > 0 && cbeg >= cend) return;
  const int nch = cend > cbeg ? (cend - cbeg + KC - 1) / KC : 0;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t sQ = smem_u32(sm);
  const uint32_t sK = sQ + T::bytes(QV);              // kStages chunks
  const uint32_t sV = sK + kStages * T::bytes(KC);    // kStages chunks
  const uint32_t bar = sV + kStages * T::bytes(KC);   // full[], empty[]
  auto full = [&](int st) { return bar + 8 * st; };
  auto empty = [&](int st) { return bar + 8 * kStages + 8 * st; };
  // per stage: which of the chunk's 64 columns hold a cache position
  // (bit c of mask[2 st] | mask[2 st + 1] << 32), written by the producer
  uint32_t* mask = reinterpret_cast<uint32_t*>(
      sm + T::bytes(QV) + 2 * kStages * T::bytes(KC) + 16 * kStages);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 32 * kProducerWarps);   // the producer lanes
      mbar_init(empty(st), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {   // producer warps
    // Gather chunk it into stage it % kStages: in each warp lane l looks
    // up the cache rows of columns l and l + 32 (two block-table reads,
    // issued together), then the warps copy 16 bytes a lane, lanes along a
    // row, each taking every kProducerWarps-th pass of 32 pieces, each
    // copy's row taken from its owner lane by a shuffle. Each chunk
    // is one cp.async group, and kStages - 1 of them stay in flight: once
    // the oldest has landed, each lane makes its copies visible to wgmma
    // (the async proxy) and arrives.
    const int lane = threadIdx.x % 32, pw = threadIdx.x / 32 - 4;
    const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(p.kc);
    const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(p.vc);
    const __nv_bfloat16* hkc = static_cast<const __nv_bfloat16*>(p.hkc);
    const __nv_bfloat16* hvc = static_cast<const __nv_bfloat16*>(p.hvc);
    const int dev_rows = p.NB * p.BS * p.KH;   // rows of the first pool
    for (int it = 0; it < nch; ++it) {
      const int st = it % kStages, c0 = cbeg + it * KC;
      const int ra = cache_row(p, tr.slot, c0 + lane, cend, g);
      const int rb = cache_row(p, tr.slot, c0 + 32 + lane, cend, g);
      const uint32_t va = __ballot_sync(0xffffffffu, ra >= 0);
      const uint32_t vb = __ballot_sync(0xffffffffu, rb >= 0);
      if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
      if (pw == 0 && lane == 0) {
        mask[2 * st] = va;
        mask[2 * st + 1] = vb;
      }
      // a pass over 32 pieces covers whole rows, all below 32 or not
#pragma unroll 4
      for (int e = 32 * pw + lane; e < KC * T::CHUNKS;
           e += 32 * kProducerWarps) {
        const int r = e / T::CHUNKS, c = e % T::CHUNKS;
        const int row = __shfl_sync(
            0xffffffffu, (e - lane) / T::CHUNKS < 32 ? ra : rb, r % 32);
        const bool dev = row < dev_rows;
        const size_t src =
            row < 0 ? 0 : (size_t)(dev ? row : row - dev_rows) * D + 8 * c;
        const uint32_t o = st * T::bytes(KC) + T::offset(KC, r, c);
        cp_async_16(sK + o, (dev ? kc : hkc) + src, row >= 0);
        cp_async_16(sV + o, (dev ? vc : hvc) + src, row >= 0);
      }
      cp_async_commit();
      if (it >= kStages - 1) {   // chunk it - kStages + 1 has landed
        cp_async_wait<kStages - 1>();
        fence_proxy_async();
        mbar_arrive(full((it - kStages + 1) % kStages));
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int it = max(nch - kStages + 1, 0); it < nch; ++it)
      mbar_arrive(full(it % kStages));
    return;
  }

  // consumer warpgroup: query vectors qv = r * rep + hh (tile row r, head
  // g * rep + hh); this thread's are qa and qa + 8, key columns
  // 8 i + 2 t (+1) of each chunk
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int nqv = tr.nrows * rep;
  const int qa = 16 * w + gq;
  {
    // Q tile: 64 query vectors, zeros past nqv
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    for (int e = tid; e < QV * T::CHUNKS; e += 128) {
      const int qv = e / T::CHUNKS, c = e % T::CHUNKS;
      const bool ok = qv < nqv;
      const size_t src =
          ok ? ((size_t)(tr.cu_i + tr.row0 + qv / rep) * p.H + g * rep +
                qv % rep) * D + 8 * c
             : 0;
      cp_async_16(sQ + T::offset(QV, qv, c), q + src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    named_barrier(1, 128);
  }
  int qpos[2];   // absolute position of each of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qv = qa + 8 * r;
    qpos[r] = qv < nqv ? tr.first_pos + qv / rep : -1;   // -1: sees none
  }
  const float sl2 = p.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // log2 domain

  for (int it = 0; it < nch; ++it) {
    const int st = it % kStages, c0 = cbeg + it * KC;
    mbar_wait(full(st), (it / kStages) & 1);
    const uint32_t lo = mask[2 * st], hi = mask[2 * st + 1];
    const uint32_t kt = sK + st * T::bytes(KC), vt = sV + st * T::bytes(KC);
    float s[KC / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<KC>(s, desc_kmajor<D>(sQ, QV, 0, kk),
                   desc_kmajor<D>(kt, KC, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * i + 2 * t + (e & 1);
        const bool has = ((c < 32 ? lo >> c : hi >> (c - 32)) & 1u) != 0;
        if (!has || c0 + c > qpos[e >> 1]) s[4 * i + e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
      }
    float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * sl2);
      alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < KC / 8; ++i)
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

    uint32_t pa[KC / 16][4];
    to_a_operand<KC / 16>(s, pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KC / 16; ++j)
      wgmma_rs<D>(o, pa[j], desc_mnmajor<D>(vt, KC, j));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    if (tid == 0) mbar_arrive(empty(st));
  }

  // this thread's rows -> out (one split) or the split's partials
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qv = qa + 8 * r;
    if (qv >= nqv) continue;
    const size_t row =
        (size_t)(tr.cu_i + tr.row0 + qv / rep) * p.H + g * rep + qv % rep;
    if (p.nsplit == 1) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + row * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        dst[4 * i + t] =
            pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    } else {
      const size_t prow = (size_t)z * p.T * p.H + row;
      float2* dst = reinterpret_cast<float2*>(p.o_part + prow * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        dst[4 * i + t] = make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
      if (t == 0)
        reinterpret_cast<float2*>(p.ml_part)[prow] = make_float2(m[r], l[r]);
    }
  }
}

// With splits: out[t, h] = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s
// over the splits s that hold row t's positions; rows outside a live slot
// are zero. One warp per (row, head).
template <int D>
__global__ void __launch_bounds__(128) ragged_combine_kernel(Params p) {
  const int wid = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= p.T * p.H) return;
  const int t = wid / p.H;
  const int ns = min(max(p.ns[0], 0), p.S);
  int n = 0;   // splits that hold this row's positions
  for (int i = 0; i < ns; ++i) {
    if (t < p.cu[i + 1]) {
      if (t >= p.cu[i]) {
        const int pos = p.ctx[i] - (p.cu[i + 1] - p.cu[i]) + (t - p.cu[i]);
        n = pos >= 0 ? min(pos / p.split + 1, p.nsplit) : 0;
      }
      break;
    }
  }
  const size_t plane = (size_t)p.T * p.H;
  const float2* ml = reinterpret_cast<const float2*>(p.ml_part);
  float mx = -INFINITY;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[s * plane + wid].x);
  constexpr int E = (D + 31) / 32;
  float acc[E], den = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float2 st = ml[s * plane + wid];
    const float wgt = st.x == -INFINITY ? 0.f : exp2f(st.x - mx);
    den += wgt * st.y;
    const float* src = p.o_part + (s * plane + wid) * D;
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (lane + 32 * k < D) acc[k] += wgt * src[lane + 32 * k];
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + (size_t)wid * D;
#pragma unroll
  for (int k = 0; k < E; ++k)
    if (lane + 32 * k < D) dst[lane + 32 * k] = __float2bfloat16(acc[k] * inv);
}

// successful launches by route: 0 the f32-FMA kernel, 1 the tensor-core
// kernel, 2 the combine kernel
long long route_launches[3] = {};

int launch_fma(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_paged_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + p.BQ - 1) / p.BQ + p.S + 1, p.KH);
  ragged_paged_attention_kernel<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++route_launches[0];
  return (int)err;
}

template <int D>
int launch_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      ragged_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + p.BQ - 1) / p.BQ + p.S + 1, p.KH, p.nsplit);
  ragged_attention_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++route_launches[1];
  if (p.nsplit == 1) return 0;
  const int warps = p.T * p.H;
  ragged_combine_kernel<D><<<(warps + 3) / 4, 128, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++route_launches[2];
  return (int)err;
}

int launch_tc_d(const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 16: return launch_tc<16>(p, stream);
    case 32: return launch_tc<32>(p, stream);
    case 64: return launch_tc<64>(p, stream);
    case 128: return launch_tc<128>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// host_key/host_value: the second pool of NHB pages (null with NHB = 0).
// dtype: 0 = float32 (any D <= 128, the FMA kernel), 1 = bfloat16 (D in
// {16, 32, 64, 128}, the tensor cores; `split` cache positions per split,
// a multiple of 64, and `nsplit` splits covering MB * BS; with nsplit > 1
// the f32 scratch o_part and ml_part). Returns a cudaError_t (0 =
// success). The caller checks shapes: H % KH == 0, H / KH <= 64,
// 64 % BS == 0, every pointer on one device, contiguous, 16-byte aligned.
extern "C" int ragged_paged_attention_fwd(
    const void* q, const void* key_cache, const void* value_cache,
    const void* host_key, const void* host_value, const void* block_tables, const void* cu_seqlens,
    const void* context_lens, const void* num_seqs, void* out,
    float* o_part, float* ml_part, int T, int H, int KH, int D, int NB,
    int NHB, int BS, int S, int MB, int split, int nsplit, float scale, int dtype,
    void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kMaxQV || D <= 0 || D > kMaxD ||
      BS <= 0 || kKC % BS != 0 || T <= 0 || S <= 0 || MB <= 0 ||
      NHB < 0 || (NHB > 0 && (host_key == nullptr || host_value == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kc = key_cache;
  p.vc = value_cache;
  p.hkc = host_key;
  p.hvc = host_value;
  p.bt = static_cast<const int*>(block_tables);
  p.cu = static_cast<const int*>(cu_seqlens);
  p.ctx = static_cast<const int*>(context_lens);
  p.ns = static_cast<const int*>(num_seqs);
  p.out = out;
  p.o_part = o_part;
  p.ml_part = ml_part;
  p.T = T;
  p.H = H;
  p.KH = KH;
  p.D = D;
  p.NB = NB;
  p.NHB = NHB;
  p.BS = BS;
  p.S = S;
  p.MB = MB;
  p.rep = H / KH;
  p.BQ = kMaxQV / p.rep;
  p.split = split;
  p.nsplit = nsplit;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fma(p, s);
  if (dtype != 1 || split <= 0 || split % kKC != 0 || nsplit <= 0 ||
      nsplit > 65535 || (long long)split * nsplit < (long long)MB * BS ||
      (nsplit > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  return launch_tc_d(p, s);
}

// Dynamic shared memory one CTA takes at head dim D for `dtype` (ptxas
// reports only static shared memory).
extern "C" size_t ragged_paged_attention_smem_bytes(int D, int dtype) {
  if (dtype == 0) return smem_bytes(D);
  switch (D) {
    case 16: return tc_smem_bytes<16>();
    case 32: return tc_smem_bytes<32>();
    case 64: return tc_smem_bytes<64>();
    case 128: return tc_smem_bytes<128>();
  }
  return 0;
}

// Successful launches so far by route: 0 the f32-FMA kernel, 1 the
// tensor-core kernel, 2 the combine kernel that merges splits.
extern "C" long long ragged_paged_attention_route_launches(int route) {
  return route >= 0 && route < 3 ? route_launches[route] : -1;
}

extern "C" const char* ragged_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
