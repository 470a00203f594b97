// Paged decode attention on Hopper: one query token per slot, attended
// through the slot's block table straight against the page pool.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:194
// (paged_attention_pallas, body _kernel). That kernel walked a slot's pages
// in order on one core, buffered the whole score row and every V page in
// VMEM and took one exact softmax at the last page. Here a slot's keys are
// split across the CTAs of one thread-block cluster instead.
//
// Layout (the JAX kernel's): q (C, KV, G, D); k_pages, v_pages
// (P, block, KV, D) with page P - 1 the trash page; tables (C, MB) int32
// with -1 = unallocated, redirected to the trash page like
// cache_ops._safe_tables; q_positions (C,) int32. Output (C, KV, G, D) in
// q's dtype. f32 and bf16 operands; all arithmetic in fp32.
//
// Design. One cluster of kRanks CTAs per (slot, KV head), one launch per
// call; a CTA holds that head's G query rows. Key tile i (keys 32i ..
// 32i + 31, by absolute position, whatever the page size) belongs to rank
// i mod kRanks, and each key finds its own page in the slot's table row. A
// slot attends keys [first, pos] (pos clamped to the table's row, first
// from the sliding window); its tiles run from first / 32 to pos / 32. Each
// rank walks its own tiles in ascending order through two shared-memory
// stages. A thread loads its 16-byte chunks of the next tile into
// registers one tile ahead (plain vector loads, in flight while the
// current tile is computed) and stores them into the free stage after it;
// the table entries are read two tiles ahead, and a thread's chunk offsets
// are computed once. (cp.async and one-row bulk copies were measured slower
// here; PERF.md section 6.) Rows that are not a multiple of 16 bytes, or pools
// not 16-byte aligned, are copied element by element. The
// ranks then meet through distributed shared memory
// (cooperative_groups::this_cluster):
//
// * float path (paged_decode_kernel): each rank keeps an online softmax
//   (running max m, sum l, output o per query row, fp32) over its tiles; a
//   tile's scores are one lane per key and one warp per query row. After
//   a cluster.sync() the ranks merge the partials, each rank a slice of
//   the (G, D) outputs, always in rank order 0 .. kRanks-1:
//   m = max m_r, l = sum l_r exp(m_r - m), o = sum o_r exp(m_r - m), and
//   write o / l. A rank with no key has m_r = kMasked, l_r = 0 and weight
//   exactly 0.
// * SC path (paged_decode_sc_kernel) follows the reference's SC branch,
//   which quantizes the *normalized* probability row over all of the
//   slot's keys (repro/kernels/paged_attention.py:172-185). Pass 1 over a
//   rank's K tiles quantizes each K row over D and keeps the rank's SC
//   scores (masked keys at kMasked) in shared memory, or in a device
//   workspace for rows longer than kRanks times the wrapper's budget. Four
//   exchanges, each after a cluster.sync(): the row max; the denominator
//   as the ranks' partial sums of exp(s - max) added in rank order; the
//   max of p = un / denom, which gives the probability scale; and, after
//   pass 2 over the rank's V tiles (each V row quantized over D, the SC PV
//   terms summed key by key in position order), the partial (G, D) sums,
//   added in rank order. Scores, planes and PV terms repeat the plain
//   version's float32 operations one for one (sc_attention.cuh).
//
// Logit softcap (softcap > 0; gemma2's attention): a key's scaled score s
// becomes softcap * tanhf(s / softcap) before the causal and window masks,
// on both paths, as the TPU kernel applies it
// (repro/kernels/paged_attention.py:134-135 and :158-159). It is one
// elementwise step on a score and changes no order of summation. The
// build keeps IEEE division and the accurate tanhf (no --use_fast_math,
// so no __tanhf).
//
// Why the result depends only on the slot's own keys: the tiles, their
// owners, every order of summation inside a rank and the merge order are
// functions of the absolute key index, the slot's position and the window
// alone — not of the page size, the table layout, the other slots of the
// batch or C. A dense cache viewed as one page per slot gives the same
// bits as any paging of the same rows, which keeps the sequential baseline
// and the engine token-identical.
//
// Cluster hygiene: a slot that attends nothing returns before any
// cluster.sync(), and the condition depends on the slot alone, so the
// whole cluster takes that return together; every other rank, with tiles
// or without, takes part in every cluster.sync(); each kernel ends with a
// cluster.sync() so no CTA exits while another may read its shared memory.
//
// What bounds it: at long contexts the bytes of K and V (each key's rows
// read once, by one rank); at short contexts (a few hundred keys, a tile or
// two a rank) the latency of one tile's load and of the cluster's
// exchanges. Between the two, a rank's tile costs about one memory latency
// or its compute, whichever is longer.
#include "sc_attention.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using namespace sc_attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // keys per tile; tile i is keys 32i .. 32i + 31
constexpr int kRanks = 8;        // CTAs per cluster: the portable maximum
constexpr int kPrefetch = 8;     // 16-byte chunks a thread holds for the next tile
constexpr int kMaxDevices = 64;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* tables;
  const int* q_positions;
  void* out;
  float* work;          // SC score rows in device memory, or null
  int KV, G, D, block, max_blocks, n_pages;
  int vec;              // rows a multiple of 16 bytes, pools 16-byte aligned
  int share;            // SC: score slots per rank and query row
  int window;           // <= 0: none
  int sc_bits;
  float scale;
  float softcap;        // <= 0: none
};

// Bytes of one K or V row in a stage: 16-byte aligned plus 16, so lanes
// reading 16 bytes of different rows fall on different banks.
__host__ __device__ __forceinline__ int row_stride(int D, int esz) {
  return (D * esz + 15) / 16 * 16 + 16;
}

__host__ __device__ __forceinline__ size_t float_smem_bytes(int esz, int G, int D) {
  return 2 * static_cast<size_t>(2 * kTile) * row_stride(D, esz) +
         sizeof(float) * (2 * static_cast<size_t>(G) * D + kWarps * kTile + 2 * G);
}

__host__ __device__ __forceinline__ size_t sc_smem_bytes(int esz, int G, int D, int share,
                                                         bool scores_in_smem) {
  return 2 * static_cast<size_t>(kTile) * row_stride(D, esz) +
         sizeof(float) * (2 * static_cast<size_t>(G) * D + kTile * (D + 1) + kTile + 5 * G +
                          (scores_in_smem ? static_cast<size_t>(G) * share : 0));
}

// cap * tanh(s / cap), the plain version's softcap, one rounding a step.
__device__ __forceinline__ float capped(float s, float cap) {
  return cap > 0.f ? __fmul_rn(cap, tanhf(__fdiv_rn(s, cap))) : s;
}

// The keys a slot attends and the tiles that hold them.
struct Span {
  int pos, first, tile_lo, tile_hi;
  bool active;
};

__device__ __forceinline__ Span key_span(const Args& a, int c) {
  Span s;
  const int qpos = a.q_positions[c];
  s.pos = min(qpos, a.max_blocks * a.block - 1);   // nothing is stored past the row
  s.first = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
  s.active = qpos >= 0 && s.first <= s.pos;
  s.tile_lo = s.first / kTile;
  s.tile_hi = s.pos / kTile;
  return s;
}

// This rank's tiles: i0, i0 + kRanks, ... up to tile_hi; returns how many.
__device__ __forceinline__ int own_tiles(const Span& s, int rank, int* i0) {
  *i0 = s.tile_lo + ((rank - s.tile_lo) % kRanks + kRanks) % kRanks;
  return *i0 <= s.tile_hi ? (s.tile_hi - *i0) / kRanks + 1 : 0;
}

// The pool row (page * block + offset in the page) of key k0 + lane of a
// tile (lane < 32); 0 past the slot's keys. Rows are read from the table two
// tiles ahead; the copies take a row from its lane by a shuffle.
__device__ __forceinline__ int lane_row(const int* table, int k0, int pos, const Args& a) {
  const int key = k0 + (threadIdx.x & 31);
  if (key > pos) return 0;
  const int j = key / a.block;
  const int page = table[j];
  return (page < 0 ? a.n_pages - 1 : page) * a.block + (key - j * a.block);   // -1: trash page
}

// Where this thread's first kPrefetch 16-byte chunks of a tile lie: chunk k
// (= threadIdx.x + kThreads * k) is chunk e16 / 16 of stage row `row`, that
// is row row % kTile of pool row / kTile (row >= n_pools * kTile: past the
// tile). Fixed for the kernel.
struct Chunks {
  int row[kPrefetch], e16[kPrefetch];
};

__device__ __forceinline__ void chunks_of(Chunks& ch, int per_row) {
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int c = threadIdx.x + kThreads * k;
    ch.row[k] = c / per_row;
    ch.e16[k] = (c - ch.row[k] * per_row) * 16;
  }
}

template <typename T>
__device__ __forceinline__ const unsigned char* row_bytes(const T* pool, int row, int h,
                                                          const Args& a) {
  return reinterpret_cast<const unsigned char*>(
      pool + (static_cast<size_t>(row) * a.KV + h) * a.D);
}

// One tile's chunks on their way: loaded into registers ahead of the tile's
// turn (16-byte rows only), stored into its stage when that comes.
struct Prefetched {
  uint4 v[kPrefetch];
};

// Load this thread's first kPrefetch chunks of a tile's rows t < nt of
// n_pools pools into registers. `row` is this lane's lane_row for the tile.
template <typename T>
__device__ __forceinline__ void fetch(Prefetched& r, const Chunks& ch, const T* pool0,
                                      const T* pool1, int n_pools, int row, int nt, int h,
                                      const Args& a) {
  if (!a.vec) return;
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int t = ch.row[k] & (kTile - 1), p = ch.row[k] / kTile;
    const int rw = __shfl_sync(0xffffffffu, row, t);
    if (p < n_pools && t < nt)
      r.v[k] = __ldg(reinterpret_cast<const uint4*>(
          row_bytes(p == 0 ? pool0 : pool1, rw, h, a) + ch.e16[k]));
  }
}

// Store a tile's rows t < nt into a stage of n_pools * kTile rows of
// `stride` bytes: the chunks fetched into registers, then the rest straight
// from memory (16-byte chunks past kPrefetch a thread, or elements when rows
// are not 16-byte).
template <typename T>
__device__ __forceinline__ void commit(unsigned char* stage, int stride, const Prefetched& r,
                                       const Chunks& ch, const T* pool0, const T* pool1,
                                       int n_pools, int row, int nt, int h, const Args& a) {
  const int lane = threadIdx.x & 31;
  const int per_row = a.vec ? a.D * static_cast<int>(sizeof(T)) / 16 : a.D;
  const int total = n_pools * kTile * per_row;
  int base = threadIdx.x - lane;
  if (a.vec) {
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k)
      if (ch.row[k] < n_pools * kTile && (ch.row[k] & (kTile - 1)) < nt)
        *reinterpret_cast<uint4*>(stage + ch.row[k] * stride + ch.e16[k]) = r.v[k];
    base += kThreads * kPrefetch;
  }
  for (; base < total; base += kThreads) {          // warp-uniform
    const int c = base + lane;
    const int p = c / (kTile * per_row), rem = c - p * kTile * per_row;
    const int t = rem / per_row, e = rem - t * per_row;
    const int rw = __shfl_sync(0xffffffffu, row, t & 31);
    if (c < total && t < nt) {
      const unsigned char* src = row_bytes(p == 0 ? pool0 : pool1, rw, h, a);
      unsigned char* dst = stage + (p * kTile + t) * stride;
      if (a.vec)
        reinterpret_cast<uint4*>(dst)[e] = __ldg(reinterpret_cast<const uint4*>(src) + e);
      else
        reinterpret_cast<T*>(dst)[e] = reinterpret_cast<const T*>(src)[e];
    }
  }
}

// q . k, one fused multiply-add a term in a fixed order: with 16-byte
// reads of the staged row (a row a multiple of 16 bytes) two chains, the
// first and second half of each 16 bytes, added at the end.
__device__ __forceinline__ float dot_row(const float* q, const unsigned char* row, int D,
                                         const float*) {
  const float* r = reinterpret_cast<const float*>(row);
  if (D % 4 != 0) {
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(q[d], r[d], dot);
    return dot;
  }
  float da = 0.f, db = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float4 u = *reinterpret_cast<const float4*>(r + c);
    const float4 x = *reinterpret_cast<const float4*>(q + c);
    da = fmaf(x.x, u.x, da);
    da = fmaf(x.y, u.y, da);
    db = fmaf(x.z, u.z, db);
    db = fmaf(x.w, u.w, db);
  }
  return da + db;
}

__device__ __forceinline__ float dot_row(const float* q, const unsigned char* row, int D,
                                         const __nv_bfloat16*) {
  const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(row);
  if (D % 8 != 0) {
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(q[d], __bfloat162float(r[d]), dot);
    return dot;
  }
  float da = 0.f, db = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(r + c);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 f0 = __bfloat1622float2(b[0]), f1 = __bfloat1622float2(b[1]);
    const float2 f2 = __bfloat1622float2(b[2]), f3 = __bfloat1622float2(b[3]);
    const float4 x0 = *reinterpret_cast<const float4*>(q + c);
    const float4 x1 = *reinterpret_cast<const float4*>(q + c + 4);
    da = fmaf(x0.x, f0.x, da);
    da = fmaf(x0.y, f0.y, da);
    da = fmaf(x0.z, f1.x, da);
    da = fmaf(x0.w, f1.y, da);
    db = fmaf(x1.x, f2.x, db);
    db = fmaf(x1.y, f2.y, db);
    db = fmaf(x1.z, f3.x, db);
    db = fmaf(x1.w, f3.y, db);
  }
  return da + db;
}

template <typename T>
__device__ __forceinline__ float staged(const unsigned char* row, int d) {
  return to_f(reinterpret_cast<const T*>(row)[d]);
}

// Elements 2 * d2 and 2 * d2 + 1 of a staged row.
__device__ __forceinline__ float2 staged2(const unsigned char* row, int d2, const float*) {
  return reinterpret_cast<const float2*>(row)[d2];
}
__device__ __forceinline__ float2 staged2(const unsigned char* row, int d2,
                                          const __nv_bfloat16*) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[d2]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, D = a.D;
  const size_t qbase = (static_cast<size_t>(c) * a.KV + h) * G * D;
  T* out = static_cast<T*>(a.out) + qbase;
  const Span sp = key_span(a, c);
  if (!sp.active) {                  // the slot alone decides: the whole cluster returns
    for (int i = rank * kThreads + tid; i < G * D; i += kRanks * kThreads)
      out[i] = from_f<T>(0.f);
    return;
  }

  const int stride = row_stride(D, sizeof(T));
  const int stage_bytes = 2 * kTile * stride;          // K rows, then V rows
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + 2 * static_cast<size_t>(stage_bytes));
  float* o_s = q_s + G * D;          // G * D  running output
  float* p_s = o_s + G * D;          // kWarps * kTile  a warp's probabilities
  float* m_s = p_s + kWarps * kTile; // G  running max
  float* l_s = m_s + G;              // G  running sum

  int i0;
  const int n = own_tiles(sp, rank, &i0);
  const int* table = a.tables + static_cast<size_t>(c) * a.max_blocks;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  auto k0_of = [&](int j) { return (i0 + j * kRanks) * kTile; };
  auto nt_of = [&](int j) { return min(kTile, sp.pos + 1 - k0_of(j)); };
  auto row_of = [&](int j) { return j < n ? lane_row(table, k0_of(j), sp.pos, a) : 0; };
  // While tile j is computed, tile j + 1 is on its way in registers; the
  // lanes' rows of the tile to store, the tile to fetch and the one after
  // are kept ahead, the last still loading.
  Chunks ch;
  chunks_of(ch, max(1, D * static_cast<int>(sizeof(T)) / 16));
  Prefetched pre;
  auto fetch_tile = [&](int j, int row) {
    if (j < n) fetch<T>(pre, ch, kp, vp, 2, row, nt_of(j), h, a);
  };
  auto commit_tile = [&](int j, int row) {
    commit<T>(smem + static_cast<size_t>(j & 1) * stage_bytes, stride, pre, ch, kp, vp, 2, row,
              nt_of(j), h, a);
  };
  int row1 = row_of(0), row2 = row_of(1), row3 = row_of(2);
  fetch_tile(0, row1);
  const T* qg = static_cast<const T*>(a.q) + qbase;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(qg[i]);
    o_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kMasked;
    l_s[g] = 0.f;
  }
  if (n > 0) commit_tile(0, row1);
  fetch_tile(1, row2);
  row1 = row2;
  row2 = row3;
  row3 = row_of(3);

  for (int j = 0; j < n; ++j) {
    __syncthreads();                 // tile j is stored; every warp is done with tile j - 1
    const int k0 = k0_of(j);
    const int nt = nt_of(j);
    const unsigned char* kt = smem + static_cast<size_t>(j & 1) * stage_bytes;
    const unsigned char* vt = kt + kTile * stride;
    float* pw = p_s + warp * kTile;
    for (int g = warp; g < G; g += kWarps) {
      const int key = k0 + lane;
      float s = kMasked;
      if (lane < nt && key >= sp.first)
        s = capped(dot_row(q_s + g * D, kt + lane * stride, D, static_cast<const T*>(nullptr)) *
                       a.scale,
                   a.softcap);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = s <= kMasked ? 0.f : expf(s - m_new);   // masked: exactly 0
      const float alpha = expf(m_old - m_new);
      const float l_new = fmaf(l_s[g], alpha, warp_sum(p));
      pw[lane] = p;
      __syncwarp();
      // P V over the tile's keys in order, each d its own chain; a lane
      // takes d pairs when D is even (the same operations per d)
      float* o = o_s + g * D;
      if (D % 2 == 0) {
        for (int d2 = lane; d2 < D / 2; d2 += 32) {
          float pv0 = 0.f, pv1 = 0.f;
#pragma unroll 4
          for (int t = 0; t < nt; ++t) {
            const float2 v = staged2(vt + t * stride, d2, static_cast<const T*>(nullptr));
            pv0 = fmaf(pw[t], v.x, pv0);
            pv1 = fmaf(pw[t], v.y, pv1);
          }
          o[2 * d2] = fmaf(o[2 * d2], alpha, pv0);
          o[2 * d2 + 1] = fmaf(o[2 * d2 + 1], alpha, pv1);
        }
      } else {
        for (int d = lane; d < D; d += 32) {
          float pv = 0.f;
          for (int t = 0; t < nt; ++t) pv = fmaf(pw[t], staged<T>(vt + t * stride, d), pv);
          o[d] = fmaf(o[d], alpha, pv);
        }
      }
      __syncwarp();                  // pw and m_s[g] are read before they change
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_new;
      }
      __syncwarp();
    }
    if (j + 1 < n) {                 // into the stage tile j - 1 used
      commit_tile(j + 1, row1);
      fetch_tile(j + 2, row2);
      row1 = row2;
      row2 = row3;
      row3 = row_of(j + 4);
    }
  }

  cluster.sync();                    // every rank's (m, l, o) is final
  for (int i = rank * kThreads + tid; i < G * D; i += kRanks * kThreads) {
    const int g = i / D;
    float m = kMasked;
    for (int r = 0; r < kRanks; ++r) m = fmaxf(m, *cluster.map_shared_rank(m_s + g, r));
    float l = 0.f, o = 0.f;
    for (int r = 0; r < kRanks; ++r) {
      const float w = expf(*cluster.map_shared_rank(m_s + g, r) - m);
      l = fmaf(*cluster.map_shared_rank(l_s + g, r), w, l);
      o = fmaf(*cluster.map_shared_rank(o_s + i, r), w, o);
    }
    out[i] = from_f<T>(l > 0.f ? o / l : 0.f);
  }
  cluster.sync();                    // no CTA leaves while its partials may be read
}

// Quantize the staged rows t < nt of a tile over D into signed magnitudes
// (kTile rows of DP floats at kq) and their scales: 8 lanes a row, four
// rows a warp at a time. The same float32 operations as quant_row_warp;
// the absmax is a max, exact in any order.
template <typename T>
__device__ __forceinline__ void quant_tile(const unsigned char* st, int stride, int nt,
                                           float* kq, float* scales, int D, int DP,
                                           int n_max) {
  const int lane = threadIdx.x & 31, sub = lane & 7;
  for (int t0 = (threadIdx.x >> 5) * 4; t0 < nt; t0 += kWarps * 4) {   // warp-uniform
    const int t = t0 + (lane >> 3);
    const bool live = t < nt;
    const unsigned char* row = st + t * stride;
    float amax = 0.f;
    if (live)
      for (int d = sub; d < D; d += 8) amax = fmaxf(amax, fabsf(staged<T>(row, d)));
    for (int o = 4; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = quant_scale(amax, n_max);
    if (live) {
      for (int d = sub; d < D; d += 8)
        kq[t * DP + d] = __int_as_float(quant_signed(staged<T>(row, d), scale, n_max));
      if (sub == 0) scales[t] = scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_sc_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, D = a.D, DP = D + 1;
  const size_t qbase = (static_cast<size_t>(c) * a.KV + h) * G * D;
  T* out = static_cast<T*>(a.out) + qbase;
  const Span sp = key_span(a, c);
  if (!sp.active) {                  // the slot alone decides: the whole cluster returns
    for (int i = rank * kThreads + tid; i < G * D; i += kRanks * kThreads)
      out[i] = from_f<T>(0.f);
    return;
  }
  const int n_max = (1 << a.sc_bits) - 1;
  const int half = (1 << a.sc_bits) >> 1;
  const float n_stream = static_cast<float>(1 << a.sc_bits);

  const int stride = row_stride(D, sizeof(T));
  const int stage_bytes = kTile * stride;              // K rows or V rows
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + 2 * static_cast<size_t>(stage_bytes));
  float* pv_s = q_s + G * D;           // G * D  this rank's P V sums
  float* kq_s = pv_s + G * D;          // kTile * DP  quantized K or V rows
  float* kv_scale = kq_s + kTile * DP; // kTile  their scales
  float* nq_s = kv_scale + kTile;      // G  N * dq
  float* np_s = nq_s + G;              // G  N * dp
  float* x_max = np_s + G;             // G  exchanged: this rank's row max
  float* x_den = x_max + G;            // G  exchanged: its partial denominator
  float* x_pmax = x_den + G;           // G  exchanged: its max probability
  float* s_loc = a.work != nullptr     // G * share  this rank's scores, then p
      ? a.work + ((static_cast<size_t>(c) * a.KV + h) * kRanks + rank) * G * a.share
      : x_pmax + G;

  int i0;
  const int n = own_tiles(sp, rank, &i0);
  const int* table = a.tables + static_cast<size_t>(c) * a.max_blocks;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  // steps 0 .. n-1 stage this rank's K tiles, n .. 2n-1 its V tiles
  auto k0_of = [&](int j) { return (i0 + (j < n ? j : j - n) * kRanks) * kTile; };
  auto nt_of = [&](int j) { return min(kTile, sp.pos + 1 - k0_of(j)); };
  auto pool_of = [&](int j) { return j < n ? kp : vp; };
  auto row_of = [&](int j) { return j < 2 * n ? lane_row(table, k0_of(j), sp.pos, a) : 0; };
  // the float kernel's load schedule, over the steps
  Chunks ch;
  chunks_of(ch, max(1, D * static_cast<int>(sizeof(T)) / 16));
  Prefetched pre;
  auto fetch_step = [&](int j, int row) {
    if (j < 2 * n) fetch<T>(pre, ch, pool_of(j), vp, 1, row, nt_of(j), h, a);
  };
  auto commit_step = [&](int j, int row) {
    commit<T>(smem + static_cast<size_t>(j & 1) * stage_bytes, stride, pre, ch, pool_of(j), vp,
              1, row, nt_of(j), h, a);
  };
  int row1 = row_of(0), row2 = row_of(1), row3 = row_of(2);
  fetch_step(0, row1);
  const T* qg = static_cast<const T*>(a.q) + qbase;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(qg[i]);
    pv_s[i] = 0.f;
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    const float dq = quant_row_warp(q_s + g * D, D, n_max);
    if (lane == 0) nq_s[g] = __fmul_rn(n_stream, dq);
  }
  if (n > 0) commit_step(0, row1);
  fetch_step(1, row2);
  row1 = row2;
  row2 = row3;
  row3 = row_of(3);

  const int DH = (D + 1) / 2;
  auto step = [&](int j) {
    __syncthreads();                 // step j is stored; step j - 1 is consumed
    const int jj = j < n ? j : j - n;
    const int k0 = k0_of(j);
    const int nt = nt_of(j);
    const unsigned char* st = smem + static_cast<size_t>(j & 1) * stage_bytes;
    quant_tile<T>(st, stride, nt, kq_s, kv_scale, D, DP, n_max);
    __syncthreads();
    if (j + 1 < 2 * n) {             // the stage is free: store step j + 1, fetch j + 2
      commit_step(j + 1, row1);
      fetch_step(j + 2, row2);
      row1 = row2;
      row2 = row3;
      row3 = row_of(j + 4);
    }
    if (j < n) {
      // SC scores, one (g, key) per thread, lane = key % 32
      for (int i = tid; i < G * kTile; i += kThreads) {
        const int g = i / kTile, t = i - g * kTile;
        float s = kMasked;
        if (t < nt && k0 + t >= sp.first) {
          int count = 0;
#pragma unroll 8
          for (int d = 0; d < D; ++d) count += signed_term(q_s[g * D + d], kq_s[t * DP + d], half);
          s = capped(sc_score(count, nq_s[g], kv_scale[t], a.scale), a.softcap);
        }
        s_loc[static_cast<size_t>(g) * a.share + jj * kTile + t] = s;
      }
    } else {
      // P V, key by key in position order for each (g, d); a thread takes
      // d and d + DH, each its own sum
      for (int i = tid; i < G * DH; i += kThreads) {
        const int g = i / DH, d0 = i - g * DH, d1 = d0 + DH;
        const float* prow = s_loc + static_cast<size_t>(g) * a.share + jj * kTile;
        float* acc = pv_s + g * D;
        float s0 = acc[d0], s1 = d1 < D ? acc[d1] : 0.f;
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const float p = prow[t], dv = kv_scale[t];
          s0 = __fadd_rn(s0, sc_pv_term(p, kq_s[t * DP + d0], dv, half));
          if (d1 < D) s1 = __fadd_rn(s1, sc_pv_term(p, kq_s[t * DP + d1], dv, half));
        }
        acc[d0] = s0;
        if (d1 < D) acc[d1] = s1;
      }
    }
  };

  for (int j = 0; j < n; ++j) step(j);

  // The exact softmax over the slot's row, across the cluster; the first V
  // tiles are on their way meanwhile. Rank r's key t of own tile jj sits at
  // jj * 32 + t of its row, and in lane t of the row reductions.
  __syncthreads();                   // this rank's scores are written
  const int n_loc = n * kTile;
  for (int g = warp; g < G; g += kWarps) {
    const float* srow = s_loc + static_cast<size_t>(g) * a.share;
    float mx = kMasked;
    for (int t = lane; t < n_loc; t += 32) mx = fmaxf(mx, srow[t]);
    mx = warp_max(mx);
    if (lane == 0) x_max[g] = mx;
  }
  cluster.sync();                    // exchange 1: the row max
  for (int g = warp; g < G; g += kWarps) {
    float mx = kMasked;
    for (int r = 0; r < kRanks; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(x_max + g, r));
    float* srow = s_loc + static_cast<size_t>(g) * a.share;
    float sum = 0.f;
    for (int t = lane; t < n_loc; t += 32) {
      const float s = srow[t];
      const float un = s <= kMasked ? 0.f : expf(__fsub_rn(s, mx));
      srow[t] = un;
      sum = __fadd_rn(sum, un);
    }
    sum = warp_sum(sum);
    if (lane == 0) x_den[g] = sum;
  }
  cluster.sync();                    // exchange 2: the partial denominators
  for (int g = warp; g < G; g += kWarps) {
    float denom = *cluster.map_shared_rank(x_den + g, 0);
    for (int r = 1; r < kRanks; ++r)
      denom = __fadd_rn(denom, *cluster.map_shared_rank(x_den + g, r));
    float* srow = s_loc + static_cast<size_t>(g) * a.share;
    float pmax = 0.f;
    for (int t = lane; t < n_loc; t += 32) {
      const float p = __fdiv_rn(srow[t], denom);
      srow[t] = p;
      pmax = fmaxf(pmax, p);
    }
    pmax = warp_max(pmax);
    if (lane == 0) x_pmax[g] = pmax;
  }
  cluster.sync();                    // exchange 3: the probability maxima
  for (int g = warp; g < G; g += kWarps) {
    float pmax = 0.f;
    for (int r = 0; r < kRanks; ++r) pmax = fmaxf(pmax, *cluster.map_shared_rank(x_pmax + g, r));
    const float dp = quant_scale(pmax, n_max);
    float* srow = s_loc + static_cast<size_t>(g) * a.share;
    for (int t = lane; t < n_loc; t += 32)
      srow[t] = __int_as_float(quant_signed(srow[t], dp, n_max));
    if (lane == 0) np_s[g] = __fmul_rn(n_stream, dp);
  }

  for (int j = n; j < 2 * n; ++j) step(j);

  cluster.sync();                    // exchange 4: every rank's P V sums
  for (int i = rank * kThreads + tid; i < G * D; i += kRanks * kThreads) {
    float sum = *cluster.map_shared_rank(pv_s + i, 0);
    for (int r = 1; r < kRanks; ++r) sum = __fadd_rn(sum, *cluster.map_shared_rank(pv_s + i, r));
    out[i] = from_f<T>(__fmul_rn(sum, np_s[i / D]));
  }
  cluster.sync();                    // no CTA leaves while its sums may be read
}

// One cluster launch of kRanks CTAs per (slot, KV head). The shared-memory
// attribute and the check that such a cluster fits the card are made once
// per kernel, device and size: `checked` is the kernel's own record of the
// largest size checked on each device. A refused launch returns its
// cudaError_t.
int launch(void (*kernel)(Args), size_t* checked, const Args& a, int C, size_t bytes,
           void* stream) {
  if (C <= 0 || a.KV <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks, C, a.KV);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (dev >= kMaxDevices || bytes > checked[dev]) {
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < kMaxDevices) checked[dev] = bytes;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k_pages, const void* v_pages, const void* tables,
               const void* q_positions, void* out, void* work, int KV, int G, int D, int block,
               int max_blocks, int n_pages, int vec, int share, float scale, float softcap,
               int window, int sc_bits) {
  Args a;
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.tables = static_cast<const int*>(tables);
  a.q_positions = static_cast<const int*>(q_positions);
  a.out = out;
  a.work = static_cast<float*>(work);
  a.KV = KV;
  a.G = G;
  a.D = D;
  a.block = block;
  a.max_blocks = max_blocks;
  a.n_pages = n_pages;
  a.vec = vec;
  a.share = share;
  a.window = window;
  a.sc_bits = sc_bits;
  a.scale = scale;
  a.softcap = softcap;
  return a;
}

template <typename T>
int launch_float(const void* q, const void* k_pages, const void* v_pages, const void* tables,
                 const void* q_positions, void* out, int C, int KV, int G, int D, int block,
                 int max_blocks, int n_pages, int vec, float scale, float softcap, int window,
                 void* stream) {
  const Args a = make_args(q, k_pages, v_pages, tables, q_positions, out, nullptr, KV, G, D,
                           block, max_blocks, n_pages, vec, 0, scale, softcap, window, 0);
  static size_t checked[kMaxDevices] = {};
  return launch(paged_decode_kernel<T>, checked, a, C, float_smem_bytes(sizeof(T), G, D),
                stream);
}

template <typename T>
int launch_sc(const void* q, const void* k_pages, const void* v_pages, const void* tables,
              const void* q_positions, void* out, void* work, int C, int KV, int G, int D,
              int block, int max_blocks, int n_pages, int vec, int share, float scale,
              float softcap, int window, int sc_bits, void* stream) {
  const Args a = make_args(q, k_pages, v_pages, tables, q_positions, out, work, KV, G, D,
                           block, max_blocks, n_pages, vec, share, scale, softcap, window,
                           sc_bits);
  static size_t checked[kMaxDevices] = {};
  return launch(paged_decode_sc_kernel<T>, checked, a, C,
                sc_smem_bytes(sizeof(T), G, D, share, work == nullptr), stream);
}

}  // namespace

// The launch plan's constants and shared-memory size, for the wrapper's
// plan (kernels/paged_attention.py::plan) to be checked against.
extern "C" int paged_attention_ranks() { return kRanks; }

extern "C" long long paged_attention_smem_bytes(int sc, int esz, int G, int D, int share,
                                                int scores_in_smem) {
  return static_cast<long long>(sc ? sc_smem_bytes(esz, G, D, share, scores_in_smem != 0)
                                   : float_smem_bytes(esz, G, D));
}

extern "C" int paged_attention_f32(const void* q, const void* k_pages, const void* v_pages,
                                   const void* tables, const void* q_positions, void* out,
                                   int C, int KV, int G, int D, int block, int max_blocks,
                                   int n_pages, int vec, float scale, float softcap, int window,
                                   void* stream) {
  return launch_float<float>(q, k_pages, v_pages, tables, q_positions, out, C, KV, G, D, block,
                             max_blocks, n_pages, vec, scale, softcap, window, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                    const void* tables, const void* q_positions, void* out,
                                    int C, int KV, int G, int D, int block, int max_blocks,
                                    int n_pages, int vec, float scale, float softcap, int window,
                                    void* stream) {
  return launch_float<__nv_bfloat16>(q, k_pages, v_pages, tables, q_positions, out, C, KV, G,
                                     D, block, max_blocks, n_pages, vec, scale, softcap, window,
                                     stream);
}

extern "C" int paged_attention_sc_f32(const void* q, const void* k_pages, const void* v_pages,
                                      const void* tables, const void* q_positions, void* out,
                                      void* work, int C, int KV, int G, int D, int block,
                                      int max_blocks, int n_pages, int vec, int share,
                                      float scale, float softcap, int window, int sc_bits,
                                      void* stream) {
  return launch_sc<float>(q, k_pages, v_pages, tables, q_positions, out, work, C, KV, G, D,
                          block, max_blocks, n_pages, vec, share, scale, softcap, window,
                          sc_bits, stream);
}

extern "C" int paged_attention_sc_bf16(const void* q, const void* k_pages, const void* v_pages,
                                       const void* tables, const void* q_positions, void* out,
                                       void* work, int C, int KV, int G, int D, int block,
                                       int max_blocks, int n_pages, int vec, int share,
                                       float scale, float softcap, int window, int sc_bits,
                                       void* stream) {
  return launch_sc<__nv_bfloat16>(q, k_pages, v_pages, tables, q_positions, out, work, C, KV,
                                  G, D, block, max_blocks, n_pages, vec, share, scale, softcap,
                                  window, sc_bits, stream);
}
