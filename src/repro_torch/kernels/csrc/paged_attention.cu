// Paged decode attention on Hopper: one query token per slot, attended
// through the slot's block table straight against the page pool.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention_pallas (body _kernel). That kernel buffered the whole
// score row and every fp32 V page of a slot in VMEM and took one exact
// softmax at the last page; a whole row (max_blocks * block * kvh * d fp32)
// does not fit in a block's 227 KB of shared memory at long contexts, so
// this kernel keeps an online softmax (running max m, sum l, and output
// accumulator per query row, all fp32) and holds only one tile of K and V at
// a time. It therefore agrees with the exact softmax to a stated tolerance,
// not bitwise.
//
// Layout (the JAX kernel's): q (C, KV, G, D); k_pages, v_pages
// (P, block, KV, D) with page P - 1 the trash page; tables (C, MB) int32
// with -1 = unallocated, redirected to the trash page like
// cache_ops._safe_tables; q_positions (C,) int32. Output (C, KV, G, D) in
// q's dtype. f32 and bf16 operands; all arithmetic in fp32.
//
// One block per (slot, KV head) holds that head's G query rows. The block
// reads its own table row and walks only the pages up to its position (pages
// past pos contribute exact zeros in the reference, so they are skipped),
// and inside a page tiles of kTile tokens, stopping at pos. Positions past
// pos, and outside the sliding window when one is set, are masked; a masked
// token gets probability exactly 0. The tile boundaries fall at multiples of
// kTile from the page start, so any page size that is a multiple of kTile
// walks a slot's positions in the same tiles, and a slot's result does not
// depend on the other slots of the batch or on how the pool is paged.
//
// What bounds it: bytes. Each (slot, head) reads pos + 1 rows of K and V
// once; at the decode shapes (C = 4, KV = 5) there are only 20 blocks, so
// the walk is latency-bound on a few SMs — splitting a slot's pages across
// blocks (a second pass to merge partial softmaxes) is later work.
//
// The SC path (paged_decode_sc_kernel) follows the reference's SC branch:
// it quantizes the *normalized* probability row over all of the slot's keys
// (repro/kernels/paged_attention.py:172-185), so it cannot fold PV into an
// online softmax. It is two passes inside the block. Pass 1 walks the keys
// in 32-token tiles, quantizes each K row over D, and writes the SC scores
// (masked keys at -1e30) into a score row: shared memory when it fits,
// else a device workspace the wrapper allocates. Then, one warp per query
// row: the row max, the denominator, p = exp(s - max) / denominator, and p
// quantized over the row. Pass 2 walks the tiles again, quantizes each V row
// over D and sums the SC PV terms key by key in position order. Key k sits
// in lane k % 32 of the row reductions and the tiles start at multiples of
// 32, whatever the page size, so a slot's result does not depend on the
// paging (a dense cache viewed as one page per slot gives the same bits).
// Every head layout is served, single-KV-head full-MHA included.
#include "sc_attention.cuh"

#include <stdint.h>

namespace {

using namespace sc_attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // tokens per online-softmax step / SC tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ q_positions, T* __restrict__ out,
                    int KV, int G, int D, int block, int max_blocks,
                    int n_pages, float scale, int window) {
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int DP = D + 1;          // padded K row: lanes walking t hit distinct banks
  extern __shared__ float smem[];
  float* q_s = smem;               // G * D
  float* o_s = q_s + G * D;        // G * D   running output
  float* k_s = o_s + G * D;        // kTile * DP
  float* v_s = k_s + kTile * DP;   // kTile * D
  float* p_s = v_s + kTile * D;    // G * kTile  scores, then probabilities
  float* m_s = p_s + G * kTile;    // G   running max
  float* l_s = m_s + G;            // G   running sum
  float* a_s = l_s + G;            // G   rescale of this tile

  const size_t qbase = (static_cast<size_t>(c) * KV + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(q[qbase + i]);
    o_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kMasked;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int pos = q_positions[c];
  // A negative position attends nothing and writes zeros.
  const int last_page = pos < 0 ? -1 : min(pos / block, max_blocks - 1);
  int first_page = 0;
  if (window > 0 && pos - window + 1 > 0) first_page = (pos - window + 1) / block;

  for (int j = first_page; j <= last_page; ++j) {
    int page = tables[static_cast<size_t>(c) * max_blocks + j];
    if (page < 0) page = n_pages - 1;                      // trash page
    for (int t0 = 0; t0 < block; t0 += kTile) {
      const int kpos0 = j * block + t0;
      if (kpos0 > pos) break;
      if (window > 0 && pos - (kpos0 + kTile - 1) >= window) continue;
      const int nt = min(kTile, block - t0);
      // stage the tile: rows of D contiguous elements, coalesced along d
      for (int i = tid; i < nt * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        const size_t src =
            ((static_cast<size_t>(page) * block + t0 + t) * KV + h) * D + d;
        k_s[t * DP + d] = to_f(k_pages[src]);
        v_s[t * D + d] = to_f(v_pages[src]);
      }
      __syncthreads();
      // scores, one (g, t) per thread, dot product in a fixed d order
      for (int i = tid; i < G * nt; i += kThreads) {
        const int g = i / nt, t = i - g * nt;
        const int kpos = kpos0 + t;
        const bool valid = kpos <= pos && (window <= 0 || pos - kpos < window);
        float s = kMasked;
        if (valid) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[t * DP + d];
          s = dot * scale;
        }
        p_s[g * kTile + t] = s;
      }
      __syncthreads();
      // online-softmax update per query row; masked tokens get p = 0 exactly
      for (int g = tid; g < G; g += kThreads) {
        const float m_old = m_s[g];
        float m_new = m_old;
        for (int t = 0; t < nt; ++t) m_new = fmaxf(m_new, p_s[g * kTile + t]);
        const float alpha = expf(m_old - m_new);
        float sum = 0.f;
        for (int t = 0; t < nt; ++t) {
          const float s = p_s[g * kTile + t];
          const float p = s <= kMasked ? 0.f : expf(s - m_new);
          p_s[g * kTile + t] = p;
          sum += p;
        }
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
      }
      __syncthreads();
      // rescale and accumulate P V, one (g, d) per thread
      for (int i = tid; i < G * D; i += kThreads) {
        const int g = i / D, d = i - g * D;
        float pv = 0.f;
        for (int t = 0; t < nt; ++t) pv += p_s[g * kTile + t] * v_s[t * D + d];
        o_s[i] = o_s[i] * a_s[g] + pv;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    out[qbase + i] = from_f<T>(l > 0.f ? o_s[i] / l : 0.f);
  }
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) *
         (2 * static_cast<size_t>(G) * D + kTile * (D + 1) + kTile * D + G * kTile + 3 * G);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* q_positions, void* out, int C,
           int KV, int G, int D, int block, int max_blocks, int n_pages,
           float scale, int window, void* stream) {
  if (C <= 0 || KV <= 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = smem_bytes(G, D);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(C, KV);
  paged_decode_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(q_positions), static_cast<T*>(out), KV, G, D,
      block, max_blocks, n_pages, scale, window);
  return static_cast<int>(cudaGetLastError());
}

// SC path: two passes over the slot's keys (see the note at the top).
// `work`, when not null, holds a (C, KV, G, row_cap) float32 score row per
// (slot, KV head) instead of shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_sc_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ tables,
                       const int* __restrict__ q_positions, T* __restrict__ out,
                       float* __restrict__ work, int KV, int G, int D, int block,
                       int max_blocks, int n_pages, float scale, int window,
                       int sc_bits) {
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int DP = D + 1;
  const int n_max = (1 << sc_bits) - 1;
  const int half = (1 << sc_bits) >> 1;
  const float n_stream = static_cast<float>(1 << sc_bits);
  const int row_cap = max_blocks * block;
  extern __shared__ float smem[];
  float* q_s = smem;                  // G * D    query rows, then signed mags
  float* pv_s = q_s + G * D;          // G * D    P V sums
  float* kv_s = pv_s + G * D;         // kTile * DP  K then V tile
  float* kv_scale = kv_s + kTile * DP;  // kTile  row scales of the tile
  float* nq_s = kv_scale + kTile;     // G  N * dq
  float* np_s = nq_s + G;             // G  N * dp
  int* page_s = reinterpret_cast<int*>(np_s + G);  // kTile  page of each key
  float* s_row = work != nullptr
      ? work + (static_cast<size_t>(c) * KV + h) * G * row_cap
      : reinterpret_cast<float*>(page_s + kTile);   // G * row_cap

  const size_t qbase = (static_cast<size_t>(c) * KV + h) * G * D;
  // keys [key0, pos]: past the row's end nothing is stored, and key0 is a
  // multiple of kTile at or below the window's first key
  const int qpos = q_positions[c];
  const int pos = min(qpos, row_cap - 1);
  const int first = window > 0 ? max(0, qpos - window + 1) : 0;
  const int key0 = first / kTile * kTile;
  const int n_keys = pos + 1 - key0;
  if (qpos < 0 || first > pos) {     // attends nothing: zeros
    for (int i = tid; i < G * D; i += kThreads) out[qbase + i] = from_f<T>(0.f);
    return;
  }
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(q[qbase + i]);
    pv_s[i] = 0.f;
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    const float dq = quant_row_warp(q_s + g * D, D, n_max);
    if (lane == 0) nq_s[g] = __fmul_rn(n_stream, dq);
  }

  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? k_pages : v_pages;
    for (int t0 = key0; t0 <= pos; t0 += kTile) {
      const int nt = min(kTile, pos + 1 - t0);
      __syncthreads();               // the previous tile is consumed
      for (int t = tid; t < nt; t += kThreads) {
        const int page = tables[static_cast<size_t>(c) * max_blocks + (t0 + t) / block];
        page_s[t] = page < 0 ? n_pages - 1 : page;             // trash page
      }
      __syncthreads();
      for (int i = tid; i < nt * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        const size_t at =
            ((static_cast<size_t>(page_s[t]) * block + (t0 + t) % block) * KV + h) * D + d;
        kv_s[t * DP + d] = to_f(src[at]);
      }
      __syncthreads();
      for (int t = warp; t < nt; t += kWarps) {
        const float dk = quant_row_warp(kv_s + t * DP, D, n_max);
        if (lane == 0) kv_scale[t] = dk;
      }
      __syncthreads();
      if (pass == 0) {
        // SC scores, one (g, t) per thread
        for (int i = tid; i < G * nt; i += kThreads) {
          const int g = i / nt, t = i - g * nt;
          const int kpos = t0 + t;
          float s = kMasked;
          if (kpos >= first) {
            int count = 0;
            for (int d = 0; d < D; ++d)
              count += signed_term(q_s[g * D + d], kv_s[t * DP + d], half);
            s = sc_score(count, nq_s[g], kv_scale[t], scale);
          }
          s_row[static_cast<size_t>(g) * row_cap + (kpos - key0)] = s;
        }
      } else {
        // P V, key by key in position order for each (g, d)
        for (int i = tid; i < G * D; i += kThreads) {
          const int g = i / D, d = i - g * D;
          const float* prow = s_row + static_cast<size_t>(g) * row_cap + (t0 - key0);
          float sum = pv_s[i];
          for (int t = 0; t < nt; ++t)
            sum = __fadd_rn(sum, sc_pv_term(prow[t], kv_s[t * DP + d], kv_scale[t], half));
          pv_s[i] = sum;
        }
      }
    }
    if (pass == 0) {
      __syncthreads();
      // exact softmax over the row, then p quantized over the row
      for (int g = warp; g < G; g += kWarps) {
        float* srow = s_row + static_cast<size_t>(g) * row_cap;
        float mx = kMasked;
        for (int t = lane; t < n_keys; t += 32) mx = fmaxf(mx, srow[t]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int t = lane; t < n_keys; t += 32) {
          const float s = srow[t];
          const float un = s <= kMasked ? 0.f : expf(__fsub_rn(s, mx));
          srow[t] = un;
          sum = __fadd_rn(sum, un);
        }
        const float denom = warp_sum(sum);
        float pmax = 0.f;
        for (int t = lane; t < n_keys; t += 32) {
          const float p = __fdiv_rn(srow[t], denom);
          srow[t] = p;
          pmax = fmaxf(pmax, p);
        }
        const float dp = quant_scale(warp_max(pmax), n_max);
        for (int t = lane; t < n_keys; t += 32)
          srow[t] = __int_as_float(quant_signed(srow[t], dp, n_max));
        if (lane == 0) np_s[g] = __fmul_rn(n_stream, dp);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads)
    out[qbase + i] = from_f<T>(__fmul_rn(pv_s[i], np_s[i / D]));
}

size_t sc_smem_bytes(int G, int D, int row_cap, bool row_in_smem) {
  return sizeof(float) * (2 * static_cast<size_t>(G) * D + kTile * (D + 1) + kTile + 2 * G +
                          kTile + (row_in_smem ? static_cast<size_t>(G) * row_cap : 0));
}

template <typename T>
int launch_sc(const void* q, const void* k_pages, const void* v_pages,
              const void* tables, const void* q_positions, void* out, void* work,
              int C, int KV, int G, int D, int block, int max_blocks, int n_pages,
              float scale, int window, int sc_bits, void* stream) {
  if (C <= 0 || KV <= 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = sc_smem_bytes(G, D, max_blocks * block, work == nullptr);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_sc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(C, KV);
  paged_decode_sc_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(q_positions), static_cast<T*>(out),
      static_cast<float*>(work), KV, G, D, block, max_blocks, n_pages, scale, window,
      sc_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_attention_f32(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* q_positions, void* out, int C,
                                   int KV, int G, int D, int block,
                                   int max_blocks, int n_pages, float scale,
                                   int window, void* stream) {
  return launch<float>(q, k_pages, v_pages, tables, q_positions, out, C, KV,
                       G, D, block, max_blocks, n_pages, scale, window, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages, const void* tables,
                                    const void* q_positions, void* out, int C,
                                    int KV, int G, int D, int block,
                                    int max_blocks, int n_pages, float scale,
                                    int window, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, q_positions, out,
                               C, KV, G, D, block, max_blocks, n_pages, scale,
                               window, stream);
}

extern "C" int paged_attention_sc_f32(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* q_positions, void* out, void* work,
                                      int C, int KV, int G, int D, int block,
                                      int max_blocks, int n_pages, float scale,
                                      int window, int sc_bits, void* stream) {
  return launch_sc<float>(q, k_pages, v_pages, tables, q_positions, out, work, C, KV,
                          G, D, block, max_blocks, n_pages, scale, window, sc_bits,
                          stream);
}

extern "C" int paged_attention_sc_bf16(const void* q, const void* k_pages,
                                       const void* v_pages, const void* tables,
                                       const void* q_positions, void* out, void* work,
                                       int C, int KV, int G, int D, int block,
                                       int max_blocks, int n_pages, float scale,
                                       int window, int sc_bits, void* stream) {
  return launch_sc<__nv_bfloat16>(q, k_pages, v_pages, tables, q_positions, out, work,
                                  C, KV, G, D, block, max_blocks, n_pages, scale,
                                  window, sc_bits, stream);
}
