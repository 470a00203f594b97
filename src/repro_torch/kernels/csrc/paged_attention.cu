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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;        // tokens per online-softmax step
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
