// Causal flash-attention forward on Hopper, float and SC variants.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _kernel). The TPU kernel ran a sequential
// grid over (q block, kv block) carrying m, l and acc in VMEM scratch; here
// one block owns a (batch, head, tile of kBQ query rows) and loops over the
// keys itself, with m, l and acc in float32 shared memory, K and V staged
// through shared memory kBK rows at a time. GQA: head h reads KV head
// h / G. Layout q (B, H, Sq, D), k, v (B, KV, Skv, D), out like q, each
// addressed by (b, h, s) strides with a contiguous D axis, so the model's
// (B, S, H, D) tensors and cache slices are read in place. f32 and bf16
// operands; all arithmetic in float32 (probabilities stay float32 into PV,
// where the TPU kernel rounds them to v's dtype).
//
// Positions are absolute: query row i at q_offset + i, key j at j. Keys are
// walked in groups of `group` from key 0 (the SC quantization group: the TPU
// kernel's bk, the jnp formulation's kv_block). For each group, pass A
// writes the group's scores (float dot, or SC counts dequantized) into
// shared memory and takes each row's maximum over the whole group; the
// online-softmax update turns them into probabilities (SC: quantized per
// row over the group, after that maximum); pass B sums P V over the group.
// Groups past a tile's last row are not visited, rows past Sq are never
// written, and keys past Skv are never read: the ragged edges are masked
// here, nothing is padded.
//
// Row invariance: a row's result depends only on its position, the keys at
// or before it and `group` — not on the other rows of its tile, on Skv, or
// on the chunk it arrived in. Group boundaries fall at multiples of `group`
// from key 0; every sum over keys (row sums lane-strided by the key's offset
// in its group then a fixed butterfly, PV sums key by key in order) adds a
// masked key's exact 0.0 as a no-op; and a group fully masked for a row
// leaves its m, l and acc unchanged (alpha = 1, p = 0). So chunked prefill
// (q_offset = the staging offset, Skv = the bucket extent) and one-shot
// prefill (q_offset = 0) give every row the same bits.
//
// What bounds it: at the serving shapes (Sq 16-64, Skv <= 256, D = 64) the
// work is a few MFLOP per head, so it is latency bound on a few dozen blocks
// (15 heads x Sq / 16). Dots run on CUDA cores in a fixed d order; mma/wgmma
// tiles are later work.
#include "sc_attention.cuh"

#include <stdint.h>

namespace {

using namespace sc_attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;   // query rows per block
constexpr int kBK = 32;   // keys per K/V tile in shared memory

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Skv, D, G;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int q_offset, causal, group, sc_bits;
  float scale;
};

size_t smem_floats(int D, int group) {
  return 3 * static_cast<size_t>(kBQ) * D + static_cast<size_t>(kBK) * (D + 1) + kBK +
         static_cast<size_t>(kBQ) * group + 5 * kBQ;
}

// Stage rows [t0, t0 + nt) of K or V into kv_s (float32, row stride D + 1).
template <typename T>
__device__ __forceinline__ void load_tile(float* kv_s, const T* src, long long ss, int t0,
                                          int nt, int D) {
  for (int i = threadIdx.x; i < nt * D; i += kThreads) {
    const int t = i / D, d = i - t * D;
    kv_s[t * (D + 1) + d] = to_f(src[static_cast<long long>(t0 + t) * ss + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  const int row0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, DP = D + 1, grp = a.group;
  const bool sc = a.sc_bits > 0;
  const int n_max = sc ? (1 << a.sc_bits) - 1 : 0;
  const int half = sc ? (1 << a.sc_bits) >> 1 : 0;
  const float n_stream = sc ? static_cast<float>(1 << a.sc_bits) : 0.f;
  const int n_rows = min(kBQ, a.Sq - row0);

  extern __shared__ float smem[];
  float* q_s = smem;                  // kBQ * D  query rows (or signed mags)
  float* acc = q_s + kBQ * D;         // kBQ * D  running output
  float* pv = acc + kBQ * D;          // kBQ * D  this group's P V
  float* kv_s = pv + kBQ * D;         // kBK * DP K then V tile
  float* kv_scale = kv_s + kBK * DP;  // kBK      SC row scales of the tile
  float* s_buf = kv_scale + kBK;      // kBQ * group: scores, p, p magnitudes
  float* m_s = s_buf + kBQ * grp;     // kBQ running max
  float* l_s = m_s + kBQ;             // kBQ running sum
  float* alpha_s = l_s + kBQ;         // kBQ rescale of this group
  float* nq_s = alpha_s + kBQ;        // kBQ N * dq (SC)
  float* np_s = nq_s + kBQ;           // kBQ N * dp of this group (SC)

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const int kvh = h / a.G;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    q_s[i] = r < n_rows ? to_f(q[static_cast<long long>(row0 + r) * a.q_ss + d]) : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (sc) {
    for (int r = warp; r < kBQ; r += kWarps) {
      const float dq = quant_row_warp(q_s + r * D, D, n_max);
      if (lane == 0) nq_s[r] = __fmul_rn(n_stream, dq);
    }
    __syncthreads();
  }

  // keys any row of this tile can see
  const int kv_end = a.causal ? min(a.Skv, a.q_offset + row0 + n_rows) : a.Skv;
  for (int g0 = 0; g0 < kv_end; g0 += grp) {
    const int g_end = min(g0 + grp, kv_end);
    const int gn = g_end - g0;
    // pass A: the group's scores
    for (int t0 = g0; t0 < g_end; t0 += kBK) {
      const int nt = min(kBK, g_end - t0);
      load_tile(kv_s, k, a.k_ss, t0, nt, D);
      __syncthreads();
      if (sc) {
        for (int t = warp; t < nt; t += kWarps) {
          const float dk = quant_row_warp(kv_s + t * DP, D, n_max);
          if (lane == 0) kv_scale[t] = dk;
        }
        __syncthreads();
      }
      for (int i = tid; i < kBQ * nt; i += kThreads) {
        const int r = i / nt, t = i - r * nt;
        const int kpos = t0 + t;
        const bool valid = r < n_rows && (!a.causal || kpos <= a.q_offset + row0 + r);
        float s = kMasked;
        if (valid) {
          const float* qr = q_s + r * D;
          const float* kr = kv_s + t * DP;
          if (sc) {
            int count = 0;
            for (int d = 0; d < D; ++d) count += signed_term(qr[d], kr[d], half);
            s = sc_score(count, nq_s[r], kv_scale[t], a.scale);
          } else {
            float dot = 0.f;
            for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
            s = __fmul_rn(dot, a.scale);
          }
        }
        s_buf[r * grp + (kpos - g0)] = s;
      }
      __syncthreads();
    }
    // online-softmax update over the whole group, one warp per row
    for (int r = warp; r < kBQ; r += kWarps) {
      float* srow = s_buf + r * grp;
      float mx = kMasked;
      for (int t = lane; t < gn; t += 32) mx = fmaxf(mx, srow[t]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f, pmax = 0.f;
      for (int t = lane; t < gn; t += 32) {
        const float s = srow[t];
        const float p = s <= kMasked ? 0.f : expf(__fsub_rn(s, m_new));
        srow[t] = p;
        sum = __fadd_rn(sum, p);
        pmax = fmaxf(pmax, p);
      }
      sum = warp_sum(sum);
      if (sc) {
        // probabilities quantized per row over the group, after its max
        const float dp = quant_scale(warp_max(pmax), n_max);
        for (int t = lane; t < gn; t += 32)
          srow[t] = __int_as_float(quant_signed(srow[t], dp, n_max));
        if (lane == 0) np_s[r] = __fmul_rn(n_stream, dp);
      }
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        alpha_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
      }
    }
    for (int i = tid; i < kBQ * D; i += kThreads) pv[i] = 0.f;
    __syncthreads();
    // pass B: P V over the group, key by key in order for each (row, d)
    for (int t0 = g0; t0 < g_end; t0 += kBK) {
      const int nt = min(kBK, g_end - t0);
      load_tile(kv_s, v, a.v_ss, t0, nt, D);
      __syncthreads();
      if (sc) {
        for (int t = warp; t < nt; t += kWarps) {
          const float dv = quant_row_warp(kv_s + t * DP, D, n_max);
          if (lane == 0) kv_scale[t] = dv;
        }
        __syncthreads();
      }
      for (int i = tid; i < kBQ * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        const float* prow = s_buf + r * grp + (t0 - g0);
        float sum = pv[i];
        if (sc) {
          for (int t = 0; t < nt; ++t)
            sum = __fadd_rn(sum, sc_pv_term(prow[t], kv_s[t * DP + d], kv_scale[t], half));
        } else {
          for (int t = 0; t < nt; ++t)
            sum = __fadd_rn(sum, __fmul_rn(prow[t], kv_s[t * DP + d]));
        }
        pv[i] = sum;
      }
      __syncthreads();
    }
    // fold the group into the running output
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D;
      const float g = sc ? __fmul_rn(pv[i], np_s[r]) : pv[i];
      acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha_s[r]), g);
    }
    __syncthreads();
  }

  for (int i = tid; i < n_rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    out[static_cast<long long>(row0 + r) * a.o_ss + d] =
        from_f<T>(__fdiv_rn(acc[i], fmaxf(l_s[r], 1e-30f)));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
           int Sq, int Skv, int D, int G, long long q_sb, long long q_sh, long long q_ss,
           long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, long long o_sb, long long o_sh, long long o_ss, int q_offset,
           int causal, int group, int sc_bits, float scale, void* stream) {
  (void)KV;
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = sizeof(float) * smem_floats(D, group);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Args a{q,    k,    v,    out,  Sq,   Skv,  D,    G,        q_sb,   q_sh,    q_ss,
         k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,     o_ss,   q_offset, causal,
         group, sc_bits, scale};
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLASH_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, int B, int H,  \
                      int KV, int Sq, int Skv, int D, int G, long long q_sb, long long q_sh, \
                      long long q_ss, long long k_sb, long long k_sh, long long k_ss,        \
                      long long v_sb, long long v_sh, long long v_ss, long long o_sb,        \
                      long long o_sh, long long o_ss, int q_offset, int causal, int group,   \
                      int sc_bits, float scale, void* stream) {                              \
    return launch<T>(q, k, v, out, B, H, KV, Sq, Skv, D, G, q_sb, q_sh, q_ss, k_sb, k_sh,    \
                     k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, q_offset, causal, group,      \
                     sc_bits, scale, stream);                                                \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
