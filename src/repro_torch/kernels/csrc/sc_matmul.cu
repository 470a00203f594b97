// SC-GEMM on Hopper: the signed stochastic-multiplier GEMM, fused with the
// activation quantization and the dequantization around it
//
//     counts[m, n] = sum_k s_x s_y O(x, y)
//     O(x, y)      = msb_y * floor(x / 2) + clamp(min(y_low, floor((x - msb_y) / 2)), 0)
//     out[m, n]    = counts[m, n] * ((N * s_row[m]) * s_w)        (fused entry)
//
// Replaces the Pallas TPU kernel repro/kernels/sc_matmul.py::
// sc_matmul_counts_pallas (body _kernel) and the quantize / count /
// dequantize chain around it (repro/kernels/ops.py::_sc_matmul_pallas_jit):
// a model projection is one launch. It takes the float activation rows (f32
// or bf16, quantized per row in the prologue exactly as
// quantize_sign_magnitude(axis=-1) does, through sc_attention.cuh's
// quantizer) and a weight plane packed once (kernels/sc_matmul.py::
// pack_weight: sign * mag as int16 for bits <= 15, int32 above, columns
// padded with zeros to a multiple of 8), and writes the dequantized output in
// the activations' dtype. The counts entry (sc_matmul_counts_signed) runs the
// same kernel on a signed A plane and writes the float32 counts.
//
// What bounds it. Per (m, k, n) triple the closed form costs integer issue,
// while the bytes are the weight plane's 2 per (k, n): at decode (M = 4) a
// smollm-360m step is ~0.22 ms of weight bytes and a few 1e9 integer
// operations, so the kernel has to keep every SM issuing and B streaming:
//
// * Enough blocks. A block owns a 64-column by MR-row output tile and one
//   K range; the wrapper splits K (kernels/sc_matmul.py::plan) so every
//   smollm decode shape launches at least one full wave. The int32
//   partials of a tile's K ranges meet in the same launch: each block writes
//   its partial to a workspace the wrapper keeps, and the block that arrives
//   last at the tile's atomic counter adds them in split order and resets
//   the counter for the next launch. Counts are exact integers, so any split
//   and any order gives the same bits: the split depends on M, and batch
//   invariance does not move (each row's scale and counts are its own).
// * 16-byte loads in flight. A thread owns 8 columns (16 bytes of an int16
//   plane, 32 of an int32 one) of one k row per stage; 32 k rows make a
//   stage, and cp.async fills a ring of 4 stages ahead of the compute. A
//   thread reads only the bytes it loaded itself, so the CUDA-core loops
//   need no barrier.
// * A prepared once. The prologue quantizes the block's rows over its K
//   range into shared memory as s*floor(x/2) and s*max(floor((x-1)/2), 0).
//   With v the select of the two by msb_y, s_x min(y_low, t) is
//   clamp(v, -y_low, y_low), and s_y clamp(v, -y_low, y_low) is
//   clamp(s_y v, -y_low, y_low), the clamp being odd.
//
// Two forms of the inner loop:
// * packed 16-bit (bits <= 8, the main path): every operand fits a byte, so two
//   columns share a 32-bit register, 16 bits each. Each row's k entry holds
//   a byte table: s_y v + 128 for the four (msb_y, s_y), and the msb term
//   s_y s_x floor(x/2) + 128 or 0. Per column pair: two PRMT picks (the
//   selectors are built once per B element and serve all MR rows), a
//   max.u16x2 / min.u16x2 clamp to [128 - y_low, 128 + y_low], and one add
//   of both: 2.5 instructions a triple. A lane gains at most 510 a k row and
//   a thread sees at most 128 rows (plan caps a block's K range), so the
//   lanes never carry; the 128s are taken off before the reduction.
// * int32 (bits 9..30): select, max, min and two multiply-adds a triple.
// An int8 tensor-core form of the msb term (mma.sync.m16n8k32 at 16-row
// tiles, the residual on the CUDA cores, a barrier a stage) was measured
// slower than the packed 16-bit loop at every smollm prefill shape on the
// H100 and was removed (PERF.md).
//
// NaN and Inf rows. A row's absmax carries a NaN through (max.NaN), and a
// NaN absmax gives a NaN scale, as amax and clamp_min do in the plain
// version: the row's magnitudes then quantize to 0 and its output is
// 0 * NaN = NaN. An Inf row has an infinite scale, magnitudes 0 and output
// 0 * Inf = NaN, as in the plain version on the card.
//
// Rows: MR = 1, 2, 4, 8 (decode, one row tile) or 16-row tiles above
// (prefill). Ragged M, N and K are masked (zero bytes contribute O = 0).
//
// Experts. One launch may serve a batch of independent problems of one
// shape (a MoE projection of every expert: the reference's jax.vmap over
// sc_proj, which gives its pallas_call a batch grid axis): blockIdx.z runs
// over batch x row tiles, and problem e reads A, B and the weight scale
// and writes the output at e times their strides. A block's work, its K
// split and its sums are those of the unbatched launch of problem e, so
// the bits are too; the split's workspace and tile counters take a tile
// per (problem, row tile, column tile).
// The caller keeps |counts| < 2^24 so the float32 conversion is exact, and
// plane magnitudes below 2^bits. Build without --use_fast_math: the
// quantizer divides with __fdiv_rn and the epilogue multiplies with
// __fmul_rn, in the plain version's order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sc_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 8;                    // threads across a tile
constexpr int kTileN = kColThreads * 8;           // 64 columns, 8 a thread
constexpr int kKLanes = kThreads / kColThreads;   // 32 k rows a stage
constexpr int kStages = 4;
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* a;          // (M, K): f32 / bf16 activations, or a signed plane
  const void* b;          // (K, ldb) signed plane, zero past N
  const float* w_scale;   // the weight's per-tensor scale (fused entry)
  void* out;              // (M, N)
  int* ws;                // (tiles, splits, MR * 64) partials when splits > 1
  unsigned* counters;     // one per output tile, zero between launches
  int M, N, K, ldb, bits, kc, splits;
  int tiles_m;            // row tiles a problem; blockIdx.z / tiles_m is it
  long long a_stride, b_stride, out_stride;   // elements between problems
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <typename T> __device__ __forceinline__ float load_f(const T* p, size_t i) {
  return sc_attn::to_f(p[i]);
}

// the larger of a and b, NaN if either is NaN (fmaxf drops a NaN; amax
// does not)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float warp_max_nan(float v) {
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max |v| over the 16 bytes of u (8 bf16 or 4 f32 values) and amax
__device__ __forceinline__ float amax16(uint4 u, float amax, const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[h]));
    amax = max_nan(amax, max_nan(fabsf(f.x), fabsf(f.y)));
  }
  return amax;
}
__device__ __forceinline__ float amax16(uint4 u, float amax, const float*) {
  return max_nan(max_nan(amax, max_nan(fabsf(__uint_as_float(u.x)), fabsf(__uint_as_float(u.y)))),
                 max_nan(fabsf(__uint_as_float(u.z)), fabsf(__uint_as_float(u.w))));
}

template <typename TO> __device__ __forceinline__ TO store_cast(float v);
template <> __device__ __forceinline__ float store_cast<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TA> constexpr bool kQuant = false;
template <> constexpr bool kQuant<float> = true;
template <> constexpr bool kQuant<__nv_bfloat16> = true;

template <typename TB>
constexpr int kVec = sizeof(TB) / 2;   // 16-byte chunks a thread a row

__device__ __forceinline__ unsigned max_u16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned min_u16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__host__ __device__ constexpr size_t a_region(int mr, int kc) {
  return (size_t)mr * kc * 8 > (size_t)kWarps * mr * kTileN * 4
             ? (size_t)mr * kc * 8 : (size_t)kWarps * mr * kTileN * 4;
}

// P16: the packed 16-bit inner loop (bits <= 8), else the int32 one
template <typename TB, typename TA, typename TO, int MR, bool P16>
__global__ void __launch_bounds__(kThreads)
sc_gemm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = kVec<TB>;
  uint4* ring = reinterpret_cast<uint4*>(smem);
  unsigned char* after_ring = smem + (size_t)kStages * kThreads * V * 16;
  int2* a_s = reinterpret_cast<int2*>(after_ring);
  int* red = reinterpret_cast<int*>(after_ring);   // reused after the K loop
  __shared__ float row_scale[MR];
  __shared__ bool last_block;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  const int e = blockIdx.z / p.tiles_m;   // the problem (expert)
  const int m0 = (blockIdx.z - e * p.tiles_m) * MR, n0 = blockIdx.x * kTileN;
  const int k0 = blockIdx.y * p.kc;
  const int kend = min(p.K, k0 + p.kc);
  const int klen = max(kend - k0, 0);
  const int rows = min(MR, p.M - m0);
  const int half = (1 << p.bits) / 2;
  const int n_max = (1 << p.bits) - 1;

  // B: this thread's k lane and 8 columns; start the ring before the prologue
  const int kl = tid / kColThreads;
  const int col = n0 + (tid % kColThreads) * 8;
  const bool col_ok = col < p.ldb;
  const int iters = (klen + kKLanes - 1) / kKLanes;
  const TB* bp = static_cast<const TB*>(p.b) + e * p.b_stride;
  auto issue = [&](int it) {
    const int k = k0 + it * kKLanes + kl;
    const bool ok = col_ok && k < kend;
    const TB* src = ok ? bp + (size_t)k * p.ldb + col : bp;
    uint4* dst = ring + ((size_t)(it % kStages) * kThreads + tid) * V;
#pragma unroll
    for (int v = 0; v < V; ++v) cp_async16(dst + v, src + v * (16 / sizeof(TB)), ok ? 16 : 0);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) issue(s);
    cp_async_commit();
  }

  // A: per-row scales over the whole row, then this block's K range
  const TA* ap = static_cast<const TA*>(p.a) + e * p.a_stride;
  if constexpr (kQuant<TA>) {
    // rows of whole 16-byte words are read 16 bytes a lane (the max is
    // exact in any order)
    constexpr int kPer16 = 16 / sizeof(TA);
    const bool words = p.K % kPer16 == 0 && reinterpret_cast<uintptr_t>(ap) % 16 == 0;
    for (int r = warp; r < rows; r += kWarps) {
      const TA* row = ap + (size_t)(m0 + r) * p.K;
      float amax = 0.f;
      if (words) {
        const uint4* row4 = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
        for (int i = lane; i < p.K / kPer16; i += 32) amax = amax16(row4[i], amax, ap);
      } else {
        for (int i = lane; i < p.K; i += 32) amax = max_nan(amax, fabsf(load_f(row, i)));
      }
      amax = warp_max_nan(amax);
      // quant_scale's clamp would turn a NaN absmax into 1e-12
      if (lane == 0) row_scale[r] = isnan(amax) ? amax : sc_attn::quant_scale(amax, n_max);
    }
    __syncthreads();
  }
  for (int i = tid; i < MR * p.kc; i += kThreads) {
    const int r = i / p.kc, k = k0 + i % p.kc;
    int q = 0;
    if (r < rows && k < kend) {
      const size_t at = (size_t)(m0 + r) * p.K + k;
      if constexpr (kQuant<TA>) q = sc_attn::quant_signed(load_f(ap, at), row_scale[r], n_max);
      else q = static_cast<int>(ap[at]);
    }
    const int x = abs(q);
    const int xh = x >> 1, xl = max((x - 1) >> 1, 0);
    const int sxh = q < 0 ? -xh : xh, sxl = q < 0 ? -xl : xl;
    if constexpr (P16) {
      // bytes 0-3: s_y * v + 128 for (msb, s_y) = (0,+), (1,+), (0,-), (1,-);
      // bytes 4-7: 0 or s_y * s_x floor(x/2) + 128 by the same index
      a_s[i] = make_int2(
          static_cast<int>((sxh + 128) | (sxl + 128) << 8 | (128 - sxh) << 16
                           | static_cast<unsigned>(128 - sxl) << 24),
          static_cast<int>((sxh + 128) << 8 | static_cast<unsigned>(128 - sxh) << 24));
    } else {
      a_s[i] = make_int2(sxh, sxl);
    }
  }
  __syncthreads();

  int acc[P16 ? 1 : MR][8];
#pragma unroll
  for (int r = 0; r < (P16 ? 1 : MR); ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0;
  // packed 16-bit form: lane pairs of (r + 128) + (t + 128 or 0) per column pair,
  // and each column's count of msb_y = 1
  unsigned acc2[P16 ? MR : 1][4], msb2[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < (P16 ? MR : 1); ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc2[r][q] = 0u;

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    if (it + kStages - 1 < iters) issue(it + kStages - 1);
    cp_async_commit();

    const uint4* mine = ring + ((size_t)(it % kStages) * kThreads + tid) * V;
    int bv[8];
    if constexpr (V == 1) {
      const uint4 u = mine[0];
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        bv[2 * h] = static_cast<int>(static_cast<int16_t>(w[h] & 0xffffu));
        bv[2 * h + 1] = static_cast<int>(w[h]) >> 16;
      }
    } else {
      const uint4 u0 = mine[0], u1 = mine[1];
      bv[0] = u0.x; bv[1] = u0.y; bv[2] = u0.z; bv[3] = u0.w;
      bv[4] = u1.x; bv[5] = u1.y; bv[6] = u1.z; bv[7] = u1.w;
    }
    const int kk = it * kKLanes + kl;
    int2 av[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) av[r] = a_s[r * p.kc + kk];
    if constexpr (P16) {
      // Two columns a 32-bit register, 16 bits each. PRMT picks, per
      // column, s_y * v + 128 from the row's byte table by (msb_y, s_y) and
      // the msb term's byte the same way; max/min.u16x2 clamp the first to
      // [128 - y_low, 128 + y_low] (s_y clamp(v, -y_low, y_low) + 128, as
      // the clamp is odd); one add takes both. Each lane gains at most
      // 510 a k row and a thread sees at most kc / 32 <= 128 rows, so the
      // lanes never carry; the 128s are taken off at the end.
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned sel = 0x4040u, lo = 0u, hi = 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = bv[2 * q + h];
          const int y = abs(b);
          const int msb = y >= half ? 1 : 0;
          const int yl = y - msb * half;
          sel |= static_cast<unsigned>(msb | (b < 0 ? 2 : 0)) << (8 * h);
          lo |= static_cast<unsigned>(128 - yl) << (16 * h);
          hi |= static_cast<unsigned>(128 + yl) << (16 * h);
          msb2[q] += static_cast<unsigned>(msb) << (16 * h);
        }
        const unsigned sel_t = sel + 0x0404u;
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const unsigned a0 = static_cast<unsigned>(av[r].x), a1 = static_cast<unsigned>(av[r].y);
          const unsigned rv = min_u16x2(max_u16x2(__byte_perm(a0, a1, sel), lo), hi);
          acc2[r][q] += rv + __byte_perm(a0, a1, sel_t);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b = bv[j];
        const int y = abs(b);
        const bool msb = y >= half;
        const int yl = msb ? y - half : y;
        const int sy = b < 0 ? -1 : 1;
        const int msy = msb ? sy : 0;
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const int v = msb ? av[r].y : av[r].x;
          acc[r][j] += min(max(v, -yl), yl) * sy;
          acc[r][j] += av[r].x * msy;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // a_s is done with: red takes its place

  // the 32 k lanes: 4 in a warp by shuffles, then the 8 warps in shared memory
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int v;
      if constexpr (P16) {
        const int h = 16 * (j & 1);
        v = static_cast<int>((acc2[r][j >> 1] >> h) & 0xffffu)
            - 128 * (iters + static_cast<int>((msb2[j >> 1] >> h) & 0xffffu));
      } else {
        v = acc[r][j];
      }
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < kColThreads) red[(warp * MR + r) * kTileN + lane * 8 + j] = v;
    }
  __syncthreads();

  auto write = [&](int i, int count) {
    const int r = i / kTileN, n = n0 + i % kTileN, m = m0 + r;
    if (r >= rows || n >= p.N) return;
    if constexpr (kQuant<TA>) {
      const float s = __fmul_rn(__fmul_rn(static_cast<float>(1 << p.bits), row_scale[r]),
                                p.w_scale[e]);
      static_cast<TO*>(p.out)[e * p.out_stride + (size_t)m * p.N + n] =
          store_cast<TO>(__fmul_rn(static_cast<float>(count), s));
    } else {
      static_cast<float*>(p.out)[e * p.out_stride + (size_t)m * p.N + n] =
          static_cast<float>(count);
    }
  };
  int* part = p.ws + ((size_t)tile * p.splits + blockIdx.y) * (MR * kTileN);
  for (int i = tid; i < MR * kTileN; i += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * MR + i / kTileN) * kTileN + i % kTileN];
    if (p.splits == 1) write(i, s);
    else part[i] = s;
  }
  if (p.splits == 1) return;

  // the last block of the tile to arrive adds the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned prev = atomicAdd(p.counters + tile, 1u);
    last_block = prev == static_cast<unsigned>(p.splits - 1);
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int* first = p.ws + (size_t)tile * p.splits * (MR * kTileN);
  for (int i = tid; i < MR * kTileN; i += kThreads) {
    int s = 0;
#pragma unroll 8
    for (int sp = 0; sp < p.splits; ++sp) s += __ldcg(first + (size_t)sp * (MR * kTileN) + i);
    write(i, s);
  }
  if (tid == 0) p.counters[tile] = 0u;   // ready for the next launch
}

template <typename TB, typename TA, typename TO, int MR, bool P16>
int launch(const Params& p, int tiles_n, int tiles_z, cudaStream_t stream) {
  auto kern = sc_gemm_kernel<TB, TA, TO, MR, P16>;
  const size_t smem = (size_t)kStages * kThreads * kVec<TB> * 16 + a_region(MR, p.kc);
  // the dynamic size the kernel may take, raised as larger tiles ask
  // (with the static shared memory, even 48 KB needs it)
  static size_t granted = 0;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  // z: every problem's row tiles
  kern<<<dim3(tiles_n, p.splits, tiles_z), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB, typename TA, typename TO, bool P16>
int by_rows(const Params& p, int mr, int tiles_n, int tiles_z, cudaStream_t s) {
  switch (mr) {
    case 1: return launch<TB, TA, TO, 1, P16>(p, tiles_n, tiles_z, s);
    case 2: return launch<TB, TA, TO, 2, P16>(p, tiles_n, tiles_z, s);
    case 4: return launch<TB, TA, TO, 4, P16>(p, tiles_n, tiles_z, s);
    case 8: return launch<TB, TA, TO, 8, P16>(p, tiles_n, tiles_z, s);
    case 16: return launch<TB, TA, TO, 16, P16>(p, tiles_n, tiles_z, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// int16 planes: the packed 16-bit form at bits <= 8, else the int32 form
template <typename TA, typename TO>
int int16_plane(const Params& p, int mr, int tiles_n, int tiles_z, cudaStream_t s) {
  if (p.bits <= 8) return by_rows<int16_t, TA, TO, true>(p, mr, tiles_n, tiles_z, s);
  return by_rows<int16_t, TA, TO, false>(p, mr, tiles_n, tiles_z, s);
}

}  // namespace

// kinds: a 0 f32, 1 bf16 (fused: quantize, count, dequantize into the same
// dtype), 2 int16, 3 int32 (a signed plane: float32 counts); b 0 int16,
// 1 int32. batch problems of one shape, problem e at e times the strides
// (in elements) of A, B and the output, its weight scale w_scale[e].
extern "C" int sc_gemm(int a_kind, int b_kind, const void* a, const void* b,
                       const void* w_scale, void* out, void* ws, void* counters,
                       int M, int N, int K, int ldb, int bits, int mr, int kc,
                       int splits, int batch, long long a_stride,
                       long long b_stride, long long out_stride, void* stream) {
  if (M <= 0 || N <= 0 || batch <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles_n = (N + kTileN - 1) / kTileN, tiles_m = (M + mr - 1) / mr;
  if ((long long)tiles_m * batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p{a, b, static_cast<const float*>(w_scale), out, static_cast<int*>(ws),
           static_cast<unsigned*>(counters), M, N, K, ldb, bits, kc, splits,
           tiles_m, a_stride, b_stride, out_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_z = tiles_m * batch;
  if (b_kind == 0) {
    switch (a_kind) {
      case 0: return int16_plane<float, float>(p, mr, tiles_n, tiles_z, s);
      case 1: return int16_plane<__nv_bfloat16, __nv_bfloat16>(p, mr, tiles_n, tiles_z, s);
      case 2: return int16_plane<int16_t, float>(p, mr, tiles_n, tiles_z, s);
    }
  } else if (b_kind == 1) {
    switch (a_kind) {
      case 0: return by_rows<int32_t, float, float, false>(p, mr, tiles_n, tiles_z, s);
      case 1: return by_rows<int32_t, __nv_bfloat16, __nv_bfloat16, false>(p, mr, tiles_n, tiles_z, s);
      case 3: return by_rows<int32_t, int32_t, float, false>(p, mr, tiles_n, tiles_z, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
