// Causal flash-attention forward on Hopper: a bf16 tensor-core float path,
// a float32 CUDA-core float path and a packed-integer SC path, one launch a
// call each.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _kernel). The TPU kernel ran a sequential
// grid over (q block, kv block) carrying m, l and acc in VMEM scratch; here
// a block loops over the keys itself. Layout q (B, H, Sq, D), k, v (B, KV,
// Skv, D), out like q, each addressed by (b, h, s) strides with a
// contiguous D axis, so the model's (B, S, H, D) tensors and cache slices
// are read in place. Positions are absolute: query row i at q_offset + i,
// key j at j. q_offset is a launch scalar, or an int32 in device memory
// that every block reads at entry: a captured CUDA graph of a prefill
// chunk then replays at the staging offset of the moment. The grid is
// then the worst case for Sq rows at any offset (ceil((Sq - 1) / 16) + 1
// m-tiles); a block finds its m-tiles from the offset it read, and a block
// past the last active m-tile returns at once.
//
// Blocks. Query positions are cut into m-tiles of kMTile = 16 aligned to
// position 0 (m-tile t holds positions 16t .. 16t+15; a position outside
// [q_offset, q_offset + Sq) is an inactive row that is computed on zeros,
// masked, and never written). A block serves `hb` query heads of one KV
// head (GQA: head h reads KV head h / G) over `mt` consecutive m-tiles, so
// each K/V tile is read once for those hb heads. A row's slot in its tile is
// its position mod 16 and its head: never a function of q_offset, Sq or the
// block's other rows. Blocks run from the last m-tile down (causal work
// grows with the position). The launch plan (hb, mt, shared memory) comes
// from kernels/flash_attention.py::plan; flash_attention_smem_bytes is its
// C mirror, which a gpu test holds equal.
//
// Keys. A block visits keys [0, kv_end), kv_end = min(Skv, its last active
// position + 1) when causal (Skv otherwise), in tiles starting at multiples
// of the tile size from key 0. Rows of a tile at or past kv_end are
// zero-filled by the copy (cp.async with a source size of 0) and never read
// from memory: a staging cache past the chunk may hold anything, NaN
// included, and 0 * NaN would be NaN.
//
// Float path, bf16 operands (flash_fwd_mma_kernel): one warp per 16 rows
// (one head, one m-tile). S = Q K^T and O += P V run on tensor cores as
// mma.sync m16n8k16 bf16 -> f32, fragments loaded with ldmatrix from
// shared memory rows padded by 16 bytes (conflict-free). K and V tiles of
// 64 keys arrive by 16-byte cp.async in a ring of 3 stages: tiles i+1 and
// i+2 are in flight while tile i is computed. S and P stay in registers; the online
// softmax runs per key tile (base-2 exponent, the attention scale folded
// into log2(e)); P feeds the PV mma straight from the score accumulator,
// split into a bf16 high part and a bf16 low part (two mma each), so the
// probabilities enter PV with 16 significant bits (relative error <=
// 2^-17), not rounded to bf16. A tile wholly past a warp's rows is skipped
// (an exact no-op for the row: alpha = 1, p = 0).
//
// Float path, f32 operands (flash_fwd_f32_kernel): no TF32. CUDA cores, 256
// threads, hb = min(G, 4) heads of one m-tile a block sharing each 32-key
// K/V tile (16-byte cp.async, double buffered); scores one warp a row (a
// lane a key, dot products in a fixed d order), online softmax per tile,
// PV key by key in order for each (row, d).
//
// SC path (flash_fwd_sc_kernel): the QK^T and PV contractions through the
// popcount closed form, integer and exact. Keys are walked in groups of
// `group` from key 0 (the TPU kernel's bk, the jnp formulation's
// kv_block); a row's probabilities are quantized over each group after its
// maximum over the whole group is known. Per group:
//   pass A  each K row of a 32-key tile is quantized once for all hb heads
//           (packed 8-bit magnitudes, 4 a word; all 512 threads, a lane a
//           word); each (row, key) count is sum_d s_q s_k O(x, y) with O
//           evaluated 4 terms at a time in byte SIMD (masks, a bytewise
//           min by subtract and prmt sign-replicate) and the signs applied
//           by dp4a(unsigned O, signed +-1). Counts are stored as int16
//           (|count| <= 128 * 254) for the whole group, which is what the
//           group's quantization needs: scores are rebuilt from them
//           exactly, not recomputed (the price: hb is cut so that
//           16 * hb * group int16 fit shared memory);
//   stats   one warp a row: the group max, p = exp(s - m), their sum (lane
//           strided by key offset, then a fixed butterfly) and max, the
//           probability scale;
//   pass B  each V row quantized once; each (row, key) probability
//           quantized into a word; PV terms O(x_p, y_v) * (+-dv) in byte
//           SIMD, summed key by key in order with fmaf.
// Every division the plain version makes as an IEEE division is __fdiv_rn
// (sc_attention.cuh). The scores and quantized planes repeat the plain
// version's float32 operations one for one; only float sums differ.
//
// Row invariance: a row's result depends only on its position, its head,
// the keys at or before it and `group` — not on the other rows of its
// block, on Skv, or on the chunk it arrived in. Tiles and groups start at
// fixed key indices; every order of summation is a function of the key
// index; a masked key adds an exact zero; a tile or group wholly masked for
// a row leaves its m, l and acc unchanged. So chunked prefill (q_offset =
// the staging offset, Skv = the bucket extent) and one-shot prefill give
// every row the same bits.
//
// What bounds it: at long prompts the float path is bound by the latency
// of each warp's chain through a tile (copies issued, QK^T mma, softmax,
// PV mma; each phase adds, none dominates), not by bytes (K/V are read
// once per KV head and block) nor by the tensor cores' rate; a k-step's
// fragments are loaded before its mma, and the low parts' mma follow the
// high parts' by 8, to overlap what can be. The SC path is bound by
// integer issue (about 10 instructions per 4 count terms, pass B's byte
// to float conversions). At the serving shapes (16-64 rows a call) every
// path is latency bound on a few dozen blocks; there the SC plan splits
// a KV head's query heads over more blocks (flash_attention.py::plan).
#include "sc_attention.cuh"

#include <stdint.h>

namespace {

using namespace sc_attn;
using bf16 = __nv_bfloat16;

constexpr int kMTile = 16;       // query positions per m-tile
constexpr int kMaxD = 128;       // largest head dim
constexpr int kMmaTileK = 64;    // keys per K/V tile, bf16 float path
constexpr int kMmaMaxWarps = 8;  // warps per block, bf16 float path
constexpr int kMmaStages = 3;    // K/V tiles in flight, bf16 float path
constexpr int kF32TileK = 32;    // keys per K/V tile, f32 float path
constexpr int kScTileK = 32;     // keys per K/V tile, SC path
constexpr int kThreads = 256;    // threads per block, f32 float path
constexpr int kScThreads = 512;  // threads per block, SC path
constexpr int kScItems = 4;      // PV outputs (4 d each) a thread holds, SC
constexpr short kNoKey = -32768; // a masked key's stored SC count

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Skv, D, G, hb, mt;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int q_offset, causal, group, sc_bits, vec;
  float scale;
  const int* q_off;  // q_offset in device memory, or null: the scalar
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Shared-memory bytes of each path (kernels/flash_attention.py::plan).
size_t smem_mma(int hb, int mt, int D) {
  const int dp = D <= 64 ? 64 : 128;
  const size_t row = static_cast<size_t>(dp + 8) * sizeof(bf16);
  return row * (static_cast<size_t>(kMTile) * hb * mt + 2 * kMmaStages * kMmaTileK);
}

size_t smem_f32(int hb, int D) {
  const size_t rows = static_cast<size_t>(kMTile) * hb;
  return sizeof(float) * (2 * rows * D + rows * kF32TileK + 4 * kF32TileK * (D + 4) + 3 * rows);
}

size_t smem_sc(int hb, int D, int group, int esz) {
  const size_t rows = static_cast<size_t>(kMTile) * hb;
  const size_t dw = (D + 3) / 4;
  return align16(rows * dw * 12) + align16(rows * 6 * 4) + align16(rows * group * 2) +
         align16(static_cast<size_t>(group) * 4) + align16(2 * kScTileK * D * esz) +
         align16(kScTileK * dw * 24) + rows * kScTileK * 8;
}

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// all but the newest committed group have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a b, one m16n8k16 tile, bf16 operands, float32 accumulator (not
// volatile: a pure function of registers, which the compiler may schedule
// between the fragment loads)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one word of two bf16 (the first in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats as a bf16 pair rounded to nearest (h) and the pair of their
// residuals (l): lo + hi = h + l to 16 significant bits. The residuals are
// taken against h unpacked by shifts, not by a second conversion.
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& h, uint32_t& l) {
  h = pack_bf16(lo, hi);
  l = pack_bf16(lo - __uint_as_float(h << 16), hi - __uint_as_float(h & 0xFFFF0000u));
}

// d = c + sum of the four products of unsigned bytes of a and signed bytes of b
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// byte i of a word (a value <= 255) as an exact float
__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)) - 8388608.f;
}

// -------------------------------------------------------------------- blocks

// The block's place: m-tiles [mt0, mt0 + mt) (heaviest first), heads
// kvh * G + hb0 + [0, nh) of KV head kvh, batch row b; its active positions
// are [lo, hi) and it reads keys [0, kv_end). off is the query offset;
// a block of a worst-case grid past the offset's m-tiles is not active.
struct Place {
  int mt0, hb0, nh, kvh, b, lo, hi, kv_end, off;
  bool active;
};

__device__ __forceinline__ Place place(const Args& a) {
  Place p;
  const int n_hg = (a.G + a.hb - 1) / a.hb;
  p.kvh = blockIdx.y / n_hg;
  p.hb0 = (blockIdx.y - p.kvh * n_hg) * a.hb;
  p.nh = min(a.hb, a.G - p.hb0);
  p.b = blockIdx.z;
  p.off = a.q_off ? *a.q_off : a.q_offset;
  const int first = p.off / kMTile;
  const int end = (p.off + a.Sq + kMTile - 1) / kMTile;
  // the blocks this offset needs, numbered as a grid of exactly that many
  // would number them: a row's m-tile, slot and block do not depend on
  // whether the offset came as a scalar or from device memory
  const int blocks = (end - first + a.mt - 1) / a.mt;
  p.active = static_cast<int>(blockIdx.x) < blocks;
  p.mt0 = first + (blocks - 1 - static_cast<int>(blockIdx.x)) * a.mt;
  p.lo = max(p.off, p.mt0 * kMTile);
  p.hi = min(p.off + a.Sq, min(end, p.mt0 + a.mt) * kMTile);
  p.kv_end = a.causal ? min(a.Skv, p.hi) : a.Skv;
  return p;
}

// Copy rows [r0, r0 + rows) of K or V (element stride D contiguous, row
// stride ss) into shared rows of stride ld elements; rows at or past
// n_valid are zero-filled. vec: 16-byte chunks by cp.async (D * sizeof(T)
// a multiple of 16, every address 16-byte aligned); a thread keeps one
// chunk column and walks rows by pointer increments (one division a call,
// none a chunk: issuing a tile's copies is on the critical path). Else
// element by element.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long ss, int r0,
                                          int n_valid, int rows, int D, bool vec) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    const int cpr = D / per, step = blockDim.x / cpr;
    int r = threadIdx.x / cpr;
    if (r >= step) return;
    const int c = (threadIdx.x - r * cpr) * per;
    const T* p = src + (r0 + r) * ss + c;
    const long long pstep = step * ss;
    T* q = dst + r * ld + c;
    for (; r < rows; r += step, p += pstep, q += step * ld) {
      const bool ok = r < n_valid;
      cp_async16(q, ok ? p : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      dst[r * ld + d] = r < n_valid ? src[(r0 + r) * ss + d] : from_f<T>(0.f);
    }
  }
}

// ------------------------------------------------------- float path, bf16 mma

template <int DP>
__global__ void __launch_bounds__(kMmaMaxWarps * 32) flash_fwd_mma_kernel(Args a) {
  constexpr int LD = DP + 8;  // shared row stride in bf16: 16 bytes of padding
  constexpr int NK = DP / 16;
  const Place pl = place(a);
  if (!pl.active) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = a.D, ksteps = (D + 15) / 16;
  const int n_qrows = kMTile * a.hb * a.mt;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [mt][hb][16] rows
  bf16* kv_s = q_s + n_qrows * LD;            // [kMmaStages][K, V][kMmaTileK] rows

  const bf16* qg = static_cast<const bf16*>(a.q) + pl.b * a.q_sb;
  const bf16* kg = static_cast<const bf16*>(a.k) + pl.b * a.k_sb + pl.kvh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + pl.b * a.v_sb + pl.kvh * a.v_sh;
  const bool vec = a.vec != 0;

  // columns [D, 16 * ksteps) are read by the mma: zero them once
  if (D < 16 * ksteps) {
    const int pad = 16 * ksteps - D, rows = n_qrows + 2 * kMmaStages * kMmaTileK;
    for (int i = threadIdx.x; i < rows * pad; i += blockDim.x) {
      const int r = i / pad;
      q_s[r * LD + D + (i - r * pad)] = __float2bfloat16(0.f);
    }
  }
  // query rows: row (i * hb + hh) * 16 + slot holds head hb0 + hh at
  // position 16 * (mt0 + i) + slot, zeros when inactive
  {
    const int cpr = vec ? D / 8 : D;
    for (int i = threadIdx.x; i < n_qrows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = i - r * cpr;
      const int hh = (r / kMTile) % a.hb, pos = (pl.mt0 + r / (kMTile * a.hb)) * kMTile + r % kMTile;
      const bool ok = hh < pl.nh && pos >= pl.lo && pos < pl.hi;
      const bf16* src = qg + (pl.kvh * a.G + pl.hb0 + hh) * a.q_sh + (pos - pl.off) * a.q_ss;
      if (vec)
        cp_async16(q_s + r * LD + c * 8, ok ? src + c * 8 : qg, ok ? 16 : 0);
      else
        q_s[r * LD + c] = ok ? src[c] : __float2bfloat16(0.f);
    }
  }
  const int n_tiles = (pl.kv_end + kMmaTileK - 1) / kMmaTileK;
  auto issue = [&](int it) {
    bf16* st = kv_s + (it % kMmaStages) * 2 * kMmaTileK * LD;
    const int t0 = it * kMmaTileK, nv = min(kMmaTileK, pl.kv_end - t0);
    load_rows(st, LD, kg, a.k_ss, t0, nv, kMmaTileK, D, vec);
    load_rows(st + kMmaTileK * LD, LD, vg, a.v_ss, t0, nv, kMmaTileK, D, vec);
    cp_async_commit();
  };
  for (int it = 0; it < kMmaStages - 1 && it < n_tiles; ++it) issue(it);

  // this warp's 16 rows: head hb0 + wh, m-tile mt0 + wm; this thread's two
  // rows are slots g and g + 8 (the mma fragment's rows)
  const int wh = warp % a.hb, wm = warp / a.hb;
  const int g = lane >> 2, tq = lane & 3;
  const int pos0 = (pl.mt0 + wm) * kMTile + g, pos1 = pos0 + 8;
  const bool act0 = wh < pl.nh && pos0 >= pl.lo && pos0 < pl.hi;
  const bool act1 = wh < pl.nh && pos1 >= pl.lo && pos1 < pl.hi;
  const int w_lo = max(pl.lo, (pl.mt0 + wm) * kMTile);
  const int w_hi = min(pl.hi, (pl.mt0 + wm + 1) * kMTile);  // warp's active [w_lo, w_hi)
  const bool w_act = wh < pl.nh && w_lo < w_hi;
  const float sl2 = a.scale * 1.4426950408889634f;
  const uint32_t q_addr = smem_u32(q_s + (warp * kMTile + (lane & 15)) * LD + (lane >> 4) * 8);

  float o[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    // tile it has landed (tile it + 1 may still be in flight); every warp
    // is done with tile it - 1, whose stage tile it + 2 takes
    if (it + 1 < n_tiles)
      cp_async_wait_one();
    else
      cp_async_wait_all();
    __syncthreads();
    if (it + kMmaStages - 1 < n_tiles) issue(it + kMmaStages - 1);
    const int t0 = it * kMmaTileK;
    if (!w_act || (a.causal && t0 >= w_hi)) continue;
    const bf16* ks = kv_s + (it % kMmaStages) * 2 * kMmaTileK * LD;
    const bf16* vs = ks + kMmaTileK * LD;

    // S = Q K^T, 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // a k-step's fragments are loaded before its 8 independent mma
    const uint32_t k_addr =
        smem_u32(ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk < ksteps) {
        uint32_t a0, a1, a2, a3, b[4][4];
        ldsm_x4(a0, a1, a2, a3, q_addr + kk * 32);
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2)
          ldsm_x4(b[j2][0], b[j2][1], b[j2][2], b[j2][3],
                  k_addr + (j2 * 16 * LD + kk * 16) * sizeof(bf16));
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          mma_bf16(s[2 * j2], a0, a1, a2, a3, b[j2][0], b[j2][1]);
          mma_bf16(s[2 * j2 + 1], a0, a1, a2, a3, b[j2][2], b[j2][3]);
        }
      }
    }
    // mask and scale (log2 units); the tile's row maxima over the quad. A
    // tile every key of which every row of the warp sees needs no mask (the
    // select would keep every score: the same bits)
    const bool full = w_hi - w_lo == kMTile && t0 + kMmaTileK <= a.Skv &&
                      (!a.causal || t0 + kMmaTileK <= w_lo + 1);
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * j + 2 * tq + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const bool ok = full || ((e < 2 ? act0 : act1) && key < a.Skv && (!a.causal || key <= pos));
        s[j][e] = ok ? s[j][e] * sl2 : kMasked;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        s[j][e] = s[j][e] <= kMasked ? 0.f : ex2(s[j][e] - mn);
      }
      rs0 = __fadd_rn(rs0, __fadd_rn(s[j][0], s[j][1]));
      rs1 = __fadd_rn(rs1, __fadd_rn(s[j][2], s[j][3]));
    }
    rs0 = __fadd_rn(rs0, __shfl_xor_sync(0xffffffffu, rs0, 1));
    rs0 = __fadd_rn(rs0, __shfl_xor_sync(0xffffffffu, rs0, 2));
    rs1 = __fadd_rn(rs1, __shfl_xor_sync(0xffffffffu, rs1, 1));
    rs1 = __fadd_rn(rs1, __shfl_xor_sync(0xffffffffu, rs1, 2));
    l0 = __fadd_rn(__fmul_rn(l0, al0), rs0);
    l1 = __fadd_rn(__fmul_rn(l1, al1), rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    // O += P V: P from the score registers as bf16 high + low parts
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* pa = s[2 * kk];
      const float* pb = s[2 * kk + 1];
      uint32_t h0, h1, h2, h3, r0, r1, r2, r3;
      split_bf16(pa[0], pa[1], h0, r0);
      split_bf16(pa[2], pa[3], h1, r1);
      split_bf16(pb[0], pb[1], h2, r2);
      split_bf16(pb[2], pb[3], h3, r3);
      const uint32_t v_addr = smem_u32(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       (lane >> 4) * 8);
      // 64 columns at a time: their fragments first, then the high parts'
      // mma, then the low parts' (each 8 mma after its twin)
#pragma unroll
      for (int c0 = 0; c0 < NK; c0 += 4) {
        uint32_t b[4][4];
#pragma unroll
        for (int n2 = c0; n2 < c0 + 4; ++n2)
          if (n2 < ksteps)
            ldsm_x4_t(b[n2 - c0][0], b[n2 - c0][1], b[n2 - c0][2], b[n2 - c0][3],
                      v_addr + n2 * 16 * sizeof(bf16));
#pragma unroll
        for (int n2 = c0; n2 < c0 + 4; ++n2) {
          if (n2 < ksteps) {
            mma_bf16(o[2 * n2], h0, h1, h2, h3, b[n2 - c0][0], b[n2 - c0][1]);
            mma_bf16(o[2 * n2 + 1], h0, h1, h2, h3, b[n2 - c0][2], b[n2 - c0][3]);
          }
        }
#pragma unroll
        for (int n2 = c0; n2 < c0 + 4; ++n2) {
          if (n2 < ksteps) {
            mma_bf16(o[2 * n2], r0, r1, r2, r3, b[n2 - c0][0], b[n2 - c0][1]);
            mma_bf16(o[2 * n2 + 1], r0, r1, r2, r3, b[n2 - c0][2], b[n2 - c0][3]);
          }
        }
      }
    }
  }

  bf16* og = static_cast<bf16*>(a.out) + pl.b * a.o_sb +
             (pl.kvh * a.G + pl.hb0 + wh) * a.o_sh;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * n + 2 * tq + (e & 1);
      const bool row_ok = e < 2 ? act0 : act1;
      if (row_ok && col < D) {
        const int pos = e < 2 ? pos0 : pos1;
        og[(pos - pl.off) * a.o_ss + col] =
            __float2bfloat16(__fdiv_rn(o[n][e], e < 2 ? d0 : d1));
      }
    }
  }
}

// ------------------------------------------------- float path, f32 CUDA cores

__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Args a) {
  const Place pl = place(a);
  if (!pl.active) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, DS = D + 4, R = kMTile * a.hb;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // R * D
  float* acc = q_s + R * D;                     // R * D
  float* p_s = acc + R * D;                     // R * kF32TileK
  float* kv_s = p_s + R * kF32TileK;            // [stage][K, V][kF32TileK][DS]
  float* m_s = kv_s + 4 * kF32TileK * DS;       // R
  float* l_s = m_s + R;                         // R
  float* al_s = l_s + R;                        // R

  const float* qg = static_cast<const float*>(a.q) + pl.b * a.q_sb;
  const float* kg = static_cast<const float*>(a.k) + pl.b * a.k_sb + pl.kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + pl.b * a.v_sb + pl.kvh * a.v_sh;
  const bool vec = a.vec != 0;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int hh = r / kMTile, pos = pl.mt0 * kMTile + r % kMTile;
    const bool ok = hh < pl.nh && pos >= pl.lo && pos < pl.hi;
    q_s[i] = ok ? qg[(pl.kvh * a.G + pl.hb0 + hh) * a.q_sh + (pos - pl.off) * a.q_ss + d]
                : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }
  const int n_tiles = (pl.kv_end + kF32TileK - 1) / kF32TileK;
  auto issue = [&](int it) {
    float* st = kv_s + (it & 1) * 2 * kF32TileK * DS;
    const int t0 = it * kF32TileK, nv = min(kF32TileK, pl.kv_end - t0);
    load_rows(st, DS, kg, a.k_ss, t0, nv, kF32TileK, D, vec);
    load_rows(st + kF32TileK * DS, DS, vg, a.v_ss, t0, nv, kF32TileK, D, vec);
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) issue(it + 1);
    const int t0 = it * kF32TileK;
    const float* ks = kv_s + (it & 1) * 2 * kF32TileK * DS;
    const float* vs = ks + kF32TileK * DS;
    // scores and the online softmax: one warp a row, a lane a key
    for (int r = warp; r < R; r += kThreads / 32) {
      const int hh = r / kMTile, pos = pl.mt0 * kMTile + r % kMTile;
      const int key = t0 + lane;
      const bool ok = hh < pl.nh && pos >= pl.lo && pos < pl.hi && key < a.Skv &&
                      (!a.causal || key <= pos);
      float s = kMasked;
      if (ok) {
        const float* qr = q_s + r * D;
        const float* kr = ks + lane * DS;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = __fmul_rn(dot, a.scale);
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = s <= kMasked ? 0.f : expf(__fsub_rn(s, m_new));
      const float sum = warp_sum(p);
      p_s[r * kF32TileK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        al_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // P V, key by key in order for each (row, d)
    const int nt = min(kF32TileK, pl.kv_end - t0);
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* pr = p_s + r * kF32TileK;
      float sum = 0.f;
      for (int t = 0; t < nt; ++t) sum = fmaf(pr[t], vs[t * DS + d], sum);
      acc[i] = fmaf(acc[i], al_s[r], sum);
    }
  }
  __syncthreads();

  float* og = static_cast<float*>(a.out) + pl.b * a.o_sb;
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int hh = r / kMTile, pos = pl.mt0 * kMTile + r % kMTile;
    if (hh < pl.nh && pos >= pl.lo && pos < pl.hi)
      og[(pl.kvh * a.G + pl.hb0 + hh) * a.o_sh + (pos - pl.off) * a.o_ss + d] =
          __fdiv_rn(acc[i], fmaxf(l_s[r], 1e-30f));
  }
}

// ----------------------------------------------------------------- SC path

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// bytewise min of two words whose bytes are <= 127: (a | 0x80) - b keeps
// bit 7 exactly where a >= b, and prmt replicates it over the byte
__device__ __forceinline__ uint32_t min7x4(uint32_t a, uint32_t b) {
  const uint32_t ge = prmt((a | 0x80808080u) - b, 0, 0xBA98);
  return a ^ ((a ^ b) & ge);
}

// the x-side words of O(x, y), bytewise: xa = x >> 1 and
// xd = xa ^ ((x -sat 1) >> 1)
__device__ __forceinline__ void x_words(uint32_t x, uint32_t& xa, uint32_t& xd) {
  xa = (x >> 1) & 0x7F7F7F7Fu;
  xd = xa ^ ((__vsubus4(x, 0x01010101u) >> 1) & 0x7F7F7F7Fu);
}

// O(x, y) = msb_y * (x >> 1) + min(y_low, (x - msb_y) >> 1) for 4 byte
// pairs, given xa = x >> 1 and xd = xa ^ ((x -sat 1) >> 1) bytewise, yl =
// y mod N/2 and mm = 0xFF where y >= N/2; every byte stays <= 254
__device__ __forceinline__ uint32_t o_word(uint32_t xa, uint32_t xd, uint32_t yl, uint32_t mm) {
  return (xa & mm) + min7x4(yl, xa ^ (xd & mm));
}

// Quantize `rows` rows of D elements (D <= 128), 2^lg lanes a row (a lane a
// word of 4 elements), every warp of the block: row r's elements come from
// src(r) (nullptr: zeros) and store(r, w, scale, mag, neg) gets word w's
// packed magnitudes and 0xFF in each byte whose element is negative.
template <typename T, typename Src, typename Store>
__device__ __forceinline__ void quant_rows(int rows, int D, int n_max, Src src, Store store) {
  const int DW = (D + 3) / 4;
  int lg = 0;
  while ((1 << lg) < DW) ++lg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int per_warp = 32 >> lg, w = lane & ((1 << lg) - 1);
  for (int base = warp * per_warp; base < rows; base += n_warps * per_warp) {
    const int r = base + (lane >> lg);
    const T* row = r < rows ? src(r) : nullptr;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * w + i;
      v[i] = row != nullptr && d < D ? to_f(row[d]) : 0.f;
    }
    float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
    for (int o = (1 << lg) >> 1; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = quant_scale(amax, n_max);
    uint32_t mag = 0, neg = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mag |= static_cast<uint32_t>(abs(quant_signed(v[i], scale, n_max))) << (8 * i);
      neg |= (v[i] < 0.f ? 0xFFu : 0u) << (8 * i);
    }
    if (r < rows && w < DW) store(r, w, scale, mag, neg);
  }
}

template <typename T>
__global__ void __launch_bounds__(kScThreads) flash_fwd_sc_kernel(Args a) {
  const Place pl = place(a);
  if (!pl.active) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kScThreads / 32;
  const int D = a.D, DW = (D + 3) / 4, R = kMTile * a.hb, grp = a.group;
  const int n_max = (1 << a.sc_bits) - 1, half = (1 << a.sc_bits) >> 1;
  const float n_stream = static_cast<float>(1 << a.sc_bits);
  const uint32_t half4 = 0x01010101u * half, low4 = 0x01010101u * (half - 1);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sp = smem;
  auto take = [&](size_t bytes) {
    unsigned char* p = sp;
    sp += align16(bytes);
    return p;
  };
  // query rows: xa, xd and sign words (bytes 0x00 / 0xFE) [R][DW]
  uint32_t* qa = reinterpret_cast<uint32_t*>(take(static_cast<size_t>(R) * DW * 12));
  uint32_t* qd = qa + R * DW;
  uint32_t* qs = qd + R * DW;
  float* nq_s = reinterpret_cast<float*>(take(static_cast<size_t>(R) * 24));
  float* m_s = nq_s + R;
  float* l_s = m_s + R;
  float* al_s = l_s + R;
  float* dp_s = al_s + R;
  float* np_s = dp_s + R;
  short* cnt = reinterpret_cast<short*>(take(static_cast<size_t>(R) * grp * 2));  // [R][grp]
  float* dk_s = reinterpret_cast<float*>(take(static_cast<size_t>(grp) * 4));
  T* raw = reinterpret_cast<T*>(take(2 * kScTileK * static_cast<size_t>(D) * sizeof(T)));
  uint32_t* qt = reinterpret_cast<uint32_t*>(take(static_cast<size_t>(kScTileK) * DW * 24));
  uint32_t* pwa = reinterpret_cast<uint32_t*>(sp);  // [R][kScTileK] x >> 1, replicated
  uint32_t* pwd = pwa + R * kScTileK;               // [R][kScTileK] xd, replicated
  // the quantized tile: K as [DW][kScTileK] words (4 keys a 16-byte load),
  // sign bytes 0x01 / 0xFF, so that q sign ^ k sign is the +-1 byte; V as
  // [kScTileK][DW] words and [kScTileK][4 * DW] signed scales
  uint32_t* k_yl = qt;
  uint32_t* k_mm = k_yl + DW * kScTileK;
  uint32_t* k_sg = k_mm + DW * kScTileK;
  uint32_t* v_yl = qt;
  uint32_t* v_mm = v_yl + kScTileK * DW;
  float* v_dv = reinterpret_cast<float*>(v_mm + kScTileK * DW);

  const T* qg = static_cast<const T*>(a.q) + pl.b * a.q_sb;
  const T* kg = static_cast<const T*>(a.k) + pl.b * a.k_sb + pl.kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + pl.b * a.v_sb + pl.kvh * a.v_sh;
  const bool vec = a.vec != 0;

  // the load sequence: per group, its K tiles then its V tiles
  struct Step {
    int g0, v, t0;
  };
  auto advance = [&](Step s) {
    const int g_end = min(s.g0 + grp, pl.kv_end);
    s.t0 += kScTileK;
    if (s.t0 >= g_end) {
      if (s.v) {
        s.g0 += grp;
        s.v = 0;
      } else {
        s.v = 1;
      }
      s.t0 = s.g0;
    }
    return s;
  };
  auto issue = [&](Step s, int stage) {
    const int nv = min(kScTileK, min(s.g0 + grp, pl.kv_end) - s.t0);
    load_rows(raw + stage * kScTileK * D, D, s.v ? vg : kg, s.v ? a.v_ss : a.k_ss, s.t0, nv,
              kScTileK, D, vec);
    cp_async_commit();
  };
  Step next{0, 0, 0};
  int step = 0;
  if (pl.kv_end > 0) {
    issue(next, 0);
    next = advance(next);
  }
  auto top = [&]() {  // wait for this step's tile; start the next one's
    cp_async_wait_all();
    __syncthreads();
    if (next.g0 < pl.kv_end) {
      issue(next, (step + 1) & 1);
      next = advance(next);
    }
  };

  // query rows quantized once
  quant_rows<T>(
      R, D, n_max,
      [&](int r) -> const T* {
        const int hh = r / kMTile, pos = pl.mt0 * kMTile + r % kMTile;
        if (hh >= pl.nh || pos < pl.lo || pos >= pl.hi) return nullptr;
        return qg + (pl.kvh * a.G + pl.hb0 + hh) * a.q_sh + (pos - pl.off) * a.q_ss;
      },
      [&](int r, int ww, float scale, uint32_t mag, uint32_t neg) {
        uint32_t xa, xd;
        x_words(mag, xa, xd);
        qa[r * DW + ww] = xa;
        qd[r * DW + ww] = xd;
        qs[r * DW + ww] = neg & 0xFEFEFEFEu;
        if (ww == 0) {
          nq_s[r] = __fmul_rn(n_stream, scale);
          m_s[r] = kMasked;
          l_s[r] = 0.f;
        }
      });

  // PV outputs: word w of rows rs + k * n_rs
  const int n_rs = kScThreads / DW;
  const int w = tid % DW, rs = tid / DW;
  float acc[kScItems][4], pv[kScItems][4];
#pragma unroll
  for (int k = 0; k < kScItems; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = pv[k][j] = 0.f;

  for (int g0 = 0; g0 < pl.kv_end; g0 += grp) {
    const int g_end = min(g0 + grp, pl.kv_end), gn = g_end - g0;
    // pass A: the group's counts
    for (int t0 = g0; t0 < g_end; t0 += kScTileK, ++step) {
      top();
      const int nt = min(kScTileK, g_end - t0);
      const T* st = raw + (step & 1) * kScTileK * D;
      quant_rows<T>(
          kScTileK, D, n_max, [&](int t) -> const T* { return st + t * D; },
          [&](int t, int ww, float scale, uint32_t mag, uint32_t neg) {
            k_yl[ww * kScTileK + t] = mag & low4;
            k_mm[ww * kScTileK + t] = __vcmpgeu4(mag, half4);
            k_sg[ww * kScTileK + t] = neg | 0x01010101u;
            if (ww == 0 && t < nt) dk_s[t0 - g0 + t] = scale;
          });
      __syncthreads();
      for (int item = tid; item < R * (kScTileK / 4); item += kScThreads) {
        const int r = item / (kScTileK / 4), kq = item - r * (kScTileK / 4);
        int c[4] = {0, 0, 0, 0};
#pragma unroll 4
        for (int wd = 0; wd < DW; ++wd) {
          const uint32_t xa = qa[r * DW + wd], xd = qd[r * DW + wd], sq = qs[r * DW + wd];
          const uint4 yl = *reinterpret_cast<const uint4*>(k_yl + wd * kScTileK + 4 * kq);
          const uint4 mm = *reinterpret_cast<const uint4*>(k_mm + wd * kScTileK + 4 * kq);
          const uint4 sg = *reinterpret_cast<const uint4*>(k_sg + wd * kScTileK + 4 * kq);
          c[0] = dp4a_us(o_word(xa, xd, yl.x, mm.x), sq ^ sg.x, c[0]);
          c[1] = dp4a_us(o_word(xa, xd, yl.y, mm.y), sq ^ sg.y, c[1]);
          c[2] = dp4a_us(o_word(xa, xd, yl.z, mm.z), sq ^ sg.z, c[2]);
          c[3] = dp4a_us(o_word(xa, xd, yl.w, mm.w), sq ^ sg.w, c[3]);
        }
        const int hh = r / kMTile, pos = pl.mt0 * kMTile + r % kMTile;
        const bool row_ok = hh < pl.nh && pos >= pl.lo && pos < pl.hi;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * kq + j, key = t0 + t;
          if (t < nt) {
            const bool ok = row_ok && (!a.causal || key <= pos);
            cnt[r * grp + key - g0] = ok ? static_cast<short>(c[j]) : kNoKey;
          }
        }
      }
    }
    __syncthreads();
    // the group's statistics, one warp a row
    for (int r = warp; r < R; r += kWarps) {
      const short* cr = cnt + r * grp;
      const float nq = nq_s[r];
      float mx = kMasked;
      for (int t = lane; t < gn; t += 32)
        if (cr[t] != kNoKey) mx = fmaxf(mx, sc_score(cr[t], nq, dk_s[t], a.scale));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f, pmax = 0.f;
      for (int t = lane; t < gn; t += 32) {
        const float p = cr[t] == kNoKey
                            ? 0.f
                            : expf(__fsub_rn(sc_score(cr[t], nq, dk_s[t], a.scale), m_new));
        sum = __fadd_rn(sum, p);
        pmax = fmaxf(pmax, p);
      }
      sum = warp_sum(sum);
      const float dp = quant_scale(warp_max(pmax), n_max);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        al_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
        dp_s[r] = dp;
        np_s[r] = __fmul_rn(n_stream, dp);
      }
    }
    // pass B: P V over the group, key by key in order
    for (int t0 = g0; t0 < g_end; t0 += kScTileK, ++step) {
      top();
      const int nt = min(kScTileK, g_end - t0);
      const T* st = raw + (step & 1) * kScTileK * D;
      quant_rows<T>(
          kScTileK, D, n_max, [&](int t) -> const T* { return st + t * D; },
          [&](int t, int ww, float scale, uint32_t mag, uint32_t neg) {
            v_yl[t * DW + ww] = mag & low4;
            v_mm[t * DW + ww] = __vcmpgeu4(mag, half4);
            float4 sdv;
            sdv.x = neg & 0xFFu ? -scale : scale;
            sdv.y = neg & 0xFF00u ? -scale : scale;
            sdv.z = neg & 0xFF0000u ? -scale : scale;
            sdv.w = neg & 0xFF000000u ? -scale : scale;
            reinterpret_cast<float4*>(v_dv)[t * DW + ww] = sdv;
          });
      // each (row, key) probability quantized over the group
      for (int i = tid; i < R * kScTileK; i += kScThreads) {
        const int r = i / kScTileK, t = i - r * kScTileK;
        const short c = t < nt ? cnt[r * grp + t0 - g0 + t] : kNoKey;
        const float p = c == kNoKey ? 0.f
                                    : expf(__fsub_rn(sc_score(c, nq_s[r], dk_s[t0 - g0 + t],
                                                              a.scale),
                                                     m_s[r]));
        const uint32_t x = static_cast<uint32_t>(quant_signed(p, dp_s[r], n_max));
        const uint32_t xa = x >> 1, xb = (x > 0 ? x - 1 : 0) >> 1;
        pwa[i] = xa * 0x01010101u;
        pwd[i] = (xa ^ xb) * 0x01010101u;
      }
      __syncthreads();
      if (rs < n_rs) {
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const uint32_t yl = v_yl[t * DW + w], mm = v_mm[t * DW + w];
          const float4 dv = reinterpret_cast<const float4*>(v_dv)[t * DW + w];
#pragma unroll
          for (int k = 0; k < kScItems; ++k) {
            const int r = rs + k * n_rs;
            if (r < R) {
              const uint32_t o = o_word(pwa[r * kScTileK + t], pwd[r * kScTileK + t], yl, mm);
              pv[k][0] = fmaf(byte_f(o, 0), dv.x, pv[k][0]);
              pv[k][1] = fmaf(byte_f(o, 1), dv.y, pv[k][1]);
              pv[k][2] = fmaf(byte_f(o, 2), dv.z, pv[k][2]);
              pv[k][3] = fmaf(byte_f(o, 3), dv.w, pv[k][3]);
            }
          }
        }
      }
    }
    // fold the group into the running output
    if (rs < n_rs) {
#pragma unroll
      for (int k = 0; k < kScItems; ++k) {
        const int r = rs + k * n_rs;
        if (r < R) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[k][j] = __fadd_rn(__fmul_rn(acc[k][j], al_s[r]), __fmul_rn(pv[k][j], np_s[r]));
            pv[k][j] = 0.f;
          }
        }
      }
    }
  }
  __syncthreads();

  if (rs < n_rs) {
    T* og = static_cast<T*>(a.out) + pl.b * a.o_sb;
#pragma unroll
    for (int k = 0; k < kScItems; ++k) {
      const int r = rs + k * n_rs;
      const int hh = r / kMTile, pos = pl.mt0 * kMTile + r % kMTile;
      if (r < R && hh < pl.nh && pos >= pl.lo && pos < pl.hi) {
        const float den = fmaxf(l_s[r], 1e-30f);
        T* orow = og + (pl.kvh * a.G + pl.hb0 + hh) * a.o_sh + (pos - pl.off) * a.o_ss;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * w + j < D) orow[4 * w + j] = from_f<T>(__fdiv_rn(acc[k][j], den));
      }
    }
  }
}

// ------------------------------------------------------------------ launches

// The largest dynamic shared memory a block may take, set once per kernel
// and device (cudaFuncSetAttribute is not repeated on every launch).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 16 && done[dev]) return 0;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 16) done[dev] = true;
  return 0;
}

template <typename Kernel>
int run(Kernel kernel, bool* done, dim3 grid, int threads, size_t bytes, const Args& a,
        void* stream) {
  const int rc = allow_smem(kernel, bytes, done);
  if (rc) return rc;
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int B, int KV, void* stream) {
  if (B <= 0 || a.Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (a.D < 1 || a.D > kMaxD || a.hb < 1 || a.mt < 1) return static_cast<int>(cudaErrorInvalidValue);
  // m-tiles of the rows: exact for a scalar offset, the worst case over
  // every offset for one read on the device (flash_attention.py::plan)
  const int tiles = a.q_off ? (a.Sq + kMTile - 2) / kMTile + 1
                            : (a.q_offset + a.Sq + kMTile - 1) / kMTile - a.q_offset / kMTile;
  const int n_hg = (a.G + a.hb - 1) / a.hb;
  dim3 grid((tiles + a.mt - 1) / a.mt, KV * n_hg, B);
  const size_t esz = sizeof(T);
  if (a.sc_bits > 0) {
    if (kMTile * a.hb > kScItems * (kScThreads / ((a.D + 3) / 4)))
      return static_cast<int>(cudaErrorInvalidValue);
    static bool done[16];
    return run(flash_fwd_sc_kernel<T>, done, grid, kScThreads,
               smem_sc(a.hb, a.D, a.group, static_cast<int>(esz)), a, stream);
  }
  if constexpr (sizeof(T) == 2) {
    if (a.hb * a.mt > kMmaMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 32 * a.hb * a.mt;
    const size_t bytes = smem_mma(a.hb, a.mt, a.D);
    if (a.D <= 64) {
      static bool done[16];
      return run(flash_fwd_mma_kernel<64>, done, grid, threads, bytes, a, stream);
    }
    static bool done[16];
    return run(flash_fwd_mma_kernel<128>, done, grid, threads, bytes, a, stream);
  } else {
    static bool done[16];
    return run(flash_fwd_f32_kernel, done, grid, kThreads, smem_f32(a.hb, a.D), a, stream);
  }
}

}  // namespace

// path: 0 float f32, 1 float bf16 (mma), 2 SC
extern "C" long long flash_attention_smem_bytes(int path, int esz, int hb, int mt, int D,
                                                int group) {
  if (path == 0) return static_cast<long long>(smem_f32(hb, D));
  if (path == 1) return static_cast<long long>(smem_mma(hb, mt, D));
  return static_cast<long long>(smem_sc(hb, D, group, esz));
}

#define FLASH_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, int B, int H,  \
                      int KV, int Sq, int Skv, int D, int G, int hb, int mt, long long q_sb, \
                      long long q_sh, long long q_ss, long long k_sb, long long k_sh,        \
                      long long k_ss, long long v_sb, long long v_sh, long long v_ss,        \
                      long long o_sb, long long o_sh, long long o_ss, int q_offset,          \
                      const void* q_offset_dev, int causal, int group, int sc_bits, int vec, \
                      float scale, void* stream) {                                           \
    (void)H;                                                                                 \
    const Args a{q,    k,    v,    out,  Sq,   Skv,  D,        G,      hb,      mt,         \
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,     v_sh,   v_ss,    o_sb,       \
                 o_sh, o_ss, q_offset, causal, group, sc_bits, vec, scale,                   \
                 static_cast<const int*>(q_offset_dev)};                                     \
    return launch<T>(a, B, KV, stream);                                                      \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
