// The paper's bit-parallel multiplier on Hopper: for each element, the
// thermometer stream of x ANDed with the correlation-encoded stream of y,
// 32 stream bits per word, popcounted and summed over the 2^B / 32 words.
//
// Replaces the Pallas TPU kernel repro/kernels/sc_bitops.py::sc_stream_mul_pallas
// (body _kernel), which rebuilt both words per lane with a SWAR popcount over
// (block_rows, 128) int32 tiles. It exists to prove on the device that the
// 3-op closed form SC-GEMM and SC attention compute is the literal datapath,
// so every word of both streams is a 32-bit word, ANDed and popcounted: no
// word is skipped, and the two streams' masks are never merged.
//
// What bounds it: one popcount per word, and the H100 issues __popc at 16
// lanes a clock per SM against 64 for the other 32-bit integer operations.
// Memory is 12 bytes a pair (two int32 in, one out) against 2^B / 32 words,
// so instruction issue bounds it: a word may cost 4 ALU instructions besides
// its popcount before the popcounts stop being the limit. The first port
// spent about 18 (two clamps, two masks of compare / select / min / shift /
// subtract, a branch on msb, a runtime loop counter) and ran at 4.45x the
// popcount bound. This design spends 3.75 ALU instructions a word and one
// shared-memory load, with no branch, and keeps 4 elements a thread so that
// their popcount chains overlap.
//
// Words, for word w (stream positions 32w+1 .. 32w+32 at bits j = 0..31), in
// chunks of kChunk words from word base / 32 on (base = 32 x the chunk's
// first word), unrolled, so that 32w - base is an immediate:
//   thermometer:  ones at positions i <= x, i.e. the low clamp(x - 32w, 0, 32)
//                 bits: the B-to-TCU decoder as a ROM in shared memory. Each
//                 block writes the words T(t) = low clamp(t, 0, 32) bits for
//                 t = -kLead .. kTop once; per chunk an element points at
//                 T(c), c = clamp(x - base, 0, kTop) (one instruction), and
//                 word w is the load at the immediate offset -(32w - base).
//                 Inside a chunk that equals T(x - 32w): c clamps only where
//                 every word of the chunk is all ones or all zeros anyway.
//                 The clamp stops at kTop = kSpan + 33, not + 32, so the two
//                 words most lanes read at the chunk's word i (T(-32i) and
//                 T(kTop - 32i)) sit in different shared-memory banks.
//   correlation:  with msb = y >= N/2 and y_low = y mod N/2, bit j of word w sits
//                 at k = 16w + j/2 + 1:
//                   odd j  (position 2k):   msb | (k <= y_low)
//                   even j (position 2k-1): msb & (k >= 2) & (k <= y_low + 1)
//                 so, with ys = 2 y_low + 2 msb, Q = msb ? ~0 : 0xAAAAAAAA and
//                 P = msb ? 0xAAAAAAAA : 0 (all per element, once), the word is
//                 P | funnelshift_lc(Q, 0, max(ys - 32w, 0)): the top s bits
//                 of Q moved to the bottom (s even, so Q's parity is kept).
//                 The funnel shift clamps its shift at 32 (a full word); the
//                 max (one DPX add-and-max) keeps a negative amount from
//                 reading as a huge unsigned one. Bit 0 of word 0 (k = 1 at an
//                 odd position) is never set: the first chunk clears it, so
//                 no word carries a branch.
//   per word:     the ROM load, the add-and-max and the funnel shift, one
//                 three-input logic op for T & (P | S), the popcount, and
//                 half a three-input add for the sum.
//
// Layout: a thread takes 4 consecutive elements (one 16-byte load of each
// operand, one 16-byte store), a block block_rows * 32 threads: the TPU
// tile's block_rows rows of 128 elements. The thread that straddles the
// ragged end loads and stores element by element. B = 5..16 each have an
// instance with the word count fixed at compile time; B = 17..30 run the
// same chunk loop with its trip count read at run time.
// Integers only: every value in this source has an integer type (the port's
// form of the JAX package's integer-only audit, repro/analysis/contracts.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;             // elements a thread
constexpr int kChunk = 16;          // words a chunk (unrolled)
constexpr int kSpan = 32 * kChunk;  // stream positions a chunk covers
constexpr int kLead = kSpan - 32;   // lowest t a chunk reads: T(0 - 32w)
constexpr int kTop = kSpan + 33;    // clamp of x - base: T(kTop) is in bank 1
constexpr int kRom = kLead + kTop + 1;  // ROM words, t = -kLead .. kTop
constexpr int kMaxFixedBits = 16;   // widest instance with B fixed
constexpr unsigned kOddBits = 0xAAAAAAAAu;  // bits j = 1, 3, ..., 31

// what one element's words are built from
struct Operands {
  int x;        // thermometer level
  int ys;       // 2 y_low + 2 msb: the correlation word's shift before 32w
  unsigned p;   // bits every correlation word has (the odd ones when msb)
  unsigned q;   // the pattern shifted in (all bits when msb, odd bits if not)
};

__device__ __forceinline__ Operands prepare(int x, int y, int half) {
  const bool msb = y >= half;
  return {x, 2 * (msb ? y - half : y) + (msb ? 2 : 0),
          msb ? kOddBits : 0u, msb ? 0xFFFFFFFFu : kOddBits};
}

// T(t): the low clamp(t, 0, 32) bits
__device__ __forceinline__ unsigned thermo_rom_word(int t) {
  return __funnelshift_lc(0xFFFFFFFFu, 0u, static_cast<unsigned>(max(t, 0)));
}

// the correlation word at offset `off` = 32w - base, from ys - base
__device__ __forceinline__ unsigned corr_word(int yb, unsigned p, unsigned q,
                                              int off) {
  return p | __funnelshift_lc(q, 0u,
                              static_cast<unsigned>(__viaddmax_s32(yb, -off, 0)));
}

// kWords words from word base / 32 on, for each of the thread's elements;
// kFirst clears bit 0 of word 0's correlation word
template <int kWords, bool kFirst>
__device__ __forceinline__ void chunk(const unsigned* rom,
                                      const Operands (&e)[kVec], int base,
                                      int (&acc)[kVec]) {
  const unsigned* tx[kVec];   // T(clamp(x - base, 0, kTop))
  int yb[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    tx[v] = rom + kLead + __viaddmin_s32_relu(e[v].x, -base, kTop);
    yb[v] = e[v].ys - base;
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const unsigned xw = tx[v][-32 * j];
      unsigned yw = corr_word(yb[v], e[v].p, e[v].q, 32 * j);
      if (kFirst && j == 0) yw &= ~1u;
      acc[v] += __popc(xw & yw);
    }
  }
}

// kBits = 5..16: B fixed at compile time; 0: B = bits, read at run time.
template <int kBits>
__global__ void __launch_bounds__(256)
sc_stream_mul_kernel(const int* __restrict__ x, const int* __restrict__ y,
                     int* __restrict__ out, long long n, int bits) {
  constexpr int kFixedWords = kBits ? (1 << kBits) / 32 : kChunk;
  constexpr int kWords = kFixedWords < kChunk ? kFixedWords : kChunk;
  __shared__ unsigned rom[kRom];
  for (int k = threadIdx.x; k < kRom; k += blockDim.x)
    rom[k] = thermo_rom_word(k - kLead);
  __syncthreads();
  const int stream_bits = 1 << (kBits ? kBits : bits);  // 32 x the words
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (i0 >= n) return;
  const bool whole = i0 + kVec <= n;
  int xv[kVec], yv[kVec];
  if (whole) {   // 16-byte aligned: the wrapper passes aligned operands
    const int4 a = *reinterpret_cast<const int4*>(x + i0);
    const int4 c = *reinterpret_cast<const int4*>(y + i0);
    xv[0] = a.x; xv[1] = a.y; xv[2] = a.z; xv[3] = a.w;
    yv[0] = c.x; yv[1] = c.y; yv[2] = c.z; yv[3] = c.w;
  } else {       // the ragged tail
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      xv[v] = i0 + v < n ? x[i0 + v] : 0;
      yv[v] = i0 + v < n ? y[i0 + v] : 0;
    }
  }
  Operands e[kVec];
  int acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    e[v] = prepare(xv[v], yv[v], stream_bits / 2);
    acc[v] = 0;
  }
  chunk<kWords, true>(rom, e, 0, acc);
#pragma unroll 1
  for (int base = 32 * kWords; base < stream_bits; base += 32 * kWords)
    chunk<kWords, false>(rom, e, base, acc);
  if (whole) {
    *reinterpret_cast<int4*>(out + i0) = make_int4(acc[0], acc[1], acc[2],
                                                   acc[3]);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (i0 + v < n) out[i0 + v] = acc[v];
  }
}

template <int kBits>
void launch(const int* x, const int* y, int* out, long long n, int bits,
            unsigned blocks, int threads, cudaStream_t stream) {
  sc_stream_mul_kernel<kBits><<<blocks, threads, 0, stream>>>(x, y, out, n,
                                                              bits);
}

template <int kBits>
bool launch_fixed(int bits, const int* x, const int* y, int* out, long long n,
                  unsigned blocks, int threads, cudaStream_t stream) {
  if (bits == kBits) {
    launch<kBits>(x, y, out, n, bits, blocks, threads, stream);
    return true;
  }
  if constexpr (kBits < kMaxFixedBits) {
    return launch_fixed<kBits + 1>(bits, x, y, out, n, blocks, threads,
                                   stream);
  }
  return false;
}

}  // namespace

// x, y, out: n int32 on the device, each 16-byte aligned; 5 <= bits <= 30;
// block_rows rows of 128 elements per block (1..8), 4 elements a thread.
// Returns the launch's cudaError_t.
extern "C" int sc_stream_mul(const void* x, const void* y, void* out,
                             long long n, int bits, int block_rows,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int threads = 128 / kVec * block_rows;
  const long long per_block = static_cast<long long>(threads) * kVec;
  const auto blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  const auto* xp = static_cast<const int*>(x);
  const auto* yp = static_cast<const int*>(y);
  auto* op = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!launch_fixed<5>(bits, xp, yp, op, n, blocks, threads, s))
    launch<0>(xp, yp, op, n, bits, blocks, threads, s);
  return static_cast<int>(cudaGetLastError());
}
