// The paper's bit-parallel multiplier on Hopper: for each element, the
// thermometer stream of x ANDed with the correlation-encoded stream of y,
// 32 stream bits per word, popcounted and summed over the 2^B / 32 words.
//
// Replaces the Pallas TPU kernel repro/kernels/sc_bitops.py::sc_stream_mul_pallas
// (body _kernel), which rebuilt both words per lane with a SWAR popcount over
// (block_rows, 128) int32 tiles. It exists to prove on the device that the
// 3-op closed form SC-GEMM and SC attention compute is the literal datapath.
//
// Layout: one thread per element over the flat int32 operands; a block holds
// block_rows * 128 threads (the TPU tile's rows of 128 lanes). The ragged tail
// is masked here, so the wrapper pads nothing. Nothing carries across threads.
//
// Words, for word w (stream positions 32w+1 .. 32w+32 at bits j = 0..31):
//   thermometer:  ones at positions i <= x, i.e. the low clamp(x - 32w, 0, 32)
//                 bits. (1u << 32) is undefined in C as in XLA, so the shift is
//                 clamped to 31 and a full word taken by a select.
//   correlation:  with msb = y >= N/2 and y_low = y mod N/2, bit j of word w sits
//                 at k = 16w + i + 1 where i = j / 2:
//                   odd j  (position 2k):   msb | (k <= y_low)
//                   even j (position 2k-1): msb & (k >= 2) & (k <= y_low + 1)
//                 so the odd lanes hold the low clamp(y_low - 16w, 0, 16) pairs
//                 (all of them when msb), the even lanes the low
//                 clamp(y_low - 16w + 1, 0, 16) pairs when msb, less bit 0 of
//                 word 0 (k = 1). A few mask operations in place of the TPU
//                 kernel's 32-step bit loop.
//   popcount:     the hardware __popc in place of the SWAR sequence.
//
// What bounds it: per element 2^B / 32 words of about 15 integer operations and
// one popcount, against 12 bytes moved (two int32 in, one out). At the paper's
// B = 8 that is 8 words per 12 bytes and at B = 12 128: integer issue, not
// memory, bounds it, so the design keeps everything in registers and issues
// only the masks and the popcount per word. Integers only: every value in this
// source has an integer type (the port's form of the JAX package's integer-only
// audit, repro/analysis/contracts.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kOddBits = 0xAAAAAAAAu;   // bits j = 1, 3, ..., 31
constexpr unsigned kEvenBits = 0x55555555u;  // bits j = 0, 2, ..., 30

// the low n bits set, n in [0, 32]
__device__ __forceinline__ unsigned low_bits(int n) {
  return n >= 32 ? 0xFFFFFFFFu : (1u << min(n, 31)) - 1u;
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return max(lo, min(v, hi));
}

__global__ void sc_stream_mul_kernel(const int* __restrict__ x,
                                     const int* __restrict__ y,
                                     int* __restrict__ out, long long n,
                                     int n_words, int half) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;  // the ragged tail
  const int xv = x[i];
  const int yv = y[i];
  const bool msb = yv >= half;
  const int y_low = msb ? yv - half : yv;
  int acc = 0;
  for (int w = 0; w < n_words; ++w) {
    const unsigned xw = low_bits(clamp_int(xv - 32 * w, 0, 32));
    const int base = y_low - 16 * w;
    unsigned yw;
    if (msb) {
      unsigned even = kEvenBits & low_bits(2 * clamp_int(base + 1, 0, 16));
      if (w == 0) even &= ~1u;  // k = 1 is never set at an odd position
      yw = kOddBits | even;
    } else {
      yw = kOddBits & low_bits(2 * clamp_int(base, 0, 16));
    }
    acc += __popc(xw & yw);
  }
  out[i] = acc;
}

}  // namespace

// x, y, out: n int32 on the device; bits >= 5; block_rows rows of 128 lanes
// per block (1..8). Returns the launch's cudaError_t.
extern "C" int sc_stream_mul(const void* x, const void* y, void* out,
                             long long n, int bits, int block_rows,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 128 * block_rows;
  const long long blocks = (n + threads - 1) / threads;
  sc_stream_mul_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(y),
      static_cast<int*>(out), n, (1 << bits) / 32, (1 << bits) / 2);
  return static_cast<int>(cudaGetLastError());
}
