// SC-GEMM counts on Hopper: the signed stochastic-multiplier GEMM
//
//     counts[m, n] = sum_k s_x s_y O(x, y)
//     O(x, y)      = msb_y * floor(x / 2) + clamp(min(y_low, floor((x - msb_y) / 2)), 0)
//
// Replaces the Pallas TPU kernel repro/kernels/sc_matmul.py::sc_matmul_counts_pallas
// (body _kernel), which split O into an MXU matmul term and a VPU residual.
// Here the whole closed form runs on the CUDA cores in int32: the residual's
// clamp(min(.)) is not a product, so it cannot go to the tensor cores, and the
// matmul term is computed in the same loop rather than in a separate GEMM.
//
// Operands arrive as signed planes: a[m, k] = s_x * x, b[k, n] = s_y * y
// (int16 for bits <= 15, int32 above). A zero magnitude contributes
// O = 0 whatever its sign, so the packing loses nothing, and it halves the
// bytes of the int8 sign + int32 magnitude planes the TPU kernel reads.
//
// What bounds it: about eight integer operations per (m, k, n) triple against
// two bytes of B per (k, n), so at the decode shapes (M = 4) it is bound by
// integer issue, not by memory. The design keeps each B element's decode
// (|y|, msb, y_low, sign) out of the row loop — one decode serves BM rows — and
// keeps the integer accumulators in registers. No tensor-core path exists for
// the residual; a GEMV-shaped variant and B-plane caching are later work.
//
// Layout: one block per (32-column, BM-row) output tile. Lane = column, so a
// warp reads 32 consecutive B elements per k; the 8 warps of the block walk K
// with stride 8 (warp w takes k = w, w + 8, ...) and their int32 partial sums
// meet in shared memory at the end. Nothing carries across blocks. The kernel
// masks the ragged M, N and K edges itself. Counts are exact integers; the
// caller guarantees |counts| < 2^24 so the final float32 cast is exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // output columns per block, one per lane
constexpr int kSplit = 8;   // warps per block, interleaved over K

template <typename T, int BM>
__global__ void __launch_bounds__(kCols * kSplit)
sc_counts_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ out, int M, int N, int K, int half) {
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int n = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * BM;
  const bool n_ok = n < N;

  int acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0;

  for (int k = warp; k < K; k += kSplit) {
    const int yv = n_ok ? static_cast<int>(b[static_cast<size_t>(k) * N + n]) : 0;
    const int y = abs(yv);
    const int msb = y >= half ? 1 : 0;
    const int y_low = y - msb * half;
    const bool y_neg = yv < 0;
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const int m = m0 + i;
      // every lane of the warp reads the same a[m, k]: one broadcast load
      const int xv = m < M ? static_cast<int>(a[static_cast<size_t>(m) * K + k]) : 0;
      const int x = abs(xv);
      // floor((x - msb) / 2) by arithmetic shift: x - msb can be -1, where
      // C's '/' would truncate to 0 but the shift floors to -1. The clamp
      // below zeroes both -1 and 0, so either would do; the shift is the
      // floor the closed form states.
      const int t = (x - msb) >> 1;
      const int r = max(min(y_low, t), 0);
      const int o = msb * (x >> 1) + r;
      acc[i] += ((xv < 0) != y_neg) ? -o : o;
    }
  }

  __shared__ int part[kSplit][BM][kCols];
#pragma unroll
  for (int i = 0; i < BM; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  if (warp == 0 && n_ok) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const int m = m0 + i;
      if (m >= M) break;
      int s = 0;
#pragma unroll
      for (int w = 0; w < kSplit; ++w) s += part[w][i][lane];
      out[static_cast<size_t>(m) * N + n] = static_cast<float>(s);  // one cast, at the end
    }
  }
}

template <typename T, int BM>
void launch(const void* a, const void* b, void* out, int M, int N, int K,
            int half, cudaStream_t stream) {
  dim3 block(kCols, kSplit);
  dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  sc_counts_kernel<T, BM><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), M, N, K, half);
}

// Rows per block: the smallest of 1, 2, 4, 8, 16 covering M (capped at 16),
// so decode calls (M = capacity) waste no rows.
template <typename T>
int dispatch(const void* a, const void* b, void* out, int M, int N, int K,
             int bits, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const int half = (1 << bits) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) launch<T, 1>(a, b, out, M, N, K, half, s);
  else if (M <= 2) launch<T, 2>(a, b, out, M, N, K, half, s);
  else if (M <= 4) launch<T, 4>(a, b, out, M, N, K, half, s);
  else if (M <= 8) launch<T, 8>(a, b, out, M, N, K, half, s);
  else launch<T, 16>(a, b, out, M, N, K, half, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sc_matmul_counts_i16(const void* a, const void* b, void* out,
                                    int M, int N, int K, int bits,
                                    void* stream) {
  return dispatch<int16_t>(a, b, out, M, N, K, bits, stream);
}

extern "C" int sc_matmul_counts_i32(const void* a, const void* b, void* out,
                                    int M, int N, int K, int bits,
                                    void* stream) {
  return dispatch<int32_t>(a, b, out, M, N, K, bits, stream);
}
