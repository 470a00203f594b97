// Device helpers shared by the port's two attention kernels
// (paged_attention.cu, flash_attention.cu): float32 loads and stores, warp
// reductions, and the four steps of SC attention — the __device__
// counterparts of kernels/sc_attention.py (sc_quant_rows, sc_popcount,
// sc_scores, sc_pv), which port repro/kernels/sc_attention.py:66-136.
//
// The quantization repeats the plain version's float32 operations one for
// one: scale = max(absmax, 1e-12) / n_max as one IEEE division (never a
// multiply by a reciprocal), mag = clip(rint(|v| / scale), 0, n_max) with a
// true division rounded half to even, sign = -1 where v < 0 (so -0.0 is +1).
// Products and sums that the plain version rounds separately use __fmul_rn
// and __fadd_rn, which the compiler never contracts into an FMA. Build
// without --use_fast_math: a division or rounding that moves one ulp can
// move a magnitude one step, which is a whole quantization step of output.
//
// The paged kernel stores a quantized row in place as signed magnitudes
// (sign * mag) in the float slots (__int_as_float): a zero magnitude
// contributes nothing, so its sign is not needed. Int32 counts are exact:
// |count| <= D * (N - 1). The flash kernel keeps packed 8-bit magnitudes
// instead and takes only the scalar steps here (quant_scale, quant_signed,
// sc_score, the warp reductions).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace sc_attn {

constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A fixed butterfly over the 32 lanes: the same inputs in the same lanes
// give the same bits.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// scale = max(absmax, 1e-12) / n_max
__device__ __forceinline__ float quant_scale(float absmax, int n_max) {
  return __fdiv_rn(fmaxf(absmax, 1e-12f), static_cast<float>(n_max));
}

// sign(v) * clip(rint(|v| / scale), 0, n_max)
__device__ __forceinline__ int quant_signed(float v, float scale, int n_max) {
  const float r = rintf(__fdiv_rn(fabsf(v), scale));
  const int mag = static_cast<int>(fminf(fmaxf(r, 0.f), static_cast<float>(n_max)));
  return v < 0.f ? -mag : mag;
}

// Quantize one row of n floats in place, cooperatively by one warp (every
// lane must call it); returns the row's scale to every lane.
__device__ __forceinline__ float quant_row_warp(float* row, int n, int n_max) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(row[i]));
  const float scale = quant_scale(warp_max(amax), n_max);
  for (int i = lane; i < n; i += 32) row[i] = __int_as_float(quant_signed(row[i], scale, n_max));
  return scale;
}

// popcount(X_u AND Y_u) in closed form: msb * floor(x / 2)
// + max(min(y_low, floor((x - msb) / 2)), 0). x is the Q or probability
// magnitude, y the K or V magnitude (O is not symmetric). The arithmetic
// shift floors x - msb = -1 to -1, which the clamp zeroes: O(0, y) = 0.
__device__ __forceinline__ int popcount_closed(int x, int y, int half) {
  const int msb = y >= half ? 1 : 0;
  const int y_low = y - msb * half;
  return msb * (x >> 1) + max(min(y_low, (x - msb) >> 1), 0);
}

// s_x * s_y * O(|x|, |y|) of two signed magnitudes (stored as float bits)
__device__ __forceinline__ int signed_term(float x, float y, int half) {
  const int sx = __float_as_int(x), sy = __float_as_int(y);
  const int o = popcount_closed(abs(sx), abs(sy), half);
  return (sx ^ sy) < 0 ? -o : o;
}

// SC score: count * ((N * dq) * dk) * scale, rounded as the plain version
// rounds it; nq = N * dq is computed once per query row.
__device__ __forceinline__ float sc_score(int count, float nq, float dk, float scale) {
  return __fmul_rn(__fmul_rn(static_cast<float>(count), __fmul_rn(nq, dk)), scale);
}

// One SC PV term, dequantized by the value row's scale.
__device__ __forceinline__ float sc_pv_term(float p, float v, float dv, int half) {
  return __fmul_rn(static_cast<float>(signed_term(p, v, half)), dv);
}

}  // namespace sc_attn
