// Device helpers of the Q4 products, shared by q4_matvec.cu and
// fused_layer.cu: warp reductions, the Q4_0 activation quantizer and the
// int4 x int4 block dot.
//
// Activation quantization (quantize_activations_q4_0_int, ggml.c:568-601):
// per 32-block d = amax/7, inv = 1/d, q = trunc(x*inv +- 0.5), half away
// from zero.  The explicit _rn intrinsics keep nvcc from contracting
// x*inv + 0.5 into one FMA, which rounds ties differently.  q is stored
// de-interleaved per block so that it lines up with the nibble bytes:
// bytes 0..15 hold the even elements of each 8-group, bytes 16..31 the odd
// ones.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QK = 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp quantizes one 32-block: lane holds element `lane` of the block
// in v; writes the block's 32 de-interleaved codes to xq_block, and its
// sum of codes and scale to *qsum and *dx.
__device__ __forceinline__ void quantize_block_warp(float v, int lane, int8_t* xq_block, int* qsum,
                                                    float* dx) {
  const float amax = warp_max(fabsf(v));
  const float d = __fdiv_rn(amax, 7.0f);
  const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
  const float q = truncf(__fadd_rn(__fmul_rn(v, inv), v >= 0.0f ? 0.5f : -0.5f));
  const int qi = static_cast<int>(q);
  // element e = 8g + 2t + parity  ->  byte (parity*4 + g)*4 + t
  const int g = lane >> 3, r = lane & 7;
  xq_block[((r & 1) * 4 + g) * 4 + (r >> 1)] = static_cast<int8_t>(qi);
  const int s = warp_sum_i(qi);
  if (lane == 0) {
    *qsum = s;
    *dx = d;
  }
}

__device__ __forceinline__ int dot_word(uint32_t w, uint32_t qe, uint32_t qo, int acc) {
  acc = __dp4a(static_cast<int>(w & 0x0F0F0F0Fu), static_cast<int>(qe), acc);
  return __dp4a(static_cast<int>((w >> 4) & 0x0F0F0F0Fu), static_cast<int>(qo), acc);
}

// Exact integer dot of one weight block (16 nibble bytes) with its 32
// de-interleaved activation codes (qe: even elements, qo: odd ones), the
// -8 offset removed as 8 * sum(q) (qsum = 0 leaves sum(n * q)).
__device__ __forceinline__ int block_dot(uint4 w, uint4 qe, uint4 qo, int qsum) {
  int s = dot_word(w.x, qe.x, qo.x, 0);
  s = dot_word(w.y, qe.y, qo.y, s);
  s = dot_word(w.z, qe.z, qo.z, s);
  s = dot_word(w.w, qe.w, qo.w, s);
  return s - 8 * qsum;
}

}  // namespace
