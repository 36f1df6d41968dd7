// Q4_0 -> dense dequantization for the prefill matmul.
//
// Replaces the TPU kernels `_dequant_kernel_q4_0` and
// `_dequant_kernel_q4_0_stacked` (llama_swift_tpu/ops/q4_dequant_pallas.py,
// entry points q4v_dequant_pm and q4v_dequant_pm_stacked, reached through
// q4_dense_matmul_pm):
//
//   dense[o, 32b + i] = (n[o, 32b + i] - 8) * d[o, b]
//
// written in logical column order (the TPU's phase-major order worked around
// a Mosaic lane-reshape limit and has no reason to exist here).  The product
// is one f32 rounding, then round-to-nearest-even to bf16 when asked, so the
// result is bit-identical to the plain version.  The matmul that follows is
// torch.matmul, as the JAX package leaves it to XLA.
//
// What bounds it on the H100: device-memory bandwidth — 0.625 bytes read and
// 2 (bf16) or 4 (f32) bytes written per weight, one multiply each.
//
// Design: one thread per 32-element block: one 16-byte load of nibbles, one
// scale, 32 products, written as 16-byte vector stores (4 for bf16, 8 for
// f32).  Neighbouring threads take neighbouring blocks, so a warp reads 512
// contiguous bytes and writes one contiguous 2 or 4 KiB span.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162 p;
  p = __floats2bfloat162_rn(v[0], v[1]); u.x = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[2], v[3]); u.y = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[4], v[5]); u.z = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[6], v[7]); u.w = *reinterpret_cast<uint32_t*>(&p);
  *reinterpret_cast<uint4*>(dst) = u;
}

// qs [n_blocks][16] u8, d [n_blocks] f32 -> out [n_blocks][32]
template <typename T>
__global__ void q4_0_dequant_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ d,
                                    T* __restrict__ out, long long n_blocks) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(qs) + b);
  const float s = __ldg(d + b);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  T* dst = out + b * 32;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float v[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // byte t of word g holds elements 8g+2t, 8g+2t+1
      const uint32_t byte = (words[g] >> (8 * t)) & 0xFFu;
      v[2 * t] = __fmul_rn(static_cast<float>(static_cast<int>(byte & 0xFu) - 8), s);
      v[2 * t + 1] = __fmul_rn(static_cast<float>(static_cast<int>(byte >> 4) - 8), s);
    }
    store8(dst + 8 * g, v);
  }
}

}  // namespace

extern "C" int q4_0_dequant(const void* qs, const void* d, void* out, long long n_blocks,
                            int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((n_blocks + threads - 1) / threads);
  if (is_bf16)
    q4_0_dequant_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const uint8_t*>(qs), static_cast<const float*>(d),
        static_cast<__nv_bfloat16*>(out), n_blocks);
  else
    q4_0_dequant_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const uint8_t*>(qs), static_cast<const float*>(d),
        static_cast<float*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}
