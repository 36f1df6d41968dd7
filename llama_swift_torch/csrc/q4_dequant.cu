// Q4_0 and Q4_1 -> dense dequantization for the prefill matmul (Q4_1: for
// every product of more than one row).
//
// Replaces the TPU kernels `_dequant_kernel_q4_0` / `_dequant_kernel_q4_0_stacked`
// and `_dequant_kernel_q4_1` / `_dequant_kernel_q4_1_stacked`
// (llama_swift_tpu/ops/q4_dequant_pallas.py, entry points q4v_dequant_pm and
// q4v_dequant_pm_stacked, reached through q4_dense_matmul_pm):
//
//   Q4_0: dense[o, 32b + i] = (n[o, 32b + i] - 8) * d[o, b]
//   Q4_1: dense[o, 32b + i] = n[o, 32b + i] * d[o, b] + m[o, b]
//
// written in logical column order (the TPU's phase-major order worked around
// a Mosaic lane-reshape limit and has no reason to exist here).  Q4_0 rounds
// one f32 product, Q4_1 a product and then a sum (explicit _rn intrinsics:
// nvcc would contract them into one FMA), then round-to-nearest-even to bf16
// when asked, so the result is bit-identical to the plain version.  The
// matmul that follows is torch.matmul, as the JAX package leaves it to XLA.
//
// What bounds it on the H100: device-memory bandwidth -- 0.625 (Q4_0) or
// 0.75 (Q4_1) bytes read and 2 (bf16) or 4 (f32) bytes written per weight,
// one or two operations each.
//
// Design: one thread per 32-element block: one 16-byte load of nibbles, one
// 4-byte scale (Q4_0) or one 8-byte (d, m) pair (Q4_1), 32 values, written as
// 16-byte vector stores (4 for bf16, 8 for f32).  Neighbouring threads take
// neighbouring blocks, so a warp reads 512 contiguous bytes and writes one
// contiguous 2 or 4 KiB span.
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

// Q4_0 blocks: a scale per block
struct Q40 {
  float d;
  __device__ __forceinline__ float operator()(uint32_t n) const {
    return __fmul_rn(static_cast<float>(static_cast<int>(n) - 8), d);
  }
};

// Q4_1 blocks: a (delta, min) pair per block
struct Q41 {
  float2 dm;
  __device__ __forceinline__ float operator()(uint32_t n) const {
    return __fadd_rn(__fmul_rn(static_cast<float>(n), dm.x), dm.y);
  }
};

// qs [n_blocks][16] u8, scales [n_blocks] (float for Q40, float2 for Q41)
// -> out [n_blocks][32]
template <typename T, typename Kind, typename Scale>
__global__ void dequant_kernel(const uint8_t* __restrict__ qs, const Scale* __restrict__ scales,
                               T* __restrict__ out, long long n_blocks) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(qs) + b);
  const Kind f{__ldg(scales + b)};
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  T* dst = out + b * 32;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float v[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // byte t of word g holds elements 8g+2t, 8g+2t+1
      const uint32_t byte = (words[g] >> (8 * t)) & 0xFFu;
      v[2 * t] = f(byte & 0xFu);
      v[2 * t + 1] = f(byte >> 4);
    }
    store8(dst + 8 * g, v);
  }
}

template <typename Kind, typename Scale>
int launch(const void* qs, const void* scales, void* out, long long n_blocks, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((n_blocks + threads - 1) / threads);
  const uint8_t* q = static_cast<const uint8_t*>(qs);
  const Scale* sc = static_cast<const Scale*>(scales);
  if (is_bf16)
    dequant_kernel<__nv_bfloat16, Kind><<<grid, threads, 0, s>>>(q, sc, static_cast<__nv_bfloat16*>(out), n_blocks);
  else
    dequant_kernel<float, Kind><<<grid, threads, 0, s>>>(q, sc, static_cast<float*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qs [n_blocks][16] u8, d [n_blocks] f32
extern "C" int q4_0_dequant(const void* qs, const void* d, void* out, long long n_blocks,
                            int is_bf16, void* stream) {
  return launch<Q40, float>(qs, d, out, n_blocks, is_bf16, stream);
}

// qs [n_blocks][16] u8, dm [n_blocks][2] f32 (delta, min)
extern "C" int q4_1_dequant(const void* qs, const void* dm, void* out, long long n_blocks,
                            int is_bf16, void* stream) {
  return launch<Q41, float2>(qs, dm, out, n_blocks, is_bf16, stream);
}
