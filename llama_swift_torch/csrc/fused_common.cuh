// Device code of the fused decode kernels, shared by fused_layer.cu (the
// whole-stack kernel) and fused_blocks.cu (one layer's attention block and
// FFN block): the head dim, the Q4_0 weight and published-activation
// records, the cache element conversion, the norm element, the SwiGLU
// element and the occupancy of a cooperative launch.  Each kernel keeps
// its own norm statistics, quantization, staging and product loop, sized
// for its blocks.
#pragma once

#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "q4_common.cuh"

namespace {

constexpr int DH = 128;  // head dim: one thread per dim in attention

struct Weight {
  const uint8_t* qs;  // [L, out, in/2]
  const float* d;     // [L, out, in/32]
};

// An activation quantized across the grid and published in global memory.
struct Staged {
  int8_t* xq;  // [max_in] codes, de-interleaved per 32-block
  int* qsum;   // [max_in / 32] their sums per 32-block
  float* dx;   // and their scales
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

struct NormStats {
  float mean, den;  // norm(x)_i = (x_i - mean) / den
};

__device__ __forceinline__ float norm_elem(float xi, float w, NormStats ns) {
  return __fmul_rn(__fdiv_rn(__fsub_rn(xi, ns.mean), ns.den), w);
}

// silu(g1) * g3, the JAX formula g1 / (1 + exp(-g1)) * g3 (expf, not __expf)
__device__ __forceinline__ float swiglu(float g1, float g3) {
  return __fmul_rn(__fdiv_rn(g1, __fadd_rn(1.0f, expf(-g1))), g3);
}

// Blocks of one cooperative launch of `kernel` (`threads` threads, `smem`
// bytes of shared memory a block): as many as the occupancy calculator
// says are resident, at most `max_per_sm` an SM; or a negative cudaError.
template <typename K>
int coop_blocks(K kernel, size_t smem, int threads, int max_per_sm) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (!coop) return -static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return (per_sm < max_per_sm ? per_sm : max_per_sm) * sms;
}

}  // namespace
