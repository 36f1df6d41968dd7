// Device code of the fused decode kernels, shared by fused_layer.cu (the
// whole-stack kernel) and fused_blocks.cu (one layer's attention block and
// FFN block): the norm statistics, the grid-wide 4-bit quantization of an
// activation and its staging in shared memory, the Q4_0 product loop (a
// warp per output row), the SwiGLU element, and the occupancy of a
// cooperative launch.  fused_layer.cu's design note says how a phase uses
// them.
#pragma once

#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "q4_common.cuh"

namespace {

constexpr int DH = 128;  // head dim: one thread per dim in attention
constexpr int THREADS = DH;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS_PER_SM = 4;

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

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory: the staged activation (codes, sums, scales) and the norm
// reduction, or in attention the split pass's arrays plus the roped q.
__host__ __device__ size_t smem_bytes(int max_in) {
  const size_t stage = round16(max_in) + 2 * sizeof(float) * (max_in / QK) + WARPS * sizeof(float);
  const size_t attn = (2 * DH + 2 * CHUNK) * sizeof(float);
  return stage > attn ? stage : attn;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// Sum over the block in a fixed order: every thread gets the same value.
__device__ float block_sum(float v, float* red) {
  v = warp_sum_f(v);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

struct NormStats {
  float mean, den;  // norm(x)_i = (x_i - mean) / den
};

// ggml_norm (mean-centered) or RMSNorm statistics of x [n]
__device__ NormStats norm_stats(const float* x, int n, int layernorm, float eps, float* red) {
  float s = 0.0f;
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float xi = __ldcg(x + i);
    s += layernorm ? xi : __fmul_rn(xi, xi);
  }
  const float m = __fdiv_rn(block_sum(s, red), static_cast<float>(n));
  if (!layernorm) return {0.0f, sqrtf(__fadd_rn(m, eps))};
  float c2 = 0.0f;
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float c = __fsub_rn(__ldcg(x + i), m);
    c2 += __fmul_rn(c, c);
  }
  const float var = __fdiv_rn(block_sum(c2, red), static_cast<float>(n));
  return {m, sqrtf(__fadd_rn(var, eps))};
}

__device__ __forceinline__ float norm_elem(float xi, float w, NormStats ns) {
  return __fmul_rn(__fdiv_rn(__fsub_rn(xi, ns.mean), ns.den), w);
}

// silu(g1) * g3, the JAX formula g1 / (1 + exp(-g1)) * g3 (expf, not __expf)
__device__ __forceinline__ float swiglu(float g1, float g3) {
  return __fmul_rn(__fdiv_rn(g1, __fadd_rn(1.0f, expf(-g1))), g3);
}

// Quantize act(i), i < n, once across the grid: warps take 32-blocks with
// a grid stride and publish codes, sums and scales (and the values, to
// `trace` when given).  A barrier must follow before anyone reads them.
template <typename Act>
__device__ void quantize_grid(Act act, int n, Staged st, float* trace) {
  const int lane = threadIdx.x & 31;
  for (int b = blockIdx.x * WARPS + (threadIdx.x >> 5); b < n / QK; b += gridDim.x * WARPS) {
    const float v = act(b * QK + lane);
    if (trace != nullptr) trace[b * QK + lane] = v;
    quantize_block_warp(v, lane, st.xq + b * QK, st.qsum + b, st.dx + b);
  }
}

// Copy the published activation of n values into this block's shared memory.
__device__ void load_staged(Staged st, int n, int8_t* xq, int* qsum, float* dx) {
  __syncthreads();  // the previous phase's reads of the staging area are done
  const uint4* src = reinterpret_cast<const uint4*>(st.xq);
  for (int i = threadIdx.x; i < n / 16; i += THREADS) reinterpret_cast<uint4*>(xq)[i] = __ldcg(src + i);
  for (int i = threadIdx.x; i < n / QK; i += THREADS) {
    qsum[i] = __ldcg(st.qsum + i);
    dx[i] = __ldcg(st.dx + i);
  }
  __syncthreads();
}

// y[row] (= or +=) W[il][row] . staged activation, a warp per row, rows
// taken with a grid stride.
__device__ void q4_rows(Weight w, int il, int out, int nb, const int8_t* xq, const int* qsum,
                        const float* dx, float* y, bool accumulate) {
  const int lane = threadIdx.x & 31;
  const uint8_t* qs = w.qs + static_cast<size_t>(il) * out * nb * 16;
  const float* dw = w.d + static_cast<size_t>(il) * out * nb;
  const uint4* xq4 = reinterpret_cast<const uint4*>(xq);
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < out; row += gridDim.x * WARPS) {
    const uint4* wrow = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(row) * nb * 16);
    const float* drow = dw + static_cast<size_t>(row) * nb;
    float acc = 0.0f;
#pragma unroll 4
    for (int b = lane; b < nb; b += 32) {
      const int part = block_dot(__ldg(wrow + b), xq4[2 * b], xq4[2 * b + 1], qsum[b]);
      const float scale = __fmul_rn(__ldg(drow + b), dx[b]);
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(part), scale));
    }
    acc = warp_sum_f(acc);
    if (lane == 0) y[row] = accumulate ? __fadd_rn(__ldcg(y + row), acc) : acc;
  }
}

// Blocks of one cooperative launch of `kernel` (THREADS threads, `smem`
// bytes of shared memory a block): as many as the occupancy calculator
// says are resident, at most MAX_BLOCKS_PER_SM an SM; or a negative
// cudaError.
template <typename K>
int coop_blocks(K kernel, size_t smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (!coop) return -static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM) * sms;
}

}  // namespace
