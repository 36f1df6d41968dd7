// Single-query (decode) attention over one layer of the stacked KV cache.
//
// Replaces the TPU kernels `_flash_decode_kernel` and
// `_flash_decode_stacked_kernel` (llama_swift_tpu/ops/attention.py, entry
// points flash_decode_attention and flash_decode_attention_stacked):
//
//   out[h] = softmax_j( q[h] . k[h, j] / sqrt(Dh) ) . v[h, j],   j = 0..n_past
//
// over a head-major cache [L, H, n_ctx, Dh] (f32 or bf16) read in place at
// layer il; only keys j <= n_past are read, so the bytes moved grow with
// n_past, not n_ctx (stale slots beyond n_past are never touched).
//
// What bounds it on the H100: device-memory bandwidth (2 * (n_past+1) * H *
// Dh cache elements, 4 flops each), and at 7B decode shapes also launch and
// latency: 32 heads are fewer blocks than the card's 132 SMs.
//
// Design (split-K flash decoding, two launches):
//  * flash_split_kernel, grid (H, S): block (h, c) takes keys
//    [64c, 64c+64) of head h, one thread per head dim.  Warps compute the
//    scores (a warp reads a 128-dim key row as one coalesced line, lanes
//    split the dims, shuffles reduce), the block takes the chunk max m_c,
//    p_j = exp(s_j - m_c), l_c = sum p_j, and thread d accumulates
//    acc_c[d] = sum_j p_j v[j, d] (the block reads each value row coalesced).
//    Splitting the keys puts H * S blocks on the card instead of H.
//  * flash_combine_kernel, grid H: rescales the S partials by
//    exp(m_c - max m) and normalises (online softmax across chunks).
// All arithmetic is f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;  // keys per split

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q [H, Dh]; k/v: layer plane [H, n_ctx, Dh]; part: [H, S, Dh + 2] (acc, m, l)
template <typename T>
__global__ void flash_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, float* __restrict__ part,
                                   int n_ctx, int dh, int n_keys, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;        // [dh]
  float* sc = smem + dh;   // [CHUNK]
  const int h = blockIdx.x, c = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  qs[tid] = q[h * dh + tid];
  __syncthreads();
  const int j0 = c * CHUNK;
  const int jn = min(CHUNK, n_keys - j0);
  const T* kh = k + (static_cast<size_t>(h) * n_ctx + j0) * dh;
  const T* vh = v + (static_cast<size_t>(h) * n_ctx + j0) * dh;
  for (int j = warp; j < jn; j += nwarps) {
    const T* kr = kh + static_cast<size_t>(j) * dh;
    float s = 0.0f;
    for (int d = lane; d < dh; d += 32) s += qs[d] * to_f32(kr[d]);
    s = warp_sum(s);
    if (lane == 0) sc[j] = s * scale;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = 0; j < jn; ++j) m = fmaxf(m, sc[j]);
  __syncthreads();
  for (int j = tid; j < jn; j += blockDim.x) sc[j] = expf(sc[j] - m);
  __syncthreads();
  float l = 0.0f, acc = 0.0f;
  for (int j = 0; j < jn; ++j) {
    const float p = sc[j];
    l += p;
    acc += p * to_f32(vh[static_cast<size_t>(j) * dh + tid]);
  }
  float* out = part + (static_cast<size_t>(h) * S + c) * (dh + 2);
  out[tid] = acc;
  if (tid == 0) {
    out[dh] = m;
    out[dh + 1] = l;
  }
}

__global__ void flash_combine_kernel(const float* __restrict__ part, float* __restrict__ o,
                                     int dh, int S) {
  const int h = blockIdx.x, tid = threadIdx.x;
  const float* ph = part + static_cast<size_t>(h) * S * (dh + 2);
  float mx = -INFINITY;
  for (int c = 0; c < S; ++c) mx = fmaxf(mx, ph[c * (dh + 2) + dh]);
  float l = 0.0f, acc = 0.0f;
  for (int c = 0; c < S; ++c) {
    const float* pc = ph + c * (dh + 2);
    const float a = expf(pc[dh] - mx);
    l += a * pc[dh + 1];
    acc += a * pc[tid];
  }
  o[h * dh + tid] = acc / l;
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* part, void* out, int H,
            int n_ctx, int dh, int n_keys, float scale, cudaStream_t s) {
  const int S = (n_keys + CHUNK - 1) / CHUNK;
  const size_t shmem = (dh + CHUNK) * sizeof(float);
  flash_split_kernel<T><<<dim3(H, S), dh, shmem, s>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(part), n_ctx, dh, n_keys, scale);
  flash_combine_kernel<<<H, dh, 0, s>>>(static_cast<const float*>(part),
                                        static_cast<float*>(out), dh, S);
}

}  // namespace

// k/v point at layer il of the stacked cache; n_keys = n_past + 1;
// part is scratch of H * ceil(n_keys/64) * (dh + 2) floats.
extern "C" int flash_decode(const void* q, const void* k, const void* v, void* part,
                            void* out, int H, int n_ctx, int dh, int n_keys, float scale,
                            int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(q, k, v, part, out, H, n_ctx, dh, n_keys, scale, s);
  else
    launch<float>(q, k, v, part, out, H, n_ctx, dh, n_keys, scale, s);
  return static_cast<int>(cudaGetLastError());
}
