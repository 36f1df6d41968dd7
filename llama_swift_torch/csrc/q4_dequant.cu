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
// one or two operations each.  The writes are 76-84 % of the bytes (90 MB
// bf16, 180 MB f32 at 11008x4096, more than L2's 50 MB).
//
// Design, for the store side:
//  * a thread writes 16-byte chunks of the output: 8 bf16 or 4 f32
//    elements, from 4 or 2 nibble bytes of its block (4 or 8 threads a
//    32-element block), so one warp store instruction writes one
//    contiguous 512-byte span (16 bytes a lane, neighbouring lanes on
//    neighbouring chunks), and a warp's nibble loads read 128 or 64
//    contiguous bytes;
//  * streaming stores (st.global.cs, evict-first): the dense weight is
//    read once by the product that follows and does not fit in L2, so it
//    should not push the nibbles and the other operand out of it;
//  * bytes in flight: a thread loads UNROLL chunks' nibbles and scales
//    (the chunks of one step a block-width apart, so each step's stores
//    stay contiguous across the warp) before it converts and stores any.
// The arithmetic is the functors below, the same for both dtypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // chunks a thread loads before it stores any

// 4 f32 values, one 16-byte streaming store
__device__ __forceinline__ void store_chunk(float* dst, const float* v) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}

// 8 values rounded to nearest even bf16, one 16-byte streaming store
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162 p;
  p = __floats2bfloat162_rn(v[0], v[1]); u.x = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[2], v[3]); u.y = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[4], v[5]); u.z = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[6], v[7]); u.w = *reinterpret_cast<uint32_t*>(&p);
  __stcs(reinterpret_cast<uint4*>(dst), u);
}

// The nibble bytes of one chunk: 4 (bf16, one 32-bit load) or 2 (f32)
__device__ __forceinline__ uint32_t load_nibbles(const uint8_t* p, float) {
  return __ldcs(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ uint32_t load_nibbles(const uint8_t* p, __nv_bfloat16) {
  return __ldcs(reinterpret_cast<const unsigned int*>(p));
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
// -> out [n_blocks][32], as n_chunks = n_blocks * 32 / EPC chunks of 16
// bytes; chunk c is elements [c * EPC, (c + 1) * EPC) of block c / CPB.
template <typename T, typename Kind, typename Scale>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const uint8_t* __restrict__ qs, const Scale* __restrict__ scales, T* __restrict__ out,
               long long n_chunks) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a chunk: 8 bf16 or 4 f32
  constexpr int CPB = 32 / EPC;                         // chunks a block
  constexpr int NBYTES = EPC / 2;                       // nibble bytes a chunk
  const long long c0 = static_cast<long long>(blockIdx.x) * THREADS * UNROLL + threadIdx.x;
  uint32_t w[UNROLL];
  Scale sc[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long c = c0 + u * THREADS;
    if (c < n_chunks) {
      const long long b = c / CPB;
      w[u] = load_nibbles(qs + b * 16 + (c % CPB) * NBYTES, T());
      sc[u] = __ldg(scales + b);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long c = c0 + u * THREADS;
    if (c < n_chunks) {
      const Kind f{sc[u]};
      float v[EPC];
#pragma unroll
      for (int t = 0; t < NBYTES; ++t) {  // byte t holds elements 2t (low nibble) and 2t + 1
        const uint32_t byte = (w[u] >> (8 * t)) & 0xFFu;
        v[2 * t] = f(byte & 0xFu);
        v[2 * t + 1] = f(byte >> 4);
      }
      store_chunk(out + c * EPC, v);
    }
  }
}

template <typename T, typename Kind, typename Scale>
int launch_as(const void* qs, const void* scales, void* out, long long n_blocks, cudaStream_t s) {
  const long long n_chunks = n_blocks * 32 / (16 / static_cast<long long>(sizeof(T)));
  const long long per = static_cast<long long>(THREADS) * UNROLL;
  dequant_kernel<T, Kind, Scale><<<static_cast<unsigned>((n_chunks + per - 1) / per), THREADS, 0, s>>>(
      static_cast<const uint8_t*>(qs), static_cast<const Scale*>(scales), static_cast<T*>(out), n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kind, typename Scale>
int launch(const void* qs, const void* scales, void* out, long long n_blocks, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the loads and stores above: nibbles 4-byte, scales and the output at their own alignment
  if (reinterpret_cast<uintptr_t>(qs) % 4 || reinterpret_cast<uintptr_t>(scales) % sizeof(Scale) ||
      reinterpret_cast<uintptr_t>(out) % 16 || n_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  return is_bf16 ? launch_as<__nv_bfloat16, Kind, Scale>(qs, scales, out, n_blocks, s)
                 : launch_as<float, Kind, Scale>(qs, scales, out, n_blocks, s);
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
