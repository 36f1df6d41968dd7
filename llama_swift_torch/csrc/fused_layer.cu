// Whole-stack batch-1 decode: all L transformer layers of one token in one
// persistent cooperative launch.
//
// Replaces the TPU kernel `_make_layers_kernel`
// (llama_swift_tpu/ops/q4_fused_layer.py, entry point fused_layers_block).
// Per layer il, with x the f32 residual stream [D], D = H * 128:
//
//   h    = norm(x) * attn_norm[il]
//   qkv  = wqkv[il] . q4(h)                         3D rows (q; k; v)
//   q, k = rope(q), rope(k) at position n_past;  k, v -> cache[il, :, n_past]
//   ctx  = softmax_j(q . k_j / sqrt(128)) . v_j      j = 0..n_past, per head
//   x   += wo[il] . q4(ctx)
//   h    = norm(x) * ffn_norm[il]
//   g    = w13[il] . q4(h)                          2F rows (g1; g3)
//   x   += w2[il] . q4(g1 / (1 + exp(-g1)) * g3)
//
// q4(.) quantizes the activation per 32-block to integers in [-7, 7] and
// every product is the exact int4 x int4 block dot of q4_matvec.cu.  The
// new token's K/V are written to the cache (f32 or bf16) before attention
// reads keys j <= n_past, so its own softmax term sees the cache-rounded
// values, as the TPU kernel's round trip through the cache dtype does.
//
// What bounds it on the H100: device-memory bandwidth.  A 7B token streams
// the packed weights of 32 layers once (202.4 M weights a layer at 0.625
// bytes: about 4.05 GB, 1.21 ms at 3.35 TB/s) plus 2 * 32 * H * (n_past+1)
// cache rows.  The work is 2 integer operations a weight, far below the
// dp4a rate.
//
// Design (simple first; the TPU kernel's DMA ring and MXU tricks have no
// counterpart here):
//  * One cooperative launch of up to MAX_BLOCKS_PER_SM blocks per SM (as
//    many as the occupancy calculator says fit, so that every block is
//    resident), 128 threads each.  Each layer runs nine phases separated by
//    grid-wide barriers (cooperative_groups grid.sync):
//      A1 attention norm + quantize;  A2 wqkv rows;
//      B  rope, new K/V, attention splits;  C combine + quantize ctx;
//      D  wo rows + residual;
//      E1 ffn norm + quantize;  E2 w13 rows;
//      F1 SwiGLU + quantize;  F2 w2 rows + residual.
//  * Each activation is quantized once: the grid's warps take its 32-blocks
//    with a grid stride and publish codes, sums and scales in global memory
//    before a barrier (phase C quantizes each head's four blocks where it
//    combines them); every block then copies the published activation
//    (5-14 KB) into its shared memory for its rows.  The norm statistics
//    are the only thing every block computes, with identical code on
//    identical data (a fixed-order reduction), so all blocks agree.
//  * The products reuse the matvec's inner loop (q4_common.cuh): a warp per
//    output row, rows taken with a grid stride, never an early return
//    (every thread reaches every barrier).  A residual row x[o] += y[o]
//    belongs to one warp, and no block reads x in the phases that write it.
//  * Attention reuses flash_decode.cu's split pass (flash_common.cuh): work
//    items (head h, 64-key chunk c) taken with a grid stride; the block of a
//    head's last chunk ropes that head's q and k, stores k and v at n_past,
//    and only then reads its keys.  Every block ropes q itself.
//  * Buffers that other blocks wrote in the same launch (x, qkv, the
//    published activation, partials, g13) are read through L2 (__ldcg),
//    never from a stale L1 line.
//  * Float rounding follows the plain version: _rn intrinsics where nvcc
//    would contract a multiply and an add, expf (not __expf) in SwiGLU.
#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "q4_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 128;  // head dim: one thread per dim in attention
constexpr int THREADS = DH;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS_PER_SM = 4;

struct Weight {
  const uint8_t* qs;  // [L, out, in/2]
  const float* d;     // [L, out, in/32]
};

struct Args {
  float* x;            // [D] residual stream, updated in place
  const float* anorm;  // [L, D]
  const float* fnorm;  // [L, D]
  Weight wqkv, wo, w13, w2;
  void* k;             // [L, H, n_ctx, DH] f32 or bf16
  void* v;
  float* qkv;          // scratch [3D]
  float* g13;          // scratch [2F]
  float* part;         // scratch [H, S, DH + 2]
  int8_t* xq;          // scratch [max(D, F)]: the published activation's codes,
  int* qsum;           //   [max(D, F) / 32] their sums per 32-block
  float* dx;           //   and their scales
  float* trace;        // [L, 3D + F] quantizer inputs, or null
  int L, H, F, n_ctx, n_past, layernorm;
  float eps, scale;
};

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory: the staged activation (codes, sums, scales) and the norm
// reduction, or in phase B the split pass's arrays plus the roped q.
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

// Quantize act(i), i < n, once across the grid: warps take 32-blocks with
// a grid stride and publish codes, sums and scales (and the values, to
// `trace` when given).  A barrier must follow before anyone reads them.
template <typename Act>
__device__ void quantize_grid(Act act, int n, const Args& a, float* trace) {
  const int lane = threadIdx.x & 31;
  for (int b = blockIdx.x * WARPS + (threadIdx.x >> 5); b < n / QK; b += gridDim.x * WARPS) {
    const float v = act(b * QK + lane);
    if (trace != nullptr) trace[b * QK + lane] = v;
    quantize_block_warp(v, lane, a.xq + b * QK, a.qsum + b, a.dx + b);
  }
}

// Copy the published activation of n values into this block's shared memory.
__device__ void load_staged(const Args& a, int n, int8_t* xq, int* qsum, float* dx) {
  __syncthreads();  // the previous phase's reads of the staging area are done
  const uint4* src = reinterpret_cast<const uint4*>(a.xq);
  for (int i = threadIdx.x; i < n / 16; i += THREADS) reinterpret_cast<uint4*>(xq)[i] = __ldcg(src + i);
  for (int i = threadIdx.x; i < n / QK; i += THREADS) {
    qsum[i] = __ldcg(a.qsum + i);
    dx[i] = __ldcg(a.dx + i);
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

// Element d of rope(x) for one head: pair (2j, 2j+1) rotated by (cs, sn).
__device__ __forceinline__ float rope_elem(const float* x, int d, float cs, float sn) {
  const float x0 = __ldcg(x + (d & ~1)), x1 = __ldcg(x + (d | 1));
  return (d & 1) ? __fadd_rn(__fmul_rn(x0, sn), __fmul_rn(x1, cs))
                 : __fsub_rn(__fmul_rn(x0, cs), __fmul_rn(x1, sn));
}

// Phase B: the split pass over keys 0..n_past of every head of layer il.
template <typename T>
__device__ void attention_splits(const Args& a, int il, float* smem_f) {
  const int tid = threadIdx.x, D = a.H * DH;
  const int n_keys = a.n_past + 1, S = (n_keys + CHUNK - 1) / CHUNK;
  T* kc = static_cast<T*>(a.k);
  T* vc = static_cast<T*>(a.v);
  float* qrow = smem_f + DH + 2 * CHUNK;  // beside split_chunk_kv's arrays
  const int j = tid >> 1;                 // angle n_past * 10000^(-2j/DH)
  const float ang = static_cast<float>(a.n_past) *
                    powf(10000.0f, __fdiv_rn(-static_cast<float>(2 * j), static_cast<float>(DH)));
  const float cs = cosf(ang), sn = sinf(ang);
  for (int item = blockIdx.x; item < a.H * S; item += gridDim.x) {
    const int h = item / S, c = item % S;
    const size_t head = (static_cast<size_t>(il) * a.H + h) * a.n_ctx * DH;
    __syncthreads();  // the previous item is done with qrow
    qrow[tid] = rope_elem(a.qkv + h * DH, tid, cs, sn);
    if (c == S - 1) {  // this block owns head h's new row
      const size_t row = head + static_cast<size_t>(a.n_past) * DH + tid;
      kc[row] = from_f32<T>(rope_elem(a.qkv + D + h * DH, tid, cs, sn));
      vc[row] = from_f32<T>(__ldcg(a.qkv + 2 * D + h * DH + tid));
    }
    __syncthreads();
    split_chunk_kv<T>(qrow, DenseRows<T>{kc + head, nullptr, DH}, DenseRows<T>{vc + head, nullptr, DH},
                      c * CHUNK, min(CHUNK, n_keys - c * CHUNK), a.scale,
                      a.part + (static_cast<size_t>(h) * S + c) * (DH + 2));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_layers_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int D = a.H * DH, F = a.F, max_in = D > F ? D : F;
  int8_t* xq = reinterpret_cast<int8_t*>(fused_smem);
  int* qsum = reinterpret_cast<int*>(fused_smem + round16(max_in));
  float* dx = reinterpret_cast<float*>(qsum + max_in / QK);
  float* red = dx + max_in / QK;
  const int S = (a.n_past + CHUNK) / CHUNK;  // splits of n_past + 1 keys
  for (int il = 0; il < a.L; ++il) {
    float* tr = a.trace ? a.trace + static_cast<size_t>(il) * (3 * D + F) : nullptr;
    // (A) attention norm, wqkv
    const float* an = a.anorm + static_cast<size_t>(il) * D;
    const NormStats ns = norm_stats(a.x, D, a.layernorm, a.eps, red);
    quantize_grid([&](int i) { return norm_elem(__ldcg(a.x + i), an[i], ns); }, D, a, tr);
    grid.sync();
    load_staged(a, D, xq, qsum, dx);
    q4_rows(a.wqkv, il, 3 * D, D / QK, xq, qsum, dx, a.qkv, false);
    grid.sync();
    // (B) rope, new K/V, attention splits
    attention_splits<T>(a, il, reinterpret_cast<float*>(fused_smem));
    grid.sync();
    // (C) combine a head's splits; its four 32-blocks, one a warp, are quantized here
    for (int h = blockIdx.x; h < a.H; h += gridDim.x) {
      const float v = combine_splits(a.part + static_cast<size_t>(h) * S * (DH + 2), S, DH);
      const int b = h * (DH / QK) + (threadIdx.x >> 5);
      if (tr != nullptr) tr[D + b * QK + (threadIdx.x & 31)] = v;
      quantize_block_warp(v, threadIdx.x & 31, a.xq + b * QK, a.qsum + b, a.dx + b);
    }
    grid.sync();
    // (D) wo + residual
    load_staged(a, D, xq, qsum, dx);
    q4_rows(a.wo, il, D, D / QK, xq, qsum, dx, a.x, true);
    grid.sync();
    // (E) ffn norm, w13
    const float* fn = a.fnorm + static_cast<size_t>(il) * D;
    const NormStats fs = norm_stats(a.x, D, a.layernorm, a.eps, red);
    quantize_grid([&](int i) { return norm_elem(__ldcg(a.x + i), fn[i], fs); }, D, a, tr ? tr + 2 * D : nullptr);
    grid.sync();
    load_staged(a, D, xq, qsum, dx);
    q4_rows(a.w13, il, 2 * F, D / QK, xq, qsum, dx, a.g13, false);
    grid.sync();
    // (F) SwiGLU, w2 + residual
    quantize_grid(
        [&](int i) {
          const float g1 = __ldcg(a.g13 + i), g3 = __ldcg(a.g13 + F + i);
          return __fmul_rn(__fdiv_rn(g1, __fadd_rn(1.0f, expf(-g1))), g3);
        },
        F, a, tr ? tr + 3 * D : nullptr);
    grid.sync();
    load_staged(a, F, xq, qsum, dx);
    q4_rows(a.w2, il, D, F / QK, xq, qsum, dx, a.x, true);
    grid.sync();
  }
}

// Blocks of one cooperative launch of fused_layers_kernel<T> with `smem`
// bytes of shared memory a block, or a negative cudaError.
template <typename T>
int grid_blocks(size_t smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(fused_layers_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_layers_kernel<T>, THREADS, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (!coop) return -static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM) * sms;
}

int blocks_for(int kind, size_t smem) {
  switch (kind) {
    case 0: return grid_blocks<float>(smem);
    case 1: return grid_blocks<__nv_bfloat16>(smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Bytes of scratch that fused_layers needs for these widths and position
// (about 150 KB at 7B and n_past 511).
extern "C" int fused_layers_scratch_bytes(int H, int F, int n_past) {
  const int D = H * DH, max_in = D > F ? D : F, S = (n_past + CHUNK) / CHUNK;
  return static_cast<int>(round16(max_in)) + 4 * (2 * (max_in / QK) + 3 * D + 2 * F + H * S * (DH + 2));
}

// Blocks that fused_layers launches for these widths and cache element
// kind (0 f32, 1 bf16), or a negative cudaError code.
extern "C" int fused_layers_blocks(int H, int F, int kind) {
  const int D = H * DH;
  return blocks_for(kind, smem_bytes(D > F ? D : F));
}

// All L layers of one decode token.  x [D] is updated in place; the new
// K/V of every layer land at row n_past of the caches [L, H, n_ctx, 128].
// scratch holds fused_layers_scratch_bytes(...) bytes, 16-byte aligned;
// trace is null or [L, 3D + F] floats.
extern "C" int fused_layers(void* x, const void* anorm, const void* fnorm, const void* wqkv_qs,
                            const void* wqkv_d, const void* wo_qs, const void* wo_d,
                            const void* w13_qs, const void* w13_d, const void* w2_qs,
                            const void* w2_d, void* k, void* v, void* scratch, void* trace, int L,
                            int H, int F, int n_ctx, int n_past, int layernorm, float eps,
                            float scale, int kind, void* stream) {
  const int D = H * DH;
  if (D % QK || F % QK || n_past < 0 || n_past >= n_ctx) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D > F ? D : F);
  const int blocks = blocks_for(kind, smem);
  if (blocks < 0) return -blocks;
  const int max_in = D > F ? D : F;
  // scratch: codes [max_in] | sums, scales [max_in / 32] | qkv [3D] | g13 [2F] | partials
  int8_t* codes = static_cast<int8_t*>(scratch);
  int* qsum = reinterpret_cast<int*>(codes + round16(max_in));
  float* dx = reinterpret_cast<float*>(qsum + max_in / QK);
  float* qkv = dx + max_in / QK;
  Args a{static_cast<float*>(x),
         static_cast<const float*>(anorm),
         static_cast<const float*>(fnorm),
         {static_cast<const uint8_t*>(wqkv_qs), static_cast<const float*>(wqkv_d)},
         {static_cast<const uint8_t*>(wo_qs), static_cast<const float*>(wo_d)},
         {static_cast<const uint8_t*>(w13_qs), static_cast<const float*>(w13_d)},
         {static_cast<const uint8_t*>(w2_qs), static_cast<const float*>(w2_d)},
         k, v, qkv, qkv + 3 * D, qkv + 3 * D + 2 * F, codes, qsum, dx,
         static_cast<float*>(trace), L, H, F, n_ctx, n_past, layernorm, eps, scale};
  void* args[] = {&a};
  const void* fn = kind == 0 ? reinterpret_cast<const void*>(fused_layers_kernel<float>)
                             : reinterpret_cast<const void*>(fused_layers_kernel<__nv_bfloat16>);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
