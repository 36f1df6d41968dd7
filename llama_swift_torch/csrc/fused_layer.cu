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
//  * The products reuse the matvec's inner loop (q4_common.cuh, through
//    fused_common.cuh, which fused_blocks.cu shares): a warp per
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
#include "fused_common.cuh"

namespace cg = cooperative_groups;

namespace {

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
  Staged st;           // scratch: the published activation, max(D, F) values
  float* trace;        // [L, 3D + F] quantizer inputs, or null
  int L, H, F, n_ctx, n_past, layernorm;
  float eps, scale;
};

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
    quantize_grid([&](int i) { return norm_elem(__ldcg(a.x + i), an[i], ns); }, D, a.st, tr);
    grid.sync();
    load_staged(a.st, D, xq, qsum, dx);
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
      quantize_block_warp(v, threadIdx.x & 31, a.st.xq + b * QK, a.st.qsum + b, a.st.dx + b);
    }
    grid.sync();
    // (D) wo + residual
    load_staged(a.st, D, xq, qsum, dx);
    q4_rows(a.wo, il, D, D / QK, xq, qsum, dx, a.x, true);
    grid.sync();
    // (E) ffn norm, w13
    const float* fn = a.fnorm + static_cast<size_t>(il) * D;
    const NormStats fs = norm_stats(a.x, D, a.layernorm, a.eps, red);
    quantize_grid([&](int i) { return norm_elem(__ldcg(a.x + i), fn[i], fs); }, D, a.st, tr ? tr + 2 * D : nullptr);
    grid.sync();
    load_staged(a.st, D, xq, qsum, dx);
    q4_rows(a.w13, il, 2 * F, D / QK, xq, qsum, dx, a.g13, false);
    grid.sync();
    // (F) SwiGLU, w2 + residual
    quantize_grid([&](int i) { return swiglu(__ldcg(a.g13 + i), __ldcg(a.g13 + F + i)); }, F, a.st,
                  tr ? tr + 3 * D : nullptr);
    grid.sync();
    load_staged(a.st, F, xq, qsum, dx);
    q4_rows(a.w2, il, D, F / QK, xq, qsum, dx, a.x, true);
    grid.sync();
  }
}

int blocks_for(int kind, size_t smem) {
  switch (kind) {
    case 0: return coop_blocks(fused_layers_kernel<float>, smem);
    case 1: return coop_blocks(fused_layers_kernel<__nv_bfloat16>, smem);
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
         k, v, qkv, qkv + 3 * D, qkv + 3 * D + 2 * F, {codes, qsum, dx},
         static_cast<float*>(trace), L, H, F, n_ctx, n_past, layernorm, eps, scale};
  void* args[] = {&a};
  const void* fn = kind == 0 ? reinterpret_cast<const void*>(fused_layers_kernel<float>)
                             : reinterpret_cast<const void*>(fused_layers_kernel<__nv_bfloat16>);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
