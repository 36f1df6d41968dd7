// One decode layer in two kernels: the attention block and the FFN block
// (fused_attn_block, fused_ffn_block), each one persistent cooperative launch.
//
// Replace the TPU kernels `_make_attn_kernel` and `_make_ffn_kernel`
// (llama_swift_tpu/ops/q4_fused_layer.py, entry points fused_attn_block and
// fused_ffn_block: the "two kernels per layer" design that the whole-stack
// kernel superseded there).  With x the f32 residual stream [D], D = H * 128,
// and layer il of stacked Q4_0 weights:
//
//   attention block:
//     h     = norm(x) * attn_norm
//     qkv   = wqkv[il] . q4(h)                          3D rows (q; k; v)
//     q, k  = rope(q), rope(k): y[d] = x[d] cos[d] + x[d ^ 1] sin_s[d] (the
//             caller's rope vectors for position n_past, as in the JAX block)
//     k_new, v_new = k, v rounded through the cache type (f32 or bf16)
//     ctx   = softmax over (keys j < n_past of the cache, then k_new) . (values, v_new)
//     delta = wo[il] . q4(ctx)
//   FFN block:
//     h     = norm(x) * ffn_norm
//     g     = w13[il] . q4(h)                           2F rows (g1; g3)
//     delta = w2[il] . q4(g1 / (1 + exp(-g1)) * g3)
//
// q4(.) and the products compute what the whole-stack kernel's do (the
// quantizer and the block dot of q4_common.cuh), with loops of their own
// for these 128-thread blocks, below.  The differences from its layer are
// the TPU blocks': the cache is only read, and only at j < n_past; the new
// token's k and v go out to the caller (who writes them at n_past) and
// enter the softmax as its last term, from their cache-rounded values;
// neither block adds the residual, each writes its delta.
//
// What bounds them on the H100: device-memory bandwidth.  At 7B the
// attention block streams 4 D^2 weights at 0.625 bytes (41.9 MB) and
// 2 H n_past cache rows; the FFN block 3 D F weights (84.6 MB).
//
// Design: the whole-stack kernel's phases for one layer, one cooperative
// launch per block, as many blocks as the occupancy calculator says are
// resident (at most four an SM), 128 threads each:
//   attention: A1 norm + quantize | A2 wqkv rows | B k_new/v_new out,
//     splits over the history | C combine + own term + quantize ctx |
//     D wo rows -> delta;
//   FFN: E1 norm + quantize | E2 w13 rows | F1 SwiGLU + quantize |
//     F2 w2 rows -> delta;
// with a grid-wide barrier between phases.  Phase B's work items are (head,
// 64-key chunk of the history); phase C combines a head's chunks (none at
// n_past 0) and folds in the own term with the JAX kernel's update: m' =
// max(m, s), l' = l exp(m - m') + exp(s - m'), acc' = acc exp(m - m') +
// exp(s - m') v_new.
#include "fused_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = DH;  // threads a block: one per head dim in attention
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS_PER_SM = 4;

// Shared memory: the staged activation (codes, sums, scales) and the norm
// reduction, or in attention the split pass's arrays plus the roped q.
__host__ __device__ size_t smem_bytes(int max_in) {
  const size_t stage = round16(max_in) + 2 * sizeof(float) * (max_in / QK) + WARPS * sizeof(float);
  const size_t attn = (2 * DH + 2 * CHUNK) * sizeof(float);
  return stage > attn ? stage : attn;
}

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

struct AttnArgs {
  const float* x;      // [D]
  const float* norm;   // [D] the layer's attention norm
  const float* cos;    // [DH] rope vectors: cos repeated per pair,
  const float* sin_s;  //   sin signed -/+ for the even/odd element
  Weight wqkv, wo;     // stacked, read at layer il
  const void* k;       // [L, H, n_ctx, DH] f32 or bf16, read-only
  const void* v;
  float* delta;        // [D] out
  float* k_new;        // [H, DH] out, cache-rounded
  float* v_new;
  float* qkv;          // scratch [3D]
  float* part;         // scratch [H, S, DH + 2]
  Staged st;           // scratch: the published activation, D values
  float* trace;        // [2D] quantizer inputs (h, ctx), or null
  int il, H, n_ctx, n_past, layernorm;
  float eps, scale;
};

struct FfnArgs {
  const float* x;      // [D]
  const float* norm;   // [D] the layer's FFN norm
  Weight w13, w2;      // stacked, read at layer il
  float* delta;        // [D] out
  float* g13;          // scratch [2F]
  Staged st;           // scratch: the published activation, max(D, F) values
  float* trace;        // [D + F] quantizer inputs (h, gate), or null
  int il, D, F, layernorm;
  float eps;
};

__host__ __device__ int history_splits(int n_past) { return (n_past + CHUNK - 1) / CHUNK; }

// Element d of rope(x) for one head with the caller's vectors: two products
// and a sum, each rounded, as the plain version's x * cos + swap(x) * sin_s.
__device__ __forceinline__ float rope_cs(const float* x, int d, const AttnArgs& a) {
  return __fadd_rn(__fmul_rn(__ldcg(x + d), a.cos[d]), __fmul_rn(__ldcg(x + (d ^ 1)), a.sin_s[d]));
}

// Phase B: the new token's k and v rows (roped k; both rounded through the
// cache type) to k_new/v_new, and the split pass over keys 0..n_past-1.
template <typename T>
__device__ void history_pass(const AttnArgs& a, float* smem_f) {
  const int tid = threadIdx.x, D = a.H * DH, S = history_splits(a.n_past);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  float* qrow = smem_f + DH + 2 * CHUNK;  // beside split_chunk_kv's arrays
  for (int h = blockIdx.x; h < a.H; h += gridDim.x) {
    a.k_new[h * DH + tid] = to_f32(from_f32<T>(rope_cs(a.qkv + D + h * DH, tid, a)));
    a.v_new[h * DH + tid] = to_f32(from_f32<T>(__ldcg(a.qkv + 2 * D + h * DH + tid)));
  }
  for (int item = blockIdx.x; item < a.H * S; item += gridDim.x) {
    const int h = item / S, c = item % S;
    const size_t head = (static_cast<size_t>(a.il) * a.H + h) * a.n_ctx * DH;
    __syncthreads();  // the previous item is done with qrow
    qrow[tid] = rope_cs(a.qkv + h * DH, tid, a);
    __syncthreads();
    split_chunk_kv<T>(qrow, DenseRows<T>{kc + head, nullptr, DH}, DenseRows<T>{vc + head, nullptr, DH},
                      c * CHUNK, min(CHUNK, a.n_past - c * CHUNK), a.scale,
                      a.part + (static_cast<size_t>(h) * S + c) * (DH + 2));
  }
}

// Phase C for head h: the history splits combined, then the own term last;
// thread tid returns dim tid of ctx.
__device__ float combine_with_own(const AttnArgs& a, int h, float* red) {
  const int tid = threadIdx.x, S = history_splits(a.n_past);
  const float q = rope_cs(a.qkv + h * DH, tid, a);
  const float s_own = block_sum(q * __ldcg(a.k_new + h * DH + tid), red) * a.scale;
  float m = -INFINITY, l = 0.0f, acc = 0.0f;
  const float* ph = a.part + static_cast<size_t>(h) * S * (DH + 2);
  for (int c = 0; c < S; ++c) m = fmaxf(m, __ldcg(ph + c * (DH + 2) + DH));
  for (int c = 0; c < S; ++c) {
    const float* pc = ph + c * (DH + 2);
    const float w = expf(__ldcg(pc + DH) - m);
    l += w * __ldcg(pc + DH + 1);
    acc += w * __ldcg(pc + tid);
  }
  const float mf = fmaxf(m, s_own);
  const float alpha = expf(m - mf), p_own = expf(s_own - mf);  // alpha = 0 without history
  l = l * alpha + p_own;
  acc = acc * alpha + p_own * __ldcg(a.v_new + h * DH + tid);
  return acc / l;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) attn_block_kernel(AttnArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int D = a.H * DH;
  int8_t* xq = reinterpret_cast<int8_t*>(fused_smem);
  int* qsum = reinterpret_cast<int*>(fused_smem + round16(D));
  float* dx = reinterpret_cast<float*>(qsum + D / QK);
  float* red = dx + D / QK;
  // (A) attention norm, wqkv
  const NormStats ns = norm_stats(a.x, D, a.layernorm, a.eps, red);
  quantize_grid([&](int i) { return norm_elem(__ldcg(a.x + i), a.norm[i], ns); }, D, a.st, a.trace);
  grid.sync();
  load_staged(a.st, D, xq, qsum, dx);
  q4_rows(a.wqkv, a.il, 3 * D, D / QK, xq, qsum, dx, a.qkv, false);
  grid.sync();
  // (B) the new K/V out, splits over the history
  history_pass<T>(a, reinterpret_cast<float*>(fused_smem));
  grid.sync();
  // (C) combine a head's splits and its own term; its four 32-blocks, one a warp, are quantized here
  for (int h = blockIdx.x; h < a.H; h += gridDim.x) {
    const float v = combine_with_own(a, h, red);
    const int b = h * (DH / QK) + (threadIdx.x >> 5);
    if (a.trace != nullptr) a.trace[D + b * QK + (threadIdx.x & 31)] = v;
    quantize_block_warp(v, threadIdx.x & 31, a.st.xq + b * QK, a.st.qsum + b, a.st.dx + b);
  }
  grid.sync();
  // (D) wo -> delta
  load_staged(a.st, D, xq, qsum, dx);
  q4_rows(a.wo, a.il, D, D / QK, xq, qsum, dx, a.delta, false);
}

__global__ void __launch_bounds__(THREADS) ffn_block_kernel(FfnArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int D = a.D, F = a.F, max_in = D > F ? D : F;
  int8_t* xq = reinterpret_cast<int8_t*>(fused_smem);
  int* qsum = reinterpret_cast<int*>(fused_smem + round16(max_in));
  float* dx = reinterpret_cast<float*>(qsum + max_in / QK);
  float* red = dx + max_in / QK;
  // (E) ffn norm, w13
  const NormStats ns = norm_stats(a.x, D, a.layernorm, a.eps, red);
  quantize_grid([&](int i) { return norm_elem(__ldcg(a.x + i), a.norm[i], ns); }, D, a.st, a.trace);
  grid.sync();
  load_staged(a.st, D, xq, qsum, dx);
  q4_rows(a.w13, a.il, 2 * F, D / QK, xq, qsum, dx, a.g13, false);
  grid.sync();
  // (F) SwiGLU, w2 -> delta
  quantize_grid([&](int i) { return swiglu(__ldcg(a.g13 + i), __ldcg(a.g13 + F + i)); }, F, a.st,
                a.trace ? a.trace + D : nullptr);
  grid.sync();
  load_staged(a.st, F, xq, qsum, dx);
  q4_rows(a.w2, a.il, D, F / QK, xq, qsum, dx, a.delta, false);
}

int attn_blocks_for(int kind, size_t smem) {
  switch (kind) {
    case 0: return coop_blocks(attn_block_kernel<float>, smem, THREADS, MAX_BLOCKS_PER_SM);
    case 1: return coop_blocks(attn_block_kernel<__nv_bfloat16>, smem, THREADS, MAX_BLOCKS_PER_SM);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// scratch of the published activation of max_in values at its start
Staged staged_at(void* scratch, int max_in) {
  int8_t* codes = static_cast<int8_t*>(scratch);
  int* qsum = reinterpret_cast<int*>(codes + round16(max_in));
  return {codes, qsum, reinterpret_cast<float*>(qsum + max_in / QK)};
}

}  // namespace

// Bytes of scratch that fused_attn_block needs at these widths and position.
extern "C" int fused_attn_block_scratch_bytes(int H, int n_past) {
  const int D = H * DH;
  return static_cast<int>(round16(D)) + 4 * (2 * (D / QK) + 3 * D + H * history_splits(n_past) * (DH + 2));
}

// Blocks that fused_attn_block launches (cache element kind 0 f32, 1 bf16),
// or a negative cudaError code.
extern "C" int fused_attn_block_blocks(int H, int kind) { return attn_blocks_for(kind, smem_bytes(H * DH)); }

// Layer il's attention block of one decode token: delta [D], k_new and
// v_new [H, 128] f32 out; the caches [L, H, n_ctx, 128] are only read, at
// rows j < n_past; cos and sin_s are the rope vectors [128] of position
// n_past.  scratch holds fused_attn_block_scratch_bytes(H, n_past) bytes,
// 16-byte aligned; trace is null or [2D] floats.
extern "C" int fused_attn_block(const void* x, const void* norm, const void* cos, const void* sin_s,
                                const void* wqkv_qs, const void* wqkv_d, const void* wo_qs, const void* wo_d,
                                const void* k, const void* v, void* delta,
                                void* k_new, void* v_new, void* scratch, void* trace, int il, int H, int n_ctx,
                                int n_past, int layernorm, float eps, float scale, int kind, void* stream) {
  const int D = H * DH;
  if (H < 1 || n_past < 0 || n_past >= n_ctx || il < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  const int blocks = attn_blocks_for(kind, smem);
  if (blocks < 0) return -blocks;
  // scratch: the published activation | qkv [3D] | partials
  const Staged st = staged_at(scratch, D);
  float* qkv = st.dx + D / QK;
  AttnArgs a{static_cast<const float*>(x),
             static_cast<const float*>(norm),
             static_cast<const float*>(cos),
             static_cast<const float*>(sin_s),
             {static_cast<const uint8_t*>(wqkv_qs), static_cast<const float*>(wqkv_d)},
             {static_cast<const uint8_t*>(wo_qs), static_cast<const float*>(wo_d)},
             k, v, static_cast<float*>(delta), static_cast<float*>(k_new), static_cast<float*>(v_new),
             qkv, qkv + 3 * D, st, static_cast<float*>(trace), il, H, n_ctx, n_past, layernorm, eps, scale};
  void* args[] = {&a};
  const void* fn = kind == 0 ? reinterpret_cast<const void*>(attn_block_kernel<float>)
                             : reinterpret_cast<const void*>(attn_block_kernel<__nv_bfloat16>);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch that fused_ffn_block needs at these widths.
extern "C" int fused_ffn_block_scratch_bytes(int D, int F) {
  const int max_in = D > F ? D : F;
  return static_cast<int>(round16(max_in)) + 4 * (2 * (max_in / QK) + 2 * F);
}

// Blocks that fused_ffn_block launches, or a negative cudaError code.
extern "C" int fused_ffn_block_blocks(int D, int F) {
  return coop_blocks(ffn_block_kernel, smem_bytes(D > F ? D : F), THREADS, MAX_BLOCKS_PER_SM);
}

// Layer il's FFN block of one decode token: delta [D] out.  w13 holds g1 in
// rows [0, F) and g3 in [F, 2F).  scratch holds fused_ffn_block_scratch_bytes
// (D, F) bytes, 16-byte aligned; trace is null or [D + F] floats.
extern "C" int fused_ffn_block(const void* x, const void* norm, const void* w13_qs, const void* w13_d,
                               const void* w2_qs, const void* w2_d, void* delta, void* scratch, void* trace, int il,
                               int D, int F, int layernorm, float eps, void* stream) {
  if (D % QK || F % QK || D < QK || F < QK || il < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int max_in = D > F ? D : F;
  const size_t smem = smem_bytes(max_in);
  const int blocks = coop_blocks(ffn_block_kernel, smem, THREADS, MAX_BLOCKS_PER_SM);
  if (blocks < 0) return -blocks;
  const Staged st = staged_at(scratch, max_in);
  FfnArgs a{static_cast<const float*>(x),
            static_cast<const float*>(norm),
            {static_cast<const uint8_t*>(w13_qs), static_cast<const float*>(w13_d)},
            {static_cast<const uint8_t*>(w2_qs), static_cast<const float*>(w2_d)},
            static_cast<float*>(delta), st.dx + max_in / QK, st, static_cast<float*>(trace), il, D, F, layernorm,
            eps};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ffn_block_kernel), dim3(blocks),
                                                    dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
