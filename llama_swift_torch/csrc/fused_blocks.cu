// The FFN block of one decode layer (fused_ffn_block): one persistent
// cooperative launch.  (The layer's attention block, fused_attn_block, runs
// on the whole-stack kernel's phases in fused_layer.cu.)
//
// Replaces the TPU kernel `_make_ffn_kernel`
// (llama_swift_tpu/ops/q4_fused_layer.py, entry point fused_ffn_block: the
// "two kernels per layer" design that the whole-stack kernel superseded
// there).  With x the f32 residual stream [D] and layer il of stacked Q4_0
// weights:
//
//     h     = norm(x) * ffn_norm
//     g     = w13[il] . q4(h)                           2F rows (g1; g3)
//     delta = w2[il] . q4(g1 / (1 + exp(-g1)) * g3)
//
// q4(.) and the products compute what the whole-stack kernel's do (the
// quantizer and the block dot of q4_common.cuh), with loops of their own
// for these 128-thread blocks, below.  The block does not add the
// residual; it writes its delta.
//
// What bounds it on the H100: device-memory bandwidth (at 7B, 3 D F
// weights: 84.6 MB).
//
// Design: the whole-stack kernel's first phases for one layer, one
// cooperative launch, as many blocks as the occupancy calculator says are
// resident (at most four an SM), 128 threads each:
//   E1 norm + quantize | E2 w13 rows | F1 SwiGLU + quantize | F2 w2 rows -> delta
// with a grid-wide barrier between phases.
#include "fused_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;  // threads a block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS_PER_SM = 4;

// Shared memory: the staged activation (codes, sums, scales) and the norm
// reduction.
__host__ __device__ size_t smem_bytes(int max_in) {
  return round16(max_in) + 2 * sizeof(float) * (max_in / QK) + WARPS * sizeof(float);
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

// scratch of the published activation of max_in values at its start
Staged staged_at(void* scratch, int max_in) {
  int8_t* codes = static_cast<int8_t*>(scratch);
  int* qsum = reinterpret_cast<int*>(codes + round16(max_in));
  return {codes, qsum, reinterpret_cast<float*>(qsum + max_in / QK)};
}

}  // namespace

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
