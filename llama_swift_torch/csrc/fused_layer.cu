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
// dp4a rate.  What kept the first design (528 blocks of 128 threads,
// nine grid barriers a layer) at 3.6 ms was the time between the streams:
// the memory sat idle at every barrier and at every phase's ramp, and each
// block staged each activation through global memory and L2.
//
// Design:
//  * One cooperative launch of BLOCKS_PER_SM (one) block of 512 threads an
//    SM (as many as the occupancy calculator says are resident, so no
//    barrier can deadlock; 132 blocks, where the first design had 528 of
//    128 threads, so the work every block repeats, the norm and the
//    quantization of its activation, is done 4x less often).  FIVE grid
//    barriers a layer (grid.sync), where the first design had nine:
//      A  attention norm + quantize (every block) | wqkv rows     | sync 1
//      B  rope, new K/V, attention splits, the last split of a
//         head combines it and quantizes ctx                     | sync 2
//      C  wo rows + residual                                      | sync 3
//      D  ffn norm + quantize (every block) | w13 rows; the warp
//         that writes a gate block's last row quantizes it       | sync 4
//      E  w2 rows + residual                                      | sync 5
//  * Norm activations are quantized by every block from x (D values
//    copied into its shared memory), with a fixed-order reduction, so
//    every block holds the same codes and none is published; four lanes a
//    32-block, so a block quantizes D = 4096 values in one round; block 0
//    alone writes the `trace` values.
//  * Arrival counters take the place of two barriers (the scratch's
//    int array, zeroed by the kernel itself before its first barrier and
//    left zero at its end, so no memset launch and nothing shared between
//    calls or streams): a block writes its split's (acc, m, l), fences,
//    and adds one to its head's counter; the block that brings it to S
//    fences, combines the head's splits (in split order, whoever arrives
//    last) and quantizes its ctx, then resets the counter.  Likewise the
//    warp that writes the 64th row of a gate block (32 g1 rows and their
//    32 g3 rows) computes SwiGLU of the block and quantizes it.  No atomic
//    touches a float sum, so results are the same from run to run.
//  * Products: a warp per row pair, rows taken with a grid stride, the two
//    rows' loads issued together (the first design had one row in flight
//    a warp).  Before each barrier every warp asks L2 for the nibbles of
//    its first row of the next product (cp.async.bulk.prefetch.L2; after
//    w2, the next layer's wqkv), so HBM streams while the grid waits: one
//    row a warp, 4.3 MB (w2: 11.6 MB) of the 50 MB L2.  Weight loads are
//    marked evict-first (__ldcs): each byte is read once a token.
//  * Attention runs the chunk pass of flash_common.cuh (the batch-1 flash
//    kernel's): work items (head h, split c) of split_plan(n_past + 1, 4),
//    128 at 32 heads, taken with a grid stride.  A block starts the bulk
//    copies of its first item's K/V rows (up to 3 tiles of 16 KB) right
//    after phase A's quantization, so they stream during the wqkv product
//    and barrier 1; the block of a head's last split ropes the head's k
//    and stores k and v at n_past, and takes that row from its shared
//    memory (the copies leave it out, so no fence is needed).
//  * Buffers that other blocks wrote in the same launch (x, qkv, the
//    published activation, partials, g13) are read through L2 (__ldcg),
//    never from a stale L1 line.
//  * Float rounding follows the plain version: _rn intrinsics where nvcc
//    would contract a multiply and an add, expf (not __expf) in SwiGLU.
//
// One layer's attention block (fused_attn_block) runs in this file on the
// same phases.  It replaces the TPU kernel `_make_attn_kernel`
// (llama_swift_tpu/ops/q4_fused_layer.py, entry point fused_attn_block, the
// "two kernels per layer" design):
//
//   h     = norm(x) * attn_norm;  qkv = wqkv[il] . q4(h)
//   q, k  = rope(q), rope(k): y[d] = x[d] cos[d] + x[d ^ 1] sin_s[d] (the
//           caller's rope vectors for position n_past, as in the JAX block)
//   k_new, v_new = k, v rounded through the cache type (f32 or bf16), out
//   ctx   = softmax over (keys j < n_past of the cache, then k_new) . (values, v_new)
//   delta = wo[il] . q4(ctx)
//
// The cache is only read, and only at j < n_past; the new K/V go out to the
// caller; no residual is added.  What bounds it: device memory (at 7B 4 D^2
// weights at 0.625 bytes, 41.9 MB, and 2 H n_past history rows).  Design:
// one cooperative launch of the whole-stack kernel's blocks (one of 512
// threads an SM) and two grid barriers (the first design, 128-thread blocks
// up to four an SM, had four, published the normed activation through
// global memory and walked the history in 64-key items of a one-key-a-warp
// pass with a combine phase of its own):
//   A  attention norm + quantize (every block); wqkv rows by row pairs;
//      the first K/V tiles of the block's attention item started     | sync 1
//   B  rope with the caller's vectors; the chunk pass over the history
//      keys of items (head, split) (block_split_plan: at most blocks / H
//      splits a head; ring tiles of 32 KB, 3-4 % faster than the
//      whole-stack kernel's 16 KB at n_past 511, tools/block_variants.py);
//      the last split of a head to arrive combines the
//      splits in split order, folds in the own term last (recomputing
//      k_new and v_new from qkv, rounded through the cache type), writes
//      k_new and v_new out and quantizes ctx                           | sync 2
//   C  wo rows -> delta.
// At n_past 0 there is no split: a block a head takes the own term alone
// (ctx = v_new).  The arrival counters are the launch's scratch, zeroed by
// the kernel before barrier 1 and left zero at its end.
#include "fused_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;  // threads a block
constexpr int NW = NT / 32;
constexpr int BLOCKS_PER_SM = 1;
constexpr int ATTN_STAGES = 4;           // ring tiles of the chunk pass: three in flight
constexpr int ATTN_STAGE_BYTES = 16384;  // K and V rows of a tile
constexpr int ATTN_MAX_SPLITS = 4;       // attention work items of a head (132 blocks: 128 items)
constexpr int BLOCK_STAGE_BYTES = 32768;  // the attention block's ring tiles: K and V rows of a tile

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
  Staged st;           // scratch: the published ctx or gate, max(D, F) values
  int* head_cnt;       // scratch [H] arrivals of a head's splits, then
  int* gate_cnt;       //   [F / 32] arrivals of a gate block's rows
  float* trace;        // [L, 3D + F] quantizer inputs, or null
  int L, H, F, n_ctx, n_past, layernorm, splits, split_keys;
  float eps, scale;
};

// Shared memory: the block's quantized activation and the norm
// reduction; attention's q row, split result, flag and the new K/V row
// (as the cache stores it); then the chunk pass's area, which phases A and
// D use for x and the norm weights (no phase needs both at once).
struct Smem {
  int8_t* xq;     // [max_in] codes
  int* qsum;      // [max_in / 32]
  float* dx;      // [max_in / 32]
  float* red;     // [NW]
  float* qrow;    // [DH]
  float* outp;    // [DH + 2]
  int* flag;
  unsigned char* own_k;  // [DH] cache elements
  unsigned char* own_v;
  unsigned char* pass;   // the chunk pass; or x [D] | norm weights [D]
  float* xs;
  float* ws;
};

__host__ __device__ inline int attn_tile(int elt, int stage_bytes = ATTN_STAGE_BYTES) {
  return pass_tile_rows(DH * elt, stage_bytes);
}

__host__ __device__ inline size_t smem_layout(int D, int F, int elt, unsigned char* base, Smem* sm,
                                               int stage_bytes = ATTN_STAGE_BYTES) {
  const int max_in = D > F ? D : F;
  const size_t pass = pass_smem_bytes(attn_tile(elt, stage_bytes), DH * elt, false, NT, ATTN_STAGES);
  const size_t xw = 8 * static_cast<size_t>(D);
  const size_t sizes[10] = {static_cast<size_t>(max_in), 4 * static_cast<size_t>(max_in / QK),
                            4 * static_cast<size_t>(max_in / QK), 4 * NW, 4 * DH, 4 * (DH + 2), 4,
                            static_cast<size_t>(DH * elt), static_cast<size_t>(DH * elt), pass > xw ? pass : xw};
  size_t at[10], o = 0;
  for (int i = 0; i < 10; ++i) {
    at[i] = o;
    o += round16(sizes[i]);
  }
  if (sm != nullptr)
    *sm = {reinterpret_cast<int8_t*>(base + at[0]), reinterpret_cast<int*>(base + at[1]),
           reinterpret_cast<float*>(base + at[2]),  reinterpret_cast<float*>(base + at[3]),
           reinterpret_cast<float*>(base + at[4]),  reinterpret_cast<float*>(base + at[5]),
           reinterpret_cast<int*>(base + at[6]),    base + at[7], base + at[8], base + at[9],
           reinterpret_cast<float*>(base + at[9]),  reinterpret_cast<float*>(base + at[9]) + D};
  return o;
}

// Sum over the block in a fixed order: every thread gets the same value.
__device__ float block_sum_nt(float v, float* red) {
  v = warp_sum_f(v);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < NW; ++w) s += red[w];
  return s;
}

// Start copying a norm's weights [D] into shared memory; issued before the
// barrier that precedes their phase, since they do not depend on it.
__device__ void stage_weights(const float* w, int D, const Smem& sm) {
  for (int i = threadIdx.x; i < D / 4; i += NT) cp_async16(sm.ws + 4 * i, w + 4 * i);
  cp_async_commit();
}

// Copy x [D] into shared memory (read through L2: other blocks wrote it)
// and take its ggml_norm (mean-centered) or RMSNorm statistics.  Every
// block runs the same code on the same data and gets the same values.
// The norm weights (stage_weights) must be on their way.
__device__ NormStats stage_x(const float* x, int D, int layernorm, float eps, const Smem& sm) {
  for (int i = threadIdx.x; i < D / 4; i += NT)
    reinterpret_cast<float4*>(sm.xs)[i] = __ldcg(reinterpret_cast<const float4*>(x) + i);
  cp_async_wait<0>();  // and the norm weights
  __syncthreads();
  float s = 0.0f;
  for (int i = threadIdx.x; i < D; i += NT) s += layernorm ? sm.xs[i] : __fmul_rn(sm.xs[i], sm.xs[i]);
  const float m = __fdiv_rn(block_sum_nt(s, sm.red), static_cast<float>(D));
  if (!layernorm) return {0.0f, sqrtf(__fadd_rn(m, eps))};
  float c2 = 0.0f;
  for (int i = threadIdx.x; i < D; i += NT) {
    const float c = __fsub_rn(sm.xs[i], m);
    c2 += __fmul_rn(c, c);
  }
  const float var = __fdiv_rn(block_sum_nt(c2, sm.red), static_cast<float>(D));
  return {m, sqrtf(__fadd_rn(var, eps))};
}

// Quantize act(i), i < n, into this block's shared memory (and the values
// to `trace` when given): four lanes a 32-block, eight elements a lane (the
// block's group 8j..8j+7 on lane j), so that a warp takes eight blocks at
// once.  The codes, sums and scales are quantize_block_warp's: amax and the
// sum are exact in any order, d and 1/d the same divisions.
template <typename Act>
__device__ void quantize_local(Act act, int n, const Smem& sm, float* trace) {
  const int j = threadIdx.x & 3, nblk = n / QK;
  for (int b0 = 0; b0 < nblk; b0 += NT / 4) {  // the same trip count on every lane
    const int b = b0 + (threadIdx.x >> 2);
    const bool live = b < nblk;
    float v[8];
    float amax = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = live ? act(b * QK + 8 * j + e) : 0.0f;
      amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const float d = __fdiv_rn(amax, 7.0f);
    const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
    uint32_t even = 0, odd = 0;
    int sum = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int qi = static_cast<int>(truncf(__fadd_rn(__fmul_rn(v[e], inv), v[e] >= 0.0f ? 0.5f : -0.5f)));
      sum += qi;
      // element 8j + e: byte ((e & 1) * 4 + j) * 4 + e / 2 of the block (quantize_block_warp's order)
      const uint32_t byte = static_cast<uint32_t>(qi & 0xff) << (8 * (e >> 1));
      if (e & 1) odd |= byte; else even |= byte;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (live) {
      reinterpret_cast<uint32_t*>(sm.xq + b * QK)[j] = even;
      reinterpret_cast<uint32_t*>(sm.xq + b * QK)[4 + j] = odd;
      if (trace != nullptr)
        for (int e = 0; e < 8; ++e) trace[b * QK + 8 * j + e] = v[e];
      if (j == 0) {
        sm.qsum[b] = sum;
        sm.dx[b] = d;
      }
    }
  }
  __syncthreads();
}

// Copy the published activation of n values into this block's shared memory.
__device__ void load_published(Staged st, int n, const Smem& sm) {
  __syncthreads();  // the previous phase's reads of the staging area are done
  const uint4* src = reinterpret_cast<const uint4*>(st.xq);
  for (int i = threadIdx.x; i < n / 16; i += NT) reinterpret_cast<uint4*>(sm.xq)[i] = __ldcg(src + i);
  for (int i = threadIdx.x; i < n / QK; i += NT) {
    sm.qsum[i] = __ldcg(st.qsum + i);
    sm.dx[i] = __ldcg(st.dx + i);
  }
  __syncthreads();
}

__device__ __forceinline__ void l2_prefetch(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// Ask L2 for the nibbles of the first row that each warp of this block
// reads in the product over layer il of `w` (out rows of nb blocks).
__device__ void prefetch_rows(Weight w, int il, int out, int nb) {
  const int r = blockIdx.x * NW + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0 && r < out) l2_prefetch(w.qs + (static_cast<size_t>(il) * out + r) * nb * 16, nb * 16);
}

// y[row] (= or +=) W[il][row] . the block's activation: a warp takes rows
// r and r + stride together (stride: the grid's warps), rows with a grid
// stride (the rows of warp g: g + k * stride); lane 0 writes them.
template <bool ACC>
__device__ void q4_rows2(Weight w, int il, int out, int nb, const Smem& sm, float* y) {
  const int lane = threadIdx.x & 31, stride = gridDim.x * NW;
  const uint8_t* qs = w.qs + static_cast<size_t>(il) * out * nb * 16;
  const float* dw = w.d + static_cast<size_t>(il) * out * nb;
  const uint4* xq4 = reinterpret_cast<const uint4*>(sm.xq);
  for (int r0 = blockIdx.x * NW + (threadIdx.x >> 5); r0 < out; r0 += 2 * stride) {
    const int r1 = r0 + stride;
    const bool two = r1 < out;
    const uint4* w0 = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(r0) * nb * 16);
    const uint4* w1 = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(two ? r1 : r0) * nb * 16);
    const float* d0 = dw + static_cast<size_t>(r0) * nb;
    const float* d1 = dw + static_cast<size_t>(two ? r1 : r0) * nb;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
    for (int b = lane; b < nb; b += 32) {
      const uint4 q0 = __ldcs(w0 + b), q1 = __ldcs(w1 + b);  // streamed once: evict first
      const float s0 = __ldg(d0 + b), s1 = __ldg(d1 + b);
      const uint4 xe = xq4[2 * b], xo = xq4[2 * b + 1];
      const int qsb = sm.qsum[b];
      const float dxb = sm.dx[b];
      a0 = __fadd_rn(a0, __fmul_rn(static_cast<float>(block_dot(q0, xe, xo, qsb)), __fmul_rn(s0, dxb)));
      a1 = __fadd_rn(a1, __fmul_rn(static_cast<float>(block_dot(q1, xe, xo, qsb)), __fmul_rn(s1, dxb)));
    }
    a0 = warp_sum_f(a0);
    a1 = warp_sum_f(a1);
    if (lane == 0) {
      y[r0] = ACC ? __fadd_rn(__ldcg(y + r0), a0) : a0;
      if (two) y[r1] = ACC ? __fadd_rn(__ldcg(y + r1), a1) : a1;
    }
  }
}

// After the w13 rows: count this warp's rows into their gate blocks (32
// g1 rows and their 32 g3 rows); the warp whose row completes a block
// computes SwiGLU of its 32 values, quantizes and publishes them (and
// traces them), and resets its counter.  One fence a warp, its arrivals
// issued together, one lane a row.
__device__ void gate_arrivals(const Args& a, int D, float* tr) {
  const int lane = threadIdx.x & 31, F = a.F, stride = gridDim.x * NW;
  const int first = blockIdx.x * NW + (threadIdx.x >> 5);
  if (lane == 0) __threadfence();  // the rows lane 0 wrote, before their arrivals
  __syncwarp();
  for (int k0 = 0; first + k0 * stride < 2 * F; k0 += 32) {
    const int row = first + (k0 + lane) * stride;
    int gb = 0, last = 0;
    if (row < 2 * F) {
      gb = (row < F ? row : row - F) / QK;
      last = atomicAdd(a.gate_cnt + gb, 1) == 2 * QK - 1;
    }
    unsigned done = __ballot_sync(0xffffffffu, last);
    while (done) {
      const int b = __shfl_sync(0xffffffffu, gb, __ffs(done) - 1);
      done &= done - 1;
      __threadfence();
      const int i = b * QK + lane;
      const float v = swiglu(__ldcg(a.g13 + i), __ldcg(a.g13 + F + i));
      if (tr != nullptr) tr[3 * D + i] = v;
      quantize_block_warp(v, lane, a.st.xq + b * QK, a.st.qsum + b, a.st.dx + b);
      if (lane == 0) a.gate_cnt[b] = 0;
    }
  }
}

// Element d of rope(x) for one head: pair (2j, 2j+1) rotated by (cs, sn).
__device__ __forceinline__ float rope_elem(const float* x, int d, float cs, float sn) {
  const float x0 = __ldcg(x + (d & ~1)), x1 = __ldcg(x + (d | 1));
  return (d & 1) ? __fadd_rn(__fmul_rn(x0, sn), __fmul_rn(x1, cs))
                 : __fsub_rn(__fmul_rn(x0, cs), __fmul_rn(x1, sn));
}

// Phase B: the chunk pass over keys 0..n_past of every head of layer il;
// the last split of a head to arrive combines the head and publishes its
// ctx, quantized (and traced at `tr` when given).
// Start this block's first attention item of layer il (its first tiles
// of K/V rows on their way), so that they stream during the wqkv product
// and barrier 1: rows 0..n_past - 1 are already in the cache, and the new
// row n_past is the pass's own row, never read from the cache.
template <typename T>
__device__ void attention_begin(const Args& a, int il, const Smem& sm) {
  const int S = a.splits, item = blockIdx.x, n_keys = a.n_past + 1;
  if (item >= a.H * S) return;
  const int h = item / S, c = item % S, j0 = c * a.split_keys;
  const size_t head = (static_cast<size_t>(il) * a.H + h) * a.n_ctx * DH;
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  chunk_begin<T, NT, ATTN_STAGES>(kc + head, vc + head, nullptr, nullptr, DH, j0, min(a.split_keys, n_keys - j0),
                                  attn_tile(sizeof(T)), sm.pass, c == S - 1 ? a.n_past : -1);
}

template <typename T>
__device__ void attention(const Args& a, int il, float cs, float sn, const Smem& sm, float* tr) {
  const int tid = threadIdx.x, D = a.H * DH, S = a.splits, n_keys = a.n_past + 1;
  T* kc = static_cast<T*>(a.k);
  T* vc = static_cast<T*>(a.v);
  for (int item = blockIdx.x; item < a.H * S; item += gridDim.x) {
    const int h = item / S, c = item % S;
    const size_t head = (static_cast<size_t>(il) * a.H + h) * a.n_ctx * DH;
    __syncthreads();  // the previous item is done with qrow, outp, flag and the own row
    const bool own = c == S - 1;  // this block owns head h's new row
    const int j0 = c * a.split_keys;
    chunk_pass<T, NT, ATTN_STAGES>(
        sm.qrow,
        [&] {  // while the first tiles are in flight: rope q; the new K/V row to the cache and to shared memory
          if (tid < DH) {
            sm.qrow[tid] = rope_elem(a.qkv + h * DH, tid, cs, sn);
            if (own) {
              const T kn = from_f32<T>(rope_elem(a.qkv + D + h * DH, tid, cs, sn));
              const T vn = from_f32<T>(__ldcg(a.qkv + 2 * D + h * DH + tid));
              reinterpret_cast<T*>(sm.own_k)[tid] = kn;
              reinterpret_cast<T*>(sm.own_v)[tid] = vn;
              kc[head + static_cast<size_t>(a.n_past) * DH + tid] = kn;
              vc[head + static_cast<size_t>(a.n_past) * DH + tid] = vn;
            }
          }
        },
        kc + head, vc + head, nullptr, nullptr, DH, j0, min(a.split_keys, n_keys - j0), attn_tile(sizeof(T)),
        a.scale, sm.pass, sm.outp, own ? a.n_past : -1, reinterpret_cast<const T*>(sm.own_k),
        reinterpret_cast<const T*>(sm.own_v), item == blockIdx.x);
    float* ph = a.part + static_cast<size_t>(h) * S * (DH + 2);
    if (tid < DH + 2) ph[c * (DH + 2) + tid] = sm.outp[tid];
    __threadfence();
    __syncthreads();
    if (tid == 0) *sm.flag = atomicAdd(a.head_cnt + h, 1) == S - 1;
    __syncthreads();
    if (*sm.flag) {  // every split of head h is in: combine, quantize its four 32-blocks (a warp each)
      __threadfence();
      if (tid < DH) {
        const float v = combine_splits(ph, S, DH);
        const int b = h * (DH / QK) + (tid >> 5);
        if (tr != nullptr) tr[b * QK + (tid & 31)] = v;
        quantize_block_warp(v, tid & 31, a.st.xq + b * QK, a.st.qsum + b, a.st.dx + b);
      }
      if (tid == 0) a.head_cnt[h] = 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) fused_layers_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int D = a.H * DH, F = a.F, tid = threadIdx.x;
  Smem sm;
  smem_layout(D, F, sizeof(T), fused_smem, &sm);
  // the arrival counters start at zero; barrier 1 orders this before their first use
  for (int i = blockIdx.x * NT + tid; i < a.H + F / QK; i += gridDim.x * NT) a.head_cnt[i] = 0;
  stage_weights(a.anorm, D, sm);
  float cs = 0.0f, sn = 0.0f;  // rope of dim tid at n_past: angle n_past * 10000^(-2j/DH), j = tid / 2
  if (tid < DH) {
    const float ang = static_cast<float>(a.n_past) *
                      powf(10000.0f, __fdiv_rn(-static_cast<float>(2 * (tid >> 1)), static_cast<float>(DH)));
    cs = cosf(ang);
    sn = sinf(ang);
  }
  for (int il = 0; il < a.L; ++il) {
    float* tr = a.trace ? a.trace + static_cast<size_t>(il) * (3 * D + F) : nullptr;
    float* tr0 = blockIdx.x == 0 ? tr : nullptr;  // one block traces the norm activations
    // (A) attention norm, quantized in every block; wqkv
    const NormStats ns = stage_x(a.x, D, a.layernorm, a.eps, sm);
    quantize_local([&](int i) { return norm_elem(sm.xs[i], sm.ws[i], ns); }, D, sm, tr0);
    attention_begin<T>(a, il, sm);  // x and the norm weights are done with the pass's memory
    q4_rows2<false>(a.wqkv, il, 3 * D, D / QK, sm, a.qkv);
    prefetch_rows(a.wo, il, D, D / QK);
    grid.sync();
    // (B) rope, new K/V, attention; each head's last split combines and publishes ctx
    attention<T>(a, il, cs, sn, sm, tr ? tr + D : nullptr);
    grid.sync();
    // (C) wo + residual
    load_published(a.st, D, sm);
    q4_rows2<true>(a.wo, il, D, D / QK, sm, a.x);
    stage_weights(a.fnorm + static_cast<size_t>(il) * D, D, sm);
    prefetch_rows(a.w13, il, 2 * F, D / QK);
    grid.sync();
    // (D) ffn norm, quantized in every block; w13; a gate block's last row quantizes SwiGLU
    const NormStats fs = stage_x(a.x, D, a.layernorm, a.eps, sm);
    quantize_local([&](int i) { return norm_elem(sm.xs[i], sm.ws[i], fs); }, D, sm, tr0 ? tr0 + 2 * D : nullptr);
    q4_rows2<false>(a.w13, il, 2 * F, D / QK, sm, a.g13);
    gate_arrivals(a, D, tr);
    prefetch_rows(a.w2, il, D, F / QK);
    grid.sync();
    // (E) w2 + residual
    load_published(a.st, F, sm);
    q4_rows2<true>(a.w2, il, D, F / QK, sm, a.x);
    if (il + 1 < a.L) {
      stage_weights(a.anorm + static_cast<size_t>(il + 1) * D, D, sm);
      prefetch_rows(a.wqkv, il + 1, 3 * D, D / QK);
    }
    grid.sync();
  }
}

size_t kernel_smem(int D, int F, int kind) { return smem_layout(D, F, kind == 0 ? 4 : 2, nullptr, nullptr); }

int blocks_for(int kind, size_t smem) {
  switch (kind) {
    case 0: return coop_blocks(fused_layers_kernel<float>, smem, NT, BLOCKS_PER_SM);
    case 1: return coop_blocks(fused_layers_kernel<__nv_bfloat16>, smem, NT, BLOCKS_PER_SM);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Scratch: floats qkv [3D] | g13 [2F] | partials [H, S, DH + 2], then the
// published activation's codes [max_in] | sums, scales [max_in / 32], then
// the counters [H + F / 32]; the sizes of its parts in bytes.
struct Scratch {
  size_t floats, codes, sums, counters;
};
Scratch scratch_parts(int H, int F, int n_past) {
  const int D = H * DH, max_in = D > F ? D : F, S = split_plan(n_past + 1, ATTN_MAX_SPLITS).splits;
  return {round16(4 * (3 * static_cast<size_t>(D) + 2 * static_cast<size_t>(F) +
                       static_cast<size_t>(H) * S * (DH + 2))),
          round16(max_in), round16(8 * static_cast<size_t>(max_in / QK)), 4 * static_cast<size_t>(H + F / QK)};
}

// ---------------------------------------------------------------------------
// one layer's attention block (fused_attn_block) on the phases above
// ---------------------------------------------------------------------------

struct BlockArgs {
  const float* x;      // [D]
  const float* norm;   // [D] the layer's attention norm
  const float* cos;    // [DH] the caller's rope vectors of position n_past:
  const float* sin_s;  //   cos repeated per pair, sin signed -/+ for the even/odd element
  Weight wqkv, wo;     // stacked, read at layer il
  const void* k;       // [L, H, n_ctx, DH] f32 or bf16, only read, at rows j < n_past
  const void* v;
  float* delta;        // [D] out
  float* k_new;        // [H, DH] out, rounded through the cache type
  float* v_new;
  float* qkv;          // scratch [3D]
  float* part;         // scratch [H, S, DH + 2]
  Staged st;           // scratch: the published ctx, D values
  int* head_cnt;       // scratch [H] arrivals of a head's splits
  float* trace;        // [2D] quantizer inputs (h, ctx), or null
  int il, H, n_ctx, n_past, layernorm, splits, split_keys;
  float eps, scale;
};

// The block's attention plan: splits of a head over the history keys j <
// n_past, as many as the grid holds items for every head (at most blocks
// / H a head: 4 at 32 heads and 132 blocks, 3 at 40, 2 at 52 and 64), none
// at n_past 0 (no history: ctx is the own term alone).
SplitPlan block_split_plan(int H, int n_past, int blocks) {
  if (n_past == 0) return {0, 0};
  const int most = blocks / H;
  return split_plan(n_past, most > 1 ? most : 1);
}

// Element d of rope(x) for one head with the caller's vectors: two products
// and a sum, each rounded, as the plain version's x * cos + swap(x) * sin_s.
__device__ __forceinline__ float rope_cs(const float* x, int d, const BlockArgs& a) {
  return __fadd_rn(__fmul_rn(__ldcg(x + d), __ldg(a.cos + d)), __fmul_rn(__ldcg(x + (d ^ 1)), __ldg(a.sin_s + d)));
}

// Start this block's first attention item (its first tiles of history
// K/V rows on their way), so that they stream during the wqkv product and
// barrier 1.
template <typename T>
__device__ void block_attention_begin(const BlockArgs& a, const Smem& sm) {
  const int S = a.splits, item = blockIdx.x;
  if (item >= a.H * S) return;
  const int h = item / S, c = item % S, j0 = c * a.split_keys;
  const size_t head = (static_cast<size_t>(a.il) * a.H + h) * a.n_ctx * DH;
  chunk_begin<T, NT, ATTN_STAGES>(static_cast<const T*>(a.k) + head, static_cast<const T*>(a.v) + head, nullptr,
                                  nullptr, DH, j0, min(a.split_keys, a.n_past - j0),
                                  attn_tile(sizeof(T), BLOCK_STAGE_BYTES), sm.pass);
}

// Head h's ctx, by the block that brings its last split (or, at n_past 0,
// the head's block; sm.qrow holds its roped q): the S history splits at ph
// combined in split order, then the own term last, from the cache-rounded
// new K/V (the JAX block's update: m' = max(m, s), l' = l exp(m - m') +
// exp(s - m'), acc' = acc exp(m - m') + exp(s - m') v_new); ctx quantized
// and published (a warp a 32-block), k_new and v_new out.
template <typename T>
__device__ void finish_head(const BlockArgs& a, int h, const float* ph, int S, const Smem& sm) {
  const int tid = threadIdx.x, D = a.H * DH;
  float kn = 0.0f, vn = 0.0f, q = 0.0f;
  if (tid < DH) {
    kn = to_f32(from_f32<T>(rope_cs(a.qkv + D + h * DH, tid, a)));
    vn = to_f32(from_f32<T>(__ldcg(a.qkv + 2 * D + h * DH + tid)));
    q = sm.qrow[tid];
  }
  const float s_own = block_sum_nt(__fmul_rn(q, kn), sm.red) * a.scale;
  if (tid >= DH) return;
  float m = -INFINITY, l = 0.0f, acc = 0.0f;
  for (int c = 0; c < S; ++c) m = fmaxf(m, __ldcg(ph + c * (DH + 2) + DH));
  for (int c = 0; c < S; ++c) {
    const float* pc = ph + c * (DH + 2);
    const float w = expf(__ldcg(pc + DH) - m);
    l += w * __ldcg(pc + DH + 1);
    acc += w * __ldcg(pc + tid);
  }
  const float mf = fmaxf(m, s_own);
  const float alpha = expf(m - mf), p_own = expf(s_own - mf);  // alpha = 0 without history
  const float v = (acc * alpha + p_own * vn) / (l * alpha + p_own);
  a.k_new[h * DH + tid] = kn;
  a.v_new[h * DH + tid] = vn;
  const int b = h * (DH / QK) + (tid >> 5);
  if (a.trace != nullptr) a.trace[D + b * QK + (tid & 31)] = v;
  quantize_block_warp(v, tid & 31, a.st.xq + b * QK, a.st.qsum + b, a.st.dx + b);
}

// Phase B of the block: the chunk pass over the history keys of every
// (head, split) item; the last split of a head to arrive finishes it.
template <typename T>
__device__ void block_attention(const BlockArgs& a, const Smem& sm) {
  const int tid = threadIdx.x, S = a.splits;
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  if (S == 0) {  // n_past 0: no history, a block a head
    for (int h = blockIdx.x; h < a.H; h += gridDim.x) {
      __syncthreads();  // the previous head is done with qrow
      if (tid < DH) sm.qrow[tid] = rope_cs(a.qkv + h * DH, tid, a);
      __syncthreads();
      finish_head<T>(a, h, nullptr, 0, sm);
    }
    return;
  }
  for (int item = blockIdx.x; item < a.H * S; item += gridDim.x) {
    const int h = item / S, c = item % S, j0 = c * a.split_keys;
    const size_t head = (static_cast<size_t>(a.il) * a.H + h) * a.n_ctx * DH;
    __syncthreads();  // the previous item is done with qrow, outp and flag
    chunk_pass<T, NT, ATTN_STAGES>(
        sm.qrow, [&] { if (tid < DH) sm.qrow[tid] = rope_cs(a.qkv + h * DH, tid, a); }, kc + head, vc + head,
        nullptr, nullptr, DH, j0, min(a.split_keys, a.n_past - j0), attn_tile(sizeof(T), BLOCK_STAGE_BYTES), a.scale,
        sm.pass,
        sm.outp, -1, nullptr, nullptr, item == blockIdx.x);
    float* ph = a.part + static_cast<size_t>(h) * S * (DH + 2);
    if (tid < DH + 2) ph[c * (DH + 2) + tid] = sm.outp[tid];
    __threadfence();
    __syncthreads();
    if (tid == 0) *sm.flag = atomicAdd(a.head_cnt + h, 1) == S - 1;
    __syncthreads();
    if (*sm.flag) {  // every split of head h is in
      __threadfence();
      finish_head<T>(a, h, ph, S, sm);
      if (tid == 0) a.head_cnt[h] = 0;
    }
  }
}

// Layer il's attention block: phase A (norm, quantized in every block;
// wqkv rows; the first K/V tiles started) | barrier | phase B (rope,
// attention over the history, each head finished by its last split) |
// barrier | phase C (wo rows -> delta).
template <typename T>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) attn_block_kernel(BlockArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int D = a.H * DH;
  Smem sm;
  smem_layout(D, D, sizeof(T), fused_smem, &sm, BLOCK_STAGE_BYTES);
  // the arrival counters start at zero; barrier 1 orders this before their first use
  for (int i = blockIdx.x * NT + threadIdx.x; i < a.H; i += gridDim.x * NT) a.head_cnt[i] = 0;
  stage_weights(a.norm, D, sm);
  // (A) attention norm, quantized in every block (block 0 traces it); wqkv
  const NormStats ns = stage_x(a.x, D, a.layernorm, a.eps, sm);
  quantize_local([&](int i) { return norm_elem(sm.xs[i], sm.ws[i], ns); }, D, sm,
                 blockIdx.x == 0 ? a.trace : nullptr);
  block_attention_begin<T>(a, sm);  // x and the norm weights are done with the pass's memory
  q4_rows2<false>(a.wqkv, a.il, 3 * D, D / QK, sm, a.qkv);
  prefetch_rows(a.wo, a.il, D, D / QK);
  grid.sync();
  // (B) rope, attention over the history, ctx published by each head's last split
  block_attention<T>(a, sm);
  grid.sync();
  // (C) wo -> delta
  load_published(a.st, D, sm);
  q4_rows2<false>(a.wo, a.il, D, D / QK, sm, a.delta);
}

size_t block_smem(int D, int kind) {
  return smem_layout(D, D, kind == 0 ? 4 : 2, nullptr, nullptr, BLOCK_STAGE_BYTES);
}

int block_blocks_for(int kind, size_t smem) {
  switch (kind) {
    case 0: return coop_blocks(attn_block_kernel<float>, smem, NT, BLOCKS_PER_SM);
    case 1: return coop_blocks(attn_block_kernel<__nv_bfloat16>, smem, NT, BLOCKS_PER_SM);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// The block's scratch: floats qkv [3D] | partials [H, S, DH + 2], then
// the published ctx's codes [D] | sums, scales [D / 32], then the
// counters [H]; the sizes of its parts in bytes.
Scratch block_scratch_parts(int H, int S) {
  const int D = H * DH;
  return {round16(4 * (3 * static_cast<size_t>(D) + static_cast<size_t>(H) * S * (DH + 2))), round16(D),
          round16(8 * static_cast<size_t>(D / QK)), 4 * static_cast<size_t>(H)};
}

}  // namespace

// Bytes of scratch that fused_layers needs for these widths and position
// (about 120 KB at 7B and n_past 511).
extern "C" int fused_layers_scratch_bytes(int H, int F, int n_past) {
  const Scratch s = scratch_parts(H, F, n_past);
  return static_cast<int>(s.floats + s.codes + s.sums + s.counters);
}

// Blocks that fused_layers launches for these widths and cache element
// kind (0 f32, 1 bf16), or a negative cudaError code.
extern "C" int fused_layers_blocks(int H, int F, int kind) {
  return blocks_for(kind, kernel_smem(H * DH, F, kind));
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
  if (H < 1 || D % QK || F % QK || F < QK || n_past < 0 || n_past >= n_ctx || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kernel_smem(D, F, kind);
  const int blocks = blocks_for(kind, smem);
  if (blocks < 0) return -blocks;
  const int max_in = D > F ? D : F;
  const Scratch parts = scratch_parts(H, F, n_past);
  const SplitPlan plan = split_plan(n_past + 1, ATTN_MAX_SPLITS);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float* qkv = reinterpret_cast<float*>(base);
  int8_t* codes = reinterpret_cast<int8_t*>(base + parts.floats);
  int* qsum = reinterpret_cast<int*>(base + parts.floats + parts.codes);
  float* dx = reinterpret_cast<float*>(qsum + max_in / QK);
  int* counters = reinterpret_cast<int*>(base + parts.floats + parts.codes + parts.sums);
  Args a{static_cast<float*>(x),
         static_cast<const float*>(anorm),
         static_cast<const float*>(fnorm),
         {static_cast<const uint8_t*>(wqkv_qs), static_cast<const float*>(wqkv_d)},
         {static_cast<const uint8_t*>(wo_qs), static_cast<const float*>(wo_d)},
         {static_cast<const uint8_t*>(w13_qs), static_cast<const float*>(w13_d)},
         {static_cast<const uint8_t*>(w2_qs), static_cast<const float*>(w2_d)},
         k, v, qkv, qkv + 3 * D, qkv + 3 * D + 2 * F, {codes, qsum, dx}, counters, counters + H,
         static_cast<float*>(trace), L, H, F, n_ctx, n_past, layernorm, plan.splits, plan.keys, eps, scale};
  void* args[] = {&a};
  const void* fn = kind == 0 ? reinterpret_cast<const void*>(fused_layers_kernel<float>)
                             : reinterpret_cast<const void*>(fused_layers_kernel<__nv_bfloat16>);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(NT), args, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the card's grid that the attention block's plan counts on:
// BLOCKS_PER_SM an SM (what coop_blocks gives wherever it fits), or a
// negative cudaError code.
static int card_blocks() {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e != cudaSuccess ? -static_cast<int>(e) : BLOCKS_PER_SM * sms;
}

// Blocks that fused_attn_block launches (cache element kind 0 f32, 1
// bf16), or a negative cudaError code.
extern "C" int fused_attn_block_blocks(int H, int kind) {
  return block_blocks_for(kind, block_smem(H * DH, kind));
}

// The attention block's splits of a head over the history at n_past, and
// the keys of a split (ops/fused_layer.attn_block_plan computes the same).
extern "C" int fused_attn_block_splits(int H, int n_past) {
  const int b = card_blocks();
  return b < 0 ? b : block_split_plan(H, n_past, b).splits;
}
extern "C" int fused_attn_block_split_keys(int H, int n_past) {
  const int b = card_blocks();
  return b < 0 ? b : block_split_plan(H, n_past, b).keys;
}

// Bytes of scratch that fused_attn_block needs at these widths and position.
extern "C" int fused_attn_block_scratch_bytes(int H, int n_past) {
  const int b = card_blocks();
  if (b < 0) return b;
  const Scratch s = block_scratch_parts(H, block_split_plan(H, n_past, b).splits);
  return static_cast<int>(s.floats + s.codes + s.sums + s.counters);
}

// Layer il's attention block of one decode token: delta [D], k_new and
// v_new [H, 128] f32 out; the caches [L, H, n_ctx, 128] are only read, at
// rows j < n_past; cos and sin_s are the rope vectors [128] of position
// n_past.  scratch holds fused_attn_block_scratch_bytes(H, n_past) bytes,
// 16-byte aligned; trace is null or [2D] floats.
extern "C" int fused_attn_block(const void* x, const void* norm, const void* cos, const void* sin_s,
                                const void* wqkv_qs, const void* wqkv_d, const void* wo_qs, const void* wo_d,
                                const void* k, const void* v, void* delta, void* k_new, void* v_new, void* scratch,
                                void* trace, int il, int H, int n_ctx, int n_past, int layernorm, float eps,
                                float scale, int kind, void* stream) {
  const int D = H * DH;
  if (H < 1 || n_past < 0 || n_past >= n_ctx || il < 0 || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = block_smem(D, kind);
  const int blocks = block_blocks_for(kind, smem), cb = card_blocks();
  if (blocks < 0) return -blocks;
  if (cb < 0) return -cb;
  const SplitPlan plan = block_split_plan(H, n_past, cb);
  const Scratch parts = block_scratch_parts(H, plan.splits);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float* qkv = reinterpret_cast<float*>(base);
  int8_t* codes = reinterpret_cast<int8_t*>(base + parts.floats);
  int* qsum = reinterpret_cast<int*>(base + parts.floats + parts.codes);
  float* dx = reinterpret_cast<float*>(qsum + D / QK);
  int* counters = reinterpret_cast<int*>(base + parts.floats + parts.codes + parts.sums);
  BlockArgs a{static_cast<const float*>(x),
              static_cast<const float*>(norm),
              static_cast<const float*>(cos),
              static_cast<const float*>(sin_s),
              {static_cast<const uint8_t*>(wqkv_qs), static_cast<const float*>(wqkv_d)},
              {static_cast<const uint8_t*>(wo_qs), static_cast<const float*>(wo_d)},
              k, v, static_cast<float*>(delta), static_cast<float*>(k_new), static_cast<float*>(v_new),
              qkv, qkv + 3 * D, {codes, qsum, dx}, counters, static_cast<float*>(trace),
              il, H, n_ctx, n_past, layernorm, plan.splits, plan.keys, eps, scale};
  void* args[] = {&a};
  const void* fn = kind == 0 ? reinterpret_cast<const void*>(attn_block_kernel<float>)
                             : reinterpret_cast<const void*>(attn_block_kernel<__nv_bfloat16>);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(NT), args, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
