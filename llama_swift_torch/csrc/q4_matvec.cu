// Batch-1 Q4_0 matvec with the reference's int4 x int4 block dot.
//
// Replaces the TPU kernel `_q4_0_vpu_kernel` / `_q4_0_vpu_kernel_stacked`
// (llama_swift_tpu/ops/q4_vpu_pallas.py, entry points q4_0_vpu_matvec and
// q4_0_vpu_matvec_stacked), which is itself the device form of
// ggml_vec_dot_q4_0 (ggml.c:1296-1582).
//
//   y[o] = sum_b  d_w[o,b] * d_x[b] * ( sum_i n[o,32b+i] * q[32b+i]  -  8 * sum_i q[32b+i] )
//
// with n the stored nibbles (0..15) and q the activation quantized per
// 32-block to integers in [-7, 7] (d_x = amax/7, round half away from zero).
//
// What bounds it on the H100: device-memory bandwidth.  Each weight costs
// 0.625 bytes (half a byte of nibble + 4 bytes of scale per 32) and 2 integer
// operations, far below the int8 tensor rate, so the kernel exists to stream
// the packed weight once at full rate.
//
// Design:
//  * Pre-pass (quantize_x_kernel): one warp per 32-block of x computes amax
//    with shuffles, d_x and the integer q, bit-identical to
//    quantize_activations_q4_0_int (explicit _rn intrinsics: nvcc would
//    otherwise contract x*inv + 0.5 into one FMA and round ties differently).
//    It stores q de-interleaved per block so that it lines up with the
//    nibble bytes: bytes 0..15 hold the even elements of each 8-group, bytes
//    16..31 the odd ones, plus sum(q) per block.
//  * Main kernel: one warp per output row, eight rows per block.  Lane l
//    reads block b = l, l+32, ... of its row: 16 contiguous bytes of
//    nibbles (a warp reads 512 contiguous bytes per step) and the matching
//    32 bytes of q.  Low nibbles (w & 0x0F0F0F0F) pair with the even q
//    bytes, high nibbles with the odd ones; __dp4a takes four products a
//    time, so a block is 8 dp4a.  The -8 offset is removed once per block
//    as 8*sum(q), like the TPU kernel's aux row.  Block partials are exact
//    integers; only the f32 sum over blocks is reassociated (per lane, then
//    a warp shuffle reduction).
//
// Multi-row matmul (q4_0_matmul_multi, 2..32 activation rows, the batched
// decode step of the continuous-batching engine).
//
// Replaces the TPU kernel `_make_multi_kernel` / `_multi_grid_kernel*`
// (llama_swift_tpu/ops/q4_vpu_pallas.py, entry point q4_0_vpu_matmul_multi):
//
//   y[r, o] = sum_b d_w[o,b] * d_x[r,b] * (sum_i n[o,32b+i] q[r,32b+i] - 8 sum_i q[r,32b+i])
//
// What bounds it on the H100: still the weight stream at small B (the same
// 0.625 bytes a weight as the matvec, now shared by B rows); the work grows
// to 2*B integer operations a weight, which at B = 32 is still far below
// the dp4a rate.  The activation side is B times larger than for the
// matvec: 88 KB of int8 at B = 8, in = 11008, and 352 KB at B = 32, more
// than a block's 227 KB of shared memory.
//
// Design: the pre-pass is the matvec's quantize_x_kernel over all B*nb
// blocks of the row-major [B, in] activation (a row's blocks follow each
// other, so one launch quantizes every row with the same rounding).  The
// main kernel keeps the matvec's warp-per-output-row shape: lane l loads
// weight block b = l, l+32, ... ONCE (16 bytes of nibbles and its scale)
// and dp4a-dots it against the matching 32 bytes of every row's q, which
// are read through L1/L2 with __ldg rather than staged in shared memory,
// so no row count overflows it.  The lane keeps one f32 accumulator per
// row (a compile-time row count R in {2, 4, 8, 16, 32}; rows >= B are
// skipped), and a warp reduction per row finishes each output.
//
// Q4_1 matvec (q4_1_matvec, batch 1 against Q4_1 weights).
//
// Replaces the TPU kernels `_q4_1_vpu_kernel` / `_q4_1_vpu_kernel_stacked`
// and their manually pipelined forms (llama_swift_tpu/ops/q4_vpu_pallas.py,
// entry points q4_1_vpu_matvec and q4_1_vpu_matvec_stacked):
//
//   y[o] = sum_b  d_w[o,b] * sum_i n[o,32b+i] * xh[32b+i]  +  m_w[o,b] * sum_i xh[32b+i]
//
// with n the stored nibbles (0..15), (d_w, m_w) the block's delta and min,
// and xh = q * d_x + m_x the activation quantized per 32-block through Q4_1
// (min/max, d_x = (max - min)/15, q = round((x - min)/d_x) in 0..15).
//
// What bounds it on the H100: device-memory bandwidth, 0.75 bytes a weight
// (16 bytes of nibbles plus 8 of delta and min per 32), 20 % more than Q4_0.
//
// Design: the Q4_0 matvec's shape.  The pre-pass (quantize_x_q4_1_kernel)
// reproduces quantize_activations_q4_1's codes (explicit _rn intrinsics,
// __fdiv_rn for /15 and 1/d, min and max by shuffles) and stores them
// de-interleaved like the Q4_0 codes, plus per block {d_x, m_x, sum(xh)}
// (one 16-byte load).  The main kernel is one warp per output row, lane l
// on blocks l, l+32, ...: 16 bytes of nibbles and one 8-byte (d, m) load a
// block.  ggml_vec_dot_q4_1's algebra (ggml.c:1584-1626) makes the block
// integer work: sum(n * xh) = d_x * sum(n * q) + m_x * sum(n), and dp4a
// takes both sum(n * q) (8 dp4a, as for Q4_0) and sum(n) (8 more, against
// 0x01 bytes).  This rounds otherwise than the plain version, which rounds
// each xh and sums n * xh in f32; both stay within 1e-5 of max |y|.
//
// f32 activations (q4_0_matvec_f32, q4_1_matvec_f32, q4_0_matmul_multi_f32:
// ModelConfig.quantize_activations = False).
//
// Replace the same TPU kernels fed unquantized rows (_prep_inputs,
// _prep_inputs_q41 and _prep_inputs_multi with quantize_acts=False in
// llama_swift_tpu/ops/q4_vpu_pallas.py: d_x = 1, x itself in place of the
// codes):
//
//   Q4_0:  y[r, o] = sum_b d[o,b] * sum_i (n[o,32b+i] - 8) * x[r, 32b+i]
//   Q4_1:  y[o]    = sum_b d[o,b] * sum_i n[o,32b+i] * x[32b+i]  +  m[o,b] * sum_i x[32b+i]
//
// The TPU kernel takes sum(n*x) - 8*sum(x) in a phase-major order scaled by
// 16^-p for Mosaic's lanes; these kernels take the plain sums, equal up to
// reassociation.  Plain f32 arithmetic: no fast math, no TF32, no bf16.  A
// nibble becomes a float without a conversion instruction: placed under the
// exponent of 2^23 (0x4B000000 | n is exactly 2^23 + n), one subtraction
// leaves n - 8 (Q4_0) or n (Q4_1) exactly.
//
// What bounds them on the H100: the matvecs, device-memory bandwidth (the
// bytes of the packed weight, as rows 1 and 5); the multi-row kernel, the
// weight bytes at small B and the f32 rate at large B (2*B operations a
// weight: at 11008x4096, 10.8 us of f32 work at B = 8 against 8.6 us of
// bytes).
//
// Design, matvecs: the activation row is staged once per block in shared
// memory (16 KB at in 4096, 44 KB at in 11008), transposed to [8][nb] float4
// so that lane l, on blocks l, l+32, ..., reads consecutive float4 (no bank
// conflict; the row stride is odd, so the staging writes do not conflict
// either).  The matvec's shape is kept: one warp per output row, 16 bytes of
// nibbles a block; each block's 32 products go to one f32 sum, scaled by d
// (Q4_1: plus m times the block's sum of x, computed once per block of
// threads from the staged copy).  The grid is capped at 8 blocks an SM and
// each warp strides over rows, so the row is staged a bounded number of
// times whatever the output count.
//
// Design, multi-row: B f32 rows do not fit in shared memory (352 KB at
// B = 8, in = 11008), and reading them through L1/L2 as the int8 kernel
// does would read 4 bytes of x from L2 per product for every warp.  So the
// in-dim is tiled through shared memory: the 8 warps of a block (16 output
// rows) share each staged chunk of 32 weight blocks of every row (B * 4.1 KB,
// 135 KB at B = 32), laid out so that lane l reads 8-element group l of an
// 8-block sub-chunk as two conflict-free float4.  Lane l holds word l%4 of
// block l/4 of the sub-chunk for TWO output rows (a coalesced 128-byte read
// per row and warp), unpacks them to registers once, and dots them against
// all B rows (a compile-time row count R in {2, 4, 8, 16, 32}, rows >= B
// skipped): each x value read from shared memory feeds two products (2
// bytes a product, against 4 with one output row per lane).  A chunk's
// weight words are read before its x is staged, so the two sets of reads
// overlap; the staging reads 16 floats a thread before it stores any, with
// no integer division (one L2 round trip per element, or a division per
// element, each cost about as much as the products at B = 8).  Each lane's
// 8-element partial is scaled by its block's d; a warp reduction per output
// row and x row finishes each output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "q4_common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

// x [nb*32] f32 -> xq [nb][32] int8 (de-interleaved), qsum [nb] int32, dx [nb] f32
__global__ void quantize_x_kernel(const float* __restrict__ x, int nb,
                                  int8_t* __restrict__ xq, int* __restrict__ qsum,
                                  float* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= nb) return;
  quantize_block_warp(x[b * QK + lane], lane, xq + b * QK, qsum + b, dx + b);
}

// x [nb*32] f32 -> xq [nb][32] u8 codes 0..15 (de-interleaved like the Q4_0
// codes), xs [nb] {d_x, m_x, sum of xh, 0}; the arithmetic of
// quantize_activations_q4_1 and dequantize_activations_q4_1
__global__ void quantize_x_q4_1_kernel(const float* __restrict__ x, int nb, uint8_t* __restrict__ xq,
                                       float4* __restrict__ xs) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= nb) return;
  const float v = x[b * QK + lane];
  const float mn = warp_min(v);
  const float d = __fdiv_rn(__fsub_rn(warp_max(v), mn), 15.0f);
  const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
  const float q = truncf(__fadd_rn(__fmul_rn(__fsub_rn(v, mn), inv), 0.5f));  // v - mn >= 0
  const int g = lane >> 3, r = lane & 7;
  xq[b * QK + ((r & 1) * 4 + g) * 4 + (r >> 1)] = static_cast<uint8_t>(q);
  const float xsum = warp_sum_f(__fadd_rn(__fmul_rn(q, d), mn));
  if (lane == 0) xs[b] = make_float4(d, mn, xsum, 0.0f);
}

// qs [out][nb*16] u8, dm [out][nb] {d, m} f32 -> y [out] f32
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q4_1_matvec_kernel(const uint8_t* __restrict__ qs, const float2* __restrict__ dm,
                   const uint8_t* __restrict__ xq, const float4* __restrict__ xs,
                   float* __restrict__ y, int out, int nb) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= out) return;
  const uint4* wrow = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(row) * nb * 16);
  const float2* dmrow = dm + static_cast<size_t>(row) * nb;
  const uint4* xq4 = reinterpret_cast<const uint4*>(xq);
  const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  float acc = 0.0f;
#pragma unroll 4
  for (int b = lane; b < nb; b += 32) {
    const uint4 w = __ldg(wrow + b);
    const float2 wdm = __ldg(dmrow + b);
    const float4 s = __ldg(xs + b);
    const int nq = block_dot(w, __ldg(xq4 + 2 * b), __ldg(xq4 + 2 * b + 1), 0);  // sum(n * q)
    const int n = block_dot(w, ones, ones, 0);                                   // sum(n)
    const float nx = s.x * static_cast<float>(nq) + s.y * static_cast<float>(n);  // sum(n * xh)
    acc += wdm.x * nx + wdm.y * s.z;
  }
  acc = warp_sum_f(acc);
  if (lane == 0) y[row] = acc;
}

// qs [out][nb*16] u8, dw [out][nb] f32 -> y [out] f32
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q4_0_matvec_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ dw,
                   const int8_t* __restrict__ xq, const int* __restrict__ qsum,
                   const float* __restrict__ dx, float* __restrict__ y,
                   int out, int nb) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= out) return;
  const uint4* wrow = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(row) * nb * 16);
  const float* drow = dw + static_cast<size_t>(row) * nb;
  const uint4* xq4 = reinterpret_cast<const uint4*>(xq);
  float acc = 0.0f;
#pragma unroll 4
  for (int b = lane; b < nb; b += 32) {
    const uint4 w = __ldg(wrow + b);
    const uint4 qe = __ldg(xq4 + 2 * b);
    const uint4 qo = __ldg(xq4 + 2 * b + 1);
    const int part = block_dot(w, qe, qo, __ldg(qsum + b));
    const float scale = __fmul_rn(__ldg(drow + b), __ldg(dx + b));
    acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(part), scale));
  }
  acc = warp_sum_f(acc);
  if (lane == 0) y[row] = acc;
}

// qs [out][nb*16] u8, dw [out][nb] f32, xq [B][nb*32] i8, qsum/dx [B][nb]
//   -> y [B][out] f32; R >= B accumulators per lane
template <int R>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q4_0_matmul_multi_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ dw,
                         const int8_t* __restrict__ xq, const int* __restrict__ qsum,
                         const float* __restrict__ dx, float* __restrict__ y,
                         int out, int nb, int B) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= out) return;
  const uint4* wrow = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(row) * nb * 16);
  const float* drow = dw + static_cast<size_t>(row) * nb;
  const uint4* xq4 = reinterpret_cast<const uint4*>(xq);
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  for (int b = lane; b < nb; b += 32) {
    const uint4 w = __ldg(wrow + b);
    const float d = __ldg(drow + b);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < B) {
        const size_t xb = static_cast<size_t>(r) * nb + b;  // block b of row r
        const uint4 qe = __ldg(xq4 + 2 * xb);
        const uint4 qo = __ldg(xq4 + 2 * xb + 1);
        const int part = block_dot(w, qe, qo, __ldg(qsum + xb));
        const float scale = __fmul_rn(d, __ldg(dx + xb));
        acc[r] = __fadd_rn(acc[r], __fmul_rn(static_cast<float>(part), scale));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < B) {
      const float v = warp_sum_f(acc[r]);
      if (lane == 0) y[static_cast<size_t>(r) * out + row] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 activations
// ---------------------------------------------------------------------------

constexpr int F32_CHUNK = 32;             // weight blocks of a staged chunk (multi-row)
constexpr int F32_GROUP_STRIDE = 132;     // 8-element groups of a staged chunk (128) + 4
constexpr int MULTI_F32_ROWS = 2;         // output rows a lane holds (multi-row)
constexpr int MULTI_F32_WARPS = 8;        // warps per block (multi-row): 16 output rows

// Byte m of v (a value 0..15 per byte) as a float minus `bias`, exactly:
// 0x4B0000nn is the float 2^23 + nn.
__device__ __forceinline__ float nib_f(uint32_t v, int m, float bias) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540u | m)) - (8388608.0f + bias);
}

// The 8 nibbles of one 4-byte word of a weight block (elements 8k..8k+7 of
// the block for word k) as floats n - bias, in element order.
__device__ __forceinline__ void unpack_word(uint32_t w, float bias, float* wf) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    wf[2 * m] = nib_f(lo, m, bias);
    wf[2 * m + 1] = nib_f(hi, m, bias);
  }
}

// The 32 nibbles of one weight block (16 bytes, byte j holding elements 2j
// and 2j+1, low nibble first) as floats n - bias, in element order.
__device__ __forceinline__ void unpack_block(uint4 w, float bias, float* wf) {
  unpack_word(w.x, bias, wf);
  unpack_word(w.y, bias, wf + 8);
  unpack_word(w.z, bias, wf + 16);
  unpack_word(w.w, bias, wf + 24);
}

// sum_i wf[i] * x[i] over one block whose float4 j (elements 4j..4j+3) is xb[j * stride]
__device__ __forceinline__ float dot_block(const float* wf, const float4* xb, int stride) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = xb[j * stride];
    s = fmaf(wf[4 * j], v.x, s);
    s = fmaf(wf[4 * j + 1], v.y, s);
    s = fmaf(wf[4 * j + 2], v.z, s);
    s = fmaf(wf[4 * j + 3], v.w, s);
  }
  return s;
}

constexpr int STAGE_LOADS = 8;  // reads a thread keeps in flight while staging a row

// The n floats at x into the transposed stage xs: element e (block e/32,
// float4 j = (e%32)/4 of it) lands in xs[j * stride + e/32].  Coalesced
// scalar reads (no alignment asked of x), STAGE_LOADS of them issued before
// any is stored; conflict-free writes (odd stride).
__device__ __forceinline__ void stage(const float* __restrict__ x, int n, float4* xs, int stride) {
  float* xf = reinterpret_cast<float*>(xs);
  for (int e0 = threadIdx.x; e0 < n; e0 += STAGE_LOADS * blockDim.x) {
    float v[STAGE_LOADS];
#pragma unroll
    for (int u = 0; u < STAGE_LOADS; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < n ? __ldg(x + e) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < STAGE_LOADS; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) xf[((((e & 31) >> 2) * stride) + (e >> 5)) * 4 + (e & 3)] = v[u];
    }
  }
}

// qs [out][nb*16] u8, dw [out][nb] f32, x [nb*32] f32 -> y [out] f32
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q4_0_matvec_f32_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ dw,
                       const float* __restrict__ x, float* __restrict__ y, int out, int nb, int stride) {
  extern __shared__ float4 xs[];  // [8][stride]: xs[j * stride + b] = x[32b + 4j .. 32b + 4j + 3]
  stage(x, nb * QK, xs, stride);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5); row < out; row += gridDim.x * ROWS_PER_BLOCK) {
    const uint4* wrow = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(row) * nb * 16);
    const float* drow = dw + static_cast<size_t>(row) * nb;
    float acc = 0.0f;
#pragma unroll 2
    for (int b = lane; b < nb; b += 32) {
      float wf[QK];
      unpack_block(__ldg(wrow + b), 8.0f, wf);
      acc = fmaf(__ldg(drow + b), dot_block(wf, xs + b, stride), acc);
    }
    acc = warp_sum_f(acc);
    if (lane == 0) y[row] = acc;
  }
}

// qs [out][nb*16] u8, dm [out][nb] {d, m} f32, x [nb*32] f32 -> y [out] f32
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q4_1_matvec_f32_kernel(const uint8_t* __restrict__ qs, const float2* __restrict__ dm,
                       const float* __restrict__ x, float* __restrict__ y, int out, int nb, int stride) {
  extern __shared__ float4 xs[];  // [8][stride] as for Q4_0, then xsum [nb]
  float* xsum = reinterpret_cast<float*>(xs + 8 * stride);
  stage(x, nb * QK, xs, stride);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = xs[j * stride + b];
      s += v.x + v.y + v.z + v.w;
    }
    xsum[b] = s;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5); row < out; row += gridDim.x * ROWS_PER_BLOCK) {
    const uint4* wrow = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(row) * nb * 16);
    const float2* dmrow = dm + static_cast<size_t>(row) * nb;
    float acc = 0.0f;
#pragma unroll 2
    for (int b = lane; b < nb; b += 32) {
      float wf[QK];
      unpack_block(__ldg(wrow + b), 0.0f, wf);
      const float2 wdm = __ldg(dmrow + b);
      acc = fmaf(wdm.x, dot_block(wf, xs + b, stride), fmaf(wdm.y, xsum[b], acc));
    }
    acc = warp_sum_f(acc);
    if (lane == 0) y[row] = acc;
  }
}

constexpr int STAGE_ROWS = 4;  // x rows a staging step reads at once
constexpr int STAGE_ELEMS = F32_CHUNK * QK / (MULTI_F32_WARPS * 32);  // a thread's elements of a chunk row
static_assert(STAGE_ELEMS * MULTI_F32_WARPS * 32 == F32_CHUNK * QK, "a block stages a chunk row in one step");

// Elements [c0*32, (c0+cb)*32) of rows r < B of x [B][in_dim] into the
// multi-row stage: element e of a row's range (8-element group g = e/8,
// half h = (e%8)/4) lands in xs[(r*2 + h) * F32_GROUP_STRIDE + g], so that
// lane l, on group l of an 8-block sub-chunk, reads consecutive float4.
// Each step reads STAGE_ELEMS elements of STAGE_ROWS rows (16 reads in
// flight a thread, no integer division) before storing any;
// F32_GROUP_STRIDE = 16 (mod 32) words keeps the stores conflict-free.
__device__ __forceinline__ void stage_groups(const float* __restrict__ x, int in_dim, int c0, int cb, int B,
                                             float4* xs) {
  float* xf = reinterpret_cast<float*>(xs);
  const int per = cb * QK;
  const float* xc = x + c0 * QK;
  for (int r0 = 0; r0 < B; r0 += STAGE_ROWS) {
    float v[STAGE_ROWS][STAGE_ELEMS];
#pragma unroll
    for (int rr = 0; rr < STAGE_ROWS; ++rr)
#pragma unroll
      for (int u = 0; u < STAGE_ELEMS; ++u) {
        const int e = threadIdx.x + u * blockDim.x;
        v[rr][u] = r0 + rr < B && e < per ? __ldg(xc + static_cast<size_t>(r0 + rr) * in_dim + e) : 0.0f;
      }
#pragma unroll
    for (int rr = 0; rr < STAGE_ROWS; ++rr)
#pragma unroll
      for (int u = 0; u < STAGE_ELEMS; ++u) {
        const int e = threadIdx.x + u * blockDim.x;
        if (r0 + rr < B && e < per)
          xf[(((r0 + rr) * 2 + ((e >> 2) & 1)) * F32_GROUP_STRIDE + (e >> 3)) * 4 + (e & 3)] = v[rr][u];
      }
  }
}

// qs [out][nb*16] u8, dw [out][nb] f32, x [B][nb*32] f32 -> y [B][out] f32;
// R >= B accumulators per output row per lane
template <int R>
__global__ void __launch_bounds__(MULTI_F32_WARPS * 32, 2)
q4_0_matmul_multi_f32_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ dw,
                             const float* __restrict__ x, float* __restrict__ y, int out, int nb, int B) {
  extern __shared__ float4 xs[];  // [B][2][F32_GROUP_STRIDE]: the chunk's 8-element groups of every row
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * MULTI_F32_WARPS + (threadIdx.x >> 5)) * MULTI_F32_ROWS;
  const int sub = lane >> 2, word = lane & 3;  // the lane's block of an 8-block sub-chunk, its word there
  const uint32_t* wq[MULTI_F32_ROWS];
  const float* wd[MULTI_F32_ROWS];
  bool live[MULTI_F32_ROWS];  // rows past `out`: zero weights, nothing stored; the warp still stages
#pragma unroll
  for (int o = 0; o < MULTI_F32_ROWS; ++o) {
    live[o] = row0 + o < out;
    const size_t row = live[o] ? static_cast<size_t>(row0 + o) : 0;
    wq[o] = reinterpret_cast<const uint32_t*>(qs + row * nb * 16);
    wd[o] = dw + row * nb;
  }
  float acc[MULTI_F32_ROWS][R];
#pragma unroll
  for (int o = 0; o < MULTI_F32_ROWS; ++o)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[o][r] = 0.0f;
  for (int c0 = 0; c0 < nb; c0 += F32_CHUNK) {
    const int cb = min(F32_CHUNK, nb - c0);
    // this chunk's weight words and scales, loaded before the stage so that
    // both sets of reads are in flight together
    uint32_t wv[F32_CHUNK / 8][MULTI_F32_ROWS];
    float dv[F32_CHUNK / 8][MULTI_F32_ROWS];
#pragma unroll
    for (int k = 0; k < F32_CHUNK / 8; ++k) {
      const int b = c0 + 8 * k + sub;
#pragma unroll
      for (int o = 0; o < MULTI_F32_ROWS; ++o) {
        const bool ok = live[o] && b < nb;
        wv[k][o] = ok ? __ldg(wq[o] + b * 4 + word) : 0u;
        dv[k][o] = ok ? __ldg(wd[o] + b) : 0.0f;
      }
    }
    __syncthreads();  // every warp is done with the previous chunk
    stage_groups(x, nb * QK, c0, cb, B, xs);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F32_CHUNK / 8; ++k) {
      if (8 * k + sub < cb) {  // the ragged end of the row: staged x ends there
        float wf[MULTI_F32_ROWS][8];
#pragma unroll
        for (int o = 0; o < MULTI_F32_ROWS; ++o) unpack_word(wv[k][o], 8.0f, wf[o]);
        const float4* xg = xs + 32 * k + lane;  // group 32k + lane of the chunk
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < B) {
            const float4 a = xg[(2 * r) * F32_GROUP_STRIDE], b = xg[(2 * r + 1) * F32_GROUP_STRIDE];
#pragma unroll
            for (int o = 0; o < MULTI_F32_ROWS; ++o) {
              float t = wf[o][0] * a.x;
              t = fmaf(wf[o][1], a.y, t);
              t = fmaf(wf[o][2], a.z, t);
              t = fmaf(wf[o][3], a.w, t);
              t = fmaf(wf[o][4], b.x, t);
              t = fmaf(wf[o][5], b.y, t);
              t = fmaf(wf[o][6], b.z, t);
              t = fmaf(wf[o][7], b.w, t);
              acc[o][r] = fmaf(dv[k][o], t, acc[o][r]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < B) {
#pragma unroll
      for (int o = 0; o < MULTI_F32_ROWS; ++o) {
        const float v = warp_sum_f(acc[o][r]);
        if (live[o] && lane == 0) y[static_cast<size_t>(r) * out + row0 + o] = v;
      }
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB the
// default refuses the launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// blocks of the f32 matvecs: one warp per row, at most 8 blocks an SM
int matvec_f32_grid(int out) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int rows = (out + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, cap = 8 * (sms > 0 ? sms : 1);
  return rows < cap ? rows : cap;
}

constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on the H100 (227 KB)

}  // namespace

// Launches the pre-pass and the matvec on `stream`; scratch xq [in] int8,
// qsum [in/32] int32 and dx [in/32] f32 come from the caller.
extern "C" int q4_0_matvec(const void* qs, const void* dw, const void* x, void* xq,
                           void* qsum, void* dx, void* y, int out, int in_dim,
                           void* stream) {
  const int nb = in_dim / QK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_x_kernel<<<(nb + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(x), nb, static_cast<int8_t*>(xq),
      static_cast<int*>(qsum), static_cast<float*>(dx));
  q4_0_matvec_kernel<<<(out + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32, 0, s>>>(
      static_cast<const uint8_t*>(qs), static_cast<const float*>(dw),
      static_cast<const int8_t*>(xq), static_cast<const int*>(qsum),
      static_cast<const float*>(dx), static_cast<float*>(y), out, nb);
  return static_cast<int>(cudaGetLastError());
}

// B rows (2..32) of x [B, in] against one weight; scratch xq [B, in] int8,
// qsum and dx [B, in/32] come from the caller; y is [B, out].
extern "C" int q4_0_matmul_multi(const void* qs, const void* dw, const void* x, void* xq,
                                 void* qsum, void* dx, void* y, int out, int in_dim,
                                 int B, void* stream) {
  const int nb = in_dim / QK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 32) return static_cast<int>(cudaErrorInvalidValue);
  quantize_x_kernel<<<(B * nb + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(x), B * nb, static_cast<int8_t*>(xq),
      static_cast<int*>(qsum), static_cast<float*>(dx));
  const dim3 grid((out + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK), block(ROWS_PER_BLOCK * 32);
  const uint8_t* q = static_cast<const uint8_t*>(qs);
  const float* d = static_cast<const float*>(dw);
  const int8_t* xqp = static_cast<const int8_t*>(xq);
  const int* qsp = static_cast<const int*>(qsum);
  const float* dxp = static_cast<const float*>(dx);
  float* yp = static_cast<float*>(y);
  if (B <= 2)
    q4_0_matmul_multi_kernel<2><<<grid, block, 0, s>>>(q, d, xqp, qsp, dxp, yp, out, nb, B);
  else if (B <= 4)
    q4_0_matmul_multi_kernel<4><<<grid, block, 0, s>>>(q, d, xqp, qsp, dxp, yp, out, nb, B);
  else if (B <= 8)
    q4_0_matmul_multi_kernel<8><<<grid, block, 0, s>>>(q, d, xqp, qsp, dxp, yp, out, nb, B);
  else if (B <= 16)
    q4_0_matmul_multi_kernel<16><<<grid, block, 0, s>>>(q, d, xqp, qsp, dxp, yp, out, nb, B);
  else
    q4_0_matmul_multi_kernel<32><<<grid, block, 0, s>>>(q, d, xqp, qsp, dxp, yp, out, nb, B);
  return static_cast<int>(cudaGetLastError());
}

// Q4_1 weights: qs [out, in/2] u8, dm [out, in/32, 2] f32; scratch xq [in]
// u8 and xs [in/32, 4] f32 come from the caller.
extern "C" int q4_1_matvec(const void* qs, const void* dm, const void* x, void* xq, void* xs,
                           void* y, int out, int in_dim, void* stream) {
  const int nb = in_dim / QK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_x_q4_1_kernel<<<(nb + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(x), nb, static_cast<uint8_t*>(xq), static_cast<float4*>(xs));
  q4_1_matvec_kernel<<<(out + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32, 0, s>>>(
      static_cast<const uint8_t*>(qs), static_cast<const float2*>(dm),
      static_cast<const uint8_t*>(xq), static_cast<const float4*>(xs), static_cast<float*>(y), out, nb);
  return static_cast<int>(cudaGetLastError());
}

// f32 activations, one row: x [in] f32 against Q4_0 qs [out, in/2], d [out, in/32].
extern "C" int q4_0_matvec_f32(const void* qs, const void* dw, const void* x, void* y, int out, int in_dim,
                               void* stream) {
  const int nb = in_dim / QK, stride = nb | 1;
  const size_t smem = static_cast<size_t>(8) * stride * sizeof(float4);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(q4_0_matvec_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  q4_0_matvec_f32_kernel<<<matvec_f32_grid(out), ROWS_PER_BLOCK * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const float*>(dw), static_cast<const float*>(x),
      static_cast<float*>(y), out, nb, stride);
  return static_cast<int>(cudaGetLastError());
}

// f32 activations, one row: x [in] f32 against Q4_1 qs [out, in/2], dm [out, in/32, 2].
extern "C" int q4_1_matvec_f32(const void* qs, const void* dm, const void* x, void* y, int out, int in_dim,
                               void* stream) {
  const int nb = in_dim / QK, stride = nb | 1;
  const size_t smem = static_cast<size_t>(8) * stride * sizeof(float4) + nb * sizeof(float);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(q4_1_matvec_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  q4_1_matvec_f32_kernel<<<matvec_f32_grid(out), ROWS_PER_BLOCK * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const float2*>(dm), static_cast<const float*>(x),
      static_cast<float*>(y), out, nb, stride);
  return static_cast<int>(cudaGetLastError());
}

namespace {
template <int R>
cudaError_t launch_multi_f32(const void* qs, const void* dw, const void* x, void* y, int out, int nb, int B,
                             cudaStream_t s) {
  const size_t smem = static_cast<size_t>(B) * 2 * F32_GROUP_STRIDE * sizeof(float4);
  const int rows = MULTI_F32_WARPS * MULTI_F32_ROWS;  // output rows per block
  cudaError_t err = allow_smem(q4_0_matmul_multi_f32_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  q4_0_matmul_multi_f32_kernel<R><<<(out + rows - 1) / rows, MULTI_F32_WARPS * 32, smem, s>>>(
      static_cast<const uint8_t*>(qs), static_cast<const float*>(dw), static_cast<const float*>(x),
      static_cast<float*>(y), out, nb, B);
  return cudaGetLastError();
}
}  // namespace

// f32 activations, B rows (1..32) of x [B, in] against one Q4_0 weight; y is [B, out].
extern "C" int q4_0_matmul_multi_f32(const void* qs, const void* dw, const void* x, void* y, int out, int in_dim,
                                     int B, void* stream) {
  const int nb = in_dim / QK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (B < 1 || B > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 2)
    err = launch_multi_f32<2>(qs, dw, x, y, out, nb, B, s);
  else if (B <= 4)
    err = launch_multi_f32<4>(qs, dw, x, y, out, nb, B, s);
  else if (B <= 8)
    err = launch_multi_f32<8>(qs, dw, x, y, out, nb, B, s);
  else if (B <= 16)
    err = launch_multi_f32<16>(qs, dw, x, y, out, nb, B, s);
  else
    err = launch_multi_f32<32>(qs, dw, x, y, out, nb, B, s);
  return static_cast<int>(err);
}
