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
