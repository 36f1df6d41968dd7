// Exact int4 x int4 Q4_0 product for N >= 1 activation rows on the int8
// tensor cores (q4_0_int_matmul).
//
// Replaces the TPU kernel `_q4_0_magic_kernel` and its stacked form
// (llama_swift_tpu/ops/q4_matmul_pallas.py, core `_magic_core`, entry points
// q4_0_int_matmul_pallas and q4_0_int_matmul_pallas_stacked):
//
//   y[n, o] = sum_b d_w[o,b] * d_x[n,b] * (P[n,o,b] - 8 * S[n,b])
//
// with P the integer dot of row n's activation codes q in [-7, 7] (block b,
// quantized per 32-block as quantize_activations_q4_0_int does) with the
// weight's unsigned nibbles 0..15, and S = sum of the block's q.  Every P is
// exact; the scales apply outside the integer dot.  The TPU kernel puts the
// block dots on its matrix unit through a block-diagonal bf16 expansion of
// the codes (16x wasted MXU work); here each 32-element block is exactly
// one K = 32 step of the int8 tensor cores.
//
// What bounds it on the H100: device-memory bandwidth.  The weight costs
// 0.625 bytes and 2 N integer operations a weight; at N = 64 and 11008x4096
// that is 5.8 G int8 operations, 2.9 us at the 1,979 TOPS peak, against
// 8.4 us for the packed weight's bytes.
//
// Design (simple first; wgmma, TMA and a cp.async ring are later work):
//  * Pre-pass (quantize_rows_kernel): one warp per (row, 32-block), the
//    quantizer of q4_common.cuh (bit-identical to the plain version), codes
//    stored de-interleaved per block as the matvec's are (bytes 0..15 the
//    even elements, 16..31 the odd ones), rows padded with zero codes to a
//    multiple of 8; S and d_x stored [nb][NP] so that a lane reads its two
//    activation rows' values of a block with one 8-byte load.
//  * One mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 per 32-element
//    block and tile: A is 16 weight rows x 32 nibbles as u8 (0..15), B is
//    32 codes x 8 activation rows as s8, D the 16 x 8 exact block dots P.
//    The K order is the codes' de-interleaved one: k < 16 is the low nibble
//    of packed byte k, k >= 16 the high nibble of byte k - 16, so A's
//    fragments are one 32-bit word of a row's block masked with 0x0F0F0F0F
//    (or shifted right by 4 first) and B's are one 32-bit word of the codes.
//    The -8 correction subtracts 8 * S from P, as the TPU kernel's c2 does,
//    so no signed unpack is needed.
//  * Right after its MMA each block's P - 8 S (an exact integer) is scaled
//    by d_w * d_x into f32 accumulators, which stay in registers (N rounded
//    up to 8, 16, 32 or 64 rows is a template parameter; more rows run as
//    further 64-row launches of the same weights).
//  * A block of 8 warps owns 32 output rows (two 16-row MMA tiles, so each
//    B fragment feeds two MMAs) and splits the in-dim 8 ways: warp w takes
//    blocks w, w + 8, ...  At the end the warps' partial sums meet in
//    shared memory and are added in warp order (deterministic).  Rows
//    beyond `out` read a valid row and are never stored; activation rows
//    beyond N are zero codes and are never stored.
#include <cuda_runtime.h>
#include <stdint.h>

#include "q4_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // in-dim slices
constexpr int ROWS = 32;             // output rows a block owns: two 16-row MMA tiles
constexpr int MAX_N = 64;            // activation rows one launch holds in registers

// x [N][nb*32] f32 -> xq [NP][nb*32] i8 (de-interleaved codes, zero rows
// from N up to NP), S and dx [nb][NP] (block sums of codes, block scales)
__global__ void quantize_rows_kernel(const float* __restrict__ x, int N, int NP, int nb,
                                     int8_t* __restrict__ xq, int* __restrict__ S, float* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);  // (row n, block b), row-major
  if (i >= NP * nb) return;
  const int n = i / nb, b = i - n * nb;
  int8_t* codes = xq + static_cast<size_t>(i) * QK;
  if (n < N) {
    quantize_block_warp(x[static_cast<size_t>(i) * QK + lane], lane, codes, S + b * NP + n, dx + b * NP + n);
  } else {
    codes[lane] = 0;
    if (lane == 0) {
      S[b * NP + n] = 0;
      dx[b * NP + n] = 0.0f;
    }
  }
}

// D (16 x 8 s32) = A (16 x 32 u8, row-major) . B (32 x 8 s8, column-major).
// Fragments (lane = 4 g + t): a0 row g, k 4t..4t+3; a1 row g+8, k 4t..;
// a2 row g, k 16+4t..; a3 row g+8, k 16+4t..; b0 column g, k 4t..; b1
// column g, k 16+4t..; d0, d1 row g, columns 2t, 2t+1; d2, d3 row g+8.
__device__ __forceinline__ void mma_u8s8(const uint32_t (&a)[4], uint32_t b0, uint32_t b1, int (&d)[4]) {
  const int z = 0;
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(z), "r"(z), "r"(z), "r"(z));
}

// qs [out][nb*16] u8, dw [out][nb] f32, xq [>= 8 NT][nb*32] i8 (this
// launch's rows), S/dx [nb][ld] (offset to this launch's first row)
//   -> y [n_rows][out] f32; NT >= ceil(n_rows / 8) tiles of 8 rows
template <int NT>
__global__ void __launch_bounds__(THREADS)
q4_int_mma_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ dw,
                  const int8_t* __restrict__ xq, const int* __restrict__ S, const float* __restrict__ dx,
                  float* __restrict__ y, int out, int nb, int n_rows, int ld) {
  extern __shared__ float red[];  // [WARPS][8 NT][ROWS]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.x * ROWS;
  const int ntiles = (n_rows + 7) / 8;
  // this lane's four weight rows: g and g + 8 of each 16-row tile
  const uint32_t* wrow[4];
  const float* drow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = min(o0 + 8 * j + g, out - 1);
    wrow[j] = reinterpret_cast<const uint32_t*>(qs + static_cast<size_t>(row) * nb * 16) + t;
    drow[j] = dw + static_cast<size_t>(row) * nb;
  }
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.0f;

#pragma unroll 2
  for (int b = warp; b < nb; b += WARPS) {
    uint32_t w[4];
    float sw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = __ldg(wrow[j] + 4 * b);
      sw[j] = __ldg(drow[j] + b);
    }
    const uint32_t a[2][4] = {
        {w[0] & 0x0F0F0F0Fu, w[1] & 0x0F0F0F0Fu, (w[0] >> 4) & 0x0F0F0F0Fu, (w[1] >> 4) & 0x0F0F0F0Fu},
        {w[2] & 0x0F0F0F0Fu, w[3] & 0x0F0F0F0Fu, (w[2] >> 4) & 0x0F0F0F0Fu, (w[3] >> 4) & 0x0F0F0F0Fu}};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < ntiles) {  // warp-uniform
        const uint32_t* xw =
            reinterpret_cast<const uint32_t*>(xq + (static_cast<size_t>(nt * 8 + g) * nb + b) * QK);
        const uint32_t b0 = __ldg(xw + t), b1 = __ldg(xw + 4 + t);
        const int2 s = __ldg(reinterpret_cast<const int2*>(S + b * ld + nt * 8 + 2 * t));
        const float2 d = __ldg(reinterpret_cast<const float2*>(dx + b * ld + nt * 8 + 2 * t));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          int p[4];
          mma_u8s8(a[m], b0, b1, p);
          const float w_lo = sw[2 * m], w_hi = sw[2 * m + 1];  // rows g and g + 8 of tile m
          acc[m][nt][0] += static_cast<float>(p[0] - 8 * s.x) * __fmul_rn(w_lo, d.x);
          acc[m][nt][1] += static_cast<float>(p[1] - 8 * s.y) * __fmul_rn(w_lo, d.y);
          acc[m][nt][2] += static_cast<float>(p[2] - 8 * s.x) * __fmul_rn(w_hi, d.x);
          acc[m][nt][3] += static_cast<float>(p[3] - 8 * s.y) * __fmul_rn(w_hi, d.y);
        }
      }
    }
  }

  // partials [WARPS][8 NT rows n][ROWS], summed in warp order
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + (e >> 1) * 8, n = nt * 8 + 2 * t + (e & 1);
        red[(warp * 8 * NT + n) * ROWS + r] = acc[m][nt][e];
      }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_rows * ROWS; idx += THREADS) {
    const int n = idx / ROWS, r = idx % ROWS, o = o0 + r;
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) sum += red[(k * 8 * NT + n) * ROWS + r];
    if (o < out) y[static_cast<size_t>(n) * out + o] = sum;
  }
}

template <int NT>
cudaError_t launch(const uint8_t* qs, const float* dw, const int8_t* xq, const int* S, const float* dx, float* y,
                   int out, int nb, int n_rows, int ld, cudaStream_t stream) {
  const size_t smem = sizeof(float) * WARPS * 8 * NT * ROWS;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(q4_int_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  q4_int_mma_kernel<NT><<<(out + ROWS - 1) / ROWS, THREADS, smem, stream>>>(qs, dw, xq, S, dx, y, out, nb,
                                                                            n_rows, ld);
  return cudaGetLastError();
}

}  // namespace

// x [N][in] f32 against Q4_0 qs [out][in/2] u8, dw [out][in/32] f32 -> y
// [N][out] f32, N >= 1.  Scratch from the caller: xq [NP][in] i8, S [in/32][NP]
// i32 and dx [in/32][NP] f32, NP = N rounded up to a multiple of 8.
extern "C" int q4_0_int_matmul(const void* qs, const void* dw, const void* x, void* xq, void* S, void* dx,
                               void* y, int out, int in_dim, int N, int NP, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = in_dim / QK;
  if (N < 1 || NP < N || NP % 8 || in_dim % QK || out < 1) return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_kernel<<<(NP * nb + 7) / 8, 256, 0, s>>>(static_cast<const float*>(x), N, NP, nb,
                                                        static_cast<int8_t*>(xq), static_cast<int*>(S),
                                                        static_cast<float*>(dx));
  cudaError_t e = cudaGetLastError();
  for (int n0 = 0; n0 < N && e == cudaSuccess; n0 += MAX_N) {
    const int rows = N - n0 < MAX_N ? N - n0 : MAX_N;
    const uint8_t* q = static_cast<const uint8_t*>(qs);
    const float* d = static_cast<const float*>(dw);
    const int8_t* xqp = static_cast<const int8_t*>(xq) + static_cast<size_t>(n0) * in_dim;
    const int* Sp = static_cast<const int*>(S) + n0;
    const float* dxp = static_cast<const float*>(dx) + n0;
    float* yp = static_cast<float*>(y) + static_cast<size_t>(n0) * out;
    if (rows <= 8) e = launch<1>(q, d, xqp, Sp, dxp, yp, out, nb, rows, NP, s);
    else if (rows <= 16) e = launch<2>(q, d, xqp, Sp, dxp, yp, out, nb, rows, NP, s);
    else if (rows <= 32) e = launch<4>(q, d, xqp, Sp, dxp, yp, out, nb, rows, NP, s);
    else e = launch<8>(q, d, xqp, Sp, dxp, yp, out, nb, rows, NP, s);
  }
  return static_cast<int>(e);
}
