// Q4_0 product for 1..64 f32 activation rows, the T-layout product of the
// tensor-parallel path (q4_0_matmul_t).
//
// Replaces the TPU kernel `_q4_0_phase_kernel` and its stacked form
// (llama_swift_tpu/ops/q4_matmul_pallas.py, core `_phase_core`, entry points
// q4_0_matmul_pallas and q4_0_matmul_pallas_stacked):
//
//   y[n, o] = sum_i  x[n, i] * ((nib[o, i] - 8) * d[o, i / 32])
//
// in f32.  The caller has already fake-quantized x through Q4_0 when the
// model quantizes activations, as the JAX package does outside its kernel.
// Each weight is decoded with one f32 rounding (__fmul_rn: nvcc must not
// contract it into the following FMA), then multiplied into the sums with
// f32 FMAs: f32-exact products, as the TPU kernel's Precision.HIGHEST dot;
// only the summation order differs from the plain version.
//
// The weight keeps the logical ggml layout of Q4_0Weight: nibbles uint8
// [out, in/2] (byte j of a block holds elements 2j, low nibble, and 2j+1)
// and scales f32 [out, in/32].  The TPU's pre-tiled [out/128, in/8, 128]
// words existed for Mosaic's (8, 128) tiling and for contiguous HBM block
// reads; here a block's 32 output rows are read as 128-byte row segments.
//
// What bounds it on the H100: device-memory bandwidth at few rows (0.625
// bytes a weight, 3.35 TB/s), the f32 FMA rate at many (2 operations a
// weight a row, 67 TFLOP/s without tensor cores): the two meet near 16 rows.
//
// Design (simple first; the fast forms -- int8 mma on the 4-bit codes with
// per-block scales, a cp.async ring -- are later work):
//  * a block of 256 threads owns 32 output rows for all N activation rows
//    (N padded to a power of two NR <= 64, a template parameter so the
//    accumulators stay in registers);
//  * it walks the in axis in chunks of 8 Q4_0 blocks (256 elements): the 32
//    rows' nibbles (one 16-byte load a thread, eight threads a 128-byte row
//    segment), their 256 scales and the f32 x chunk [NR, 256] are staged in
//    shared memory, so each weight byte is read from device memory once per
//    launch; the next chunk's nibbles and scale (and, for NR <= 8, its x)
//    are loaded into registers while the current chunk is computed;
//  * warp w takes block w of the chunk, lane l output row l: it decodes its
//    32 weights once into registers, then reads x of the block as 16-byte
//    broadcasts and does 32 FMAs a row into acc[n], rows innermost so that
//    consecutive FMAs do not wait on each other;
//  * at the end the eight warps' partial sums meet in shared memory and are
//    added in a fixed order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_OUT = 32;           // output rows a block owns (one per lane)
constexpr int CHUNK_BLOCKS = WARPS;    // Q4_0 blocks a chunk stages (one per warp)
constexpr int CHUNK = 32 * CHUNK_BLOCKS;
constexpr int W_STRIDE = CHUNK_BLOCKS + 1;  // uint4 per staged row: the pad spreads the lanes over the banks

// two blocks an SM where the sums leave registers enough (<= 128 a thread);
// 32 and 64 rows keep theirs
template <int NR>
__global__ void __launch_bounds__(THREADS, NR >= 32 ? 1 : 2)
q4_0_matmul_t_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ d,
                     const float* __restrict__ x, float* __restrict__ y, int out, int in, int n_rows) {
  // x is prefetched into registers too when it is a few values a thread
  constexpr bool PREFETCH_X = NR <= 8;
  constexpr int XPT = PREFETCH_X ? NR : 1;  // x values a thread stages per chunk
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);                  // [NR][CHUNK]; later [WARPS][NR][32]
  uint4* w_s = reinterpret_cast<uint4*>(x_s + NR * CHUNK);      // [TILE_OUT][W_STRIDE]
  float* s_s = reinterpret_cast<float*>(w_s + TILE_OUT * W_STRIDE);  // [TILE_OUT][W_STRIDE]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int o0 = blockIdx.x * TILE_OUT;
  const int nb = in / 32;
  // the staging role of thread t: segment (t % 8) of row (t / 8), and that block's scale
  const int r = t >> 3, seg = t & 7, row = o0 + r;
  const uint8_t* w_src = qs + (long long)min(row, out - 1) * (in / 2) + seg * 16;
  const float* s_src = d + (long long)min(row, out - 1) * nb + seg;

  // registers for the next chunk, loaded while the current one is computed
  uint4 w_next = make_uint4(0, 0, 0, 0);
  float s_next = 0.f;
  float x_next[XPT];
  auto fetch = [&](int b0) {
    const bool live = row < out && b0 + seg < nb;
    w_next = live ? *reinterpret_cast<const uint4*>(w_src + (long long)b0 * 16) : make_uint4(0, 0, 0, 0);
    s_next = live ? s_src[b0] : 0.f;
    if constexpr (PREFETCH_X) {
#pragma unroll
      for (int i = 0; i < XPT; ++i) {  // element t of row i
        x_next[i] = (i < n_rows && b0 * 32 + t < in) ? x[(long long)i * in + b0 * 32 + t] : 0.f;
      }
    }
  };

  float acc[NR];
#pragma unroll
  for (int n = 0; n < NR; ++n) acc[n] = 0.f;

  fetch(0);
  for (int b0 = 0; b0 < nb; b0 += CHUNK_BLOCKS) {
    const int nblk = min(CHUNK_BLOCKS, nb - b0);
    w_s[r * W_STRIDE + seg] = w_next;
    s_s[r * W_STRIDE + seg] = s_next;
    if constexpr (PREFETCH_X) {
#pragma unroll
      for (int i = 0; i < XPT; ++i) x_s[i * CHUNK + t] = x_next[i];
    } else {
      for (int idx = t; idx < NR * CHUNK; idx += THREADS) {
        const int n = idx / CHUNK, k = idx % CHUNK;
        x_s[idx] = (n < n_rows && k < nblk * 32) ? x[(long long)n * in + b0 * 32 + k] : 0.f;
      }
    }
    __syncthreads();
    if (b0 + CHUNK_BLOCKS < nb) fetch(b0 + CHUNK_BLOCKS);
    if (warp < nblk) {
      const uint4 packed = w_s[lane * W_STRIDE + warp];
      const float s = s_s[lane * W_STRIDE + warp];
      const uint32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
      float w[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t byte = (words[j / 4] >> (8 * (j % 4))) & 0xFF;
        w[2 * j] = __fmul_rn(static_cast<float>(static_cast<int>(byte & 0xF) - 8), s);
        w[2 * j + 1] = __fmul_rn(static_cast<float>(static_cast<int>(byte >> 4) - 8), s);
      }
      // rows inner, so that consecutive FMAs feed different sums; each
      // row's sum still takes the block's 32 terms in order
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          const float4 xv = reinterpret_cast<const float4*>(x_s + n * CHUNK + warp * 32)[q];  // a broadcast
          acc[n] = fmaf(w[4 * q], xv.x, acc[n]);
          acc[n] = fmaf(w[4 * q + 1], xv.y, acc[n]);
          acc[n] = fmaf(w[4 * q + 2], xv.z, acc[n]);
          acc[n] = fmaf(w[4 * q + 3], xv.w, acc[n]);
        }
      }
    }
    __syncthreads();
  }

  // the eight warps' partials, [WARPS][NR][32], summed in warp order
  float* red = x_s;
#pragma unroll
  for (int n = 0; n < NR; ++n) red[(warp * NR + n) * 32 + lane] = acc[n];
  __syncthreads();
  for (int idx = t; idx < NR * 32; idx += THREADS) {
    const int n = idx / 32, l = idx % 32, o = o0 + l;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) sum += red[(k * NR + n) * 32 + l];
    if (n < n_rows && o < out) y[(long long)n * out + o] = sum;
  }
}

template <int NR>
cudaError_t launch(const void* qs, const void* d, const void* x, void* y, int out, int in, int n_rows,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * NR * CHUNK + sizeof(uint4) * TILE_OUT * W_STRIDE +
                      sizeof(float) * TILE_OUT * W_STRIDE;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(q4_0_matmul_t_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int grid = (out + TILE_OUT - 1) / TILE_OUT;
  q4_0_matmul_t_kernel<NR><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(qs), static_cast<const float*>(d), static_cast<const float*>(x),
      static_cast<float*>(y), out, in, n_rows);
  return cudaGetLastError();
}

}  // namespace

// qs [out][in/2] u8, d [out][in/32] f32, x [n_rows][in] f32 -> y [n_rows][out] f32;
// 1 <= n_rows <= 64, in % 32 == 0, qs 16-byte aligned
extern "C" int q4_0_matmul_t(const void* qs, const void* d, const void* x, void* y, int out, int in,
                             int n_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows < 1 || n_rows > 64 || in % 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (n_rows == 1) e = launch<1>(qs, d, x, y, out, in, n_rows, s);
  else if (n_rows <= 2) e = launch<2>(qs, d, x, y, out, in, n_rows, s);
  else if (n_rows <= 4) e = launch<4>(qs, d, x, y, out, in, n_rows, s);
  else if (n_rows <= 8) e = launch<8>(qs, d, x, y, out, in, n_rows, s);
  else if (n_rows <= 16) e = launch<16>(qs, d, x, y, out, in, n_rows, s);
  else if (n_rows <= 32) e = launch<32>(qs, d, x, y, out, in, n_rows, s);
  else e = launch<64>(qs, d, x, y, out, in, n_rows, s);
  return static_cast<int>(e);
}
