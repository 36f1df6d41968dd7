// The HBM stream probe: a pure read of a packed Q4_0 weight's nibble words
// with almost no compute, the read ceiling that tools/kernelbench.py holds
// each product's HBM rate against.
//
// Replaces the TPU kernel `_stream_probe_kernel` (llama_swift_tpu/ops/
// q4_vpu_pallas.py, entry point stream_probe):
//
//   sum[r] = float( sum_k (word[r, k] + bias) )   (int32, wrapping; rounded once)
//
// where word[r, k] is the k-th little-endian 32-bit word of row r of the
// nibble bytes qs [out, in/2].  The TPU kernel computes the sum of every row
// and keeps one per 128-row tile; here every row's sum is written to
// out[rows], so that no load can be dropped as dead, and the wrapper keeps
// rows 0, 128, 256, ... as the TPU entry point does.
//
// What bounds it on the H100: device-memory bandwidth -- in/2 bytes read and
// 4 bytes written per row, one integer add per 4 bytes read.
//
// Design (not the TPU's grid of out/128 sequential tiles, only 32 blocks at
// 4096 rows): one warp per row, blocks of 8 warps, so 4096 rows give 512
// blocks and every SM holds many rows at once.  A lane reads 16-byte vectors
// with __ldcs (cache-streaming: the words are read once), four in flight
// before any is summed, neighbouring lanes on neighbouring vectors; unsigned
// adds give the int32 wrap without undefined behaviour; a warp-shuffle tree
// (unsigned, so exact in any order) reduces the lanes, and lane 0 rounds the
// int32 total to f32 (round to nearest even, as XLA's convert does).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ uint32_t add4(uint4 v, uint32_t bias) {
  return (v.x + bias) + (v.y + bias) + (v.z + bias) + (v.w + bias);
}

// words [rows][vecs] as 16-byte vectors (vecs = in/32: four words each)
__global__ void __launch_bounds__(kWarps * 32)
stream_probe_kernel(const uint4* __restrict__ words, uint32_t bias, float* __restrict__ out, int rows, int vecs) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* p = words + static_cast<size_t>(row) * vecs;
  uint32_t acc = 0;
  int k = lane;
  for (; k + (kUnroll - 1) * 32 < vecs; k += kUnroll * 32) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(p + k + u * 32);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += add4(v[u], bias);
  }
  for (; k < vecs; k += 32) acc += add4(__ldcs(p + k), bias);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = __int2float_rn(static_cast<int>(acc));
}

}  // namespace

// qs [rows][in/2] u8 (16-byte aligned, in % 32 == 0), out [rows] f32
extern "C" int stream_probe(const void* qs, int bias, void* out, int rows, int in_dim, void* stream) {
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  stream_probe_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<uint32_t>(bias), static_cast<float*>(out), rows, in_dim / 32);
  return static_cast<int>(cudaGetLastError());
}
