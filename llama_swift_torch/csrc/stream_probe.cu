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
// 4 bytes written per row, one integer add per 4 bytes read.  At 4096 x 4096
// (8.4 MB, 2.5 us at 3.35 TB/s) a launch's fixed part weighs as much as the
// stream: on an H100 the gap between two launches of its grid is ~2.0 us,
// its warps' start and stores ~0.2, the first byte ~0.4
// (tools/probe_variants.py's split, PERF.md).
//
// Design (ops/q4_matvec.probe_plan).  One warp a row, blocks of PROBE_WARPS
// warps on neighbouring rows, the grid queued to the hardware's block
// scheduler (at 4096 rows 512 blocks, all resident at once): a warp's first
// loads are its first instructions, and at large shapes the scheduler hands
// the next rows to whichever SM drains first.  A lane keeps PROBE_LOADS
// 16-byte streaming loads (__ldcs, evict first: every byte is read once) in
// flight, predicated at a row's end so that a chunk's loads go out together,
// neighbouring lanes on neighbouring vectors (a warp's load is 512
// contiguous bytes).  Timed against it on an H100 (tools/probe_variants.py,
// PERF.md): a persistent grid of one or two blocks an SM reading contiguous
// spans of rows through a ring of bulk copies (TMA) was 1.1-1.9x slower at
// every shape and ring (a block's bulk copies stream at ~20 KB/us, below an
// SM's share of the card's rate), and a persistent grid of plain loads
// 6-20 % slower (static spans end with the slowest SM).
//
// The sum: unsigned 32-bit adds wrap exactly in any order, so a lane's
// vectors, the warp's redux.sync (0-1 % faster than a butterfly of five
// shuffles) and the bias, added last as bias times the row's word count,
// give the plain version's bits; lane 0 rounds the int32 total to f32
// (round to nearest even, as XLA's convert does).  One launch a call, no
// scratch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PROBE_WARPS = 8;
constexpr int PROBE_LOADS = 4;

__device__ __forceinline__ uint32_t add4(uint4 v) { return v.x + v.y + v.z + v.w; }

// qs [rows][rv] as 16-byte vectors (rv = in/32), out [rows] f32; block b on
// rows b * PROBE_WARPS + w.
__global__ void __launch_bounds__(PROBE_WARPS * 32)
stream_probe_kernel(const uint4* __restrict__ qs, uint32_t bias, float* __restrict__ out, int rows, int rv) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * PROBE_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* p = qs + static_cast<size_t>(row) * rv + lane;
  uint32_t acc = 0;
  for (int k0 = 0; k0 < rv; k0 += PROBE_LOADS * 32) {
    uint4 v[PROBE_LOADS];
#pragma unroll
    for (int u = 0; u < PROBE_LOADS; ++u)
      v[u] = k0 + u * 32 + lane < rv ? __ldcs(p + k0 + u * 32) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < PROBE_LOADS; ++u) acc += add4(v[u]);
  }
  acc = __reduce_add_sync(0xffffffffu, acc);  // redux.sync: the warp's sum in one instruction
  if (lane == 0) out[row] = __int2float_rn(static_cast<int>(acc + bias * static_cast<uint32_t>(rv) * 4u));
}

}  // namespace

// qs [rows][in/2] u8 (16-byte aligned, in % 32 == 0), out [rows] f32, on
// `blocks` blocks of PROBE_WARPS rows (ops/q4_matvec.probe_plan).  One
// launch, no scratch.
extern "C" int stream_probe(const void* qs, int bias, void* out, int rows, int in_dim, int blocks, void* stream) {
  if (rows < 1 || in_dim < 32 || in_dim % 32 || blocks != (rows + PROBE_WARPS - 1) / PROBE_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  stream_probe_kernel<<<blocks, PROBE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<uint32_t>(bias), static_cast<float*>(out), rows, in_dim / 32);
  return static_cast<int>(cudaGetLastError());
}
