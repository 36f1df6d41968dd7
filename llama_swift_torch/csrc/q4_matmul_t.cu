// Q4_0 product for 1..64 f32 activation rows: the T-layout product of the
// tensor-parallel path (q4_0_matmul_t) and, through the same entry, the
// f32-activation multi-row product (q4_0_matmul_multi_f32, 1..32 rows; the
// wrappers check their own row counts and count their own launches).
//
// Replaces the TPU kernel `_q4_0_phase_kernel` and its stacked form
// (llama_swift_tpu/ops/q4_matmul_pallas.py, core `_phase_core`, entry points
// q4_0_matmul_pallas and q4_0_matmul_pallas_stacked):
//
//   y[n, o] = sum_i  x[n, i] * ((nib[o, i] - 8) * d[o, i / 32])
//
// in f32.  The caller has already fake-quantized x through Q4_0 when the
// model quantizes activations, as the JAX package does outside its kernel.
// The TPU kernel gets f32-exact products from its bf16 matrix unit
// (Precision.HIGHEST, the "6-pass bf16" dot); this one from Hopper's bf16
// tensor cores in three passes: exact bf16 nibbles times an exact
// three-way bf16 split of x, the device core of q4_f32_mma.cuh, shared
// with the f32-activation multi-row product (q4_matvec.cu).  It takes each
// 32-block's dot first and scales it by d, where the plain version rounds
// each weight (n - 8) * d to f32: the two differ by at most 2^-24 of each
// term's magnitude (the argument is in q4_f32_mma.cuh).
//
// The weight keeps the logical ggml layout of Q4_0Weight: nibbles uint8
// [out, in/2] (byte j of a block holds elements 2j, low nibble, and 2j+1)
// and scales f32 [out, in/32].  The TPU's pre-tiled [out/128, in/8, 128]
// words existed for Mosaic's (8, 128) tiling and for contiguous HBM block
// reads.
//
// What bounds it on the H100: the weight stream at few rows (0.625 bytes a
// weight, 8.4 us at 11008x4096); the tensor work at many, 3 * 2 * N
// operations a weight at 989 TFLOP/s (17.5 us at N = 64 against 9.6 us of
// bytes).
//
// Design: q4_f32_mma.cuh's kernel: one or two rows with the three pieces
// of each row as MMA columns, more rows padded to 8, 16, 32, 48 or 64
// (ops/q4_matvec.f32_mma_plan); 64 output rows a block, a ring of weight,
// scale and x chunks filled by producer warps with cp.async behind
// mbarriers, eight consumer warps on bf16 m16n8k16 MMAs; clusters of 2 or
// 4 blocks that share 1..4 tiles' units, their sums combined through
// distributed shared memory in a fixed order; one launch a call.  From 9
// rows a block holds an SM alone (its registers: the sums of 4 row tiles
// x 2 to 4 n-tiles a warp; from 33 rows its x chunks too).  What holds it back at one row
// (PERF.md): the CUDA cores' share (nibbles to bf16, the split of x) takes
// about as long as the weight stream, and the two do not fully overlap.
#include <cuda_runtime.h>
#include <stdint.h>

#include "q4_f32_mma.cuh"

// Shared memory of a launch for N rows (ops/q4_matvec.f32_mma_plan
// computes the same).
extern "C" int q4_0_f32_mma_smem_bytes(int n_rows) { return fm_smem_bytes(fm_np(n_rows)); }

// qs [out][in/2] u8, d [out][in/32] f32, x [n_rows][in] f32 -> y [n_rows][out] f32;
// 1 <= n_rows <= 64, in % 32 == 0, qs 16-byte aligned; clusters of
// `cluster` blocks sharing `cluster_tiles` tiles of 64 output rows.  One
// launch.
extern "C" int q4_0_f32_mma(const void* qs, const void* d, const void* x, void* y, int out, int in, int n_rows,
                            int cluster, int cluster_tiles, void* stream) {
  return static_cast<int>(
      fm_product(qs, d, x, y, out, in, n_rows, cluster, cluster_tiles, static_cast<cudaStream_t>(stream)));
}
