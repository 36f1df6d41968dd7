// Batch-1 Q4_0 and Q4_1 matvecs on 4-bit activation codes (q4_0_matvec,
// q4_1_matvec): one kernel template, q4_matvec_kernel<Block>, the weight
// block type its parameter.
//
// Replace the TPU kernels `_q4_0_vpu_kernel` / `_q4_0_vpu_kernel_stacked`
// and `_q4_1_vpu_kernel` / `_q4_1_vpu_kernel_stacked` with their manually
// pipelined forms (llama_swift_tpu/ops/q4_vpu_pallas.py, entry points
// q4_0_vpu_matvec(_stacked) and q4_1_vpu_matvec(_stacked), activations
// quantized by _prep_inputs and _prep_inputs_q41), the device forms of
// ggml_vec_dot_q4_0 and ggml_vec_dot_q4_1 (ggml.c:1296-1626):
//
//   Q4_0:  y[o] = sum_b d_w[o,b] * d_x[b] * ( sum_i n[o,32b+i] * q[32b+i]  -  8 * sum_i q[32b+i] )
//   Q4_1:  y[o] = sum_b d_w[o,b] * sum_i n[o,32b+i] * xh[32b+i]  +  m_w[o,b] * sum_i xh[32b+i]
//
// with n the stored nibbles (0..15); Q4_0 quantizes x per 32-block to
// integers q in [-7, 7] (d_x = amax/7, round half away from zero), Q4_1 to
// codes q in [0, 15] (min/max, d_x = (max - min)/15) and xh = q * d_x + m_x.
// ggml_vec_dot_q4_1's algebra makes Q4_1's block work integer too:
// sum(n * xh) = d_x * sum(n * q) + m_x * sum(n).
//
// What bounds them on the H100: device-memory bandwidth.  A weight costs
// 0.625 bytes (Q4_0: half a byte of nibble and 4 bytes of scale per 32) or
// 0.75 (Q4_1: 8 bytes of (d, m) per 32) and 2 integer operations, far below
// the int8 rate; the tensor cores cannot help a single row, so __dp4a on
// the CUDA cores takes four products a time (a block is 8 dp4a; Q4_1 adds
// 8 more against 0x01 bytes for sum(n)).
//
// Design (q4_matvec_kernel<Block>: one launch a call, no scratch).  The
// first kernels were two launches a call (a quantizing pre-pass through
// global scratch, then one warp a row, eight rows a block, four loads in
// flight a warp), which held the 4096^2 product, 128 of a token's 225
// calls, at 34 % (Q4_0) and 38 % (Q4_1) of its bound.  Now, on a
// persistent grid (ops/q4_matvec.matvec_q4_plan):
//  * one block of MV_WARPS = 32 warps an SM, so that x is staged and
//    quantized once an SM; warp w of block g walks rows w * grid + g,
//    + 32 * grid, ... (interleaved over the SMs: no SM holds more than one
//    row beyond another);
//  * thread 0 first issues one bulk copy (TMA) of x into shared memory: an
//    L2 hit that the weight loads queued in the SM cannot hold back (plain
//    loads of x waited behind them, 1.7-2.8 us at in 4096 and 11008 in the
//    variants timed); x off 16-byte alignment is staged by plain loads;
//  * each lane then issues the streaming loads (evict first, as the stream
//    probe's) of its first MV_RING weight blocks, 16 bytes of nibbles and
//    the 4-byte scale or Q4_1's 8-byte (d, m) each: at in 4096 (4 blocks a
//    lane a row) a lane's whole row is in flight at once;
//  * while they are on their way, the block quantizes x from shared memory
//    into shared memory, a quad of threads a 32-block (a thread holds 8
//    elements, so the tree of a warp's butterfly is levels 16, 8 and 4 in
//    its registers and levels 2 and 1 two shuffles): 32 codes
//    de-interleaved as quantize_block_warp writes them, even and odd halves
//    in two planes so that lane l's 16-byte reads of block l + 32k do not
//    conflict, and per block {sum of codes, d_x} (Q4_0) or {d_x, m_x,
//    sum xh} (Q4_1); with x, 168 or 176 bytes per 32 elements (cap:
//    ops/q4_matvec.MAX_Q4_IN);
//  * then a ring of MV_RING blocks in registers runs across rows: a lane's
//    blocks of a row and those of its next row form one stream, a refill
//    issued as soon as a block is taken.
// The codes are the pre-pass's bit for bit: amax, min and max are exact in
// any order, each code is its own element's _rn rounding, the sum of codes
// is an exact integer, and Q4_1's sum of xh is added in warp_sum_f's
// butterfly tree order (xor 16, 8, 4, 2, 1, as lane 0 saw it).  The sums
// are the first kernels' bit for bit: lane l adds its blocks l, l + 32,
// ... in order, Q4_0 as acc + part * (d_w * d_x) with each operation
// rounded, Q4_1 in the contraction nvcc chose for the first kernel's
// `acc += d * nx + m * s` (read from its SASS), written out with fmaf so
// that no kernel context changes it; then the same warp butterfly.  A
// row's lanes step through the same number of ring slots (a lane past the
// row's blocks skips its slot), so the butterfly meets every lane at the
// row's end.
//
// Multi-row matmul (q4_0_matmul_multi, 2..32 activation rows, the batched
// decode step of the continuous-batching engine).
//
// Replaces the TPU kernel `_make_multi_kernel` / `_multi_grid_kernel*`
// (llama_swift_tpu/ops/q4_vpu_pallas.py, entry point q4_0_vpu_matmul_multi):
//
//   y[r, o] = sum_b d_w[o,b] * d_x[r,b] * (sum_i n[o,32b+i] q[r,32b+i] - 8 sum_i q[r,32b+i])
//
// What bounds it on the H100: the weight stream (the same 0.625 bytes a
// weight as the matvec, now shared by B rows: 8.6 us at 11008x4096), with
// 2*B integer operations a weight on the int8 tensor cores (0.7 us at
// B = 32) and per block and row one f32 scaling of the exact dot (the
// limit of the instruction rate at B = 32).  Each code byte and each weight
// byte is read from memory once per block of threads, so the bytes do not
// grow with B.
//
// Design (q4_0_matmul_multi_kernel):
//  * Pre-pass (quantize_rows_bias_kernel): the quantizer of q4_common.cuh
//    (bit-identical to the plain version), codes de-interleaved per block,
//    rows padded with zero codes to NP = 8 * ceil(B / 8), and per (block,
//    row) the pair {0x4B400000 - 8 S, dx}.
//  * Block dots on the int8 tensor cores: each 32-element block is one
//    m16n8k32 u8 x s8 MMA (q4_mma.cuh, shared with the T layout's integer
//    product) of 16 weight rows (unsigned nibbles) by 8 activation rows
//    (codes), in the K order the codes already have.  The MMA's
//    accumulator input carries 0x4B400000 - 8 S, so its result is the bit
//    pattern of the float 12582912 + (P - 8 S), exact for |P - 8 S| <
//    2^22: one float subtraction recovers the exact integer without a
//    conversion instruction, and the block's term is scaled by d_w * d_x
//    right after its MMA: the product rounded, then added to an f32
//    accumulator, as the plain version does.
//  * A block of 8 warps owns 64 output rows (warp w: 16-row tile w % 4,
//    pairs of blocks 4u + 2 (w / 4), + 1 of each chunk) and walks the
//    in-dim in chunks of 16 weight blocks through a ring of 3 stages (2 at
//    NP 32) in shared memory, filled by cp.async: each stage holds the
//    chunk's nibbles (64 rows x 256 bytes), their scales, the NP rows'
//    codes and their {bias, dx} pairs, so every byte of the weight and of
//    the codes is read from memory once per block, and the codes are tiled
//    with the weight, so no row count or in-dim overflows shared memory
//    (two blocks an SM; one at 9-16 rows, for the registers below).  Each
//    thread's copy addresses are computed once; each chunk adds its offset.
//    Fragments come from shared memory by ldmatrix (two blocks' A or B
//    fragments an instruction; rows padded by 16 bytes: conflict-free); a
//    full chunk's loop has no guard, so the compiler interleaves its 8 MMAs.
//  * The order of the sum over blocks (see the kernel): up to 16 rows, the
//    order of the warp-a-row kernel this design replaced (a sequential sum
//    per class of blocks b mod 32 in registers, then a warp's butterfly
//    tree over the classes), so that its results, and every result built
//    on them, stay bit for bit what they were; from 17 rows the 128 more
//    registers do not fit and each warp sums two chains (reassociated).
//  * Where 64-row tiles fill at most half of the blocks the card holds
//    (LLaMA's 4096 and 5120 outputs), a thread-block cluster of 2 blocks
//    takes the even and the odd chunks of each tile
//    (ops/q4_matvec.multi_plan); at the end block 1 pushes its sums into
//    block 0's shared memory (distributed shared memory, after a cluster
//    barrier that frees the rings) and block 0 finishes the sums and
//    stores y: one launch of the product a call, no global scratch,
//    deterministic.
//  * Rows beyond `out` read row out - 1 and are never stored; activation
//    rows beyond B are zero codes and are never stored.
// What still holds it back (measured, PERF.md): a call is two launches (the
// pre-pass and a launch gap), and each block takes chunk after chunk
// behind a barrier each, so at B = 8 the weight stream is not kept full;
// from B = 16 the per-block scaling of NT MMAs a block pair sets the pace.
//
// The T layout's exact integer product (q4_0_int_matmul, N >= 1 rows).
//
// Replaces the TPU kernel `_q4_0_magic_kernel` and its stacked form
// (llama_swift_tpu/ops/q4_matmul_pallas.py, core `_magic_core`, entry
// points q4_0_int_matmul_pallas and q4_0_int_matmul_pallas_stacked), whose
// function is the multi-row product's: y[n, o] = sum_b d_w[o,b] d_x[n,b]
// (P - 8 S) with exact block dots P of each row's 4-bit codes.  The TPU
// kernel puts the block dots on its matrix unit through a block-diagonal
// bf16 expansion of the codes; here it is the multi-row kernel above,
// extended from 32 to 64 activation rows a launch: NT = ceil(N / 8) tiles
// of 8 rows, the same ring, MMA and magic-bias scaling.  At 1..32 rows it
// is q4_0_matmul_multi's pre-pass and launch, bit for bit.  At 33..64
// rows (NT 5..8) a warp keeps its two chains for all NT tiles (64
// accumulators a lane at NT 8, one block of 256 threads an SM: the ring's
// three stages take 146-194 KB), and the in-dim is split over a cluster of
// 2 where that takes fewer waves of blocks over the SMs
// (ops/q4_matvec.int_matmul_plan).  Sum order at 33..64 rows: each block's
// exact P - 8 S times the rounded d_w * d_x, added to one of the warp's two
// chains by one FMA (one rounding for the product and the sum, where 1..32
// rows round each; 3-15 % faster at 33-100 rows, measured with
// tools/block_variants.py), the chains added, the KS * 2 warp parts summed
// in order.  More than 64 rows are further calls of at most
// 64, each a pre-pass and a launch.  What bounds it: the weight stream
// (8.4 us at 11008x4096), then the per-block scaling of every (row,
// output) pair on the CUDA cores (three f32 operations each: 270 M at N =
// 64 and 11008x4096), whose dependent chains eight warps an SM do not hide.
//
// f32 activations (q4_0_matvec_f32, q4_1_matvec_f32, q4_0_matmul_multi_f32:
// ModelConfig.quantize_activations = False).
//
// Replace the same TPU kernels fed unquantized rows (_prep_inputs,
// _prep_inputs_q41 and _prep_inputs_multi with quantize_acts=False in
// llama_swift_tpu/ops/q4_vpu_pallas.py: d_x = 1, x itself in place of the
// codes; the multi-row one is `_make_multi_kernel` / `_multi_grid_kernel*`
// behind q4_0_vpu_matmul_multi):
//
//   Q4_0:  y[r, o] = sum_b d[o,b] * sum_i (n[o,32b+i] - 8) * x[r, 32b+i]
//   Q4_1:  y[o]    = sum_b d[o,b] * sum_i n[o,32b+i] * x[32b+i]  +  m[o,b] * sum_i x[32b+i]
//
// The TPU kernel takes sum(n*x) - 8*sum(x) in a phase-major order scaled by
// 16^-p for Mosaic's lanes; these kernels take the plain sums, equal up to
// reassociation.
//
// Matvecs: plain f32 arithmetic on the CUDA cores (no fast math, no TF32,
// no bf16).  A nibble becomes a float without a conversion instruction:
// placed under the exponent of 2^23 (0x4B000000 | n is exactly 2^23 + n),
// one subtraction leaves n - 8 (Q4_0) or n (Q4_1) exactly.  What bounds
// them on the H100: device-memory bandwidth (the bytes of the packed
// weight, as rows 1 and 5).
//
// Multi-row (q4_0_matmul_multi_f32, 1..32 rows): not in this file.  It is
// the bf16 tensor-core product of q4_f32_mma.cuh, shared with the T
// layout's q4_0_matmul_t and launched through q4_matmul_t.cu's one entry:
// exact bf16 nibbles times an exact three-way bf16 split of x, each
// block's dot in a fresh f32 accumulator, scaled by d on the CUDA cores;
// one launch a call, no pre-pass (nothing is quantized).  What bounds it:
// the weight bytes (8.4 us at 11008x4096, up to 32 rows; the tensor work
// is 3 * 2 * B operations a weight at 989 TFLOP/s, 2.2 us at B = 8).  The
// design, the K order and the rounding argument are in q4_f32_mma.cuh.
//
// Design, f32 matvecs (q4_matvec_f32_kernel<Block>: Q4_0 and Q4_1 on one
// kernel, the weight block type its template parameter).  The first kernels staged the whole x row in every block
// before its first weight load, so each block waited on L2 and then on
// device memory in turn; up to 1,056 blocks re-read x (8 MB of L2 reads
// at 4096^2, 22.5 MB at 4096x11008, against 10.5 and 28 MB of Q4_0
// weights); a warp had two blocks' loads in flight at a time; that held
// them at 35-55 % of their bound at 7B shapes (Q4_0 8.96 us at 4096^2,
// Q4_1 9.27; H100 80GB HBM3 at 700 W).  Now:
//  * a persistent grid of two F32_WARPS-warp blocks an SM (ops/q4_matvec.
//    matvec_f32_plan): x is staged 264 times (4.3 MB of L2 reads at in
//    4096), and every warp walks rows r, r + 16 * grid, ...;
//  * a block first issues the loads of x's first round (L2 hits, so they
//    return first), then each lane the loads of its first F32_RING weight
//    blocks (16 bytes of nibbles and the 4-byte scale, or Q4_1's 8-byte
//    (d, m), each), then stages x while the weights are on their way;
//    Q4_1 then sums each 32-block of x from the staged copy (the first
//    weights still in flight) beside the row;
//  * then a ring of F32_RING blocks in registers runs across rows: the
//    lane's blocks of a row and those of its next row form one stream, a
//    refill issued as soon as a block is taken.
// x is staged transposed to [8][nb] float4, so that lane l, on blocks l,
// l+32, ..., reads consecutive float4 (no bank conflict; the row stride is
// odd, so the staging writes do not conflict either).
// Variants timed on the card for Q4_0 (throwaway builds, H100 80GB HBM3 at
// 700 W): rings of 1-8 blocks a lane and 8-32 warps at 1-6 blocks an SM;
// two blocks in flight a lane and two 16-warp blocks an SM were the
// fastest at most of LLaMA's shapes (deeper rings take registers and
// blocks).  The arithmetic is the first kernels', bit for bit: lane l sums
// its blocks l, l+32, ... in order, each block's dot a fresh chain of 32
// FMAs, into the lane's sum as fma(d, dot, acc) (Q4_1: fma(d, dot, fma(m,
// xsum, acc)), each block's sum of x four elements at a time), then the
// same warp butterfly; a row's lanes step through the same number of ring
// slots (a lane past the row's blocks skips its slot), so the butterfly
// meets every lane at the row's end.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "q4_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// multi-row Q4_0 product on the int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int MM_THREADS = 256;              // 8 warps: MM_MT row tiles x MM_KG parts of each chunk
constexpr int MM_ROWS = 64;                  // output rows a block
constexpr int MM_MT = 4;                     // 16-row MMA tiles of a block
constexpr int MM_KG = 2;                     // warps a tile, which split each chunk's blocks
constexpr int MM_KC = 16;                    // weight blocks a chunk (a ring stage)
constexpr int MM_MAX_SPLITS = 2;             // blocks of a cluster that split a tile's in-dim
constexpr int MM_WSTRIDE = MM_KC * 16 + 16;  // bytes of a row's nibbles in a stage (16 of padding)
constexpr int MM_DSTRIDE = MM_KC + 4;        // floats of a row's scales in a stage (16 of padding)
constexpr int MM_XSTRIDE = MM_KC * 32 + 16;  // bytes of an activation row's codes in a stage
constexpr int MM_MAGIC = 0x4B400000;         // the float 12582912 = 1.5 * 2^23
constexpr int MM_MAX_ROWS = 64;              // activation rows a launch (q4_0_int_matmul; 32 for q4_0_matmul_multi)

// Ring stages for NP activation rows: 3 (2 chunks in flight while one is
// used), 2 at NP 32, so that two blocks fit on an SM (measured: a third
// stage at NP 8, or at NP 32 a third stage with one block an SM, were no
// faster).  Byte offsets in a stage:
// nibbles [MM_ROWS][MM_WSTRIDE], scales [MM_ROWS][MM_DSTRIDE] f32, codes
// [NP][MM_XSTRIDE], then [MM_KC][NP] pairs {0x4B400000 - 8 S, dx}; all
// 16-byte aligned.
__host__ __device__ constexpr int mm_stages(int np) { return np == 32 ? 2 : 3; }
__host__ __device__ constexpr int mm_off_d() { return MM_ROWS * MM_WSTRIDE; }
__host__ __device__ constexpr int mm_off_x() { return mm_off_d() + MM_ROWS * MM_DSTRIDE * 4; }
__host__ __device__ constexpr int mm_off_bd(int np) { return mm_off_x() + np * MM_XSTRIDE; }
__host__ __device__ constexpr int mm_stage_bytes(int np) { return mm_off_bd(np) + MM_KC * np * 8; }
__host__ __device__ constexpr int mm_smem_bytes(int np) { return mm_stages(np) * mm_stage_bytes(np); }
static_assert(MM_KC % 4 == 0 && mm_off_x() % 16 == 0 && MM_XSTRIDE % 16 == 0, "16-byte stage parts");
// block 0's partial sums of the cluster, [KS][MM_KG][NP][MM_ROWS], reuse the ring
static_assert(MM_KG * MM_MAX_SPLITS * 8 * MM_ROWS * 4 <= mm_smem_bytes(8) &&
              MM_KG * MM_MAX_SPLITS * 32 * MM_ROWS * 4 <= mm_smem_bytes(32) &&
              MM_KG * MM_MAX_SPLITS * 40 * MM_ROWS * 4 <= mm_smem_bytes(40) &&
              MM_KG * MM_MAX_SPLITS * 64 * MM_ROWS * 4 <= mm_smem_bytes(64), "partials fit the ring");
static_assert(mm_smem_bytes(MM_MAX_ROWS) <= 232448, "a block's shared memory at 64 rows");
static_assert(MM_MT * 16 == MM_ROWS && MM_MT * MM_KG * 32 == MM_THREADS, "warps: tiles x parts of a chunk");

// x [N][nb*32] f32 -> xq [NP][nb*32] i8 (quantize_block_warp's codes, zero
// rows from N up to NP), and bd [nb][NP] {0x4B400000 - 8 S, dx}: the MMA's accumulator
// input and the block scale of each (block, row), side by side (zero rows:
// S = 0, dx = 0)
__global__ void quantize_rows_bias_kernel(const float* __restrict__ x, int N, int NP, int nb,
                                          int8_t* __restrict__ xq, int2* __restrict__ bd) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);  // (row n, block b), row-major
  if (i >= NP * nb) return;
  const int n = i / nb, b = i - n * nb;
  int8_t* codes = xq + static_cast<size_t>(i) * QK;
  int* bias = &bd[b * NP + n].x;
  float* d = reinterpret_cast<float*>(&bd[b * NP + n].y);
  if (n < N) {
    quantize_block_warp(x[static_cast<size_t>(i) * QK + lane], lane, codes, bias, d);
    if (lane == 0) *bias = MM_MAGIC - 8 * *bias;  // lane 0 stored S just now
  } else {
    codes[lane] = 0;
    if (lane == 0) {
      *bias = MM_MAGIC;
      *d = 0.0f;
    }
  }
}

// This thread's cp.async copies of a full chunk (MM_KC blocks) where rows
// of scales are 16-byte aligned (nb % 4 == 0): the source addresses of
// chunk 0 and the stage offsets, computed once; chunk c adds c * MM_KC
// blocks to each source.
template <int NP>
struct MmCopies {
  static constexpr int W = MM_ROWS * MM_KC / MM_THREADS, X = NP * MM_KC * 2 / MM_THREADS;
  static constexpr int BD = (MM_KC * NP / 2 + MM_THREADS - 1) / MM_THREADS;  // 16-byte copies of pairs: 1, 2 from 40 rows
  static_assert(W * MM_THREADS == MM_ROWS * MM_KC && X * MM_THREADS == NP * MM_KC * 2 &&
                    MM_ROWS * MM_KC / 4 <= MM_THREADS,
                "every copy of a chunk has a thread");
  const uint8_t* w[W];
  const int8_t* x[X];
  const float* d;
  const int2* bd;
  int wdst[W], xdst[X], ddst, bddst;
  __device__ MmCopies(const uint8_t* qs, const float* dw, const int8_t* xq, const int2* bdp, int o0, int out,
                      int nb) {
#pragma unroll
    for (int k = 0; k < W; ++k) {  // 16 bytes of nibbles: block kb of row r
      const int i = threadIdx.x + k * MM_THREADS, r = i / MM_KC, kb = i % MM_KC;
      w[k] = qs + (static_cast<size_t>(min(o0 + r, out - 1)) * nb + kb) * 16;
      wdst[k] = r * MM_WSTRIDE + kb * 16;
    }
    {  // 4 scales of row r
      const int r = threadIdx.x / (MM_KC / 4), kb = 4 * (threadIdx.x % (MM_KC / 4));
      d = dw + static_cast<size_t>(min(o0 + r, out - 1)) * nb + kb;
      ddst = mm_off_d() + (r * MM_DSTRIDE + kb) * 4;
    }
#pragma unroll
    for (int k = 0; k < X; ++k) {  // half of activation row n's codes of block kb
      const int i = threadIdx.x + k * MM_THREADS, n = i / (2 * MM_KC), kb = (i / 2) % MM_KC, h = i & 1;
      x[k] = xq + (static_cast<size_t>(n) * nb + kb) * QK + h * 16;
      xdst[k] = mm_off_x() + n * MM_XSTRIDE + kb * 32 + h * 16;
    }
    bd = bdp + 2 * threadIdx.x;  // 16 bytes of the chunk's [MM_KC][NP] pairs
    bddst = mm_off_bd(NP) + 16 * threadIdx.x;
  }
  __device__ __forceinline__ void full(unsigned char* st, int c) const {
#pragma unroll
    for (int k = 0; k < W; ++k) cp_async16(st + wdst[k], w[k] + static_cast<size_t>(c) * MM_KC * 16);
    if (threadIdx.x < MM_ROWS * MM_KC / 4) cp_async16(st + ddst, d + static_cast<size_t>(c) * MM_KC);
#pragma unroll
    for (int k = 0; k < X; ++k) cp_async16(st + xdst[k], x[k] + static_cast<size_t>(c) * MM_KC * QK);
#pragma unroll
    for (int k = 0; k < BD; ++k)
      if (threadIdx.x + k * MM_THREADS < MM_KC * NP / 2)
        cp_async16(st + bddst + 16 * k * MM_THREADS, bd + static_cast<size_t>(c) * MM_KC * NP + 2 * k * MM_THREADS);
  }
};

// Chunk c (weight blocks [c * MM_KC, + cb)) of tile rows [o0, o0 + 64) and
// of the NP activation rows into stage `st`, every thread issuing its
// share of cp.async copies (one commit group by the caller), each copy
// guarded: the ragged last chunk, or any chunk where rows of scales are
// not 16-byte aligned (MmCopies::full takes the others).
template <int NP>
__device__ void mm_load_chunk(unsigned char* st, const uint8_t* __restrict__ qs, const float* __restrict__ dw,
                              const int8_t* __restrict__ xq, const int2* __restrict__ bd, int o0, int out, int nb,
                              int c) {
  const int kb0 = c * MM_KC, cb = min(MM_KC, nb - kb0);
  for (int i = threadIdx.x; i < MM_ROWS * MM_KC; i += MM_THREADS) {
    const int r = i / MM_KC, kb = i % MM_KC;
    if (kb < cb)
      cp_async16(st + r * MM_WSTRIDE + kb * 16, qs + (static_cast<size_t>(min(o0 + r, out - 1)) * nb + kb0 + kb) * 16);
  }
  for (int i = threadIdx.x; i < MM_ROWS * MM_KC; i += MM_THREADS) {
    const int r = i / MM_KC, kb = i % MM_KC;
    if (kb < cb)
      cp_async4(st + mm_off_d() + (r * MM_DSTRIDE + kb) * 4, dw + static_cast<size_t>(min(o0 + r, out - 1)) * nb + kb0 + kb);
  }
  for (int i = threadIdx.x; i < NP * MM_KC * 2; i += MM_THREADS) {
    const int n = i / (2 * MM_KC), kb = (i / 2) % MM_KC, h = i & 1;
    if (kb < cb)
      cp_async16(st + mm_off_x() + n * MM_XSTRIDE + kb * 32 + h * 16,
                 xq + (static_cast<size_t>(n) * nb + kb0 + kb) * QK + h * 16);
  }
  for (int i = threadIdx.x; i < cb * NP / 2; i += MM_THREADS)  // cb rows of NP pairs, contiguous
    cp_async16(st + mm_off_bd(NP) + i * 16, bd + static_cast<size_t>(kb0) * NP + 2 * i);
}

// qs [out][nb*16] u8, dw [out][nb] f32, xq [NP][nb*32] i8, bd [nb][NP]
//   -> y [B][out] f32.  Grid (KS, ceil(out / 64)), cluster (KS, 1, 1):
// block (r, tile) takes chunks r, r + KS, ... of tile's 64 rows.  NT = NP / 8
// activation tiles.
//
// The sum over blocks.  Every block's term d_w * d_x * (P - 8 S) is
// rounded as the plain version rounds it.  At NT <= 2 (B <= 16) the terms
// are summed in the order of the warp-a-row kernel this one replaced: per
// output, one sequential sum for each class of blocks b = l (mod 32),
// then those 32 sums by the butterfly tree of a warp reduction (xor 16,
// 8, 4, 2, 1), so the products, and every result built on them, are bit
// for bit those of that kernel.  Class l = 16 p + kb of block b = 16 c +
// kb (p: the parity of chunk c; kb = 4u + 2 kg + h: warp part kg, pair u,
// block h of the pair) lives in one warp's registers, acc[p][u][h], so
// each class sum is sequential; a cluster of 2 takes the chunks of one
// parity each.  At NT >= 3 those registers do not fit, and each warp sums
// into two chains (h) instead: the sum is reassociated.  NT 5..8 (33-64
// rows, q4_0_int_matmul only) take that order too, each term added by one
// FMA: per output, warp part kg's two chains (its blocks kb = 4u + 2 kg of
// each chunk in chunk order, chain h the pair's block h), added, then the
// KS * MM_KG parts summed in (cluster rank, kg) order; 8 NT accumulators a
// lane, one block an SM.
template <int NT>
__global__ void __launch_bounds__(MM_THREADS, NT == 2 || NT > 4 ? 1 : 2)  // NT 2: 128 class sums a lane
q4_0_matmul_multi_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ dw,
                         const int8_t* __restrict__ xq, const int2* __restrict__ bd, float* __restrict__ y,
                         int out, int nb, int B) {
  constexpr int NP = 8 * NT, STAGES = mm_stages(NP), U = MM_KC / (2 * MM_KG);
  constexpr bool EXACT = NT <= 2;
  static_assert(MM_KC == 16 && MM_KG == 2, "the class of a block: 16 p + 4 u + 2 kg + h");
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int mt = warp % MM_MT, kg = warp / MM_MT;  // this warp's 16-row tile and part of each chunk
  const int rank = blockIdx.x, KS = gridDim.x, o0 = blockIdx.y * MM_ROWS;
  const int nchunks = (nb + MM_KC - 1) / MM_KC, n = (nchunks - rank + KS - 1) / KS;

  // chunk c into stage s; every chunk but the tensor's last is full
  const MmCopies<NP> copies(qs, dw, xq, bd, o0, out, nb);
  auto load = [&](int c, int s) {
    unsigned char* st = mm_smem + s * mm_stage_bytes(NP);
    if ((c + 1) * MM_KC <= nb && nb % 4 == 0)
      copies.full(st, c);
    else
      mm_load_chunk<NP>(st, qs, dw, xq, bd, o0, out, nb, c);
  };
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load(rank + i * KS, i);
    cp_async_commit();
  }
  // EXACT: the class sums acc[p][u][h]; else two chains acc[0][0][h]
  float acc[EXACT ? 2 : 1][EXACT ? U : 1][2][NT][4];
#pragma unroll
  for (int p = 0; p < (EXACT ? 2 : 1); ++p)
#pragma unroll
    for (int u = 0; u < (EXACT ? U : 1); ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][u][h][j][e] = 0.0f;

  const int r_lo = mt * 16 + g;
  // this lane's ldmatrix rows (lanes 8m..8m+7 address matrix m): weight row
  // and block of the pair; activation row, block of the pair and 16-byte half
  const int a_off = (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * MM_WSTRIDE + (lane >> 4) * 16;
  const int x_off = (lane & 7) * MM_XSTRIDE + (lane >> 4) * 32 + ((lane >> 3) & 1) * 16;
  // the blocks of a chunk this warp takes, in pairs kb, kb + 1 (kb = 4u + 2 kg);
  // FULL: all of them are there, so no guard splits the pairs into blocks
  // of their own and the compiler interleaves their loads and MMAs; P: the
  // chunk's parity
  auto compute = [&](const unsigned char* st, int cb, auto full, auto parity) {
    constexpr bool FULL = decltype(full)::value;
    constexpr int P = EXACT ? decltype(parity)::value : 0;
    const uint32_t sw = smem_u32(st), sx = smem_u32(st + mm_off_x());
    const float* sd = reinterpret_cast<const float*>(st + mm_off_d());
    const int4* sbd = reinterpret_cast<const int4*>(st + mm_off_bd(NP));
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kb = 2 * MM_KG * u + 2 * kg;
      if (FULL || kb < cb) {
        uint32_t w[4];  // word t of rows g, g + 8 of block kb, then of block kb + 1
        ldsm_x4(sw + a_off + kb * 16, w);
        const float2 d_lo = *reinterpret_cast<const float2*>(sd + r_lo * MM_DSTRIDE + kb);
        const float2 d_hi = *reinterpret_cast<const float2*>(sd + (r_lo + 8) * MM_DSTRIDE + kb);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[4];  // codes words t and 4 + t of row j * 8 + g, block kb, then kb + 1
          ldsm_x4(sx + j * 8 * MM_XSTRIDE + x_off + kb * 32, b);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (FULL || h == 0 || kb + 1 < cb) {
              // {bias, dx} of activation rows 2t and 2t + 1 of this tile, block kb + h
              const int4 e = sbd[(kb + h) * (NP / 2) + j * 4 + t];
              uint32_t a[4];
              a_fragment(w[2 * h], w[2 * h + 1], a);
              const int c[4] = {e.x, e.z, e.x, e.z};
              int p[4];
              mma_u8s8(a, b[2 * h], b[2 * h + 1], c, p);  // 12582912 + P - 8 S, as float bits
              const float w_lo = h ? d_lo.y : d_lo.x, w_hi = h ? d_hi.y : d_hi.x;
              const float dx0 = __int_as_float(e.y), dx1 = __int_as_float(e.w);
              float* ac = acc[P][EXACT ? u : 0][h][j];  // each term rounded, then added (no FMA) ...
              if constexpr (NT > 4) {  // ... but from 33 rows the product and the sum in one rounding
                ac[0] = fmaf(__fsub_rn(__int_as_float(p[0]), 12582912.0f), __fmul_rn(w_lo, dx0), ac[0]);
                ac[1] = fmaf(__fsub_rn(__int_as_float(p[1]), 12582912.0f), __fmul_rn(w_lo, dx1), ac[1]);
                ac[2] = fmaf(__fsub_rn(__int_as_float(p[2]), 12582912.0f), __fmul_rn(w_hi, dx0), ac[2]);
                ac[3] = fmaf(__fsub_rn(__int_as_float(p[3]), 12582912.0f), __fmul_rn(w_hi, dx1), ac[3]);
              } else {
                ac[0] = __fadd_rn(ac[0], __fmul_rn(__fsub_rn(__int_as_float(p[0]), 12582912.0f), __fmul_rn(w_lo, dx0)));
                ac[1] = __fadd_rn(ac[1], __fmul_rn(__fsub_rn(__int_as_float(p[1]), 12582912.0f), __fmul_rn(w_lo, dx1)));
                ac[2] = __fadd_rn(ac[2], __fmul_rn(__fsub_rn(__int_as_float(p[2]), 12582912.0f), __fmul_rn(w_hi, dx0)));
                ac[3] = __fadd_rn(ac[3], __fmul_rn(__fsub_rn(__int_as_float(p[3]), 12582912.0f), __fmul_rn(w_hi, dx1)));
              }
            }
          }
        }
      }
    }
  };
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();              // everyone's copies; stage (i - 1) % STAGES is free
    if (i + STAGES - 1 < n) load(rank + (i + STAGES - 1) * KS, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* st = mm_smem + (i % STAGES) * mm_stage_bytes(NP);
    const int c = rank + i * KS, cb = min(MM_KC, nb - c * MM_KC);
    using F = std::true_type;
    using G = std::false_type;
    using P0 = std::integral_constant<int, 0>;
    using P1 = std::integral_constant<int, 1>;
    if (cb == MM_KC)
      (c & 1) ? compute(st, cb, F(), P1()) : compute(st, cb, F(), P0());
    else
      (c & 1) ? compute(st, cb, G(), P1()) : compute(st, cb, G(), P0());
  }
  cp_async_wait<0>();
  __syncthreads();
  // every block of the cluster is done with its ring: block 0's becomes the
  // partials that the other block pushes into it
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  float* red = cg::this_cluster().map_shared_rank(reinterpret_cast<float*>(mm_smem), 0);
  float* part = reinterpret_cast<float*>(mm_smem);
  if constexpr (EXACT) {
    constexpr int SLOTS = U * 2 * NT * 4;  // a lane's class sums of one parity
    if (rank == 1) {  // block 1 holds the odd chunks: classes 16..31, acc[1]
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[(warp * SLOTS + ((u * 2 + h) * NT + j) * 4 + e) * 32 + lane] = acc[1][u][h][j][e];
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (rank != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    float s4[2][NT][4];  // tree levels 16 (p), 8 (u >> 1) and 4 (u & 1), per h
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s16[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            s16[u] = __fadd_rn(acc[0][u][h][j][e],
                               KS == 2 ? part[(warp * SLOTS + ((u * 2 + h) * NT + j) * 4 + e) * 32 + lane]
                                       : acc[1][u][h][j][e]);
          s4[h][j][e] = __fadd_rn(__fadd_rn(s16[0], s16[2]), __fadd_rn(s16[1], s16[3]));
        }
    __syncthreads();  // everyone is done reading the pushed sums
    float* s4_kg1 = part + 8 * SLOTS * 32;  // the kg = 1 warps' level-4 sums
    if (kg == 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s4_kg1[((mt * 2 + h) * NT * 4 + j * 4 + e) * 32 + lane] = s4[h][j][e];
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s2[2];  // level 2 (kg), then level 1 (h)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s2[h] = __fadd_rn(s4[h][j][e], s4_kg1[((mt * 2 + h) * NT * 4 + j * 4 + e) * 32 + lane]);
        const int nr = j * 8 + 2 * t + (e & 1), o = o0 + r_lo + (e >> 1) * 8;
        if (nr < B && o < out) y[static_cast<size_t>(nr) * out + o] = __fadd_rn(s2[0], s2[1]);
      }
  } else {
    // partials [KS][MM_KG][NP][MM_ROWS], which every warp writes its share of
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((rank * MM_KG + kg) * NP + j * 8 + 2 * t + (e & 1)) * MM_ROWS + r_lo + (e >> 1) * 8] =
            acc[0][0][0][j][e] + acc[0][0][1][j][e];
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (rank != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    for (int idx = threadIdx.x; idx < B * MM_ROWS; idx += MM_THREADS) {
      const int nr = idx / MM_ROWS, r = idx % MM_ROWS;
      if (o0 + r >= out) continue;
      float sum = 0.0f;
      for (int q = 0; q < MM_KG * KS; ++q) sum += part[(q * NP + nr) * MM_ROWS + r];
      y[static_cast<size_t>(nr) * out + o0 + r] = sum;
    }
  }
}

template <int NT>
cudaError_t launch_multi(const uint8_t* qs, const float* dw, const int8_t* xq, const int2* bd, float* y, int out,
                         int nb, int B, int ks, cudaStream_t s) {
  constexpr int smem = mm_smem_bytes(8 * NT);
  static const cudaError_t attr =
      cudaFuncSetAttribute(q4_0_matmul_multi_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (out + MM_ROWS - 1) / MM_ROWS, 1);
  cfg.blockDim = dim3(MM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = ks;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = ks > 1 ? 1 : 0;  // a launch without clusters is one of a block each
  const cudaError_t e = cudaLaunchKernelEx(&cfg, q4_0_matmul_multi_kernel<NT>, qs, dw, xq, bd, y, out, nb, B);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 activations
// ---------------------------------------------------------------------------

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
// any is stored; conflict-free writes (odd stride).  From element `from`
// on (the rounds before it staged by the caller).
__device__ __forceinline__ void stage(const float* __restrict__ x, int n, float4* xs, int stride, int from = 0) {
  float* xf = reinterpret_cast<float*>(xs);
  for (int e0 = from + threadIdx.x; e0 < n; e0 += STAGE_LOADS * blockDim.x) {
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

constexpr int F32_WARPS = 16;  // warps of an f32 matvec block, one row at a time each
constexpr int F32_RING = 2;    // weight blocks a lane keeps in flight
constexpr int F32_BLOCKS_PER_SM = 2;  // blocks an SM of the persistent grid (ops/q4_matvec.F32_BLOCKS_PER_SM)

// The weight block types of the f32 matvec.  Q4_0: a scale d, nibbles
// n - 8.  Q4_1: (d, m), nibbles n, and each block's sum of x beside the
// staged row.
struct F32BlockQ4_0 {
  using Scale = float;
  static constexpr bool kMin = false;
  static constexpr float kOffset = 8.0f;
};
struct F32BlockQ4_1 {
  using Scale = float2;
  static constexpr bool kMin = true;
  static constexpr float kOffset = 0.0f;
};

// qs [out][nb*16] u8, sc [out][nb] (Q4_0: d f32; Q4_1: {d, m} f32),
// x [nb*32] f32 -> y [out] f32.  Warp w of block g takes rows
// g * F32_WARPS + w + k * gridDim.x * F32_WARPS.
template <typename Block>
__global__ void __launch_bounds__(F32_WARPS * 32, F32_BLOCKS_PER_SM)
q4_matvec_f32_kernel(const uint8_t* __restrict__ qs, const typename Block::Scale* __restrict__ sc,
                     const float* __restrict__ x, float* __restrict__ y, int out, int nb, int stride) {
  extern __shared__ float4 xs[];  // [8][stride]: xs[j * stride + b] = x[32b + 4j .. 32b + 4j + 3]; Q4_1: then xsum [nb]
  const int lane = threadIdx.x & 31;
  const int kb = (nb + 31) / 32;                           // ring slots a row: lane l's blocks l + 32k, k < kb
  const int klast = lane < nb ? (nb - 1 - lane) / 32 : -1;  // this lane's last slot with a block
  const int rstep = gridDim.x * F32_WARPS;
  const int first = blockIdx.x * F32_WARPS + (threadIdx.x >> 5);
  const size_t jump = static_cast<size_t>(rstep) * nb - static_cast<size_t>(32) * kb;  // a row's end to the next row
  // the load cursor (lrow, lk; block lo of the weight) runs F32_RING slots ahead of the sums
  uint4 wq[F32_RING];
  typename Block::Scale wd[F32_RING];
  int lrow = first, lk = 0;
  size_t lo = static_cast<size_t>(first) * nb + lane;
  auto fetch = [&](int u) {
    if (lrow < out && lk <= klast) {
      wq[u] = __ldg(reinterpret_cast<const uint4*>(qs) + lo);
      wd[u] = __ldg(sc + lo);
    }
    lo += 32;
    if (++lk == kb) {
      lk = 0;
      lrow += rstep;
      lo += jump;
    }
  };
  // x's first round first (L2 hits, back before the weights), then the
  // ring's first loads, then the rest of x
  const int n = nb * QK;
  float* xf = reinterpret_cast<float*>(xs);
  float xv[STAGE_LOADS];
#pragma unroll
  for (int u = 0; u < STAGE_LOADS; ++u) {
    const int e = threadIdx.x + u * blockDim.x;
    xv[u] = e < n ? __ldg(x + e) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < F32_RING; ++u) fetch(u);
#pragma unroll
  for (int u = 0; u < STAGE_LOADS; ++u) {
    const int e = threadIdx.x + u * blockDim.x;
    if (e < n) xf[((((e & 31) >> 2) * stride) + (e >> 5)) * 4 + (e & 3)] = xv[u];
  }
  stage(x, n, xs, stride, STAGE_LOADS * blockDim.x);
  __syncthreads();
  float* xsum = reinterpret_cast<float*>(xs + 8 * stride);  // Q4_1: each block's sum of x
  if constexpr (Block::kMin) {  // from the staged copy, while the first weights are on their way
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
  }
  int row = first, k = 0;
  const float4* xp = xs + lane;  // x of block lane + 32k
  float acc = 0.0f;
  while (row < out) {
#pragma unroll
    for (int u = 0; u < F32_RING; ++u) {
      if (row < out) {  // the same for the whole warp
        if (k <= klast) {
          float wf[QK];
          unpack_block(wq[u], Block::kOffset, wf);
          if constexpr (Block::kMin)
            acc = fmaf(wd[u].x, dot_block(wf, xp, stride), fmaf(wd[u].y, xsum[lane + 32 * k], acc));
          else
            acc = fmaf(wd[u], dot_block(wf, xp, stride), acc);
        }
        fetch(u);  // slot u is free: the block F32_RING slots on
        xp += 32;
        if (++k == kb) {
          acc = warp_sum_f(acc);
          if (lane == 0) y[row] = acc;
          acc = 0.0f;
          k = 0;
          row += rstep;
          xp = xs + lane;
        }
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

constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on the H100 (227 KB)

// The f32 matvec of Block's weights on `blocks` blocks of F32_WARPS warps
// (ops/q4_matvec.matvec_f32_plan: two an SM, fewer for few rows); x staged
// in shared memory, Q4_1 with each block's sum of x beside it.
template <typename Block>
int launch_matvec_f32(const void* qs, const void* sc, const void* x, void* y, int out, int in_dim, int blocks,
                      void* stream) {
  const int nb = in_dim / QK, stride = nb | 1;
  const size_t smem = static_cast<size_t>(8) * stride * sizeof(float4) + (Block::kMin ? nb * sizeof(float) : 0);
  if (out < 1 || nb < 1 || in_dim % QK || blocks < 1 || smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(q4_matvec_f32_kernel<Block>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  q4_matvec_f32_kernel<Block><<<blocks, F32_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const typename Block::Scale*>(sc), static_cast<const float*>(x),
      static_cast<float*>(y), out, nb, stride);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 4-bit activations (rows 1 and 5) on the persistent grid
// ---------------------------------------------------------------------------

constexpr int MV_WARPS = 32;         // warps of a block, one row at a time each (ops/q4_matvec.MV_WARPS)
constexpr int MV_RING = 4;           // weight blocks a lane keeps in flight (MV_RING)
constexpr int MV_BLOCKS_PER_SM = 1;  // blocks an SM of the persistent grid (MV_BLOCKS_PER_SM)

// The weight block types of the 4-bit-activation matvec.  quantize() takes
// one quad's share of a 32-block of x (quantize_x) and gives the quad's
// partial code words and the block's data exactly as the first kernels'
// pre-pass computed them (quantize_block_warp, the Q4_1 pre-pass); add()
// adds one weight block's term to a lane's sum as the first kernels did.
// Thread t of a quad holds elements t + 4k, k < 8: byte (t >> 1) + 2 (k & 1)
// of word k >> 1 of the even (t even) or the odd half of the codes.
struct BlockQ4_0 {
  using Scale = float;  // d_w
  using Meta = int2;    // {sum of the codes, d_x bits}
  __device__ static Meta quantize(const float* v, int t, uint32_t* w) {
    float a = fabsf(v[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) a = fmaxf(a, fabsf(v[k]));
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));  // amax: exact in any order
    const float d = __fdiv_rn(a, 7.0f);
    const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int q = static_cast<int>(truncf(__fadd_rn(__fmul_rn(v[k], inv), v[k] >= 0.0f ? 0.5f : -0.5f)));
      s += q;
      w[k >> 1] |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * ((t >> 1) + 2 * (k & 1)));
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    return make_int2(s, __float_as_int(d));
  }
  __device__ static float add(float acc, uint4 w, Scale d, uint4 e, uint4 o, Meta m) {
    const int part = block_dot(w, e, o, m.x);
    return __fadd_rn(acc, __fmul_rn(static_cast<float>(part), __fmul_rn(d, __int_as_float(m.y))));
  }
};
struct BlockQ4_1 {
  using Scale = float2;  // {d_w, m_w}
  using Meta = float4;   // {d_x, m_x, sum of xh, 0}
  __device__ static Meta quantize(float* v, int t, uint32_t* w) {
    float mn = v[0], mx = v[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      mn = fminf(mn, v[k]);
      mx = fmaxf(mx, v[k]);
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // min and max: exact in any order
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    const float d = __fdiv_rn(__fsub_rn(mx, mn), 15.0f);
    const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float q = truncf(__fadd_rn(__fmul_rn(__fsub_rn(v[k], mn), inv), 0.5f));  // v - mn >= 0
      w[k >> 1] |= static_cast<uint32_t>(q) << (8 * ((t >> 1) + 2 * (k & 1)));
      v[k] = __fadd_rn(__fmul_rn(q, d), mn);  // xh
    }
    // sum of xh in the tree order of warp_sum_f's butterfly as lane 0 sees
    // it: levels 16, 8, 4 pair this thread's own elements (k with k + 4,
    // then k + 2, then k + 1), levels 2 and 1 the quad's threads t ^ 2, t ^ 1
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fadd_rn(v[k], v[k + 4]);
    v[0] = __fadd_rn(v[0], v[2]);
    v[1] = __fadd_rn(v[1], v[3]);
    float s = __fadd_rn(v[0], v[1]);
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
    return make_float4(d, mn, s, 0.0f);
  }
  // sum(n * xh) = d_x * sum(n * q) + m_x * sum(n), then d_w * that + m_w *
  // sum(xh), in the contraction nvcc chose for the first kernel's
  // `nx = s.x * nq + s.y * n; acc += d * nx + m * s.z` (its SASS: FMUL s.y
  // n, FFMA s.x nq; FMUL d nx, FFMA m s.z; FADD acc)
  __device__ static float add(float acc, uint4 w, Scale dm, uint4 e, uint4 o, Meta s) {
    const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
    const float nq = static_cast<float>(block_dot(w, e, o, 0));
    const float n = static_cast<float>(block_dot(w, ones, ones, 0));
    const float nx = fmaf(s.x, nq, __fmul_rn(s.y, n));
    return __fadd_rn(acc, fmaf(dm.y, s.z, __fmul_rn(dm.x, nx)));
  }
};

// x [nb*32] f32, staged in shared memory (xs) -> its codes (even halves
// xe [nb], odd halves xo [nb], Meta [nb]), a quad of threads a 32-block,
// the quads of a warp on 8 consecutive blocks, round after round.  Quad q
// of a warp reads element t + 4 ((k + q) & 7) of its block in step k, so
// that the warp's 32 reads fall on 32 banks, and then rotates the eight
// values back into element order.  Every lane of a warp runs the same
// rounds (the quads past nb quantize block nb - 1 again and store
// nothing), so the shuffles are whole-warp.
template <typename Block>
__device__ __forceinline__ void quantize_x(const float* xs, int nb, uint4* xe, uint4* xo,
                                           typename Block::Meta* meta) {
  const int lane = threadIdx.x & 31, t = lane & 3, q = lane >> 2;
  for (int b = (threadIdx.x >> 5) * 8 + q; b - q < nb; b += (blockDim.x >> 5) * 8) {
    const float* xb = xs + min(b, nb - 1) * QK + t;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = xb[4 * ((k + q) & 7)];
#pragma unroll
    for (int r = 1; r < 8; r <<= 1) {  // v[k] holds element (k + q') & 7: take r off q'
      float u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = (q & r) ? v[(k - r) & 7] : v[k];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = u[k];
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const typename Block::Meta m = Block::quantize(v, t, w);
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g] |= __shfl_xor_sync(0xffffffffu, w[g], 2);  // the other two bytes of each word
    if (b < nb) {
      if (t < 2) (t ? xo : xe)[b] = make_uint4(w[0], w[1], w[2], w[3]);
      if (t == 0) meta[b] = m;
    }
  }
}

// Shared memory of a block at nb blocks of x: x staged [nb * 32] f32, even
// codes [nb] uint4, odd codes [nb] uint4, [nb] Block::Meta, then the
// staging copy's mbarrier (ops/q4_matvec.matvec_q4_plan computes the same)
template <typename Block>
__host__ __device__ constexpr size_t mv_smem_bytes(int nb) {
  return static_cast<size_t>(nb) * (QK * sizeof(float) + 2 * sizeof(uint4) + sizeof(typename Block::Meta)) + 8;
}

// qs [out][nb*16] u8, sc [out][nb] (Q4_0: d f32; Q4_1: {d, m} f32),
// x [nb*32] f32 -> y [out] f32.  Warp w of block g takes rows
// w * gridDim.x + g + k * gridDim.x * MV_WARPS: every SM within a row a
// warp of any other.
template <typename Block>
__global__ void __launch_bounds__(MV_WARPS * 32, MV_BLOCKS_PER_SM)
q4_matvec_kernel(const uint8_t* __restrict__ qs, const typename Block::Scale* __restrict__ sc,
                 const float* __restrict__ x, float* __restrict__ y, int out, int nb) {
  using Meta = typename Block::Meta;
  extern __shared__ uint4 xc[];  // x staged [nb][32] f32, then its codes: even halves, odd halves, Meta
  float* xs = reinterpret_cast<float*>(xc);
  uint4* xe = xc + 8 * nb;
  uint4* xo = xe + nb;
  Meta* meta = reinterpret_cast<Meta*>(xo + nb);
  uint64_t* bar = reinterpret_cast<uint64_t*>(meta + nb);
  const int lane = threadIdx.x & 31;
  const int kb = (nb + 31) / 32;                           // ring slots a row: lane l's blocks l + 32k, k < kb
  const int klast = lane < nb ? (nb - 1 - lane) / 32 : -1;  // this lane's last slot with a block
  const int rstep = gridDim.x * MV_WARPS;
  const int first = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;  // rows interleaved over the SMs
  const size_t jump = static_cast<size_t>(rstep) * nb - static_cast<size_t>(32) * kb;  // a row's end to the next row
  // the load cursor (lrow, lk; block lo of the weight) runs MV_RING slots ahead of the sums
  uint4 wq[MV_RING];
  typename Block::Scale wd[MV_RING];
  int lrow = first, lk = 0;
  size_t lo = static_cast<size_t>(first) * nb + lane;
  auto fetch = [&](int u) {
    if (lrow < out && lk <= klast) {
      wq[u] = __ldcs(reinterpret_cast<const uint4*>(qs) + lo);  // streaming loads, as the stream probe's
      wd[u] = __ldcs(sc + lo);
    }
    lo += 32;
    if (++lk == kb) {
      lk = 0;
      lrow += rstep;
      lo += jump;
    }
  };
  // x first, by one bulk copy (TMA) into shared memory where x is 16-byte
  // aligned: an L2 hit that no weight load in the SM's queues holds back;
  // then the ring's first loads, then x's codes while the weights are on
  // their way.  x off 16-byte alignment is staged by plain loads.
  const bool bulk = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (bulk && threadIdx.x == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // earlier uses of this memory before the copy
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar, nb * QK * sizeof(float));
    bulk_load(xs, x, nb * QK * sizeof(float), bar);
  }
#pragma unroll
  for (int u = 0; u < MV_RING; ++u) fetch(u);
  if (!bulk)
    for (int i = threadIdx.x; i < nb * QK; i += blockDim.x) xs[i] = __ldg(x + i);
  __syncthreads();  // the barrier's init, or the plain copy
  if (bulk) mbar_wait(bar, 0);
  quantize_x<Block>(xs, nb, xe, xo, meta);
  __syncthreads();
  if (bulk && threadIdx.x == 0) mbar_inval(bar);  // every thread is past its wait
  int row = first, k = 0, b = lane;  // b: this lane's block lane + 32k
  float acc = 0.0f;
  while (row < out) {
#pragma unroll
    for (int u = 0; u < MV_RING; ++u) {
      if (row < out) {  // the same for the whole warp
        if (k <= klast) acc = Block::add(acc, wq[u], wd[u], xe[b], xo[b], meta[b]);
        fetch(u);  // slot u is free: the block MV_RING slots on
        b += 32;
        if (++k == kb) {
          acc = warp_sum_f(acc);
          if (lane == 0) y[row] = acc;
          acc = 0.0f;
          k = 0;
          row += rstep;
          b = lane;
        }
      }
    }
  }
}

// The 4-bit-activation matvec of Block's weights on `blocks` blocks
// (ops/q4_matvec.matvec_q4_plan: two an SM, fewer for few rows); x's codes
// in shared memory.
template <typename Block>
int launch_matvec_q4(const void* qs, const void* sc, const void* x, void* y, int out, int in_dim, int blocks,
                     void* stream) {
  const int nb = in_dim / QK;
  const size_t smem = mv_smem_bytes<Block>(nb);
  if (out < 1 || nb < 1 || in_dim % QK || blocks < 1 || smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(q4_matvec_kernel<Block>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  q4_matvec_kernel<Block><<<blocks, MV_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const typename Block::Scale*>(sc), static_cast<const float*>(x),
      static_cast<float*>(y), out, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// x [in] f32 against Q4_0 qs [out, in/2], d [out, in/32], the activation
// quantized to 4-bit codes in every block; `blocks` blocks
// (ops/q4_matvec.matvec_q4_plan).  One launch, no scratch.
extern "C" int q4_0_matvec(const void* qs, const void* dw, const void* x, void* y, int out, int in_dim, int blocks,
                           void* stream) {
  return launch_matvec_q4<BlockQ4_0>(qs, dw, x, y, out, in_dim, blocks, stream);
}

// Shared memory of a multi-row launch of B rows (ops/q4_matvec.multi_plan
// computes the same).
extern "C" int q4_0_matmul_multi_smem_bytes(int B) { return mm_smem_bytes(8 * ((B + 7) / 8)); }

// The pre-pass and the product of B rows (1..max_rows) of x [B, in]
// against one weight, the in-dim split over `ks` (1..2) blocks of a
// cluster; scratch xq [NP, in] int8 and bd [in/32, NP, 2] int32 (NP = 8 *
// ceil(B / 8)) come from the caller; y is [B, out].
static int multi_rows(const void* qs, const void* dw, const void* x, void* xq, void* bd, void* y, int out,
                      int in_dim, int B, int ks, int max_rows, void* stream) {
  const int nb = in_dim / QK, NT = (B + 7) / 8, NP = 8 * NT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (nb + MM_KC - 1) / MM_KC;
  if (B < 1 || B > max_rows || in_dim % QK || nb < 1 || out < 1 || ks < 1 || ks > MM_MAX_SPLITS ||
      ks > nchunks)  // every block of a cluster has a chunk
    return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_bias_kernel<<<(NP * nb + 7) / 8, 256, 0, s>>>(static_cast<const float*>(x), B, NP, nb,
                                                             static_cast<int8_t*>(xq), static_cast<int2*>(bd));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint8_t* q = static_cast<const uint8_t*>(qs);
  const float* d = static_cast<const float*>(dw);
  const int8_t* xqp = static_cast<const int8_t*>(xq);
  const int2* bdp = static_cast<const int2*>(bd);
  float* yp = static_cast<float*>(y);
  switch (NT) {
    case 1: e = launch_multi<1>(q, d, xqp, bdp, yp, out, nb, B, ks, s); break;
    case 2: e = launch_multi<2>(q, d, xqp, bdp, yp, out, nb, B, ks, s); break;
    case 3: e = launch_multi<3>(q, d, xqp, bdp, yp, out, nb, B, ks, s); break;
    case 4: e = launch_multi<4>(q, d, xqp, bdp, yp, out, nb, B, ks, s); break;
    case 5: e = launch_multi<5>(q, d, xqp, bdp, yp, out, nb, B, ks, s); break;
    case 6: e = launch_multi<6>(q, d, xqp, bdp, yp, out, nb, B, ks, s); break;
    case 7: e = launch_multi<7>(q, d, xqp, bdp, yp, out, nb, B, ks, s); break;
    default: e = launch_multi<8>(q, d, xqp, bdp, yp, out, nb, B, ks, s); break;
  }
  return static_cast<int>(e);
}

// B rows (1..32) of x [B, in] against one weight (multi_rows); two
// launches: the pre-pass and the product.
extern "C" int q4_0_matmul_multi(const void* qs, const void* dw, const void* x, void* xq, void* bd, void* y,
                                 int out, int in_dim, int B, int ks, void* stream) {
  return multi_rows(qs, dw, x, xq, bd, y, out, in_dim, B, ks, 32, stream);
}

// The T layout's exact integer product (q4_0_int_matmul): N rows (1..64)
// of x [N, in] against one weight, the pre-pass and one launch of the
// multi-row kernel at ceil(N / 8) tiles; at 1..32 rows the very launches
// of q4_0_matmul_multi, bit for bit.  The caller cuts more rows into
// calls of at most 64 (ops/q4_matvec.int_matmul_plan).
extern "C" int q4_0_int_matmul(const void* qs, const void* dw, const void* x, void* xq, void* bd, void* y, int out,
                               int in_dim, int N, int ks, void* stream) {
  return multi_rows(qs, dw, x, xq, bd, y, out, in_dim, N, ks, MM_MAX_ROWS, stream);
}

// x [in] f32 against Q4_1 qs [out, in/2], dm [out, in/32, 2], the activation
// quantized through Q4_1 in every block; `blocks` blocks
// (ops/q4_matvec.matvec_q4_plan).  One launch, no scratch.
extern "C" int q4_1_matvec(const void* qs, const void* dm, const void* x, void* y, int out, int in_dim, int blocks,
                           void* stream) {
  return launch_matvec_q4<BlockQ4_1>(qs, dm, x, y, out, in_dim, blocks, stream);
}

// f32 activations, one row: x [in] f32 against Q4_0 qs [out, in/2], d [out,
// in/32]; `blocks` blocks (ops/q4_matvec.matvec_f32_plan).
extern "C" int q4_0_matvec_f32(const void* qs, const void* dw, const void* x, void* y, int out, int in_dim,
                               int blocks, void* stream) {
  return launch_matvec_f32<F32BlockQ4_0>(qs, dw, x, y, out, in_dim, blocks, stream);
}

// f32 activations, one row: x [in] f32 against Q4_1 qs [out, in/2], dm [out,
// in/32, 2]; `blocks` blocks (ops/q4_matvec.matvec_f32_plan).
extern "C" int q4_1_matvec_f32(const void* qs, const void* dm, const void* x, void* y, int out, int in_dim,
                               int blocks, void* stream) {
  return launch_matvec_f32<F32BlockQ4_1>(qs, dm, x, y, out, in_dim, blocks, stream);
}
