// The Q4_0 product on f32 activation rows, on Hopper's bf16 tensor cores:
// the device core of q4_0_matmul_multi_f32 (1..32 rows, the multi-row
// product of an engine step with f32 activations) and of q4_0_matmul_t
// (1..64 rows, the T layout's product), both launched through the one C
// entry of q4_matmul_t.cu.
//
//   y[r, o] = sum_b d[o, b] * sum_i (n[o, 32b + i] - 8) * x[r, 32b + i]
//
// with n the stored nibbles (byte j of a 16-byte block holds elements 2j,
// low nibble, and 2j + 1) and d the f32 block scales.  It replaces the
// TPU kernels `_make_multi_kernel` /
// `_multi_grid_kernel*` fed f32 rows (llama_swift_tpu/ops/q4_vpu_pallas.py,
// `_prep_inputs_multi(quantize_acts=False)`) and `_q4_0_phase_kernel`
// (llama_swift_tpu/ops/q4_matmul_pallas.py, core `_phase_core`).
//
// Exact products from bf16 operands (the TPU kernels take their
// f32-exact products as the "6-pass bf16" dot of Precision.HIGHEST):
//  * n - 8 is in [-8, 7], exact in bf16.  0x4300 | n is the bf16 128 + n,
//    so one lop3 puts two nibbles under that exponent and one packed bf16
//    FMA (v * 1 - 136) leaves n - 8 exactly: no conversion instruction.
//  * An f32 x is exactly x0 + x1 + x2 with three bf16 pieces: x0 is x with
//    its low 16 bits cleared (rounded toward zero: to nearest, x would
//    round to infinity above the largest bf16), r = x - x0 is exact (the
//    16 cleared bits), x1 is r cut alike and x2 = r - x1 has at most 8
//    significant bits, so it is a bf16.  This holds for |x| >= 2^-110,
//    above which no piece falls below bf16's subnormals; bf16 has f32's
//    exponent range, so no piece overflows.
//  * A product of a nibble and a piece (8 x 8 significant bits) is exact
//    in f32.
//
// The block term.  Per 32-element block, the 2 k-steps x 3 pieces (the
// small pieces first) go into a fresh f32 accumulator; that block dot is
// then scaled by d[o, b] and added into the running sum with one FMA on
// the CUDA cores: the plain version of row 6f, "block dot, scaled by d,
// summed".  The tensor cores add exact products but align and truncate
// them instead of rounding each sum: a few units of 2^-23 of the block's
// magnitude a block.  With the pieces as MMA columns (1 and 2 rows, below)
// each piece's block dots are scaled and summed apart and the three sums
// added at the end, the small pieces first.  Row 10's plain version rounds
// each weight first,
// x * fl((n - 8) d); since fl((n - 8) d) = (n - 8) d (1 + e) with |e| <=
// 2^-24, d * sum((n - 8) x) differs from sum(x fl((n - 8) d)) by at most
// 2^-24 of each term's magnitude.
//
// K order.  ldmatrix hands lane 4g + t the 32-bit word t of a weight
// row's block: bytes 4t..4t+3, elements 8t..8t+7, element 8t + k in bits
// 4k..4k+3.  nibble_frags makes of it v[r] = {n[8t + r] - 8, n[8t + r + 4]
// - 8} (low half first, r = 0..3), and k-step s (0, 1) of the m16n8k16 MMA
// takes a0/a1 = v[2s] of rows g/g + 8 and a2/a3 = v[2s + 1]: its k = 2t,
// 2t + 1, 2t + 8, 2t + 9 are the block's elements 8t + 2s, 8t + 2s + 4,
// 8t + 2s + 1, 8t + 2s + 5.  The B fragments follow the same order: lane
// 4g + t reads elements 8t..8t+7 of its column's activation row (two
// float4) and packs the pairs (x[8t + r], x[8t + r + 4]); b0 is pair 2s,
// b1 pair 2s + 1 of each piece.  So x is split where a warp forms its B
// fragments from the staged f32 rows, with no second copy in shared
// memory: each consumer warp owns whole blocks of a chunk for all four row
// tiles and its n-tiles, so every x value is split once a block of
// threads (tests/test_torch_f32_mma_split.py emulates both orders).
//
// What bounds it on the H100: the weight stream, 0.625 bytes a weight
// (8.4 us at 11008x4096), up to 32 rows; the tensor work, 3 * 2 * N
// operations a weight at 989 TFLOP/s (17.5 us at 64 rows).  What holds it
// back (PERF.md): the CUDA cores' share, about 8 instructions a lane to
// turn a 16-row tile's block into A fragments and 11 for each pair of x
// values split, which at 1 and 2 rows takes about as long as the weight
// stream.
//
// Design (q4_f32_mma_kernel<NP>):
//  * Rows: NP = 2 takes 1 or 2 activation rows with the three pieces of
//    each row as MMA columns (column 3r + p), so a block of a 16-row tile
//    takes 2 MMAs, not 6 of which 5/6 would be zeros; NP = 8..64 take B
//    padded to 8, 16, 32, 48 or 64 rows (rows >= B are zeros in shared
//    memory, never copied, never stored), the pieces as successive MMAs.
//  * A block of threads owns 64 output rows (four 16-row MMA tiles) of a
//    tile and walks units (tile, chunk of KC weight blocks: 16 at 1-2
//    rows, 8 to 16 rows, 4 beyond) through a ring of STAGES stages in
//    shared memory: the chunk's nibbles [64][KC*16 + 16], scales [64][KC +
//    4 or 8] and f32 x [NP][KC*128 + 16] bytes (row strides that keep
//    ldmatrix, the scale reads and the float4 reads of x free of bank
//    conflicts).
//  * 2 producer warps (4 from 3 rows: the x copies grow with the rows)
//    fill the ring with cp.async, the chunk's 16-byte copies dealt out
//    over their lanes (4-byte copies where rows of scales or x are not
//    16-byte aligned; zeros for the ragged last chunk's scales and x, stale
//    finite nibbles), and mark a stage full through an mbarrier
//    (cp.async.mbarrier.arrive.noinc: each lane's arrival lands with its
//    copies); 8 consumer warps each take one block of every chunk (two at
//    1-2 rows) and hand
//    the stage back through a second mbarrier.  No block-wide barrier a
//    chunk: a consumer waits only for its stage's copies, the producers
//    only for a stage to be free.  One producer warp measured slower (its
//    copies in flight are too few), as did 1-D bulk copies of each row
//    (TMA: too many small requests) and an L2 prefetch of each row's next
//    512 bytes.
//  * Balance: 172 tiles of 11008 outputs on 132 SMs would leave 40 SMs
//    twice the work of the others.  A cluster of C blocks (1, 2 or 4)
//    shares T <= C tiles: its T * chunks units are cut into C contiguous
//    ranges, so a block's units lie in at most two tiles (up to 8 rows it
//    keeps the first tile's sums in a region of their own; beyond, T = 1).
//    ops/q4_matvec.f32_mma_plan picks C and T (11008 outputs: C = 4, T =
//    3 up to 8 rows, C = 2, T = 1 beyond; 4096: C = 2, T = 1).
//  * The sums: a block adds its 8 warps' sums of each of its tiles in a
//    fixed order into a slot of the tile's owner (the block of its first
//    unit) through distributed shared memory, after a cluster barrier that
//    frees the rings; the owner adds the slots in rank order and stores y.
//    One launch a call, no global scratch, deterministic.  Rows past
//    `out` read row out - 1 and are never stored.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "q4_mma.cuh"

namespace {

constexpr int FM_ROWS = 64;                           // output rows a block: four 16-row tiles
constexpr int FM_CONSUMERS = 8;                       // consumer warps
constexpr int FM_BAR_BYTES = 128;                     // the ring's mbarriers, before the stages
constexpr int FM_SMEM_SM = 233472, FM_SMEM_BLOCK = 232448;  // H100: an SM's shared memory, a block's

// The shape of a launch for NP staged activation rows (ops/q4_matvec.py's
// f32_mma_plan mirrors it).  NP = 2 takes 1 or 2 rows with the three
// pieces of each row as columns of the MMA (columns 3r + p), so 2 MMAs
// instead of 6 take a block of a 16-row tile; NP = 8..64 take B padded
// to a multiple of 8 (pieces as successive MMAs).  COLS MMA columns in NG
// groups of NTG n-tiles, KG = 8 / NG consumer warps a group, each on BPW
// blocks of a chunk of KC = KG * BPW (2 at 1 or 2 rows, where a warp's
// work a block is least, else 1), 2 producer warps for 1 or 2 rows and 4
// beyond (the x copies grow with the rows).  Two blocks of threads an SM
// up to 8 rows; from 9 rows one, by its registers: a warp's sums and B
// fragments of 2 n-tiles take about 160, and the 80 that two blocks leave
// a thread spilled them inside the MMA loop, which measured slower than
// the lost block.  The ring takes as many stages (at most 8) as half an
// SM's shared memory holds up to 32 rows (a ring of 8 stages measured no
// faster from 9 rows), a block's whole beyond.
__host__ __device__ constexpr int fm_np(int rows) {
  return rows <= 2 ? 2 : rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32 : rows <= 48 ? 48 : 64;
}
__host__ __device__ constexpr int fm_cols(int np) { return np == 2 ? 8 : np; }
__host__ __device__ constexpr int fm_ng(int np) { return fm_cols(np) <= 16 ? 1 : 2; }
__host__ __device__ constexpr int fm_ntg(int np) { return fm_cols(np) / (8 * fm_ng(np)); }
__host__ __device__ constexpr int fm_kg(int np) { return FM_CONSUMERS / fm_ng(np); }
__host__ __device__ constexpr int fm_bpw(int np) { return np == 2 ? 2 : 1; }
__host__ __device__ constexpr int fm_kc(int np) { return fm_kg(np) * fm_bpw(np); }
__host__ __device__ constexpr int fm_producers(int np) { return np == 2 ? 2 : 4; }
__host__ __device__ constexpr int fm_threads(int np) { return 32 * (FM_CONSUMERS + fm_producers(np)); }
__host__ __device__ constexpr int fm_per_sm(int np) { return np <= 8 ? 2 : 1; }
__host__ __device__ constexpr bool fm_half_smem(int np) { return np <= 32; }
// Blocks of a cluster at most.  Up to 8 rows a block's units may end one
// tile and begin the next (it keeps the first tile's sums in a region of
// their own, FLUSH bytes); beyond, a cluster of at most 2 splits one tile.
__host__ __device__ constexpr int fm_max_cluster(int np) { return np <= 8 ? 4 : 2; }
__host__ __device__ constexpr int fm_flush_bytes(int np) {
  return np <= 8 ? fm_kg(np) * fm_cols(np) * FM_ROWS * 4 : 0;
}
__host__ __device__ constexpr int fm_wstride(int np) { return fm_kc(np) * 16 + 16; }
// floats of a row's scales in a stage: rows g = 0..7 on distinct banks
__host__ __device__ constexpr int fm_dstride(int np) { return fm_kc(np) + (fm_kc(np) == 4 ? 8 : 4); }
__host__ __device__ constexpr int fm_xstride(int np) { return fm_kc(np) * 128 + 16; }
__host__ __device__ constexpr int fm_off_d(int np) { return FM_ROWS * fm_wstride(np); }
__host__ __device__ constexpr int fm_off_x(int np) { return fm_off_d(np) + FM_ROWS * fm_dstride(np) * 4; }
__host__ __device__ constexpr int fm_stage_bytes(int np) { return fm_off_x(np) + np * fm_xstride(np); }
__host__ __device__ constexpr int fm_budget(int np) {
  return (fm_half_smem(np) ? FM_SMEM_SM / 2 - 1024 : FM_SMEM_BLOCK) - FM_BAR_BYTES - fm_flush_bytes(np);
}
__host__ __device__ constexpr int fm_stages(int np) {
  return fm_budget(np) / fm_stage_bytes(np) < 8 ? fm_budget(np) / fm_stage_bytes(np) : 8;
}
__host__ __device__ constexpr int fm_smem_bytes(int np) {
  return FM_BAR_BYTES + fm_flush_bytes(np) + fm_stages(np) * fm_stage_bytes(np);
}

// D (16 x 8 f32) += A (16 x 16 bf16, row-major) . B (16 x 8 bf16, column-major).
// Fragments (lane = 4 g + t): a0 row g, k 2t, 2t+1; a1 row g+8, k 2t, 2t+1;
// a2 row g, k 2t+8, 2t+9; a3 row g+8, k 2t+8, 2t+9; b0 column g, k 2t,
// 2t+1; b1 column g, k 2t+8, 2t+9 (the lower k in the low half of each
// register); d0, d1 row g, columns 2t, 2t+1; d2, d3 row g+8.
__device__ __forceinline__ void mma_bf16(const uint32_t (&a)[4], uint32_t b0, uint32_t b1, float (&d)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 pair {n[8t + r] - 8, n[8t + r + 4] - 8} of a block's word t.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, int r) {
  uint32_t v, o;  // {128 + n, 128 + n'}: (w >> 4r) & 0x000F000F | 0x43004300 in one lop3
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(v) : "r"(w >> (4 * r)), "n"(0x000F000F), "r"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(o) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));  // v * 1 - 136
  return o;
}

// The A fragments of one block for rows g and g + 8 of a 16-row tile (wl,
// wh: word t of the two rows' blocks), [k-step][a0..a3], in the K order
// above.
__device__ __forceinline__ void nibble_frags(uint32_t wl, uint32_t wh, uint32_t (&a)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    a[s][0] = nibble_pair(wl, 2 * s);
    a[s][1] = nibble_pair(wh, 2 * s);
    a[s][2] = nibble_pair(wl, 2 * s + 1);
    a[s][3] = nibble_pair(wh, 2 * s + 1);
  }
}

// The upper 16 bits of two floats as a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t hi16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ float cut_bf16(float v) { return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u); }

// The f32 pair (lo, hi) as three bf16 pairs p[0] + p[1] + p[2], exactly
// (see above; explicit _rn subtractions, which are exact here).
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p0, uint32_t& p1, uint32_t& p2) {
  p0 = hi16_pair(lo, hi);
  const float rl = __fsub_rn(lo, cut_bf16(lo)), rh = __fsub_rn(hi, cut_bf16(hi));
  p1 = hi16_pair(rl, rh);
  p2 = hi16_pair(__fsub_rn(rl, cut_bf16(rl)), __fsub_rn(rh, cut_bf16(rh)));
}

// cp.async that copies `bytes` of src (16: 0..16; 4: 0 or 4) and fills the
// rest of dst with zeros
__device__ __forceinline__ void cp_async16_z(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4_z(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}
// an arrival on b once this lane's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_init_n(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_u32(b)) : "memory");
}

// qs [out][nb*16] u8, dw [out][nb] f32, x [B][nb*32] f32 -> y [B][out] f32.
// Grid (KS, ceil(out / 64)), cluster (KS, 1, 1): block (rank, tile) takes
// chunks rank, rank + KS, ... of the tile's in-dim.
template <int NP>
__global__ void __launch_bounds__(fm_threads(NP), fm_per_sm(NP))
q4_f32_mma_kernel(const uint8_t* __restrict__ qs, const float* __restrict__ dw, const float* __restrict__ x,
                  float* __restrict__ y, int out, int nb, int B, int T) {
  constexpr bool PC = NP == 2;  // the pieces as columns
  constexpr int COLS = fm_cols(NP), NTG = fm_ntg(NP), KG = fm_kg(NP), BPW = fm_bpw(NP), KC = fm_kc(NP);
  constexpr int S = fm_stages(NP);
  constexpr int FM_THREADS = fm_threads(NP), FM_PRODUCERS = fm_producers(NP);
  constexpr int WS = fm_wstride(NP), DS = fm_dstride(NP), XS = fm_xstride(NP), SB = fm_stage_bytes(NP);
  constexpr int OFF_D = fm_off_d(NP), OFF_X = fm_off_x(NP);
  constexpr bool FLUSH = fm_flush_bytes(NP) > 0;
  constexpr int RED_B = KG * COLS * FM_ROWS;  // floats: the warps' sums, then the cluster's [C][NP][64]
  static_assert(S >= 2 && 2 * S * 8 <= FM_BAR_BYTES, "a ring of 2..8 stages");
  static_assert(fm_ng(NP) * NTG * 8 == COLS && KG * fm_ng(NP) == FM_CONSUMERS, "warps: blocks x n-tile groups");
  static_assert((RED_B + fm_max_cluster(NP) * NP * FM_ROWS) * 4 <= S * SB, "the partial sums fit the ring");
  static_assert(!PC || (NTG == 1 && KG == 8), "pieces as columns: one n-tile");
  static_assert(WS % 16 == 0 && DS % 4 == 0 && XS % 16 == 0 && OFF_X % 16 == 0 && SB % 16 == 0, "16-byte parts");
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char fm_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(fm_smem);
  uint64_t* empty = full + S;
  float* flush = reinterpret_cast<float*>(fm_smem + FM_BAR_BYTES);  // FLUSH: the first tile's sums [KG][COLS][64]
  unsigned char* ring = fm_smem + FM_BAR_BYTES + fm_flush_bytes(NP);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the cluster's units (tile, chunk) of tiles t0 .. t0 + tc - 1, tile-major;
  // this block's are [u0, u1), from tile tau0 to tile tau1 (<= tau0 + 1)
  const int C = gridDim.x, rank = blockIdx.x, t0 = blockIdx.y * T;
  const int tiles = (out + FM_ROWS - 1) / FM_ROWS, tc = min(T, tiles - t0);
  const int nchunks = (nb + KC - 1) / KC, U = tc * nchunks;
  const int u0 = rank * U / C, u1 = (rank + 1) * U / C, n = u1 - u0;
  const int tau0 = u0 / nchunks, tau1 = (u1 - 1) / nchunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init_n(&full[s], 32 * FM_PRODUCERS);  // the producer lanes
      mbar_init_n(&empty[s], FM_CONSUMERS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // activation rows B..NP-1: zeros in every stage, never copied
  for (int s = 0; s < S; ++s)
    for (int i = threadIdx.x; i < (NP - B) * KC * 8; i += FM_THREADS)
      *reinterpret_cast<float4*>(ring + s * SB + OFF_X + (B + i / (KC * 8)) * XS + (i % (KC * 8)) * 16) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  float acc[4][NTG][4];  // consumer warps: [row tile][n-tile][fragment]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NTG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
  const int kg = warp % KG, ng = warp / KG, g = lane >> 2, t = lane & 3;

  if (warp >= FM_CONSUMERS) {
    // The producers: chunk i into stage i % S once the consumers freed it,
    // their lanes taking turns over the chunk's 16-byte copies (scales: 4
    // where rows of scales are not 16-byte aligned; x: 4 where x is not);
    // blocks past the tensor get zeros (scales and x) or stale nibbles
    // (finite whatever they are).
    constexpr int PL = 32 * FM_PRODUCERS;
    const int pl = threadIdx.x - 32 * FM_CONSUMERS;
    const bool d16 = nb % 4 == 0 && reinterpret_cast<uintptr_t>(dw) % 16 == 0;
    const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int in_dim = nb * 32;
    constexpr int WQ = FM_ROWS * KC / PL;  // 16-byte nibble copies of a lane a chunk: block pl % KC of rows
    const uint8_t* wsrc[WQ];                // pl / KC + PL / KC * q of the tile, from block 0
    int o0 = (t0 + tau0) * FM_ROWS, c = u0 - tau0 * nchunks;
    auto rows_of = [&]() {
#pragma unroll
      for (int q = 0; q < WQ; ++q)
        wsrc[q] = qs + (static_cast<size_t>(min(o0 + (pl + PL * q) / KC, out - 1)) * nb + pl % KC) * 16;
    };
    rows_of();
    unsigned char* st = ring;
    for (int i = 0, s = 0; i < n; ++i) {
      if (i >= S) mbar_wait(&empty[s], ((i / S) + 1) & 1);
      const int kb0 = c * KC, cb = min(KC, nb - kb0);
      if (pl % KC < cb)
#pragma unroll
        for (int q = 0; q < WQ; ++q)
          cp_async16(st + ((pl + PL * q) / KC) * WS + (pl % KC) * 16, wsrc[q] + kb0 * 16);
      if (d16) {
        for (int p = pl; p < FM_ROWS * KC / 4; p += PL) {  // 4 scales of row r
          const int r = p / (KC / 4), k4 = 4 * (p % (KC / 4)), bytes = 4 * max(0, min(4, cb - k4));
          cp_async16_z(st + OFF_D + (r * DS + k4) * 4,
                       bytes ? dw + static_cast<size_t>(min(o0 + r, out - 1)) * nb + kb0 + k4 : dw, bytes);
        }
      } else {
        for (int p = pl; p < FM_ROWS * KC; p += PL) {  // one scale of row r
          const int r = p / KC, kb = p % KC;
          cp_async4_z(st + OFF_D + (r * DS + kb) * 4,
                      kb < cb ? dw + static_cast<size_t>(min(o0 + r, out - 1)) * nb + kb0 + kb : dw, kb < cb ? 4 : 0);
        }
      }
      const float* xc = x + static_cast<size_t>(kb0) * 32;
      if (x16) {
        for (int p = pl; p < B * KC * 8; p += PL) {  // 16 bytes h of block kb of row r
          const int r = p / (KC * 8), kb = (p / 8) % KC, h = p % 8, bytes = kb < cb ? 16 : 0;
          cp_async16_z(st + OFF_X + r * XS + kb * 128 + h * 16,
                       bytes ? xc + static_cast<size_t>(r) * in_dim + kb * 32 + h * 4 : x, bytes);
        }
      } else {
        for (int p = pl; p < B * KC * 32; p += PL) {  // element e of block kb of row r
          const int r = p / (KC * 32), kb = (p / 32) % KC, e = p % 32, bytes = kb < cb ? 4 : 0;
          cp_async4_z(st + OFF_X + r * XS + kb * 128 + e * 4,
                      bytes ? xc + static_cast<size_t>(r) * in_dim + kb * 32 + e : x, bytes);
        }
      }
      cp_async_arrive(&full[s]);
      st += SB;
      if (++s == S) {
        s = 0;
        st = ring;
      }
      if (++c == nchunks) {  // the next unit begins the next tile
        c = 0;
        o0 += FM_ROWS;
        rows_of();
      }
    }
  } else {
    // a consumer: block kg of each chunk, all four row tiles, n-tiles ng * NTG ..;
    // PC: lane 4 g + t's column g is piece g % 3 of row g / 3 (zeros from 3 B)
    const int xrow = PC ? min(g / 3, 1) : ng * NTG * 8 + g;
    const bool live = !PC || g < 3 * B;
    const float* xw = reinterpret_cast<const float*>(ring + OFF_X + xrow * XS + kg * 128 + t * 32);
    const float* dwp = reinterpret_cast<const float*>(ring + OFF_D) + g * DS + kg;
    const uint32_t aw = smem_u32(ring) + lane * WS + kg * 16;  // this lane's ldmatrix row: row `lane` of a pair of tiles
    uint32_t phase = 0;
    for (int i = 0, s = 0, c = u0 - tau0 * nchunks; i < n; ++i) {
      mbar_wait(&full[s], phase);
      const int so = s * SB;
#pragma unroll
      for (int u = 0; u < BPW; ++u) {  // blocks kg + KG u of the chunk
        // B fragments: pieces [p] of the pairs (x[8t + r], x[8t + r + 4]) of row (ng * NTG + j) * 8 + g
        // (PC: the piece g % 3 only, in bx[0][0])
        uint32_t bx[NTG][3][4];
#pragma unroll
        for (int j = 0; j < NTG; ++j) {
          const float* xr = xw + (so + j * 8 * XS) / 4 + u * KG * 32;
          const float4 lo = *reinterpret_cast<const float4*>(xr), hi = *reinterpret_cast<const float4*>(xr + 4);
          split3(lo.x, hi.x, bx[j][0][0], bx[j][1][0], bx[j][2][0]);
          split3(lo.y, hi.y, bx[j][0][1], bx[j][1][1], bx[j][2][1]);
          split3(lo.z, hi.z, bx[j][0][2], bx[j][1][2], bx[j][2][2]);
          split3(lo.w, hi.w, bx[j][0][3], bx[j][1][3], bx[j][2][3]);
          if constexpr (PC) {
            const int p = g % 3;
#pragma unroll
            for (int r = 0; r < 4; ++r) bx[0][0][r] = live ? (p == 0 ? bx[0][0][r] : p == 1 ? bx[0][1][r] : bx[0][2][r]) : 0u;
          }
        }
        const float* sd = dwp + so / 4 + u * KG;
#pragma unroll
        for (int mp = 0; mp < 2; ++mp) {  // row tiles 2 mp and 2 mp + 1
          uint32_t w4[4];                 // word t of rows g, g + 8 of tile 2 mp, then of tile 2 mp + 1
          ldsm_x4(aw + so + mp * 32 * WS + u * KG * 16, w4);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 2 * mp + h;
            uint32_t a[2][4];
            nibble_frags(w4[2 * h], w4[2 * h + 1], a);
            const float d_lo = sd[m * 16 * DS], d_hi = sd[(m * 16 + 8) * DS];
#pragma unroll
            for (int j = 0; j < NTG; ++j) {
              float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the block dot, small pieces first
#pragma unroll
              for (int p = PC ? 0 : 2; p >= 0; --p) {
                mma_bf16(a[0], bx[j][p][0], bx[j][p][1], f);
                mma_bf16(a[1], bx[j][p][2], bx[j][p][3], f);
              }
              acc[m][j][0] = fmaf(d_lo, f[0], acc[m][j][0]);
              acc[m][j][1] = fmaf(d_lo, f[1], acc[m][j][1]);
              acc[m][j][2] = fmaf(d_hi, f[2], acc[m][j][2]);
              acc[m][j][3] = fmaf(d_hi, f[3], acc[m][j][3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
      if (++c == nchunks && i + 1 < n) {  // the next unit begins a tile (FLUSH): keep this one's sums
        c = 0;
        if constexpr (FLUSH) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int j = 0; j < NTG; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                flush[(kg * COLS + (ng * NTG + j) * 8 + 2 * t + (e & 1)) * FM_ROWS + m * 16 + g + (e >> 1) * 8] =
                    acc[m][j][e];
                acc[m][j][e] = 0.0f;
              }
        }
      }
    }
  }

  // The sums.  Each tile's are split over the blocks whose units it holds:
  // a block adds its KC warps' sums of each of its tiles in a fixed order
  // (PC: and the three pieces' columns of a row, the small pieces first)
  // into slot rank - owner of the tile's owner (the block of its first
  // unit; distributed shared memory, [C][B][64] after the warps' sums),
  // and the owner adds the slots in rank order and stores y.
  __syncthreads();  // every copy has landed and every warp is done with the ring
  float* red = reinterpret_cast<float*>(ring);  // the last tile's sums [KG][COLS][64]
  if (warp < FM_CONSUMERS) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < NTG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(kg * COLS + (ng * NTG + j) * 8 + 2 * t + (e & 1)) * FM_ROWS + m * 16 + g + (e >> 1) * 8] = acc[m][j][e];
  }
  // this block's sums are written and every block is done with its ring
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int tau = tau0; tau <= tau1; ++tau) {
    const float* src = tau == tau1 ? red : flush;
    const int owner = ((tau * nchunks + 1) * C + U - 1) / U - 1;
    float* dst = cg::this_cluster().map_shared_rank(red + RED_B, owner) + (rank - owner) * NP * FM_ROWS;
    for (int idx = threadIdx.x; idx < B * FM_ROWS; idx += FM_THREADS) {
      float sum = 0.0f;
      for (int q = 0; q < KG; ++q) {
        const float* rq = src + q * COLS * FM_ROWS;
        if constexpr (PC) {
          const int cc = 3 * (idx / FM_ROWS) * FM_ROWS + idx % FM_ROWS;
          sum = __fadd_rn(sum, __fadd_rn(__fadd_rn(rq[cc + 2 * FM_ROWS], rq[cc + FM_ROWS]), rq[cc]));
        } else {
          sum = __fadd_rn(sum, rq[idx]);
        }
      }
      dst[idx] = sum;
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const int tau_o = (u0 + nchunks - 1) / nchunks;  // the tile whose first unit is this block's, if any
  if (tau_o * nchunks >= u1) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int slots = ((tau_o + 1) * nchunks * C + U - 1) / U - rank;  // the blocks that hold the tile's units
  const int o0 = (t0 + tau_o) * FM_ROWS;
  for (int idx = threadIdx.x; idx < B * FM_ROWS; idx += FM_THREADS) {
    const int nr = idx / FM_ROWS, r = idx % FM_ROWS;
    if (o0 + r >= out) continue;
    float sum = 0.0f;
    for (int q = 0; q < slots; ++q) sum = __fadd_rn(sum, red[RED_B + q * NP * FM_ROWS + idx]);
    y[static_cast<size_t>(nr) * out + o0 + r] = sum;
  }
}

template <int NP>
cudaError_t fm_launch(const void* qs, const void* dw, const void* x, void* y, int out, int nb, int B, int C, int T,
                      cudaStream_t s) {
  constexpr int smem = fm_smem_bytes(NP);
  static const cudaError_t attr =
      cudaFuncSetAttribute(q4_f32_mma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int tiles = (out + FM_ROWS - 1) / FM_ROWS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (tiles + T - 1) / T, 1);
  cfg.blockDim = dim3(fm_threads(NP), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = C > 1 ? 1 : 0;  // a launch without clusters is one of a block each
  const cudaError_t e = cudaLaunchKernelEx(&cfg, q4_f32_mma_kernel<NP>, static_cast<const uint8_t*>(qs),
                                           static_cast<const float*>(dw), static_cast<const float*>(x),
                                           static_cast<float*>(y), out, nb, B, T);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One launch of the product for `rows` (1..64) activation rows: clusters
// of C blocks, each cluster's T tiles of 64 output rows shared out over its
// blocks (ops/q4_matvec.f32_mma_plan).  Every block has a unit; with T <= C
// a block's units lie in at most two tiles and it owns at most one, and
// beyond 8 rows in one (T = 1).
cudaError_t fm_product(const void* qs, const void* dw, const void* x, void* y, int out, int in_dim, int rows, int C,
                       int T, cudaStream_t s) {
  const int nb = in_dim / 32, np = fm_np(rows), nchunks = (nb + fm_kc(np) - 1) / fm_kc(np);
  const int tiles = (out + FM_ROWS - 1) / FM_ROWS, last = tiles - (tiles - 1) / (T > 0 ? T : 1) * T;
  if (rows < 1 || rows > 64 || in_dim % 32 || nb < 1 || out < 1 || C < 1 || C > fm_max_cluster(np) || T < 1 ||
      T > C || (np > 8 && T != 1) || last * nchunks < C)
    return cudaErrorInvalidValue;
  switch (np) {
    case 2: return fm_launch<2>(qs, dw, x, y, out, nb, rows, C, T, s);
    case 8: return fm_launch<8>(qs, dw, x, y, out, nb, rows, C, T, s);
    case 16: return fm_launch<16>(qs, dw, x, y, out, nb, rows, C, T, s);
    case 32: return fm_launch<32>(qs, dw, x, y, out, nb, rows, C, T, s);
    case 48: return fm_launch<48>(qs, dw, x, y, out, nb, rows, C, T, s);
    default: return fm_launch<64>(qs, dw, x, y, out, nb, rows, C, T, s);
  }
}

}  // namespace
