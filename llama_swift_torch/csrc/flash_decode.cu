// Single-query (decode) attention over one layer of a KV cache: batch 1,
// B slots of a dense batched cache, and B slots of a paged cache; each over
// an f32, bf16 or int8 cache.
//
// Replaces the TPU kernels (llama_swift_tpu/ops/attention.py):
//  * `_flash_decode_kernel`, `_flash_decode_stacked_kernel` (entry points
//    flash_decode_attention, flash_decode_attention_stacked) and
//    `_flash_decode_stacked_int8_kernel` (flash_decode_attention_stacked_int8)
//    -> flash_decode;
//  * `_flash_batched_kernel`, `_flash_batched_int8_kernel`
//    (flash_decode_attention_batched, _int8) -> flash_decode_batched;
//  * `_flash_paged_kernel`, `_flash_paged_int8_kernel`
//    (flash_decode_attention_paged, _int8) -> flash_decode_paged.
//
//   out[b, h] = softmax_j( q[b, h] . k[b, h, j] / sqrt(Dh) ) . v[b, h, j],   j = 0..n_past[b]
//
// Caches, read in place at layer il (`kind`: 0 f32, 1 bf16, 2 int8):
//  * batch 1: head-major [L, H, n_ctx, Dh];
//  * batched: layer-major [L, B, H, n_ctx, Dh];
//  * paged: a pool [P, L, H, page, Dh] of position-range pages and a table
//    [B, MP] int32; key j of slot b lives in page table[b, j / page]
//    (clamped to [0, P-1], as the TPU kernel's index map does) at row
//    j % page.  Table entries beyond a slot's live keys are never read.
// An int8 cache carries one f32 scale per (head, position) row beside it
// ([..., n_ctx, 1], or a scale pool [P, L, H, page, 1] under the same page
// ids), folded in as the TPU kernels do: s_j = (q . k8_j) * ks_j / sqrt(Dh);
// the chunk's l sums the unscaled exp(s_j - m) and acc sums
// exp(s_j - m) * vs_j * v8_j.
// Only keys j <= n_past[b] are read, so the bytes moved grow with each
// slot's own n_past, not with n_ctx (stale rows beyond it are never touched).
//
// What bounds it on the H100: device-memory bandwidth (2 * (n_past+1) * H
// rows of Dh elements per slot, plus 8 B of scales per int8 row; 4 flops
// per element), and at 7B decode shapes also launch and latency: at n_past
// 511 a batch-1 layer is 8.4 MB of bf16 rows, 2.5 us at 3.35 TB/s, against
// a fixed ~3 us a launch.
//
// Batch 1 (`flash_decode`): one launch a call.
//  * Grid (S, H), a thread-block cluster of S <= 8 blocks per head (256
//    threads each): block (c, h) takes split c, a contiguous run of the
//    head's keys 0..n_past (split_plan: at most 8 splits of a multiple of
//    16 keys, so 32 heads give 256 blocks from n_past 127 on, and any
//    n_past < n_ctx works).
//  * Each block runs the chunk pass of flash_common.cuh: its run of K and
//    V rows copied into shared memory by the 1-D bulk copy (TMA,
//    cp.async.bulk; int8 row scales by cp.async) in a ring of 32 KB
//    tiles, up to four of them in flight from the start (q is loaded
//    behind them; the ring holds only the tiles a split needs, so more
//    blocks fit on an SM), every key of a tile scored at once, online
//    softmax from tile to tile.  Before, a block waited on memory once a
//    key (the old split pass below) and the card held too few bytes in
//    flight: bf16 cost what f32 did.
//  * The splits of a head combine inside the launch: every block writes
//    its (acc, m, l) into block 0's shared memory (distributed shared
//    memory) and arrives on the cluster barrier (release); block 0 waits
//    (acquire), rescales by exp(m_c - max m) in split order and writes the
//    head's output; the other blocks exit right after arriving.  No
//    global scratch, no counter, nothing that two streams could share.
//
// Paged (`flash_decode_paged`): one launch a call, on the same chunk pass.
//  * Grid (S, H, B), a cluster of the S blocks of one (slot, head); S and
//    the tile come from the host (ops/attention.paged_plan: S =
//    split_plan(max keys of the step, 2).splits, tiles of 16 KB of K
//    rows); slot b cuts its own keys, read on the device, by
//    split_plan(keys_b, S), so a short slot takes few splits and the
//    blocks past them hold no keys (they take part in the cluster's
//    barriers and push nothing).
//  * The chunk pass reads rows through the slot's table row (PageRows): a
//    tile's rows are cut at page edges into runs, one bulk copy of K and
//    one of V a run (at page 128 a tile of 64 or 128 rows is one run, or
//    two where the split starts off a page edge; at page 16, four to
//    nine), the tile's bytes expected on its two mbarriers; int8 row
//    scales by cp.async a row.  The ring holds two stages (one tile in
//    flight while one is used), so a block takes 72 KB and three fit an
//    SM (80 registers a thread); a tile is at most the split's length.
//  * Block 0 of a cluster combines the live splits in split order through
//    distributed shared memory, as batch 1 does.  No scratch, no second
//    launch.  Before, a call was a split pass of 64-key blocks (a warp a
//    key row, a serial max, a thread a dim) and a combine launch, with a
//    fresh scratch tensor: 47 us at B = 8 on every cache type (H100 80GB
//    HBM3, 700 W).  Variants timed on the card: 1-8 splits, rings of 2-5
//    stages, 8-64 KB stages, 1-5 blocks an SM; batch 1's plan (8 splits,
//    five 32 KB stages) was slower in every case: as many blocks as the
//    card holds, each with one or two tiles, running in waves.
//
// Batched (split-K flash decoding in two launches, on the older split
// pass):
//  * split kernel, grid (H, S, B): block (h, c, b) takes keys
//    [64c, 64c+64) of slot b, head h, one thread per head dim.  Warps compute
//    the scores (a warp reads a key row as one coalesced line: lanes split
//    the dims, a char4 per lane for int8, shuffles reduce), the block takes
//    the chunk max m_c, p_j = exp(s_j - m_c), l_c = sum p_j, and thread d
//    accumulates acc_c[d] = sum_j p_j v[j, d].  S covers the largest n_past
//    of the step (the host knows it); a block whose chunk starts past its
//    own slot's n_past exits at once.
//  * combine kernel, grid (H, B): rescales slot b's live partials by
//    exp(m_c - max m) and normalises (online softmax across chunks).
// Per-slot n_past is read on the device from an int32 tensor, so a step
// needs no device-to-host read.  All arithmetic is f32.
//
// Head dims: every even dh in [2, 1024], on every cache type.  Batch 1
// and paged stage rows by the bulk copy where a row is a whole number of 16-byte
// units on 16-byte aligned planes (pass_bulk_rows: dh 128, LLaMA's, on
// all three types), else by plain 4- or 2-byte loads into rows padded to
// 16 bytes (a template parameter of the same kernel); the value pass
// gives a row's last thread 2 dims at dh % 4 == 2.  The split pass runs
// whole warps (dh rounded up to 32 threads) and reads int8 rows a char4 a
// lane only where dh % 4 == 0.
#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace {

// Live keys of slot b: n_pasts == nullptr means every slot has n_keys.
__device__ __forceinline__ int slot_keys(const int* n_pasts, int b, int n_keys) {
  return n_pasts ? min(max(__ldg(n_pasts + b), 0) + 1, n_keys) : n_keys;
}

// q [B, H, Dh]; k/v: layer plane [B, H, n_ctx, Dh]; ks/vs: its row scales
// [B, H, n_ctx] (int8) or null; part [B, H, S, Dh + 2]; ANY_DH: dh % 32 != 0
template <typename T, bool ANY_DH>
__global__ void flash_split_batched_kernel(const float* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, const float* __restrict__ ks,
                                           const float* __restrict__ vs, const int* __restrict__ n_pasts,
                                           float* __restrict__ part, int H, int n_ctx, int dh,
                                           int n_keys, float scale) {
  const int h = blockIdx.x, c = blockIdx.y, S = gridDim.y, b = blockIdx.z;
  const int j0 = c * CHUNK;
  const int keys = slot_keys(n_pasts, b, n_keys);
  if (j0 >= keys) return;  // chunk past this slot's n_past: combine skips it
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t plane = bh * n_ctx * dh;
  const size_t rows = bh * n_ctx;
  split_chunk_kv<T, DenseRows<T>, ANY_DH>(q + bh * dh, DenseRows<T>{k + plane, ks ? ks + rows : nullptr, dh},
                    DenseRows<T>{v + plane, vs ? vs + rows : nullptr, dh}, j0,
                    min(CHUNK, keys - j0), scale, part + (bh * S + c) * (dh + 2));
}

// part [B, H, S, dh + 2] -> o [B, H, dh]; grid (H, B); slot b combines only
// its live splits (n_pasts == nullptr: all S)
__global__ void flash_combine_kernel(const float* __restrict__ part, const int* __restrict__ n_pasts,
                                     float* __restrict__ o, int H, int dh, int S, int n_keys) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int live = (slot_keys(n_pasts, b, n_keys) + CHUNK - 1) / CHUNK;
  o[bh * dh + threadIdx.x] = combine_splits(part + bh * S * (dh + 2), live, dh);
}

constexpr int ONE_THREADS = 256;          // threads of a batch-1 block
constexpr int ONE_STAGES = 5;             // ring tiles of the chunk pass: four in flight
constexpr int ONE_STAGE_BYTES = 32768;    // K and V rows of a tile
constexpr int ONE_SMEM_LIMIT = 232448;    // the most a block may take (227 KB)
constexpr int ONE_MAX_SPLITS = 8;         // blocks of a head: a cluster of the portable size
constexpr int PAGED_STAGES = 2;           // ring tiles of the paged kernel's chunk pass: one in flight
constexpr int PAGED_BLOCKS_PER_SM = 3;    // the paged kernel's registers: at most 80 a thread

// Batch 1: q [H, dh]; k/v: layer plane [H, n_ctx, dh]; ks/vs its row
// scales [H, n_ctx] (int8) or null; o [H, dh].  Grid (S, H), cluster
// (S, 1, 1); split c takes keys [c * split, min((c + 1) * split, n_keys)).
// Shared memory: the cluster's partials [S][dh + 2] (used in block 0
// only), q [dh], this split's (acc, m, l), the chunk pass.
template <typename T, bool BULK>
__global__ void __launch_bounds__(ONE_THREADS)
    flash_one_kernel(const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ ks, const float* __restrict__ vs, float* __restrict__ o,
                     int n_ctx, int dh, int n_keys, int split, int tile, float scale) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char one_smem[];
  const int c = blockIdx.x, S = gridDim.x, h = blockIdx.y, tid = threadIdx.x;
  float* parts = reinterpret_cast<float*>(one_smem);                              // [S][dh + 2]
  float* qs = reinterpret_cast<float*>(one_smem + round16(4 * S * (dh + 2)));      // [dh]
  float* mine = qs + round16(4 * dh) / 4;                                          // [dh + 2]
  unsigned char* pass = reinterpret_cast<unsigned char*>(mine) + round16(4 * (dh + 2));
  const size_t rows = static_cast<size_t>(h) * n_ctx;
  const int j0 = c * split;
  // barrier phase 1 (waited on below): every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  chunk_pass<T, ONE_THREADS, ONE_STAGES, BULK>(
      qs,
      [&] {  // q, while the first tiles are in flight
        for (int d = tid; d < dh; d += ONE_THREADS) qs[d] = __ldg(q + static_cast<size_t>(h) * dh + d);
      },
      k + rows * dh, v + rows * dh, ks ? ks + rows : nullptr, vs ? vs + rows : nullptr, dh, j0,
      min(split, n_keys - j0), tile, scale, pass, mine);
  // every split pushes its (acc, m, l) into block 0's shared memory, then
  // arrives; block 0 waits for all and combines; the others exit at once
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* dst = cluster.map_shared_rank(parts, 0) + c * (dh + 2);
  for (int d = tid; d < dh + 2; d += ONE_THREADS) dst[d] = mine[d];
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (c != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  float mx = -INFINITY;
  for (int r = 0; r < S; ++r) mx = fmaxf(mx, parts[r * (dh + 2) + dh]);
  for (int d = tid; d < dh; d += ONE_THREADS) {
    float l = 0.0f, acc = 0.0f;
    for (int r = 0; r < S; ++r) {
      const float* pc = parts + r * (dh + 2);
      const float a = expf(pc[dh] - mx);
      l += a * pc[dh + 1];
      acc += a * pc[d];
    }
    o[static_cast<size_t>(h) * dh + d] = acc / l;
  }
}

// Dynamic shared memory of a batch-1 (or, with its ring of `nst` stages,
// paged) launch: S splits of `keys` keys.
size_t one_smem_bytes(int dh, int elt, bool scaled, int S, int keys, int tile, int nst = ONE_STAGES) {
  return round16(4 * S * (dh + 2)) + round16(4 * dh) + round16(4 * (dh + 2)) +
         pass_smem_bytes(tile, dh * elt, scaled, ONE_THREADS, pass_stages(keys, tile, nst));
}

template <typename T, bool BULK>
int launch_one(cudaStream_t s, const void* q, const void* k, const void* v, const void* ks, const void* vs,
               void* out, int H, int n_ctx, int dh, int n_keys, float scale) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_one_kernel<T, BULK>, cudaFuncAttributeMaxDynamicSharedMemorySize, ONE_SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const SplitPlan plan = split_plan(n_keys, ONE_MAX_SPLITS);
  const int tile = pass_tile_rows(dh * static_cast<int>(sizeof(T)), ONE_STAGE_BYTES);
  const size_t smem = one_smem_bytes(dh, sizeof(T), kScaled, plan.splits, plan.keys, tile);
  if (smem > ONE_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.splits, H, 1);
  cfg.blockDim = dim3(ONE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = plan.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_one_kernel<T, BULK>, static_cast<const float*>(q),
                                           static_cast<const T*>(k), static_cast<const T*>(v),
                                           static_cast<const float*>(ks), static_cast<const float*>(vs),
                                           static_cast<float*>(out), n_ctx, dh, n_keys, plan.keys, tile, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Batch 1 over rows of any even dh: the bulk copy where pass_bulk_rows
// allows it (every row a whole number of 16-byte units, e.g. dh 128),
// else the same pass staging rows by plain loads.
template <typename T>
int launch_one_rows(cudaStream_t s, const void* q, const void* k, const void* v, const void* ks, const void* vs,
                    void* out, int H, int n_ctx, int dh, int n_keys, float scale) {
  if (pass_bulk_rows(dh * static_cast<int>(sizeof(T)), k, v))
    return launch_one<T, true>(s, q, k, v, ks, vs, out, H, n_ctx, dh, n_keys, scale);
  return launch_one<T, false>(s, q, k, v, ks, vs, out, H, n_ctx, dh, n_keys, scale);
}

// Paged: q [B, H, dh]; pools [P, L, H, page, dh] (scale pools [P, L, H,
// page] for int8, else null), read whole; table [B, MP] and n_pasts [B]
// int32; o [B, H, dh].  Grid (S, H, B), cluster (S, 1, 1); slot b's keys
// (at most n_keys) cut by split_plan(keys_b, S), split c of them taken by
// block c; a block past the slot's splits only keeps the cluster's
// barriers.  Shared memory as batch 1's.
template <typename T, bool BULK>
__global__ void __launch_bounds__(ONE_THREADS, PAGED_BLOCKS_PER_SM)
    flash_paged_kernel(const float* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                       const float* __restrict__ ks_pool, const float* __restrict__ vs_pool,
                       const int* __restrict__ table, const int* __restrict__ n_pasts, float* __restrict__ o,
                       int P, int L, int H, int page, int MP, int il, int dh, int n_keys, int tile, float scale) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char paged_smem[];
  const int c = blockIdx.x, S = gridDim.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  float* parts = reinterpret_cast<float*>(paged_smem);                            // [S][dh + 2]
  float* qs = reinterpret_cast<float*>(paged_smem + round16(4 * S * (dh + 2)));    // [dh]
  float* mine = qs + round16(4 * dh) / 4;                                          // [dh + 2]
  unsigned char* pass = reinterpret_cast<unsigned char*>(mine) + round16(4 * (dh + 2));
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int keys = slot_keys(n_pasts, b, n_keys);
  const SplitPlan plan = split_plan(keys, S);
  const int j0 = c * plan.keys, jn = min(plan.keys, keys - j0);  // jn <= 0: no keys in this split
  // barrier phase 1 (waited on below): every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (jn > 0) {
    const size_t head = (static_cast<size_t>(il) * H + h) * page;  // row of page 0 of this (layer, head)
    const PageRows<T> rows{k_pool + head * dh, v_pool + head * dh, ks_pool ? ks_pool + head : nullptr,
                           vs_pool ? vs_pool + head : nullptr, table + static_cast<size_t>(b) * MP,
                           static_cast<size_t>(L) * H * page, page, P};
    chunk_pass_rows<T, ONE_THREADS, PAGED_STAGES, BULK>(
        qs,
        [&] {  // q, while the first tiles are in flight
          for (int d = tid; d < dh; d += ONE_THREADS) qs[d] = __ldg(q + bh * dh + d);
        },
        rows, dh, j0, jn, tile, scale, pass, mine);
  }
  // every split with keys pushes its (acc, m, l) into block 0's shared
  // memory, then all arrive; block 0 waits and combines the live splits
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (jn > 0) {
    float* dst = cluster.map_shared_rank(parts, 0) + c * (dh + 2);
    for (int d = tid; d < dh + 2; d += ONE_THREADS) dst[d] = mine[d];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (c != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  float mx = -INFINITY;
  for (int r = 0; r < plan.splits; ++r) mx = fmaxf(mx, parts[r * (dh + 2) + dh]);
  for (int d = tid; d < dh; d += ONE_THREADS) {
    float l = 0.0f, acc = 0.0f;
    for (int r = 0; r < plan.splits; ++r) {
      const float* pc = parts + r * (dh + 2);
      const float a = expf(pc[dh] - mx);
      l += a * pc[dh + 1];
      acc += a * pc[d];
    }
    o[bh * dh + d] = acc / l;
  }
}

// Dynamic shared memory of a paged launch of S splits and tiles of `tile`
// rows over at most n_keys keys a slot (ops/attention.paged_plan chooses
// S and the tile and computes the same), or 0 where the launcher refuses
// the plan: S in [1, 8], a tile of 1 to 1024 rows.
size_t paged_smem_bytes(int dh, int elt, bool scaled, int n_keys, int S, int tile) {
  if (S < 1 || S > ONE_MAX_SPLITS || tile < 1 || tile > 1024) return 0;
  return one_smem_bytes(dh, elt, scaled, S, split_plan(n_keys, S).keys, tile, PAGED_STAGES);
}

template <typename T, bool BULK>
int launch_paged(cudaStream_t s, const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
                 const void* vs_pool, const void* table, const void* n_pasts, void* out, int B, int P, int L, int H,
                 int page, int MP, int il, int dh, int n_keys, int S, int tile, float scale) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_paged_kernel<T, BULK>, cudaFuncAttributeMaxDynamicSharedMemorySize, ONE_SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = paged_smem_bytes(dh, sizeof(T), kScaled, n_keys, S, tile);
  if (smem == 0 || smem > ONE_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, H, B);
  cfg.blockDim = dim3(ONE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = S;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_paged_kernel<T, BULK>, static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(ks_pool), static_cast<const float*>(vs_pool),
      static_cast<const int*>(table), static_cast<const int*>(n_pasts), static_cast<float*>(out), P, L, H, page,
      MP, il, dh, n_keys, tile, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Paged over rows of any even dh: the bulk copy where pass_bulk_rows
// allows it, else plain loads (as batch 1).
template <typename T>
int launch_paged_rows(cudaStream_t s, const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
                      const void* vs_pool, const void* table, const void* n_pasts, void* out, int B, int P, int L,
                      int H, int page, int MP, int il, int dh, int n_keys, int S, int tile, float scale) {
  if (pass_bulk_rows(dh * static_cast<int>(sizeof(T)), k_pool, v_pool))
    return launch_paged<T, true>(s, q, k_pool, v_pool, ks_pool, vs_pool, table, n_pasts, out, B, P, L, H, page, MP,
                                 il, dh, n_keys, S, tile, scale);
  return launch_paged<T, false>(s, q, k_pool, v_pool, ks_pool, vs_pool, table, n_pasts, out, B, P, L, H, page, MP,
                                il, dh, n_keys, S, tile, scale);
}

size_t split_smem(int dh) { return (dh + 2 * CHUNK) * sizeof(float); }
// threads of a split block: one a dim, whole warps
int split_threads(int dh) { return (dh + 31) / 32 * 32; }
// head dims the six kernels take (ops/attention.check_head_dim states the rule)
bool head_dim_ok(int dh) { return dh >= 2 && dh <= 4 * ONE_THREADS && dh % 2 == 0; }
int n_splits(int n_keys) { return (n_keys + CHUNK - 1) / CHUNK; }

template <typename T>
void split_dense(dim3 grid, int dh, cudaStream_t s, const void* q, const void* k, const void* v,
                 const void* ks, const void* vs, const int* np, float* part, int H, int n_ctx,
                 int n_keys, float scale) {
  auto kernel = dh % 32 ? flash_split_batched_kernel<T, true> : flash_split_batched_kernel<T, false>;
  kernel<<<grid, split_threads(dh), split_smem(dh), s>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), np, part, H, n_ctx, dh, n_keys,
      scale);
}

// The split pass over a dense plane for cache element `kind` (0 f32,
// 1 bf16, 2 int8); false for an unknown kind.
bool split_dense_kind(int kind, dim3 grid, int dh, cudaStream_t s, const void* q, const void* k,
                      const void* v, const void* ks, const void* vs, const int* np, float* part,
                      int H, int n_ctx, int n_keys, float scale) {
  switch (kind) {
    case 0: split_dense<float>(grid, dh, s, q, k, v, ks, vs, np, part, H, n_ctx, n_keys, scale); return true;
    case 1: split_dense<__nv_bfloat16>(grid, dh, s, q, k, v, ks, vs, np, part, H, n_ctx, n_keys, scale); return true;
    case 2: split_dense<int8_t>(grid, dh, s, q, k, v, ks, vs, np, part, H, n_ctx, n_keys, scale); return true;
    default: return false;
  }
}

}  // namespace

// k/v point at layer il of the stacked cache ([H, n_ctx, dh]), ks/vs at
// its row scales (int8) or are null; n_keys = n_past + 1; dh even, at
// most 1024.  One launch.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                            void* out, int H, int n_ctx, int dh, int n_keys, float scale, int kind,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 1 || n_keys < 1 || n_keys > n_ctx || !head_dim_ok(dh)) return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case 0: return launch_one_rows<float>(s, q, k, v, ks, vs, out, H, n_ctx, dh, n_keys, scale);
    case 1: return launch_one_rows<__nv_bfloat16>(s, q, k, v, ks, vs, out, H, n_ctx, dh, n_keys, scale);
    case 2: return launch_one_rows<int8_t>(s, q, k, v, ks, vs, out, H, n_ctx, dh, n_keys, scale);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B slots: k/v point at layer il of the batched cache ([B, H, n_ctx, Dh]),
// ks/vs at its row scales (int8) or are null; n_pasts [B] int32 on the
// device; n_keys = max_n_past + 1 bounds every slot's keys; part is scratch
// of B * H * ceil(n_keys/64) * (dh + 2) floats.
extern "C" int flash_decode_batched(const void* q, const void* k, const void* v, const void* ks,
                                    const void* vs, const void* n_pasts, void* part, void* out,
                                    int B, int H, int n_ctx, int dh, int n_keys, float scale,
                                    int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dim_ok(dh)) return static_cast<int>(cudaErrorInvalidValue);
  const int S = n_splits(n_keys);
  const int* np = static_cast<const int*>(n_pasts);
  float* pf = static_cast<float*>(part);
  if (!split_dense_kind(kind, dim3(H, S, B), dh, s, q, k, v, ks, vs, np, pf, H, n_ctx, n_keys,
                        scale))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_combine_kernel<<<dim3(H, B), dh, 0, s>>>(pf, np, static_cast<float*>(out), H, dh, S,
                                                  n_keys);
  return static_cast<int>(cudaGetLastError());
}

// B slots through a page table: pools [P, L, H, page, Dh] and scale pools
// [P, L, H, page, 1] (int8) or null (whole, not layer views), table [B, MP]
// and n_pasts [B] int32 on the device; n_keys = max_n_past + 1 bounds
// every slot's keys; S splits a (slot, head) and tiles of `tile` rows
// (ops/attention.paged_plan).  One launch, no scratch.
extern "C" int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                                  const void* ks_pool, const void* vs_pool, const void* table,
                                  const void* n_pasts, void* out, int B, int P, int L, int H, int page,
                                  int MP, int il, int dh, int n_keys, int S, int tile, float scale, int kind,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || P < 1 || page < 1 || il < 0 || il >= L || n_keys < 1 ||
      static_cast<long long>(n_keys) > static_cast<long long>(MP) * page || !head_dim_ok(dh))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case 0:
      return launch_paged_rows<float>(s, q, k_pool, v_pool, ks_pool, vs_pool, table, n_pasts, out, B, P, L, H,
                                      page, MP, il, dh, n_keys, S, tile, scale);
    case 1:
      return launch_paged_rows<__nv_bfloat16>(s, q, k_pool, v_pool, ks_pool, vs_pool, table, n_pasts, out, B, P,
                                              L, H, page, MP, il, dh, n_keys, S, tile, scale);
    case 2:
      return launch_paged_rows<int8_t>(s, q, k_pool, v_pool, ks_pool, vs_pool, table, n_pasts, out, B, P, L, H,
                                       page, MP, il, dh, n_keys, S, tile, scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of a paged launch (ops/attention.paged_plan
// mirrors it), 0 for a plan the launcher refuses, -1 for bad arguments.
extern "C" int flash_decode_paged_smem_bytes(int dh, int kind, int n_keys, int S, int tile) {
  if (kind < 0 || kind > 2 || n_keys < 1 || !head_dim_ok(dh)) return -1;
  const int elt = kind == 0 ? 4 : kind == 1 ? 2 : 1;
  return static_cast<int>(paged_smem_bytes(dh, elt, kind == 2, n_keys, S, tile));
}
