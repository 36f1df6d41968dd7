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
// Batched and paged (`flash_decode_batched`, `flash_decode_paged`): one
// launch a call of one kernel template (flash_slots_kernel) on the same
// chunk pass, its row source a template parameter (a slot's plane is one
// page of n_ctx rows).
//  * Grid (S, H, B), a cluster of the S blocks of one (slot, head); S and
//    the tile come from the host (ops/attention.batched_plan and
//    paged_plan); slot b cuts its own keys, read on the device, by
//    split_plan(keys_b, S), so a short slot takes few splits and the
//    blocks past them hold no keys (they take part in the cluster's
//    barriers and push nothing).
//  * Batched (PLANE): the chunk pass reads each slot's plane of the
//    layer-major cache (PlaneRows: one bulk copy of K and one of V a
//    tile); grid row z takes the slot of rank z by live keys, so the
//    longest slots' blocks start first.  Splits: one for every 256 keys of
//    the longest slot, halved while the grid would exceed 4 blocks an SM,
//    at least one for every 1024 keys (batched_splits); tiles of 16 KB of
//    K rows, a ring of two stages.
//  * Paged: the chunk pass reads rows through the slot's table row
//    (PageRows): a tile's rows are cut at page edges into runs,
//    one bulk copy of K and one of V a run (at page 128 a tile of 64 or
//    128 rows is one run, or two where the split starts off a page edge;
//    at page 16, four to nine), the tile's bytes expected on its two
//    mbarriers; int8 row scales by cp.async a row.  S = split_plan(max
//    keys of the step, 2).splits, tiles of 16 KB of K rows, a ring of two
//    stages (one tile in flight while one is used), so a block takes 72
//    KB and three fit an SM (80 registers a thread).
//  * Block 0 of a cluster combines the live splits in split order through
//    distributed shared memory, as batch 1 does.  No scratch, no second
//    launch.  Before, both entries ran a split pass of 64-key blocks (a
//    warp a key row, a serial max, a thread a dim) and a combine launch,
//    with a fresh scratch tensor: 47 us paged and 27-28 us dense at B = 8
//    (1289 keys in all) on every cache type (H100 80GB HBM3, 700 W).
//  * Plans timed on the card (PERF.md, Findings): 1-8 splits,
//    rings of 2-5 stages, 8-64 KB stages, 1-5 blocks an SM.  Paged: batch
//    1's plan (8 splits, five 32 KB stages) was slower in every case: as
//    many blocks as the card holds, each with one or two tiles, running
//    in waves.  Batched (tools/flash_variants.py): the fastest split
//    count follows the keys a split and the blocks a wave, as the rule
//    above does, within 10 % of the fastest plan timed but at B = 1 on
//    int8; deeper rings won nowhere.
// Per-slot n_past is read on the device from an int32 tensor, so a step
// needs no device-to-host read.  All arithmetic is f32.
//
// Head dims: every even dh in [2, 1024], on every cache type.  Rows are
// staged by the bulk copy where a row is a whole number of 16-byte units
// on 16-byte aligned planes (pass_bulk_rows: dh 128, LLaMA's, on all
// three types), else by plain 4- or 2-byte loads into rows padded to 16
// bytes (a template parameter of the same kernel); the value pass gives a
// row's last thread 2 dims at dh % 4 == 2.
#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace {

// Live keys of slot b: n_pasts == nullptr means every slot has n_keys.
__device__ __forceinline__ int slot_keys(const int* n_pasts, int b, int n_keys) {
  return n_pasts ? min(max(__ldg(n_pasts + b), 0) + 1, n_keys) : n_keys;
}

constexpr int ONE_THREADS = 256;          // threads of a batch-1 block
constexpr int ONE_STAGES = 5;             // ring tiles of the chunk pass: four in flight
constexpr int ONE_STAGE_BYTES = 32768;    // K and V rows of a tile
constexpr int ONE_SMEM_LIMIT = 232448;    // the most a block may take (227 KB)
constexpr int ONE_MAX_SPLITS = 8;         // blocks of a head: a cluster of the portable size
constexpr int PAGED_STAGES = 2;           // ring tiles of the paged kernel's chunk pass: one in flight
constexpr int BATCHED_STAGES = 2;         // and of the batched kernel's
constexpr int SLOTS_BLOCKS_PER_SM = 3;    // the slot kernel's registers: at most 80 a thread

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

// The slot of rank z among B slots in decreasing order of live keys (ties:
// the lower slot first).  Blocks start in the order of their index, so
// grid row z = 0 takes the longest slot: its blocks, the step's longest
// chain of tiles, start first and the short slots fill in behind them.
// Every thread of the block calls it; `pick` is one int of shared memory.
__device__ int slot_longest_first(const int* n_pasts, int z, int B, int n_keys, int* pick) {
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    const int kt = slot_keys(n_pasts, t, n_keys);
    int rank = 0;
    for (int u = 0; u < B; ++u) {
      const int ku = slot_keys(n_pasts, u, n_keys);
      rank += ku > kt || (ku == kt && u < t);
    }
    if (rank == z) *pick = t;
  }
  __syncthreads();
  return *pick;
}

// B slots: q [B, H, dh], n_pasts [B] int32, o [B, H, dh].  Grid (S, H, B),
// cluster (S, 1, 1); slot b's keys (at most n_keys) cut by
// split_plan(keys_b, S), split c of them taken by block c through a ring
// of NST tiles of `tile` rows; a block past the slot's splits only keeps
// the cluster's barriers.  Shared memory as batch 1's.
//  * Paged (PLANE false): pools [P, L, H, page, dh] (scale pools [P, L, H,
//    page] for int8, else null), read whole, through the table [B, MP]
//    (PageRows); grid row z on slot z.
//  * Batched (PLANE true): k/v/ks/vs point at layer il's planes [B, H,
//    n_ctx, dh] of the dense cache, each slot's plane one page of `page` =
//    n_ctx rows (PlaneRows: table, P, L, MP and il unused); grid row z on
//    the slot of rank z by live keys (slot_longest_first).
template <typename T, bool BULK, int NST, bool PLANE>
__global__ void __launch_bounds__(ONE_THREADS, SLOTS_BLOCKS_PER_SM)
    flash_slots_kernel(const float* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                       const float* __restrict__ ks_pool, const float* __restrict__ vs_pool,
                       const int* __restrict__ table, const int* __restrict__ n_pasts, float* __restrict__ o,
                       int P, int L, int H, int page, int MP, int il, int dh, int n_keys, int tile, float scale) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char slots_smem[];
  const int c = blockIdx.x, S = gridDim.x, h = blockIdx.y, tid = threadIdx.x;
  float* parts = reinterpret_cast<float*>(slots_smem);                            // [S][dh + 2]
  float* qs = reinterpret_cast<float*>(slots_smem + round16(4 * S * (dh + 2)));    // [dh]
  float* mine = qs + round16(4 * dh) / 4;                                          // [dh + 2]
  unsigned char* pass = reinterpret_cast<unsigned char*>(mine) + round16(4 * (dh + 2));
  // `mine` is free until the pass writes it; the cluster's blocks take the same slot
  const int b =
      PLANE ? slot_longest_first(n_pasts, blockIdx.z, gridDim.z, n_keys, reinterpret_cast<int*>(mine)) : blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int keys = slot_keys(n_pasts, b, n_keys);
  const SplitPlan plan = split_plan(keys, S);
  const int j0 = c * plan.keys, jn = min(plan.keys, keys - j0);  // jn <= 0: no keys in this split
  // barrier phase 1 (waited on below): every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (jn > 0) {
    auto stage_q = [&] {  // q, while the first tiles are in flight
      for (int d = tid; d < dh; d += ONE_THREADS) qs[d] = __ldg(q + bh * dh + d);
    };
    if constexpr (PLANE) {
      const size_t plane = bh * page;  // row 0 of this (slot, head)
      const PlaneRows<T> rows{k_pool + plane * dh, v_pool + plane * dh, ks_pool ? ks_pool + plane : nullptr,
                              vs_pool ? vs_pool + plane : nullptr};
      chunk_pass_rows<T, ONE_THREADS, NST, BULK>(qs, stage_q, rows, dh, j0, jn, tile, scale, pass, mine);
    } else {
      const size_t head = (static_cast<size_t>(il) * H + h) * page;  // row of page 0 of this (layer, head)
      const PageRows<T> rows{k_pool + head * dh, v_pool + head * dh, ks_pool ? ks_pool + head : nullptr,
                             vs_pool ? vs_pool + head : nullptr, table + static_cast<size_t>(b) * MP,
                             static_cast<size_t>(L) * H * page, page, P};
      chunk_pass_rows<T, ONE_THREADS, NST, BULK>(qs, stage_q, rows, dh, j0, jn, tile, scale, pass, mine);
    }
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

constexpr int SLOTS_MAX_TILE = 1024;  // the most rows a tile of the slot kernel takes

// Dynamic shared memory of a slot launch of S splits and tiles of `tile`
// rows through a ring of `nst` stages, over at most n_keys keys a slot
// (ops/attention.paged_plan and batched_plan choose S, the tile and the
// ring and compute the same), or 0 where the launcher refuses the plan:
// S in [1, 8], a tile of 1 to 1024 rows.
size_t slots_smem_bytes(int dh, int elt, bool scaled, int n_keys, int S, int tile, int nst) {
  if (S < 1 || S > ONE_MAX_SPLITS || tile < 1 || tile > SLOTS_MAX_TILE) return 0;
  return one_smem_bytes(dh, elt, scaled, S, split_plan(n_keys, S).keys, tile, nst);
}

// One slot launch: grid (S, H, B) in clusters of S, arguments as the kernel's.
template <typename T, bool BULK, int NST, bool PLANE>
int launch_slots(cudaStream_t s, const void* q, const void* k_pool, const void* v_pool, const void* ks_pool,
                 const void* vs_pool, const void* table, const void* n_pasts, void* out, int B, int P, int L, int H,
                 int page, int MP, int il, int dh, int n_keys, int S, int tile, float scale) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_slots_kernel<T, BULK, NST, PLANE>, cudaFuncAttributeMaxDynamicSharedMemorySize, ONE_SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = slots_smem_bytes(dh, sizeof(T), kScaled, n_keys, S, tile, NST);
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
      &cfg, flash_slots_kernel<T, BULK, NST, PLANE>, static_cast<const float*>(q), static_cast<const T*>(k_pool),
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
    return launch_slots<T, true, PAGED_STAGES, false>(s, q, k_pool, v_pool, ks_pool, vs_pool, table, n_pasts, out, B,
                                                       P, L, H, page, MP, il, dh, n_keys, S, tile, scale);
  return launch_slots<T, false, PAGED_STAGES, false>(s, q, k_pool, v_pool, ks_pool, vs_pool, table, n_pasts, out, B,
                                                      P, L, H, page, MP, il, dh, n_keys, S, tile, scale);
}

// Batched over one layer's planes (a slot's plane one page of n_ctx rows),
// any even dh: the bulk copy where pass_bulk_rows allows it, else plain
// loads.
template <typename T>
int launch_batched_rows(cudaStream_t s, const void* q, const void* k, const void* v, const void* ks, const void* vs,
                        const void* n_pasts, void* out, int B, int H, int n_ctx, int dh, int n_keys, int S, int tile,
                        float scale) {
  if (pass_bulk_rows(dh * static_cast<int>(sizeof(T)), k, v))
    return launch_slots<T, true, BATCHED_STAGES, true>(s, q, k, v, ks, vs, nullptr, n_pasts, out, B, 1, 1, H, n_ctx,
                                                       1, 0, dh, n_keys, S, tile, scale);
  return launch_slots<T, false, BATCHED_STAGES, true>(s, q, k, v, ks, vs, nullptr, n_pasts, out, B, 1, 1, H, n_ctx, 1,
                                                      0, dh, n_keys, S, tile, scale);
}

// head dims the six kernels take (ops/attention.check_head_dim states the rule)
bool head_dim_ok(int dh) { return dh >= 2 && dh <= 4 * ONE_THREADS && dh % 2 == 0; }

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
// device; n_keys = max_n_past + 1 bounds every slot's keys; S splits a
// (slot, head) and tiles of `tile` rows (ops/attention.batched_plan).  One
// launch, no scratch.
extern "C" int flash_decode_batched(const void* q, const void* k, const void* v, const void* ks,
                                    const void* vs, const void* n_pasts, void* out, int B, int H, int n_ctx,
                                    int dh, int n_keys, int S, int tile, float scale, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || n_keys < 1 || n_keys > n_ctx || !head_dim_ok(dh))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case 0:
      return launch_batched_rows<float>(s, q, k, v, ks, vs, n_pasts, out, B, H, n_ctx, dh, n_keys, S, tile, scale);
    case 1:
      return launch_batched_rows<__nv_bfloat16>(s, q, k, v, ks, vs, n_pasts, out, B, H, n_ctx, dh, n_keys, S, tile,
                                                scale);
    case 2:
      return launch_batched_rows<int8_t>(s, q, k, v, ks, vs, n_pasts, out, B, H, n_ctx, dh, n_keys, S, tile, scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return static_cast<int>(slots_smem_bytes(dh, elt, kind == 2, n_keys, S, tile, PAGED_STAGES));
}

// Dynamic shared memory of a batched launch (ops/attention.batched_plan
// mirrors it), 0 for a plan the launcher refuses, -1 for bad arguments.
extern "C" int flash_decode_batched_smem_bytes(int dh, int kind, int n_keys, int S, int tile) {
  if (kind < 0 || kind > 2 || n_keys < 1 || !head_dim_ok(dh)) return -1;
  const int elt = kind == 0 ? 4 : kind == 1 ? 2 : 1;
  return static_cast<int>(slots_smem_bytes(dh, elt, kind == 2, n_keys, S, tile, BATCHED_STAGES));
}
