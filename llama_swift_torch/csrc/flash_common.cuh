// Device code of single-query (decode) attention shared by flash_decode.cu
// and fused_layer.cu: the chunk pass over one run of keys (from a
// contiguous plane or through a page table) and the combine of a head's
// splits.
//
// The chunk pass (`chunk_pass`) is what batch-1 decode, the batched and
// paged kernels, the whole-stack kernel's attention phase and the
// attention block run.  What bounds it on the H100 is device memory: a
// split's K and V rows are read once (2.5 us for 8.4 MB at 3.35 TB/s for
// 32 heads at n_past 511 on a bf16 cache).  The first split pass reached
// it through many dependent loads: a warp read a key row at a time, then a
// serial max, then thread d walked the 64 value rows, so a block waited on
// memory some 80 times and too few bytes were in flight.  The chunk pass
// instead:
//  * copies its run of K and V rows into shared memory with the 1-D bulk
//    form of TMA (cp.async.bulk: one instruction for a tile's K rows, one
//    for its V rows, each completing on an mbarrier; the int8 row scales
//    by cp.async), in a ring of NST tiles (the caller sizes a tile), NST -
//    1 tiles in flight before the first is used, so a block waits on
//    memory twice a tile (its K rows, then its V rows, which land while
//    the scores are taken), not once a key; through a page table
//    (`PageRows`) a tile's rows are cut at page edges into runs, one bulk
//    copy of K and one of V a run, all completing on the tile's two
//    mbarriers; rows that are no whole number of 16-byte units (head dims
//    that are not a multiple of 4, 8 or 16 on f32, bf16 or int8) are
//    copied by every thread with plain loads instead (BULK = false), each
//    into a 16-byte padded row;
//  * takes every key of a tile at once from shared memory: 8 lanes a key
//    of f32, 4 of bf16 or int8 (a lane reads 16-byte vectors, a key's
//    lanes 128 or 64 contiguous bytes of its row; measured faster than 8
//    for the narrower rows), two or three shuffles;
//  * takes the tile's max and sum by warp reductions (online softmax from
//    tile to tile), and the values with four dims a thread (a warp a row
//    at dh 128; the warps take different keys, summed in order at the end).
// The tile's fixed work is kept small without changing a sum: warp 0
// alone takes the tile's max and exponentials (every warp doing so would
// take 8x the exponentials) and hands the rescale factor to the others
// through shared memory, and an int8 code becomes a float by a byte
// permute under the exponent of 2^23 and one subtraction (exact) instead
// of a conversion instruction.
// All arithmetic is f32 and every sum runs in a fixed order; where the
// rows come from changes no arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {

__host__ __device__ constexpr size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Combine the first `live` splits of one (slot, head) (part [S][dh + 2]):
// thread tid < dh returns dim tid of the output.  The splits are read
// through L2 (__ldcg): in the fused kernel other blocks wrote them in the
// same launch.
__device__ __forceinline__ float combine_splits(const float* __restrict__ ph, int live, int dh) {
  const int tid = threadIdx.x;
  float mx = -INFINITY;
  for (int c = 0; c < live; ++c) mx = fmaxf(mx, __ldcg(ph + c * (dh + 2) + dh));
  float l = 0.0f, acc = 0.0f;
  for (int c = 0; c < live; ++c) {
    const float* pc = ph + c * (dh + 2);
    const float a = expf(__ldcg(pc + dh) - mx);
    l += a * __ldcg(pc + dh + 1);
    acc += a * __ldcg(pc + tid);
  }
  return acc / l;
}

// ---------------------------------------------------------------------------
// the chunk pass
// ---------------------------------------------------------------------------

constexpr int PASS_MIN_KEYS = 16;       // the least keys a split takes
constexpr int PASS_BARRIER_BYTES = 128;  // the ring's mbarriers: a K and a V one a stage, up to 8 stages

// A cache row's bytes in a ring stage: its `row_bytes` rounded up to 16,
// so that every staged row starts 16-byte aligned whatever the head dim.
__host__ __device__ inline int pass_row_stride(int row_bytes) { return static_cast<int>(round16(row_bytes)); }

// Rows of a tile when a ring stage holds `stage_bytes` of K and V rows.
__host__ __device__ inline int pass_tile_rows(int row_bytes, int stage_bytes) {
  const int t = (stage_bytes / 2) / pass_row_stride(row_bytes);
  return t < 1 ? 1 : t;
}

// Bytes of one ring stage: K and V rows, then K and V row scales (int8).
__host__ __device__ inline size_t pass_stage_bytes(int tile, int row_bytes, bool scaled) {
  return round16(2 * static_cast<size_t>(tile) * pass_row_stride(row_bytes) +
                 (scaled ? 8 * static_cast<size_t>(tile) : 0));
}

// Whether the chunk pass may stage rows of `row_bytes` by the bulk copy:
// a whole number of 16-byte units a row, both planes 16-byte aligned.
// Otherwise it stages them with plain loads (any even head dim).
__host__ __device__ inline bool pass_bulk_rows(int row_bytes, const void* k, const void* v) {
  return row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// Shared memory of the pass over tiles of `tile` rows: the ring's
// mbarriers, scores and weights of a tile, 4 * NT floats for the sum
// across key groups, then `stages` tiles of the ring.  A split of `keys` keys touches min(ceil(keys / tile), NST)
// stages, so a caller may size the ring by the longest split it passes.
__host__ __device__ inline size_t pass_smem_bytes(int tile, int row_bytes, bool scaled, int nt, int stages) {
  return PASS_BARRIER_BYTES + round16(2 * 4 * static_cast<size_t>(tile)) + round16(16 * static_cast<size_t>(nt)) +
         stages * pass_stage_bytes(tile, row_bytes, scaled);
}

// Ring stages that splits of `keys` keys touch, at most nst.
__host__ __device__ inline int pass_stages(int keys, int tile, int nst) {
  const int t = (keys + tile - 1) / tile;
  return t < nst ? t : nst;
}

// How n_keys are cut into splits: at most max_splits splits of a multiple
// of PASS_MIN_KEYS keys each, none empty.
struct SplitPlan {
  int splits, keys;  // splits of `keys` keys (the last may hold fewer)
};
__host__ __device__ inline SplitPlan split_plan(int n_keys, int max_splits) {
  int s = (n_keys + PASS_MIN_KEYS - 1) / PASS_MIN_KEYS;
  s = s < max_splits ? s : max_splits;
  int len = (n_keys + s - 1) / s;
  len = (len + PASS_MIN_KEYS - 1) / PASS_MIN_KEYS * PASS_MIN_KEYS;
  return {(n_keys + len - 1) / len, len};
}

// q . (one 16-byte chunk of a row), q the chunk's dims in shared memory.
__device__ __forceinline__ float chunk_dot(const float* q, uint4 w, float) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  return a.x * __uint_as_float(w.x) + a.y * __uint_as_float(w.y) + a.z * __uint_as_float(w.z) +
         a.w * __uint_as_float(w.w);
}
__device__ __forceinline__ float bf16_pair_dot(float4 a, uint32_t w0, uint32_t w1) {
  return a.x * __uint_as_float(w0 << 16) + a.y * __uint_as_float(w0 & 0xffff0000u) +
         a.z * __uint_as_float(w1 << 16) + a.w * __uint_as_float(w1 & 0xffff0000u);
}
__device__ __forceinline__ float chunk_dot(const float* q, uint4 w, __nv_bfloat16) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  return bf16_pair_dot(q4[0], w.x, w.y) + bf16_pair_dot(q4[1], w.z, w.w);
}
// An int8 code c of a word, biased to c + 128 (one xor a word), placed
// under the exponent of 2^23 by one byte permute; one subtraction of 2^23
// + 128 leaves c exactly, with no conversion instruction (which the SM
// issues at a fraction of the rate of an add).
template <int K>
__device__ __forceinline__ float int8_code(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | K)) - 8388736.0f;
}
__device__ __forceinline__ float4 int8_word4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  return make_float4(int8_code<0>(u), int8_code<1>(u), int8_code<2>(u), int8_code<3>(u));
}
__device__ __forceinline__ float int8_word_dot(float4 a, uint32_t w) {
  const float4 c = int8_word4(w);
  return a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
}
__device__ __forceinline__ float chunk_dot(const float* q, uint4 w, int8_t) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  return int8_word_dot(q4[0], w.x) + int8_word_dot(q4[1], w.y) + int8_word_dot(q4[2], w.z) +
         int8_word_dot(q4[3], w.w);
}

// Four consecutive cache elements (16-, 8- or 4-byte aligned) as floats.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u), __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p) { return int8_word4(*reinterpret_cast<const uint32_t*>(p)); }

// Where the chunk pass reads its rows.  PlaneRows: a contiguous [n_ctx,
// dh] plane (k, v; ks, vs its row scales for int8, else null); key j is
// row j.  PageRows: one (slot, layer, head) of a paged pool [P, L, H,
// page, dh] through the slot's table row: key j is row j % page of page
// trow[j / page] (clamped to [0, P - 1], as the TPU kernel's index map
// does); k, v (ks, vs) point at page 0 of the (layer, head), and a page's
// rows lie page_stride rows apart.  row(j) is the key's row index from
// those pointers (codes and scales alike).
template <typename T>
struct PlaneRows {
  static constexpr bool kPaged = false;
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  __device__ size_t row(int j) const { return static_cast<size_t>(j); }
};

template <typename T>
struct PageRows {
  static constexpr bool kPaged = true;
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  const int* trow;     // page_table + b * MP
  size_t page_stride;  // L * H * page
  int page, n_pages;
  __device__ size_t row(int j) const {
    const int pid = min(max(__ldg(trow + j / page), 0), n_pages - 1);
    return pid * page_stride + static_cast<size_t>(j % page);
  }
};

// The pass's shared memory: the ring's mbarriers (a K and a V one a
// stage), scores and weights of a tile, 4 NT floats, the ring.  A staged
// row takes `srow` bytes (row_bytes rounded up to 16).  BULK: rows arrive
// by the bulk copy on the mbarriers; else every thread copies its share
// with plain loads (4- or 2-byte units) when the tile is loaded.
template <typename T, int NT, int NST, bool BULK>
struct PassLayout {
  static constexpr bool kScaled = std::is_same<T, int8_t>::value;
  uint64_t* bar;
  float* sc;
  float* pv;
  float* red;
  unsigned char* ring;
  size_t stage;
  int row_bytes, srow;
  __device__ PassLayout(unsigned char* smem, int dh, int tile) {
    row_bytes = dh * static_cast<int>(sizeof(T));
    srow = pass_row_stride(row_bytes);
    stage = pass_stage_bytes(tile, row_bytes, kScaled);
    bar = reinterpret_cast<uint64_t*>(smem);
    sc = reinterpret_cast<float*>(smem + PASS_BARRIER_BYTES);
    pv = sc + tile;
    red = reinterpret_cast<float*>(smem + PASS_BARRIER_BYTES + round16(8 * static_cast<size_t>(tile)));
    ring = smem + PASS_BARRIER_BYTES + round16(8 * static_cast<size_t>(tile)) + round16(16 * static_cast<size_t>(NT));
  }
  // Tile t of keys [j0, j0 + jn) into stage t % NST: thread 0 starts one
  // bulk copy of its K rows and one of its V rows (the own row, the run's
  // last, left out; through a page table, one of each a run of rows within
  // one page, the tile's bytes expected on its two mbarriers at once);
  // int8 scales by cp.async, a commit group each for K and V.  t < 0: an
  // empty slot, the same count of commit groups.
  template <typename Src>
  __device__ void load(int t, const Src& src, int dh, int j0, int jn, int tile, int own) const {
    if (t < 0) {
      if (kScaled) {
        cp_async_commit();
        cp_async_commit();
      }
      return;
    }
    const int s = t % NST, r0 = j0 + t * tile, n = min(tile, j0 + jn - r0);
    const int rows = own >= r0 && own < r0 + n ? n - 1 : n;
    unsigned char* st = ring + s * stage;
    if constexpr (BULK) {
      if (threadIdx.x == 0) {
        if constexpr (Src::kPaged) {  // own < 0: rows == n >= 1
          const uint32_t bytes = static_cast<uint32_t>(rows) * row_bytes;
          mbar_expect(bar + 2 * s, bytes);
          mbar_expect(bar + 2 * s + 1, bytes);
          for (int r = 0; r < rows;) {
            const int j = r0 + r, len = min(rows - r, src.page - j % src.page);
            const size_t at = src.row(j) * dh;
            const uint32_t run = static_cast<uint32_t>(len) * row_bytes;
            bulk_load(st + static_cast<size_t>(r) * srow, src.k + at, run, bar + 2 * s);
            bulk_load(st + static_cast<size_t>(tile + r) * srow, src.v + at, run, bar + 2 * s + 1);
            r += len;
          }
        } else {
          for (int half = 0; half < 2; ++half) {
            const uint32_t bytes = static_cast<uint32_t>(rows) * row_bytes;
            mbar_expect(bar + 2 * s + half, bytes);
            if (bytes) bulk_load(st + half * static_cast<size_t>(tile) * srow,
                                 (half ? src.v : src.k) + static_cast<size_t>(r0) * dh, bytes, bar + 2 * s + half);
          }
        }
      }
    } else {  // rows of any even dh: 4-byte units where row and planes allow, else 2-byte ones
      const bool w4 =
          ((row_bytes | reinterpret_cast<uintptr_t>(src.k) | reinterpret_cast<uintptr_t>(src.v)) & 3) == 0;
      const int unit = w4 ? 4 : 2, upr = row_bytes / unit;
      for (int half = 0; half < 2; ++half) {
        const unsigned char* base = reinterpret_cast<const unsigned char*>(half ? src.v : src.k);
        const unsigned char* plane = reinterpret_cast<const unsigned char*>((half ? src.v : src.k) +
                                                                            static_cast<size_t>(r0) * dh);
        unsigned char* dst = st + half * static_cast<size_t>(tile) * srow;
        for (int i = threadIdx.x; i < rows * upr; i += NT) {
          const int r = i / upr, off = (i - r * upr) * unit;
          const unsigned char* from = Src::kPaged ? base + src.row(r0 + r) * row_bytes + off
                                                  : plane + static_cast<size_t>(r) * row_bytes + off;
          if (w4)
            *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r) * srow + off) =
                __ldg(reinterpret_cast<const uint32_t*>(from));
          else
            *reinterpret_cast<uint16_t*>(dst + static_cast<size_t>(r) * srow + off) =
                __ldg(reinterpret_cast<const unsigned short*>(from));
        }
      }
    }
    if (kScaled) {
      float* ssc = reinterpret_cast<float*>(st + 2 * static_cast<size_t>(tile) * srow);
      for (int half = 0; half < 2; ++half) {
        const float* gsc = half ? src.vs : src.ks;
        for (int i = threadIdx.x; i < n; i += NT)
          cp_async4(ssc + half * tile + i, Src::kPaged ? gsc + src.row(r0 + i) : gsc + r0 + i);
        cp_async_commit();
      }
    }
  }
};

// Start the chunk pass over keys [j0, j0 + jn) of `src`: its mbarriers,
// and its first NST - 1 tiles on their way.  A block of NT threads calls
// it together; chunk_pass(..., begun = true) then takes them.  Nothing the
// pass reads may depend on work after this call but the own row.
template <typename T, int NT, int NST, bool BULK, typename Src>
__device__ void chunk_begin_rows(const Src& src, int dh, int j0, int jn, int tile, unsigned char* smem,
                                 int own = -1) {
  static_assert(NT % 32 == 0 && NST >= 2 && 2 * NST * 8 <= PASS_BARRIER_BYTES, "chunk_pass: NT, NST");
  const PassLayout<T, NT, NST, BULK> lay(smem, dh, tile);
  const int ntiles = (jn + tile - 1) / tile;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // earlier uses of this memory before the bulk copies
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * NST; ++i) mbar_init(lay.bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) lay.load(t < ntiles ? t : -1, src, dh, j0, jn, tile, own);
}

// chunk_begin_rows over a contiguous plane.
template <typename T, int NT, int NST, bool BULK = true>
__device__ void chunk_begin(const T* k, const T* v, const float* ks, const float* vs, int dh, int j0, int jn,
                            int tile, unsigned char* smem, int own = -1) {
  chunk_begin_rows<T, NT, NST, BULK>(PlaneRows<T>{k, v, ks, vs}, dh, j0, jn, tile, smem, own);
}

// Keys [j0, j0 + jn) of one head, their rows read from `src` (a
// PlaneRows or PageRows), against q (`qs`, dh floats in shared memory,
// 16-byte aligned, which `stage_q()` fills once the first tiles are on
// their way): writes (acc[0..dh), m, l) to `out` (dh + 2 floats of shared
// memory).  Key `own` (or none, -1; else the run's last key, f32 or bf16
// caches, a plane only) is not read from the plane but from
// `own_k`/`own_v` in shared memory (its row as the cache stores it), which
// `stage_q()` may fill: the whole-stack kernel's new row, stored to the
// cache by the same block.  A block of NT threads (NT a multiple of 32,
// dh even and <= 4 NT) calls it together, over tiles of `tile` rows;
// `smem` holds pass_smem_bytes(tile, dh * sizeof(T), int8, NT,
// pass_stages(jn, tile, NST)) bytes, 16-byte aligned.  BULK (the bulk
// copy) needs pass_bulk_rows(dh * sizeof(T), k, v) of the source's
// pointers; without it rows are staged by plain loads.  `begun`:
// chunk_begin_rows was called with the same arguments.  Reads no row
// outside the run.  Ends with a __syncthreads.
template <typename T, int NT, int NST, bool BULK, typename Src, typename StageQ>
__device__ void chunk_pass_rows(float* qs, StageQ stage_q, const Src& src, int dh, int j0, int jn, int tile,
                                float scale, unsigned char* smem, float* out, int own = -1,
                                const T* own_k = nullptr, const T* own_v = nullptr, bool begun = false) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  constexpr int KEY_LANES = sizeof(T) == 4 ? 8 : 4;  // lanes a key's score: 64 or 128 bytes of its row at once
  constexpr int GROUPS = NT / KEY_LANES;             // keys scored at once
  constexpr int EPC = 16 / sizeof(T);                // elements a chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PassLayout<T, NT, NST, BULK> lay(smem, dh, tile);
  const int row_bytes = lay.row_bytes, srow = lay.srow, cpr = row_bytes / 16;
  uint64_t* bar = lay.bar;
  float* sc = lay.sc;
  float* pv = lay.pv;
  float* red = lay.red;
  unsigned char* ring = lay.ring;
  const size_t stage = lay.stage;
  const int ntiles = (jn + tile - 1) / tile;
  if (!begun) chunk_begin_rows<T, NT, NST, BULK>(src, dh, j0, jn, tile, smem, own);
  auto load = [&](int t) { lay.load(t, src, dh, j0, jn, tile, own); };

  // the value pass: a thread takes 4 consecutive dims of a row (ceil(dh / 4)
  // threads a row, dh <= 4 NT; at dh % 4 == 2 a row's last thread keeps
  // 2), and the rows of its key group kg
  const int tpr = (dh + 3) / 4, kgroups = NT / tpr, kg = tid / tpr, d0 = 4 * (tid - kg * tpr);
  const int nd = BULK ? 4 : min(4, dh - d0);  // BULK rows hold whole 16-byte units: dh % 4 == 0
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float m_run = -INFINITY, l_run = 0.0f;

  stage_q();
  for (int t = 0; t < ntiles; ++t) {
    const uint32_t parity = (t / NST) & 1;
    if constexpr (BULK) mbar_wait(bar + 2 * (t % NST), parity);  // tile t's K rows have landed
    if (kScaled) cp_async_wait<2 * NST - 3>();
    // our reads of stage (t - 1) % NST before its refill by the bulk copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // for every thread; stage (t - 1) % NST is free
    load(t + NST - 1 < ntiles ? t + NST - 1 : -1);
    unsigned char* st = ring + (t % NST) * stage;
    const unsigned char* kt = st;
    const unsigned char* vt = st + static_cast<size_t>(tile) * srow;
    const float* sks = reinterpret_cast<const float*>(st + 2 * static_cast<size_t>(tile) * srow);
    const int n = min(tile, jn - t * tile);
    const int mine = own - (j0 + t * tile);
    const bool has_own = mine >= 0 && mine < n;
    if (has_own) {  // the own K row, from shared memory
      if constexpr (BULK)
        for (int i = tid; i < cpr; i += NT)
          reinterpret_cast<uint4*>(st + static_cast<size_t>(mine) * srow)[i] = reinterpret_cast<const uint4*>(own_k)[i];
      else
        for (int i = tid; i < dh; i += NT) reinterpret_cast<T*>(st + static_cast<size_t>(mine) * srow)[i] = own_k[i];
      __syncthreads();
    }
    // scores: KEY_LANES lanes a key
    const int grp = tid / KEY_LANES, sub = tid % KEY_LANES;
    for (int r0 = 0; r0 < n; r0 += GROUPS) {
      const int r = r0 + grp;
      float s = 0.0f;
      if (r < n) {
        const uint4* row = reinterpret_cast<const uint4*>(kt + static_cast<size_t>(r) * srow);
        for (int c = sub; c < cpr; c += KEY_LANES) s += chunk_dot(qs + c * EPC, row[c], T());
        if constexpr (!BULK)  // the row's last row_bytes % 16 bytes, an element a lane
          for (int e = cpr * EPC + sub; e < dh; e += KEY_LANES) s += qs[e] * to_f32(reinterpret_cast<const T*>(row)[e]);
      }
#pragma unroll
      for (int o = 1; o < KEY_LANES; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (sub == 0 && r < n) sc[r] = (kScaled ? s * sks[r] : s) * scale;
    }
    __syncthreads();
    // the tile's max and sum: warp 0 alone, which leaves alpha in sc[0] for
    // the others (only thread 0 reads m_run and l_run at the end)
    float alpha = 0.0f;
    if (warp == 0) {
      float tmax = -INFINITY;
      for (int j = lane; j < n; j += 32) tmax = fmaxf(tmax, sc[j]);
      tmax = warp_max_f(tmax);
      const float m_new = fmaxf(m_run, tmax);
      alpha = expf(m_run - m_new);  // 0 at the first tile
      float psum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sc[j] - m_new);
        psum += p;
        pv[j] = p;
      }
      l_run = l_run * alpha + warp_sum(psum);
      m_run = m_new;
      __syncwarp();  // every lane's reads of sc before sc[0] is overwritten
      if (lane == 0) sc[0] = alpha;
    }
    if constexpr (BULK) mbar_wait(bar + 2 * (t % NST) + 1, parity);  // tile t's V rows have landed
    if (kScaled) cp_async_wait<2 * NST - 2>();
    if (has_own) {  // the own V row, from shared memory
      if constexpr (BULK)
        for (int i = tid; i < cpr; i += NT)
          reinterpret_cast<uint4*>(st + static_cast<size_t>(tile + mine) * srow)[i] =
              reinterpret_cast<const uint4*>(own_v)[i];
      else
        for (int i = tid; i < dh; i += NT)
          reinterpret_cast<T*>(st + static_cast<size_t>(tile + mine) * srow)[i] = own_v[i];
    }
    __syncthreads();
    alpha = sc[0];  // read before the next tile's scores, behind its barrier
    // values: 4 dims of the rows of key group kg (a row's last thread at
    // dh % 4 == 2 also reads 2 elements of the row's padding, never
    // summed into the output); int8 V row scales are read only here,
    // after their wait and the barrier above (each was copied by another
    // thread)
    if (kg < kgroups) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int j = kg; j < n; j += kgroups) {
        const float p = kScaled ? pv[j] * sks[tile + j] : pv[j];
        const float4 e = load4(reinterpret_cast<const T*>(vt + static_cast<size_t>(j) * srow) + d0);
        a[0] += p * e.x;
        a[1] += p * e.y;
        a[2] += p * e.z;
        a[3] += p * e.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = acc[i] * alpha + a[i];
    }
  }
  if (kScaled) cp_async_wait<0>();
  if (kg < kgroups)
    for (int i = 0; i < nd; ++i) red[kg * dh + d0 + i] = acc[i];
  __syncthreads();
  if (tid == 0)  // every phase is complete: the barriers' memory may serve other uses
    for (int i = 0; i < 2 * NST; ++i) mbar_inval(bar + i);
  for (int d = tid; d < dh; d += NT) {  // the key groups in order
    float a = 0.0f;
    for (int g = 0; g < kgroups; ++g) a += red[g * dh + d];
    out[d] = a;
  }
  if (tid == 0) {
    out[dh] = m_run;
    out[dh + 1] = l_run;
  }
  __syncthreads();
}

// chunk_pass_rows over a contiguous [n_ctx, dh] plane (k, v; ks, vs its
// row scales for int8, else null).
template <typename T, int NT, int NST, bool BULK = true, typename StageQ>
__device__ void chunk_pass(float* qs, StageQ stage_q, const T* k, const T* v, const float* ks, const float* vs,
                           int dh, int j0, int jn, int tile, float scale, unsigned char* smem, float* out,
                           int own = -1, const T* own_k = nullptr, const T* own_v = nullptr, bool begun = false) {
  chunk_pass_rows<T, NT, NST, BULK>(qs, stage_q, PlaneRows<T>{k, v, ks, vs}, dh, j0, jn, tile, scale, smem, out,
                                    own, own_k, own_v, begun);
}

}  // namespace
