// Device code of single-query (decode) attention shared by flash_decode.cu,
// fused_layer.cu and fused_blocks.cu: row accessors of a dense or paged
// cache, the chunk pass over one contiguous run of keys, the older split
// pass and the combine of a head's splits.
//
// The chunk pass (`chunk_pass`) is what batch-1 decode and the
// whole-stack kernel's attention phase run.  What bounds it on the H100 is
// device memory: a split's K and V rows are read once (2.5 us for 8.4 MB
// at 3.35 TB/s for 32 heads at n_past 511 on a bf16 cache).  The older
// pass (`split_chunk_kv`, kept for the batched and paged kernels and the
// two-kernels-per-layer blocks) reached it through many dependent
// loads: a warp read a key row at a time, then a serial max, then thread d
// walked the 64 value rows, so a block waited on memory some 80 times and
// too few bytes were in flight.  The chunk pass instead:
//  * copies its run of K and V rows into shared memory with the 1-D bulk
//    form of TMA (cp.async.bulk: one instruction for a tile's K rows, one
//    for its V rows, each completing on an mbarrier; the int8 row scales
//    by cp.async), in a ring of NST tiles (the caller sizes a tile), NST -
//    1 tiles in flight before the first is used, so a block waits on
//    memory twice a tile (its K rows, then its V rows, which land while
//    the scores are taken), not once a key;
//  * takes every key of a tile at once from shared memory: 8 lanes a key
//    of f32, 4 of bf16 or int8 (a lane reads 16-byte vectors, a key's
//    lanes 128 or 64 contiguous bytes of its row; measured faster than 8
//    for the narrower rows), two or three shuffles;
//  * takes the tile's max and sum by warp reductions (online softmax from
//    tile to tile), and the values with four dims a thread (a warp a row
//    at dh 128; the warps take different keys, summed in order at the end).
// All arithmetic is f32 and every sum runs in a fixed order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 64;  // keys per split of split_chunk_kv

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

// This lane's share of q . row: lanes split the dims.
template <typename T>
__device__ __forceinline__ float lane_dot(const float* qs, const T* row, int dh, int lane) {
  float s = 0.0f;
  for (int d = lane; d < dh; d += 32) s += qs[d] * to_f32(row[d]);
  return s;
}

// int8 rows: four codes per lane (a 128-code row is one 128-byte line per
// warp).  Rows start at multiples of dh % 32 == 0 bytes, so char4 is aligned.
__device__ __forceinline__ float lane_dot(const float* qs, const int8_t* row, int dh, int lane) {
  float s = 0.0f;
  for (int d = 4 * lane; d < dh; d += 128) {
    const char4 c = *reinterpret_cast<const char4*>(row + d);
    s += qs[d] * c.x + qs[d + 1] * c.y + qs[d + 2] * c.z + qs[d + 3] * c.w;
  }
  return s;
}

// Rows of one (slot, head) of a contiguous [.., n_ctx, Dh] plane; `scale`
// points at the plane's [n_ctx] row scales (int8 caches only).
template <typename T>
struct DenseRows {
  const T* base;
  const float* scale;
  int dh;
  __device__ const T* row(int j) const { return base + static_cast<size_t>(j) * dh; }
  __device__ float row_scale(int j) const { return __ldg(scale + j); }
};

// Rows of one (slot, head) of a paged pool, through the slot's table row;
// `scale` is the scale pool at the same (layer, head), page 0 (int8 only).
template <typename T>
struct PagedRows {
  const T* base;        // pool + (il * H + h) * page * dh: page 0 of this (layer, head)
  const float* scale;   // scale pool + (il * H + h) * page
  const int* trow;      // page_table + b * MP
  size_t page_stride;   // L * H * page: rows from one page to the next
  int page, n_pages, dh;
  __device__ size_t row_index(int j) const {
    const int pid = min(max(__ldg(trow + j / page), 0), n_pages - 1);
    return pid * page_stride + static_cast<size_t>(j % page);
  }
  __device__ const T* row(int j) const { return base + row_index(j) * dh; }
  __device__ float row_scale(int j) const { return __ldg(scale + row_index(j)); }
};

// Keys [j0, j0 + jn) of one (slot, head), keys and values read through
// the accessors: writes (acc[0..dh), m, l) to out.  Block of dh threads;
// dynamic shared memory (dh + 2 * CHUNK) floats.
template <typename T, typename Rows>
__device__ void split_chunk_kv(const float* __restrict__ qrow, const Rows& krows, const Rows& vrows,
                               int j0, int jn, float scale, float* __restrict__ out) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  extern __shared__ float smem[];
  const int dh = krows.dh;
  float* qs = smem;                // [dh]
  float* sc = smem + dh;           // [CHUNK] scores, then exp(s - m)
  float* pv = smem + dh + CHUNK;   // [CHUNK] value weights (int8: exp(s - m) * vs)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  qs[tid] = qrow[tid];
  __syncthreads();
  for (int j = warp; j < jn; j += nwarps) {
    const float s = warp_sum(lane_dot(qs, krows.row(j0 + j), dh, lane));
    if (lane == 0) sc[j] = (kScaled ? s * krows.row_scale(j0 + j) : s) * scale;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = 0; j < jn; ++j) m = fmaxf(m, sc[j]);
  __syncthreads();
  for (int j = tid; j < jn; j += blockDim.x) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    pv[j] = kScaled ? e * vrows.row_scale(j0 + j) : e;
  }
  __syncthreads();
  float l = 0.0f, acc = 0.0f;
  for (int j = 0; j < jn; ++j) {
    l += sc[j];
    acc += pv[j] * to_f32(vrows.row(j0 + j)[tid]);
  }
  out[tid] = acc;
  if (tid == 0) {
    out[dh] = m;
    out[dh + 1] = l;
  }
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

// Rows of a tile when a ring stage holds `stage_bytes` of K and V rows.
__host__ __device__ inline int pass_tile_rows(int row_bytes, int stage_bytes) {
  const int t = (stage_bytes / 2) / row_bytes;
  return t < 1 ? 1 : t;
}

// Bytes of one ring stage: K and V rows, then K and V row scales (int8).
__host__ __device__ inline size_t pass_stage_bytes(int tile, int row_bytes, bool scaled) {
  return round16(2 * static_cast<size_t>(tile) * row_bytes + (scaled ? 8 * static_cast<size_t>(tile) : 0));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* b) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
// One arrival that also expects `bytes` of bulk copies to complete on b.
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(smem_u32(b)), "r"(parity)
                 : "memory");
  } while (!done);
}
// The 1-D bulk form of TMA: `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to this block's shared memory, completing on b.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(b))
               : "memory");
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
__device__ __forceinline__ float int8_word_dot(float4 a, uint32_t w) {
  return a.x * static_cast<float>(static_cast<int8_t>(w)) + a.y * static_cast<float>(static_cast<int8_t>(w >> 8)) +
         a.z * static_cast<float>(static_cast<int8_t>(w >> 16)) +
         a.w * static_cast<float>(static_cast<int8_t>(w >> 24));
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
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float4(static_cast<int8_t>(w), static_cast<int8_t>(w >> 8), static_cast<int8_t>(w >> 16),
                     static_cast<int8_t>(w >> 24));
}

// The pass's shared memory: the ring's mbarriers (a K and a V one a
// stage), scores and weights of a tile, 4 NT floats, the ring.
template <typename T, int NT, int NST>
struct PassLayout {
  static constexpr bool kScaled = std::is_same<T, int8_t>::value;
  uint64_t* bar;
  float* sc;
  float* pv;
  float* red;
  unsigned char* ring;
  size_t stage;
  int row_bytes;
  __device__ PassLayout(unsigned char* smem, int dh, int tile) {
    row_bytes = dh * static_cast<int>(sizeof(T));
    stage = pass_stage_bytes(tile, row_bytes, kScaled);
    bar = reinterpret_cast<uint64_t*>(smem);
    sc = reinterpret_cast<float*>(smem + PASS_BARRIER_BYTES);
    pv = sc + tile;
    red = reinterpret_cast<float*>(smem + PASS_BARRIER_BYTES + round16(8 * static_cast<size_t>(tile)));
    ring = smem + PASS_BARRIER_BYTES + round16(8 * static_cast<size_t>(tile)) + round16(16 * static_cast<size_t>(NT));
  }
  // Tile t of keys [j0, j0 + jn) into stage t % NST: thread 0 starts one
  // bulk copy of its K rows and one of its V rows (the own row, the run's
  // last, left out); int8 scales by cp.async, a commit group each for K
  // and V.  t < 0: an empty slot, the same count of commit groups.
  __device__ void load(int t, const T* k, const T* v, const float* ks, const float* vs, int dh, int j0, int jn,
                       int tile, int own) const {
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
    if (threadIdx.x == 0) {
      for (int half = 0; half < 2; ++half) {
        const uint32_t bytes = static_cast<uint32_t>(rows) * row_bytes;
        mbar_expect(bar + 2 * s + half, bytes);
        if (bytes) bulk_load(st + half * static_cast<size_t>(tile) * row_bytes,
                             (half ? v : k) + static_cast<size_t>(r0) * dh, bytes, bar + 2 * s + half);
      }
    }
    if (kScaled) {
      float* ssc = reinterpret_cast<float*>(st + 2 * static_cast<size_t>(tile) * row_bytes);
      for (int half = 0; half < 2; ++half) {
        const float* gsc = half ? vs : ks;
        for (int i = threadIdx.x; i < n; i += NT) cp_async4(ssc + half * tile + i, gsc + r0 + i);
        cp_async_commit();
      }
    }
  }
};

// Start the chunk pass over keys [j0, j0 + jn): its mbarriers, and its
// first NST - 1 tiles on their way.  A block of NT threads calls it
// together; chunk_pass(..., begun = true) then takes them.  Nothing the
// pass reads may depend on work after this call but the own row.
template <typename T, int NT, int NST>
__device__ void chunk_begin(const T* k, const T* v, const float* ks, const float* vs, int dh, int j0, int jn,
                            int tile, unsigned char* smem, int own = -1) {
  static_assert(NT % 32 == 0 && NST >= 2 && 2 * NST * 8 <= PASS_BARRIER_BYTES, "chunk_pass: NT, NST");
  const PassLayout<T, NT, NST> lay(smem, dh, tile);
  const int ntiles = (jn + tile - 1) / tile;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // earlier uses of this memory before the bulk copies
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * NST; ++i) mbar_init(lay.bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) lay.load(t < ntiles ? t : -1, k, v, ks, vs, dh, j0, jn, tile, own);
}

// Keys [j0, j0 + jn) of one head of a contiguous [n_ctx, dh] plane (k, v;
// ks, vs its row scales for int8, else null), against q (`qs`, dh floats
// in shared memory, 16-byte aligned, which `stage_q()` fills once the
// first tiles are on their way): writes (acc[0..dh), m, l) to `out` (dh + 2
// floats of shared memory).  Key `own` (or none, -1; else the run's last
// key, f32 or bf16 caches) is not read from the plane but from
// `own_k`/`own_v` in shared memory (its row as the cache stores it), which
// `stage_q()` may fill: the whole-stack kernel's new row, stored to the
// cache by the same block.  A block of NT threads (NT a multiple of 32,
// dh <= 4 NT) calls it together, over tiles of `tile` rows; `smem` holds
// pass_smem_bytes(tile, dh * sizeof(T), int8, NT, pass_stages(jn, tile,
// NST)) bytes, 16-byte aligned.  dh * sizeof(T) must be a multiple of 16
// and the rows 16-byte aligned.  `begun`: chunk_begin was called with the
// same arguments.  Reads no row outside the run.  Ends with a
// __syncthreads.
template <typename T, int NT, int NST, typename StageQ>
__device__ void chunk_pass(float* qs, StageQ stage_q, const T* __restrict__ k, const T* __restrict__ v,
                           const float* __restrict__ ks, const float* __restrict__ vs, int dh, int j0, int jn,
                           int tile, float scale, unsigned char* smem, float* out, int own = -1,
                           const T* own_k = nullptr, const T* own_v = nullptr, bool begun = false) {
  constexpr bool kScaled = std::is_same<T, int8_t>::value;
  constexpr int KEY_LANES = sizeof(T) == 4 ? 8 : 4;  // lanes a key's score: 64 or 128 bytes of its row at once
  constexpr int GROUPS = NT / KEY_LANES;             // keys scored at once
  constexpr int EPC = 16 / sizeof(T);                // elements a chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PassLayout<T, NT, NST> lay(smem, dh, tile);
  const int row_bytes = lay.row_bytes, cpr = row_bytes / 16;
  uint64_t* bar = lay.bar;
  float* sc = lay.sc;
  float* pv = lay.pv;
  float* red = lay.red;
  unsigned char* ring = lay.ring;
  const size_t stage = lay.stage;
  const int ntiles = (jn + tile - 1) / tile;
  if (!begun) chunk_begin<T, NT, NST>(k, v, ks, vs, dh, j0, jn, tile, smem, own);
  auto load = [&](int t) { lay.load(t, k, v, ks, vs, dh, j0, jn, tile, own); };

  // the value pass: a thread takes 4 consecutive dims of a row (dh / 4
  // threads a row, dh <= 4 NT), and the rows of its key group kg
  const int tpr = dh / 4, kgroups = NT / tpr, kg = tid / tpr, d0 = 4 * (tid - kg * tpr);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float m_run = -INFINITY, l_run = 0.0f;

  stage_q();
  for (int t = 0; t < ntiles; ++t) {
    const uint32_t parity = (t / NST) & 1;
    mbar_wait(bar + 2 * (t % NST), parity);  // tile t's K rows have landed
    if (kScaled) cp_async_wait<2 * NST - 3>();
    // our reads of stage (t - 1) % NST before its refill by the bulk copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // for every thread; stage (t - 1) % NST is free
    load(t + NST - 1 < ntiles ? t + NST - 1 : -1);
    unsigned char* st = ring + (t % NST) * stage;
    const T* kt = reinterpret_cast<const T*>(st);
    const T* vt = reinterpret_cast<const T*>(st + static_cast<size_t>(tile) * row_bytes);
    const float* sks = reinterpret_cast<const float*>(st + 2 * static_cast<size_t>(tile) * row_bytes);
    const int n = min(tile, jn - t * tile);
    const int mine = own - (j0 + t * tile);
    const bool has_own = mine >= 0 && mine < n;
    if (has_own) {  // the own K row, from shared memory
      for (int i = tid; i < cpr; i += NT)
        reinterpret_cast<uint4*>(st + static_cast<size_t>(mine) * row_bytes)[i] =
            reinterpret_cast<const uint4*>(own_k)[i];
      __syncthreads();
    }
    // scores: KEY_LANES lanes a key
    const int grp = tid / KEY_LANES, sub = tid % KEY_LANES;
    for (int r0 = 0; r0 < n; r0 += GROUPS) {
      const int r = r0 + grp;
      float s = 0.0f;
      if (r < n) {
        const uint4* row = reinterpret_cast<const uint4*>(kt + static_cast<size_t>(r) * dh);
        for (int c = sub; c < cpr; c += KEY_LANES) s += chunk_dot(qs + c * EPC, row[c], T());
      }
#pragma unroll
      for (int o = 1; o < KEY_LANES; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (sub == 0 && r < n) sc[r] = (kScaled ? s * sks[r] : s) * scale;
    }
    __syncthreads();
    // the tile's max and sum: every warp reduces the same scores alike
    float tmax = -INFINITY;
    for (int j = lane; j < n; j += 32) tmax = fmaxf(tmax, sc[j]);
    tmax = warp_max_f(tmax);
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);  // 0 at the first tile
    float psum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      if (warp == 0) pv[j] = p;
    }
    l_run = l_run * alpha + warp_sum(psum);
    m_run = m_new;
    mbar_wait(bar + 2 * (t % NST) + 1, parity);  // tile t's V rows have landed
    if (kScaled) cp_async_wait<2 * NST - 2>();
    if (has_own)                   // the own V row, from shared memory
      for (int i = tid; i < cpr; i += NT)
        reinterpret_cast<uint4*>(st + static_cast<size_t>(tile + mine) * row_bytes)[i] =
            reinterpret_cast<const uint4*>(own_v)[i];
    __syncthreads();
    // values: 4 dims of the rows of key group kg; int8 V row scales are
    // read only here, after their wait and the barrier above (each was
    // copied by another thread)
    if (kg < kgroups) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int j = kg; j < n; j += kgroups) {
        const float p = kScaled ? pv[j] * sks[tile + j] : pv[j];
        const float4 e = load4(vt + static_cast<size_t>(j) * dh + d0);
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
    for (int i = 0; i < 4; ++i) red[kg * dh + d0 + i] = acc[i];
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

}  // namespace
