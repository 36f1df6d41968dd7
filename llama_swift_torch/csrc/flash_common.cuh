// Device code of single-query (decode) attention shared by flash_decode.cu
// and fused_layer.cu: row accessors of a dense or paged cache, the split
// pass over one chunk of keys and the combine of a head's splits.  The
// design note at the top of flash_decode.cu says what they compute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 64;  // keys per split

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

}  // namespace
