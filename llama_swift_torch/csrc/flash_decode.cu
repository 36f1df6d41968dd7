// Single-query (decode) attention over one layer of a KV cache: batch 1,
// B slots of a dense batched cache, and B slots of a paged cache.
//
// Replaces the TPU kernels (llama_swift_tpu/ops/attention.py):
//  * `_flash_decode_kernel`, `_flash_decode_stacked_kernel` (entry points
//    flash_decode_attention, flash_decode_attention_stacked) -> flash_decode;
//  * `_flash_batched_kernel` (flash_decode_attention_batched) ->
//    flash_decode_batched;
//  * `_flash_paged_kernel` (flash_decode_attention_paged) -> flash_decode_paged.
//
//   out[b, h] = softmax_j( q[b, h] . k[b, h, j] / sqrt(Dh) ) . v[b, h, j],   j = 0..n_past[b]
//
// Caches (f32 or bf16), read in place at layer il:
//  * batch 1: head-major [L, H, n_ctx, Dh];
//  * batched: layer-major [L, B, H, n_ctx, Dh];
//  * paged: a pool [P, L, H, page, Dh] of position-range pages and a table
//    [B, MP] int32; key j of slot b lives in page table[b, j / page]
//    (clamped to [0, P-1], as the TPU kernel's index map does) at row
//    j % page.  Table entries beyond a slot's live keys are never read.
// Only keys j <= n_past[b] are read, so the bytes moved grow with each
// slot's own n_past, not with n_ctx (stale rows beyond it are never touched).
//
// What bounds it on the H100: device-memory bandwidth (2 * (n_past+1) * H *
// Dh cache elements per slot, 4 flops each), and at 7B decode shapes also
// launch and latency: 32 heads are fewer blocks than the card's 132 SMs.
//
// Design (split-K flash decoding, two launches):
//  * split kernel, grid (H, S, B): block (h, c, b) takes keys
//    [64c, 64c+64) of slot b, head h, one thread per head dim.  Warps compute
//    the scores (a warp reads a 128-dim key row as one coalesced line, lanes
//    split the dims, shuffles reduce), the block takes the chunk max m_c,
//    p_j = exp(s_j - m_c), l_c = sum p_j, and thread d accumulates
//    acc_c[d] = sum_j p_j v[j, d] (the block reads each value row coalesced).
//    Splitting the keys puts H * S * B blocks on the card instead of H * B.
//    S covers the largest n_past of the step (the host knows it); a block
//    whose chunk starts past its own slot's n_past exits at once.
//  * combine kernel, grid (H, B): rescales slot b's live partials by
//    exp(m_c - max m) and normalises (online softmax across chunks).
// Per-slot n_past is read on the device from an int32 tensor, so a step
// needs no device-to-host read.  All arithmetic is f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;  // keys per split

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of one (slot, head) of a contiguous [.., n_ctx, Dh] plane.
template <typename T>
struct DenseRows {
  const T* base;
  int dh;
  __device__ const T* row(int j) const { return base + static_cast<size_t>(j) * dh; }
};

// Rows of one (slot, head) of a paged pool, through the slot's table row.
template <typename T>
struct PagedRows {
  const T* base;        // pool + (il * H + h) * page * dh: page 0 of this (layer, head)
  const int* trow;      // page_table + b * MP
  size_t page_stride;   // L * H * page * dh: elements from one page to the next
  int page, n_pages, dh;
  __device__ const T* row(int j) const {
    const int pid = min(max(__ldg(trow + j / page), 0), n_pages - 1);
    return base + pid * page_stride + static_cast<size_t>(j % page) * dh;
  }
};

// Keys [j0, j0 + jn) of one (slot, head), keys and values read through
// the accessors: writes (acc[0..dh), m, l) to out.  Block of dh threads;
// dynamic shared memory (dh + CHUNK) floats.
template <typename T, typename Rows>
__device__ void split_chunk_kv(const float* __restrict__ qrow, const Rows& krows, const Rows& vrows,
                               int j0, int jn, float scale, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int dh = krows.dh;
  float* qs = smem;        // [dh]
  float* sc = smem + dh;   // [CHUNK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  qs[tid] = qrow[tid];
  __syncthreads();
  for (int j = warp; j < jn; j += nwarps) {
    const T* kr = krows.row(j0 + j);
    float s = 0.0f;
    for (int d = lane; d < dh; d += 32) s += qs[d] * to_f32(kr[d]);
    s = warp_sum(s);
    if (lane == 0) sc[j] = s * scale;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = 0; j < jn; ++j) m = fmaxf(m, sc[j]);
  __syncthreads();
  for (int j = tid; j < jn; j += blockDim.x) sc[j] = expf(sc[j] - m);
  __syncthreads();
  float l = 0.0f, acc = 0.0f;
  for (int j = 0; j < jn; ++j) {
    const float p = sc[j];
    l += p;
    acc += p * to_f32(vrows.row(j0 + j)[tid]);
  }
  out[tid] = acc;
  if (tid == 0) {
    out[dh] = m;
    out[dh + 1] = l;
  }
}

// Live keys of slot b: n_pasts == nullptr means every slot has n_keys.
__device__ __forceinline__ int slot_keys(const int* n_pasts, int b, int n_keys) {
  return n_pasts ? min(max(__ldg(n_pasts + b), 0) + 1, n_keys) : n_keys;
}

// q [B, H, Dh]; k/v: layer plane [B, H, n_ctx, Dh]; part [B, H, S, Dh + 2]
template <typename T>
__global__ void flash_split_batched_kernel(const float* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, const int* __restrict__ n_pasts,
                                           float* __restrict__ part, int H, int n_ctx, int dh,
                                           int n_keys, float scale) {
  const int h = blockIdx.x, c = blockIdx.y, S = gridDim.y, b = blockIdx.z;
  const int j0 = c * CHUNK;
  const int keys = slot_keys(n_pasts, b, n_keys);
  if (j0 >= keys) return;  // chunk past this slot's n_past: combine skips it
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t plane = bh * n_ctx * dh;
  split_chunk_kv<T>(q + bh * dh, DenseRows<T>{k + plane, dh}, DenseRows<T>{v + plane, dh}, j0,
                    min(CHUNK, keys - j0), scale, part + (bh * S + c) * (dh + 2));
}

// q [B, H, Dh]; pools [P, L, H, page, Dh]; table [B, MP]; part [B, H, S, Dh + 2]
template <typename T>
__global__ void flash_split_paged_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                                         const T* __restrict__ v_pool, const int* __restrict__ table,
                                         const int* __restrict__ n_pasts, float* __restrict__ part,
                                         int P, int L, int H, int page, int MP, int il, int dh,
                                         int n_keys, float scale) {
  const int h = blockIdx.x, c = blockIdx.y, S = gridDim.y, b = blockIdx.z;
  const int j0 = c * CHUNK;
  const int keys = slot_keys(n_pasts, b, n_keys);
  if (j0 >= keys) return;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = (static_cast<size_t>(il) * H + h) * page * dh;
  const size_t stride = static_cast<size_t>(L) * H * page * dh;
  const int* trow = table + static_cast<size_t>(b) * MP;
  split_chunk_kv<T>(q + bh * dh, PagedRows<T>{k_pool + head, trow, stride, page, P, dh},
                    PagedRows<T>{v_pool + head, trow, stride, page, P, dh}, j0,
                    min(CHUNK, keys - j0), scale, part + (bh * S + c) * (dh + 2));
}

// part [B, H, S, dh + 2] -> o [B, H, dh]; grid (H, B); slot b combines only
// its live splits (n_pasts == nullptr: all S)
__global__ void flash_combine_kernel(const float* __restrict__ part, const int* __restrict__ n_pasts,
                                     float* __restrict__ o, int H, int dh, int S, int n_keys) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int live = (slot_keys(n_pasts, b, n_keys) + CHUNK - 1) / CHUNK;
  const float* ph = part + bh * S * (dh + 2);
  float mx = -INFINITY;
  for (int c = 0; c < live; ++c) mx = fmaxf(mx, ph[c * (dh + 2) + dh]);
  float l = 0.0f, acc = 0.0f;
  for (int c = 0; c < live; ++c) {
    const float* pc = ph + c * (dh + 2);
    const float a = expf(pc[dh] - mx);
    l += a * pc[dh + 1];
    acc += a * pc[tid];
  }
  o[bh * dh + tid] = acc / l;
}

size_t split_smem(int dh) { return (dh + CHUNK) * sizeof(float); }
int n_splits(int n_keys) { return (n_keys + CHUNK - 1) / CHUNK; }

}  // namespace

// k/v point at layer il of the stacked cache; n_keys = n_past + 1;
// part is scratch of H * ceil(n_keys/64) * (dh + 2) floats.
extern "C" int flash_decode(const void* q, const void* k, const void* v, void* part,
                            void* out, int H, int n_ctx, int dh, int n_keys, float scale,
                            int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n_splits(n_keys);
  const dim3 grid(H, S, 1);
  const float* qf = static_cast<const float*>(q);
  float* pf = static_cast<float*>(part);
  if (is_bf16)
    flash_split_batched_kernel<__nv_bfloat16><<<grid, dh, split_smem(dh), s>>>(
        qf, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), nullptr,
        pf, H, n_ctx, dh, n_keys, scale);
  else
    flash_split_batched_kernel<float><<<grid, dh, split_smem(dh), s>>>(
        qf, static_cast<const float*>(k), static_cast<const float*>(v), nullptr, pf, H, n_ctx,
        dh, n_keys, scale);
  flash_combine_kernel<<<dim3(H, 1), dh, 0, s>>>(pf, nullptr, static_cast<float*>(out), H, dh, S,
                                                  n_keys);
  return static_cast<int>(cudaGetLastError());
}

// B slots: k/v point at layer il of the batched cache ([B, H, n_ctx, Dh]);
// n_pasts [B] int32 on the device; n_keys = max_n_past + 1 bounds every
// slot's keys; part is scratch of B * H * ceil(n_keys/64) * (dh + 2) floats.
extern "C" int flash_decode_batched(const void* q, const void* k, const void* v,
                                    const void* n_pasts, void* part, void* out, int B, int H,
                                    int n_ctx, int dh, int n_keys, float scale, int is_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n_splits(n_keys);
  const dim3 grid(H, S, B);
  const float* qf = static_cast<const float*>(q);
  const int* np = static_cast<const int*>(n_pasts);
  float* pf = static_cast<float*>(part);
  if (is_bf16)
    flash_split_batched_kernel<__nv_bfloat16><<<grid, dh, split_smem(dh), s>>>(
        qf, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), np, pf,
        H, n_ctx, dh, n_keys, scale);
  else
    flash_split_batched_kernel<float><<<grid, dh, split_smem(dh), s>>>(
        qf, static_cast<const float*>(k), static_cast<const float*>(v), np, pf, H, n_ctx, dh,
        n_keys, scale);
  flash_combine_kernel<<<dim3(H, B), dh, 0, s>>>(pf, np, static_cast<float*>(out), H, dh, S,
                                                  n_keys);
  return static_cast<int>(cudaGetLastError());
}

// B slots through a page table: pools [P, L, H, page, Dh] (whole, not a
// layer view), table [B, MP] and n_pasts [B] int32 on the device.
extern "C" int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                                  const void* table, const void* n_pasts, void* part, void* out,
                                  int B, int P, int L, int H, int page, int MP, int il, int dh,
                                  int n_keys, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n_splits(n_keys);
  const dim3 grid(H, S, B);
  const float* qf = static_cast<const float*>(q);
  const int* tb = static_cast<const int*>(table);
  const int* np = static_cast<const int*>(n_pasts);
  float* pf = static_cast<float*>(part);
  if (is_bf16)
    flash_split_paged_kernel<__nv_bfloat16><<<grid, dh, split_smem(dh), s>>>(
        qf, static_cast<const __nv_bfloat16*>(k_pool), static_cast<const __nv_bfloat16*>(v_pool),
        tb, np, pf, P, L, H, page, MP, il, dh, n_keys, scale);
  else
    flash_split_paged_kernel<float><<<grid, dh, split_smem(dh), s>>>(
        qf, static_cast<const float*>(k_pool), static_cast<const float*>(v_pool), tb, np, pf, P,
        L, H, page, MP, il, dh, n_keys, scale);
  flash_combine_kernel<<<dim3(H, B), dh, 0, s>>>(pf, np, static_cast<float*>(out), H, dh, S,
                                                  n_keys);
  return static_cast<int>(cudaGetLastError());
}
