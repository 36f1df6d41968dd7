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
// per element), and at 7B decode shapes also launch and latency: 32 heads
// are fewer blocks than the card's 132 SMs.
//
// Design (split-K flash decoding, two launches):
//  * split kernel, grid (H, S, B): block (h, c, b) takes keys
//    [64c, 64c+64) of slot b, head h, one thread per head dim.  Warps compute
//    the scores (a warp reads a key row as one coalesced line: lanes split
//    the dims, a char4 per lane for int8, shuffles reduce), the block takes
//    the chunk max m_c, p_j = exp(s_j - m_c), l_c = sum p_j, and thread d
//    accumulates acc_c[d] = sum_j p_j v[j, d] (the block reads each value
//    row coalesced).  Splitting the keys puts H * S * B blocks on the card
//    instead of H * B.  S covers the largest n_past of the step (the host
//    knows it); a block whose chunk starts past its own slot's n_past exits
//    at once.
//  * combine kernel, grid (H, B): rescales slot b's live partials by
//    exp(m_c - max m) and normalises (online softmax across chunks).
// Per-slot n_past is read on the device from an int32 tensor, so a step
// needs no device-to-host read.  All arithmetic is f32.
#include "flash_common.cuh"

namespace {

// Live keys of slot b: n_pasts == nullptr means every slot has n_keys.
__device__ __forceinline__ int slot_keys(const int* n_pasts, int b, int n_keys) {
  return n_pasts ? min(max(__ldg(n_pasts + b), 0) + 1, n_keys) : n_keys;
}

// q [B, H, Dh]; k/v: layer plane [B, H, n_ctx, Dh]; ks/vs: its row scales
// [B, H, n_ctx] (int8) or null; part [B, H, S, Dh + 2]
template <typename T>
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
  split_chunk_kv<T>(q + bh * dh, DenseRows<T>{k + plane, ks ? ks + rows : nullptr, dh},
                    DenseRows<T>{v + plane, vs ? vs + rows : nullptr, dh}, j0,
                    min(CHUNK, keys - j0), scale, part + (bh * S + c) * (dh + 2));
}

// q [B, H, Dh]; pools [P, L, H, page, Dh]; scale pools [P, L, H, page]
// (int8) or null; table [B, MP]; part [B, H, S, Dh + 2]
template <typename T>
__global__ void flash_split_paged_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                                         const T* __restrict__ v_pool, const float* __restrict__ ks_pool,
                                         const float* __restrict__ vs_pool, const int* __restrict__ table,
                                         const int* __restrict__ n_pasts, float* __restrict__ part,
                                         int P, int L, int H, int page, int MP, int il, int dh,
                                         int n_keys, float scale) {
  const int h = blockIdx.x, c = blockIdx.y, S = gridDim.y, b = blockIdx.z;
  const int j0 = c * CHUNK;
  const int keys = slot_keys(n_pasts, b, n_keys);
  if (j0 >= keys) return;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t head = (static_cast<size_t>(il) * H + h) * page;  // row offset of page 0
  const size_t stride = static_cast<size_t>(L) * H * page;
  const int* trow = table + static_cast<size_t>(b) * MP;
  split_chunk_kv<T>(q + bh * dh,
                    PagedRows<T>{k_pool + head * dh, ks_pool ? ks_pool + head : nullptr, trow, stride, page, P, dh},
                    PagedRows<T>{v_pool + head * dh, vs_pool ? vs_pool + head : nullptr, trow, stride, page, P, dh},
                    j0, min(CHUNK, keys - j0), scale, part + (bh * S + c) * (dh + 2));
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

size_t split_smem(int dh) { return (dh + 2 * CHUNK) * sizeof(float); }
int n_splits(int n_keys) { return (n_keys + CHUNK - 1) / CHUNK; }

template <typename T>
void split_dense(dim3 grid, int dh, cudaStream_t s, const void* q, const void* k, const void* v,
                 const void* ks, const void* vs, const int* np, float* part, int H, int n_ctx,
                 int n_keys, float scale) {
  flash_split_batched_kernel<T><<<grid, dh, split_smem(dh), s>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), np, part, H, n_ctx, dh, n_keys,
      scale);
}

template <typename T>
void split_paged(dim3 grid, int dh, cudaStream_t s, const void* q, const void* k_pool,
                 const void* v_pool, const void* ks_pool, const void* vs_pool, const void* table,
                 const int* np, float* part, int P, int L, int H, int page, int MP, int il,
                 int n_keys, float scale) {
  flash_split_paged_kernel<T><<<grid, dh, split_smem(dh), s>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const float*>(ks_pool), static_cast<const float*>(vs_pool),
      static_cast<const int*>(table), np, part, P, L, H, page, MP, il, dh, n_keys, scale);
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

// k/v point at layer il of the stacked cache, ks/vs at its row scales
// (int8) or are null; n_keys = n_past + 1; part is scratch of
// H * ceil(n_keys/64) * (dh + 2) floats.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* ks,
                            const void* vs, void* part, void* out, int H, int n_ctx, int dh,
                            int n_keys, float scale, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n_splits(n_keys);
  float* pf = static_cast<float*>(part);
  if (!split_dense_kind(kind, dim3(H, S, 1), dh, s, q, k, v, ks, vs, nullptr, pf, H, n_ctx, n_keys,
                        scale))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_combine_kernel<<<dim3(H, 1), dh, 0, s>>>(pf, nullptr, static_cast<float*>(out), H, dh, S,
                                                  n_keys);
  return static_cast<int>(cudaGetLastError());
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
// and n_pasts [B] int32 on the device.
extern "C" int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                                  const void* ks_pool, const void* vs_pool, const void* table,
                                  const void* n_pasts, void* part, void* out, int B, int P, int L,
                                  int H, int page, int MP, int il, int dh, int n_keys, float scale,
                                  int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = n_splits(n_keys);
  const dim3 grid(H, S, B);
  const int* np = static_cast<const int*>(n_pasts);
  float* pf = static_cast<float*>(part);
  switch (kind) {
    case 0:
      split_paged<float>(grid, dh, s, q, k_pool, v_pool, ks_pool, vs_pool, table, np, pf, P, L, H,
                         page, MP, il, n_keys, scale);
      break;
    case 1:
      split_paged<__nv_bfloat16>(grid, dh, s, q, k_pool, v_pool, ks_pool, vs_pool, table, np, pf, P,
                                 L, H, page, MP, il, n_keys, scale);
      break;
    case 2:
      split_paged<int8_t>(grid, dh, s, q, k_pool, v_pool, ks_pool, vs_pool, table, np, pf, P, L, H,
                          page, MP, il, n_keys, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_combine_kernel<<<dim3(H, B), dh, 0, s>>>(pf, np, static_cast<float*>(out), H, dh, S,
                                                  n_keys);
  return static_cast<int>(cudaGetLastError());
}
