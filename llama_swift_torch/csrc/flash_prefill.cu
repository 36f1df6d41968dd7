// Causal prefill attention: N query rows of one layer against the layer's
// K and V plane, one launch a layer.
//
//   out[i, h] = softmax_j( q[i, h] . k[h, j] / sqrt(Dh) ) . v[h, j],   j = 0..n_past + i
//
// It replaces no TPU kernel: the JAX package leaves prefill attention to
// XLA (`_attention_flash_xla`, llama_swift_tpu/models/llama.py), and the
// port's plain version (ops/attention.flash_prefill_attention_plain) loops
// over all n_ctx cache positions in 512-key chunks, some 25 launches a
// chunk, with each chunk's [H, N, 512] f32 scores in device memory.
//
// Inputs, read in place: q [N, H, Dh] with its row and head strides (f32,
// bf16 or f16: `q_kind` 0, 1, 2), the layer's K and V planes [H, n_keys, Dh]
// with their head and row strides (f32 or bf16: `kv_kind` 0, 1; the int8 and
// paged caches pass the f32 plane the model dequantizes or gathers).  The
// output [N, H, Dh] contiguous, in f32, bf16 or f16 (`out_kind`), written
// here: no division, cast or transpose after the launch.
//
// What bounds it on the H100: the causal products, 2 * 2 * H * Dh * (N^2 / 2
// + n_past * N) operations (1.6 TFLOP for 30 layers at N = 2560, H 32, Dh
// 128), at f32 precision.  The f32 CUDA cores give 67 TFLOP/s (24 ms for
// that prefill); the bf16 tensor cores 989 TFLOP/s, a sixth of it with the
// six products a term below (165 TFLOP/s).  The bytes are small beside:
// each block reads its keys' K and V rows once, and the blocks of a wave
// walk the same key tiles together, so the planes stream through L2.
//
// Precision.  The model states f32 attention (the JAX package runs it at
// Precision.HIGHEST), so no product is taken at TF32 or bf16 alone.  Each
// f32 operand is split exactly into three bf16 pieces, x = x0 + x1 + x2
// (`split3`, csrc/q4_f32_mma.cuh: 8 significant bits each), and a product
// a.b is taken as the six piece products of weight above 2^-24 on mma.sync
// m16n8k16 bf16 (each exact in f32), the small ones first: a2b0, a1b1,
// a0b2, a1b0, a0b1, a0b0; the dropped a1b2, a2b1, a2b2 are below 2^-23
// |a.b|.  A bf16 plane's values are their own x0, so a term takes three
// products.  The tensor cores align and truncate each sum instead of
// rounding it, so every k-step (16 dims of a score, 16 keys of P.V) goes
// into a fresh accumulator and is added on the CUDA cores: a score with f32
// adds, a key tile's P.V into the running output by one FMA with the
// rescale (o = o * alpha + pv), as the plain version's `acc * alpha + p @ v`.
// The softmax is f32: the scale times log2(e) folded into one multiply,
// exp2f.  The first design, three TF32 products (hi.hi + hi.lo + lo.hi),
// kept ~22 bits: 0.6-1.1e-6 of max|V| off a float64 reference, 4-6x the
// f32 FMA products' error, and enough to flip a 4-bit activation code that
// the card's f32 attention left alone (chip_smoke's int8 batched parity);
// it took 1.48 ms a layer at N 2560 where this design takes 1.94.
// Measured on an H100 (H 32, Dh 128, N 11-2560): 1.5-3.2e-7 of max|V| off
// a float64 reference, where the plain f32 version is 3.9-9.9e-7 off.
// tests/test_torch_cuda.py holds the kernel to 1e-5 of max|V| of the plain
// version, a bound that single-pass TF32 exceeds.
//
// Design (flash_prefill_kernel<DP, T>):
//  * Grid: one block a (query tile, head), 16 query rows a warp, 1, 2 or 4
//    warps (ops/attention.flash_prefill_plan picks them from N).  Blocks
//    are issued longest first: block b takes head b % H and query tile
//    n_qt - 1 - b / H, so the last query tiles, which have the most keys
//    under the causal triangle, start first and the short ones fill the
//    tail.
//  * Keys: a block visits key tiles 0 .. ceil((n_past + q_last + 1) / BK) - 1
//    of its last row q_last, nothing past.  Rows of the last tile at or past
//    that bound are zero-filled by the copy (cp.async with a source size of
//    0), so no key at or past n_past + N is ever read and a NaN there cannot
//    reach the output.  Only tiles that cross a warp's diagonal are masked;
//    a warp skips a tile that lies wholly beyond its last row.
//  * Tiles: K and V tiles of BK rows (64 for DP <= 64, else 32) staged by
//    cp.async (16 bytes a copy where rows and planes allow, else 4) in a
//    ring of two stages, the next tile in flight while the current one is
//    used.  The head dim is padded to DP (64, 128 or 256: a multiple of the
//    MMA depth); the pad columns of Q, K and V are zeros in shared memory,
//    which add nothing to a dot product, and only real dims are written.
//    Row strides keep the fragments' loads on distinct banks: Q and K rows
//    (read as f32 pairs) are DP + 8 floats, f32 V rows (read by column) DP
//    + 4, bf16 rows DP + 8 elements.
//  * Online softmax in f32 registers: each thread holds 2 rows' running
//    max and (partial) sum; rows are reduced across the 4 lanes that share
//    them by two shuffles.  P stays in registers: the C fragments of two
//    score n-tiles are the A fragment of the P.V MMA over their 16 keys.
//  * Fully masked rows do not occur (row i always has key n_past + i); a
//    running max of -inf is guarded as the plain version guards it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "q4_f32_mma.cuh"

namespace {

constexpr int FP_MAX_WARPS = 4;
constexpr float FP_LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int fp_bk(int dp) { return dp <= 64 ? 64 : 32; }
// shared rows, in elements: Q (f32) and K rows DP + 8 (f32 pairs of lanes
// 4g + t on banks 8g + 2t), f32 V rows DP + 4 (a column's rows 2t, 2t + 1
// on banks 8t + g, 8t + 4 + g), bf16 rows DP + 8 (words 4g + t / 8t + g/2)
__host__ __device__ constexpr int fp_qrow(int dp) { return dp + 8; }
__host__ __device__ constexpr int fp_krow(int dp) { return dp + 8; }
template <typename T>
__host__ __device__ constexpr int fp_vrow(int dp) {
  return sizeof(T) == 4 ? dp + 4 : dp + 8;
}
template <typename T>
__host__ __device__ constexpr size_t fp_stage_bytes(int dp) {
  return static_cast<size_t>(fp_bk(dp)) * (fp_krow(dp) + fp_vrow<T>(dp)) * sizeof(T);
}
// Q rows (f32), then two stages of a K and a V tile
template <typename T>
__host__ __device__ constexpr size_t fp_smem_bytes(int dp, int warps) {
  return static_cast<size_t>(16 * warps) * fp_qrow(dp) * 4 + 2 * fp_stage_bytes<T>(dp);
}

struct PrefillArgs {
  const void* q;
  long long q_row, q_head;
  const void* k;
  const void* v;
  long long kv_head, kv_row;
  void* out;
  int q_kind, out_kind, N, H, dh, n_past, n_qt, vec16;
  float c;  // 1/sqrt(Dh) * log2(e)
};

template <typename T>
__device__ __forceinline__ T elt_zero() {
  if constexpr (std::is_same<T, float>::value) return 0.0f;
  else return __float2bfloat16(0.0f);
}

// d += a . b, a and b split in three bf16 pieces (A fragments a[piece],
// B fragments b[piece]): the six piece products above 2^-24, small first.
__device__ __forceinline__ void mma_split3(float (&d)[4], const uint32_t (&a)[3][4], const uint32_t (&b)[3][2]) {
  mma_bf16(a[2], b[0][0], b[0][1], d);
  mma_bf16(a[1], b[1][0], b[1][1], d);
  mma_bf16(a[0], b[2][0], b[2][1], d);
  mma_bf16(a[1], b[0][0], b[0][1], d);
  mma_bf16(a[0], b[1][0], b[1][1], d);
  mma_bf16(a[0], b[0][0], b[0][1], d);
}
// the same for a bf16 b (its own first piece): three products
__device__ __forceinline__ void mma_split3(float (&d)[4], const uint32_t (&a)[3][4], uint32_t b0, uint32_t b1) {
  mma_bf16(a[2], b0, b1, d);
  mma_bf16(a[1], b0, b1, d);
  mma_bf16(a[0], b0, b1, d);
}

// a bf16 pair as a B fragment register, lo in the low half
__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float load_q(const void* q, long long off, int kind) {
  if (kind == 0) return static_cast<const float*>(q)[off];
  if (kind == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[off]);
  return __half2float(static_cast<const __half*>(q)[off]);
}

// Stage key rows k0 .. k0 + BK - 1 of head h (rows at or past kend
// zero-filled) into a K and a V tile.
template <int DP, typename T>
__device__ __forceinline__ void stage_tile(const PrefillArgs& a, int h, int k0, int kend, T* kt, T* vt) {
  constexpr int BK = fp_bk(DP), RK = fp_krow(DP), RV = fp_vrow<T>(DP);
  constexpr int PER = 16 / sizeof(T);  // elements of a 16-byte copy
  const T* kb = static_cast<const T*>(a.k) + h * a.kv_head;
  const T* vb = static_cast<const T*>(a.v) + h * a.kv_head;
  const int nth = blockDim.x;
  if (a.vec16) {
    const int cpr = a.dh / PER;
    for (int i = threadIdx.x; i < BK * cpr; i += nth) {
      const int r = i / cpr, c = (i - r * cpr) * PER;
      const bool live = k0 + r < kend;
      const long long off = live ? (k0 + r) * a.kv_row + c : 0;
      cp_async16_z(kt + r * RK + c, kb + off, live ? 16 : 0);
      cp_async16_z(vt + r * RV + c, vb + off, live ? 16 : 0);
    }
  } else {
    constexpr int PER4 = 4 / sizeof(T);
    const int cpr = a.dh / PER4;
    for (int i = threadIdx.x; i < BK * cpr; i += nth) {
      const int r = i / cpr, c = (i - r * cpr) * PER4;
      const bool live = k0 + r < kend;
      const long long off = live ? (k0 + r) * a.kv_row + c : 0;
      cp_async4_z(kt + r * RK + c, kb + off, live ? 4 : 0);
      cp_async4_z(vt + r * RV + c, vb + off, live ? 4 : 0);
    }
  }
}

// The B fragments of a K tile for keys 8j..8j+7 and dims d0..d0+15 (f32:
// split in three pieces) and of a V tile for keys 16kk..16kk+15 and dims
// 8n..8n+7: lane 4g + t holds rows (k) 2t, 2t + 1 and 2t + 8, 2t + 9 of
// column (n) g.
__device__ __forceinline__ void k_frag(const float* kr, uint32_t (&b)[3][2]) {
  const float2 x0 = *reinterpret_cast<const float2*>(kr), x1 = *reinterpret_cast<const float2*>(kr + 8);
  split3(x0.x, x0.y, b[0][0], b[1][0], b[2][0]);
  split3(x1.x, x1.y, b[0][1], b[1][1], b[2][1]);
}
__device__ __forceinline__ void v_frag(const float* vt, int rv, uint32_t (&b)[3][2]) {
  split3(vt[0], vt[rv], b[0][0], b[1][0], b[2][0]);
  split3(vt[8 * rv], vt[9 * rv], b[0][1], b[1][1], b[2][1]);
}

template <int DP, typename T>
__global__ void __launch_bounds__(32 * FP_MAX_WARPS) flash_prefill_kernel(const PrefillArgs a) {
  constexpr int BK = fp_bk(DP), NT = BK / 8, NK = BK / 16, ND = DP / 8, QS = fp_qrow(DP);
  constexpr int RK = fp_krow(DP), RV = fp_vrow<T>(DP), KT = BK * RK, ST = BK * (RK + RV);
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32, BQ = 16 * warps;
  float* qs = reinterpret_cast<float*>(smem);
  T* tiles = reinterpret_cast<T*>(smem + static_cast<size_t>(BQ) * QS * 4);  // [stage][K [BK][RK], V [BK][RV]]

  const int h = blockIdx.x % a.H;
  const int qt = a.n_qt - 1 - blockIdx.x / a.H;
  const int q0 = qt * BQ, qn = min(BQ, a.N - q0);
  const int kend = a.n_past + q0 + qn;  // keys 0 .. kend - 1 are read
  const int n_kt = (kend + BK - 1) / BK;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  // pad columns of K and V (never copied) are zeros in both stages
  if (a.dh < DP) {
    const int pad = DP - a.dh;
    for (int i = tid; i < 4 * BK * pad; i += blockDim.x) {
      const int r = i / pad, c = a.dh + i - r * pad;  // row r of the 4 * BK rows: [stage][K, V][BK]
      const int stage = r / (2 * BK), v = (r / BK) & 1, row = r % BK;
      tiles[stage * ST + (v ? KT + row * RV : row * RK) + c] = elt_zero<T>();
    }
  }
  stage_tile<DP, T>(a, h, 0, kend, tiles, tiles + KT);
  cp_async_commit();
  for (int i = tid; i < BQ * DP; i += blockDim.x) {
    const int r = i / DP, d = i - r * DP;
    qs[r * QS + d] = (q0 + r < a.N && d < a.dh) ? load_q(a.q, (q0 + r) * a.q_row + h * a.q_head + d, a.q_kind)
                                                 : 0.0f;
  }

  // this warp's rows and their limits (rows past N take the last row's)
  const int rw0 = q0 + 16 * w;
  const bool has_rows = rw0 < a.N;
  const int lim0 = a.n_past + min(rw0 + g, a.N - 1), lim1 = a.n_past + min(rw0 + g + 8, a.N - 1);
  const int lim_max = a.n_past + min(rw0 + 15, a.N - 1);
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const T* ktile = tiles + (kt & 1) * ST;
    const T* vtile = ktile + KT;
    if (kt + 1 < n_kt) {
      T* nk = tiles + ((kt + 1) & 1) * ST;
      stage_tile<DP, T>(a, h, (kt + 1) * BK, kend, nk, nk + KT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * BK;
    if (has_rows && k0 <= lim_max) {
      // scores: each 16-dim k-step into a fresh accumulator, then f32 adds
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const float* q_g = qs + (16 * w + g) * QS + 2 * t;
      const float* q_g8 = q_g + 8 * QS;
#pragma unroll
      for (int kb = 0; kb < DP / 16; ++kb) {
        const int d0 = 16 * kb;
        uint32_t qa[3][4];  // A fragments of Q's three pieces: rows g, g + 8; dims 2t, 2t + 1 and 2t + 8, 2t + 9
        const float2 x0 = *reinterpret_cast<const float2*>(q_g + d0), x1 = *reinterpret_cast<const float2*>(q_g8 + d0);
        const float2 x2 = *reinterpret_cast<const float2*>(q_g + d0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(q_g8 + d0 + 8);
        split3(x0.x, x0.y, qa[0][0], qa[1][0], qa[2][0]);
        split3(x1.x, x1.y, qa[0][1], qa[1][1], qa[2][1]);
        split3(x2.x, x2.y, qa[0][2], qa[1][2], qa[2][2]);
        split3(x3.x, x3.y, qa[0][3], qa[1][3], qa[2][3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const T* kr = ktile + (8 * j + g) * RK + d0 + 2 * t;
          if constexpr (std::is_same<T, float>::value) {
            uint32_t kb3[3][2];
            k_frag(kr, kb3);
            mma_split3(acc, qa, kb3);
          } else {
            mma_split3(acc, qa, *reinterpret_cast<const uint32_t*>(kr), *reinterpret_cast<const uint32_t*>(kr + 8));
          }
          s[j][0] += acc[0];
          s[j][1] += acc[1];
          s[j][2] += acc[2];
          s[j][3] += acc[3];
        }
      }
      // scale (log2 units), mask across the diagonal, online softmax
      const bool masked = k0 + BK - 1 > a.n_past + rw0;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          float x = s[j][e] * a.c;
          if (masked && key > (e < 2 ? lim0 : lim1)) x = -INFINITY;
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ms0 = mn0 == -INFINITY ? 0.0f : mn0, ms1 = mn1 == -INFINITY ? 0.0f : mn1;
      const float al0 = exp2f(m0 - ms0), al1 = exp2f(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2f(s[j][0] - ms0);
        s[j][1] = exp2f(s[j][1] - ms0);
        s[j][2] = exp2f(s[j][2] - ms1);
        s[j][3] = exp2f(s[j][3] - ms1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      // A fragments of P's pieces over keys 16kk..16kk+15: n-tiles 2kk, 2kk + 1
      uint32_t pa[NK][3][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        split3(s[2 * kk][0], s[2 * kk][1], pa[kk][0][0], pa[kk][1][0], pa[kk][2][0]);
        split3(s[2 * kk][2], s[2 * kk][3], pa[kk][0][1], pa[kk][1][1], pa[kk][2][1]);
        split3(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[kk][0][2], pa[kk][1][2], pa[kk][2][2]);
        split3(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[kk][0][3], pa[kk][1][3], pa[kk][2][3]);
      }
      // P . V: each 16-key k-step into a fresh accumulator, the tile's sum
      // into the running output with the rescale
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const T* vr = vtile + (16 * kk + 2 * t) * RV + 8 * n + g;
          if constexpr (std::is_same<T, float>::value) {
            uint32_t vb3[3][2];
            v_frag(vr, RV, vb3);
            mma_split3(acc, pa[kk], vb3);
          } else {
            mma_split3(acc, pa[kk], bf16_pair(vr[0], vr[RV]), bf16_pair(vr[8 * RV], vr[9 * RV]));
          }
          pv[0] += acc[0];
          pv[1] += acc[1];
          pv[2] += acc[2];
          pv[3] += acc[3];
        }
        o[n][0] = fmaf(o[n][0], al0, pv[0]);
        o[n][1] = fmaf(o[n][1], al0, pv[1]);
        o[n][2] = fmaf(o[n][2], al1, pv[2]);
        o[n][3] = fmaf(o[n][3], al1, pv[3]);
      }
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

  if (!has_rows) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = rw0 + g + 8 * half;
    if (row >= a.N) continue;
    const float l = half ? l1 : l0;
    const size_t base = (static_cast<size_t>(row) * a.H + h) * a.dh;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = 8 * i + 2 * t;
      if (d >= a.dh) continue;
      const float x0 = o[i][2 * half] / l, x1 = o[i][2 * half + 1] / l;
      if (a.out_kind == 0) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + d) = make_float2(x0, x1);
      } else if (a.out_kind == 1) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + base + d) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<__half2*>(static_cast<__half*>(a.out) + base + d) = __floats2half2_rn(x0, x1);
      }
    }
  }
}

template <int DP, typename T>
int launch_prefill(const PrefillArgs& a, int warps, cudaStream_t s) {
  const size_t smem = fp_smem_bytes<T>(DP, warps);
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_prefill_kernel<DP, T><<<a.n_qt * a.H, 32 * warps, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_prefill_dp(const PrefillArgs& a, int dp, int warps, cudaStream_t s) {
  switch (dp) {
    case 64: return launch_prefill<64, T>(a, warps, s);
    case 128: return launch_prefill<128, T>(a, warps, s);
    case 256: return launch_prefill<256, T>(a, warps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool prefill_dp_ok(int dh, int dp) {
  return dh >= 2 && dh % 2 == 0 && dh <= dp && (dp == 64 || dp == 128 || dp == 256) && (dp == 64 || dh > dp / 2);
}

}  // namespace

// One causal prefill attention launch (see the note above): q [N, H, dh]
// (row and head strides q_row, q_head in elements, unit dim stride), K and
// V planes [H, >= n_past + N, dh] (head and row strides kv_head, kv_row),
// out [N, H, dh] contiguous; dp the padded head dim (64, 128 or 256, the
// least that holds dh), warps 1, 2 or 4 (ops/attention.flash_prefill_plan);
// vec16: rows and planes allow 16-byte copies.
extern "C" int flash_prefill(const void* q, long long q_row, long long q_head, int q_kind, const void* k,
                             const void* v, long long kv_head, long long kv_row, int kv_kind, void* out,
                             int out_kind, int N, int H, int dh, int n_past, int dp, int warps, int vec16,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || n_past < 0 || !prefill_dp_ok(dh, dp) || warps < 1 || warps > FP_MAX_WARPS ||
      (warps & (warps - 1)) || q_kind < 0 || q_kind > 2 || out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  PrefillArgs a{q, q_row, q_head, k, v, kv_head, kv_row, out, q_kind, out_kind, N, H, dh, n_past,
                (N + 16 * warps - 1) / (16 * warps), vec16, scale * FP_LOG2E};
  switch (kv_kind) {
    case 0: return launch_prefill_dp<float>(a, dp, warps, s);
    case 1: return launch_prefill_dp<__nv_bfloat16>(a, dp, warps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of a launch (ops/attention.flash_prefill_plan
// mirrors it), -1 for bad arguments.
extern "C" int flash_prefill_smem_bytes(int dp, int kv_kind, int warps) {
  if ((dp != 64 && dp != 128 && dp != 256) || kv_kind < 0 || kv_kind > 1 || warps < 1 || warps > FP_MAX_WARPS)
    return -1;
  return static_cast<int>(kv_kind == 0 ? fp_smem_bytes<float>(dp, warps) : fp_smem_bytes<__nv_bfloat16>(dp, warps));
}
