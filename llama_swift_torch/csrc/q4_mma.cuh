// The int8 tensor-core pieces of the exact Q4_0 products of q4_matvec.cu
// (the multi-row product and the T layout's integer product, one kernel):
// the m16n8k32 u8 x s8 MMA whose K order is the codes' de-interleaved one
// (k < 16: the low nibble of packed byte k, k >= 16: the high nibble of
// byte k - 16), so that an A fragment is one 32-bit word of a weight
// block masked with 0x0F0F0F0F (or shifted right by 4 first) and a B
// fragment one 32-bit word of a row's codes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "q4_common.cuh"

namespace {

// D (16 x 8 s32) = A (16 x 32 u8, row-major) . B (32 x 8 s8, column-major)
// + C (16 x 8 s32), exact.  Fragments (lane = 4 g + t): a0 row g, k
// 4t..4t+3; a1 row g+8, k 4t..; a2 row g, k 16+4t..; a3 row g+8, k
// 16+4t..; b0 column g, k 4t..; b1 column g, k 16+4t..; c0/d0, c1/d1 row
// g, columns 2t, 2t+1; c2/d2, c3/d3 row g+8.
__device__ __forceinline__ void mma_u8s8(const uint32_t (&a)[4], uint32_t b0, uint32_t b1, const int (&c)[4],
                                         int (&d)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// Four 8x8 matrices of 16-bit elements from shared memory (ldmatrix):
// lanes 8m..8m+7 give the 16-byte row addresses of matrix m, and lane
// 4 g + t receives in r[m] the 32-bit word t of row g of matrix m: with
// a row a weight block's 16 bytes (or half of a block's 32 codes), word t
// of rows g and g + 8, as the MMA fragments take them.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A fragment of one weight block for rows g and g + 8 of a 16-row
// tile: wl and wh are word t (bytes 4t..4t+3) of the two rows' blocks.
__device__ __forceinline__ void a_fragment(uint32_t wl, uint32_t wh, uint32_t (&a)[4]) {
  a[0] = wl & 0x0F0F0F0Fu;
  a[1] = wh & 0x0F0F0F0Fu;
  a[2] = (wl >> 4) & 0x0F0F0F0Fu;
  a[3] = (wh >> 4) & 0x0F0F0F0Fu;
}

}  // namespace
