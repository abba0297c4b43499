// Warp-level tensor-core pieces for sm_90a (field_grad.cuh): ldmatrix and
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators.
//
// Fragments of one m16n8k16 product D[16x8] += A[16x16] B[16x8], for lane l
// with g = l / 4 and t = l % 4 (two bf16 per 32-bit register, the lower
// column or k index in the low half):
//   A: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B: b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   D: d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t], d3 = D[g+8][2t+1]
// ldmatrix loads 8x8 b16 matrices whose row addresses lanes 8i..8i+7 give for
// matrix i (16-byte aligned rows): register i of lane l holds row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1, or with .trans the transposed matrix's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nf {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// two matrices: the addresses of lanes 0-15 are read
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}

// d += a b on the tensor cores (exact bf16 products, f32 sums)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace nf
