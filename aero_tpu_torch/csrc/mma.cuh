// Tensor-core and asynchronous-copy pieces of the bfloat16 kernels
// (local_attention_mma.cu, local_attention_bwd_mma.cu, lstm_mma.cu,
// ftb_mma.cu), as inline PTX for sm_90a.
//
// mma.sync.aligned.m16n8k16 with bfloat16 inputs and float32 sums; with
// g = lane / 4 and q = lane % 4 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), a thread holds
//   A (16 x 16, row-major): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..2q+1),
//                           a2 = (g, 2q+8..2q+9), a3 = (g+8, 2q+8..2q+9)
//   B (16 x 8):             b0 = (2q..2q+1, g), b1 = (2q+8..2q+9, g)
//   C, D (16 x 8, float32): c0, c1 = (g, 2q..2q+1), c2, c3 = (g+8, 2q..2q+1)
// and each 32-bit register packs two bfloat16, the lower index in the lower
// half.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace aero {

// d += a * b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 rounded to bfloat16 and packed, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (ex2.approx: 2 ulp, -inf -> +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy N bytes (4, 8 or 16, both addresses N-aligned) from global to
// shared memory without passing through registers; with valid false the
// N bytes of dst are filled with zeros and src is not read.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(N), "r"(valid ? N : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bfloat16 matrices, transposed: lanes 8i..8i+7 give the row
// addresses (16 bytes each, 16-aligned) of matrix i; r[i] receives the
// thread's B-fragment register of matrix i read column-wise, i.e. rows
// 2q..2q+1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// Four 8 x 8 bfloat16 matrices: lanes 8i..8i+7 give the row addresses
// (16 bytes each, 16-aligned) of matrix i; r[i] receives row g, columns
// 2q..2q+1 of matrix i. On a [n][k] tile that is the B fragment register
// that ldmatrix_x4_trans gives on the same values stored [k][n].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// two bfloat16 products, each rounded once to the nearest bfloat16
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&p);
}

}  // namespace aero
