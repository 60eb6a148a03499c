// Device helpers shared by the port's kernels: asynchronous copies into
// shared memory, ldmatrix fragment loads, the bf16 mma.sync tile product, and
// a correctly rounded division by a divisor whose reciprocal is computed once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 tiles of 16-bit elements (8 rows of 16 bytes each); lane l
// gives the row address of tile l / 8, and receives element pairs of
// row l / 4, as the mma fragments take them.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// a / b correctly rounded, given y = __frcp_rn(b): q = a * y is within an
// ulp of a / b, its remainder a - b * q is exact in one FMA, and one
// correction q + r * y rounds to the quotient (Markstein's theorem for a
// correctly rounded reciprocal). Three arithmetic instructions where
// __fdiv_rn takes a reciprocal of b and a range check each time. It holds
// while the remainder neither underflows nor overflows: in attention's
// softmax (2^-80 <= a <= 1 <= b, and a = 0) and in a static int8 quantize
// (quant_code). Below 2^-80 the remainder can underflow, so the softmax
// redoes such numerators with __fdiv_rn (div_rn_exact). pk_check_div_rn
// holds the two equal bit for bit over every float in [0, 1], and
// pk_check_quant_code holds quant_code against __fdiv_rn over every float.
constexpr float kDivRnMin = 0x1p-80f;

__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

__device__ __forceinline__ float div_rn_exact(float a, float b, float y) {
  return a > 0.0f && a < kDivRnMin ? __fdiv_rn(a, b) : div_rn(a, b, y);
}

// The static int8 code of y at step sx >= 1e-12 (rcp = __frcp_rn(sx)):
// clip(rint(y / sx), -127, 127) with the quotient rounded as __fdiv_rn
// rounds it, then half to even (__float2int_rn). Where |y * rcp| >= 256 the
// quotient is past the clamp whatever its last bit, and y may be infinite or
// huge, where the correction would overflow, so the uncorrected product
// decides; NaN gives 0 both ways. Where a code is not 0 (|y / sx| > 1/2, so
// |y| > 5e-13) the remainder is a normal float.
__device__ __forceinline__ int quant_code(float y, float sx, float rcp) {
  const float q = __fmul_rn(y, rcp);
  const int code = __float2int_rn(fabsf(q) < 256.0f ? div_rn(y, sx, rcp) : q);
  return min(max(code, -127), 127);
}

}  // namespace
