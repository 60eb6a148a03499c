// Fused LayerNorm -> static-scale int8 quantize: the Hopper port of
// panoptikon_tpu/ops/ln_quant.py::ln_quant_2d (kernel _kernel).
//
// What it computes, per row x of an (R, W) activation:
//   mean = sum(x) / W,  var = sum((x - mean)^2) / W      f32, centered
//   y    = (x - mean) * rsqrt(var + 1e-5) * gamma + beta  f32
//   code = clip(rint(y / sx), -127, 127), sx = max(s / 127, 1e-12)
// with s the calibrated per-tensor absmax (one f32 on the device, so the
// caller never reads it back). The variance is the reference's two-pass
// centered form, not E[x^2] - mean^2 and not Welford, which round
// differently. The epilogue uses no FMA contraction (__fmul_rn, __fadd_rn),
// the quotient y / sx rounded as __fdiv_rn rounds it, and __float2int_rn
// (half to even), so the plain PyTorch version reproduces it up to the
// order of the two sums.
//
// What bounds it on an H100: the bytes. It reads each row once (2 bytes an
// element in bf16) and writes one int8 per element; the arithmetic is a few
// operations an element. At (256 * 257, 1024) that is 202 MB, 0.0603 ms at
// 3.35 TB/s. Its first form (one 2-byte load, one 1-byte store and one
// __fdiv_rn an element, gamma and beta read per element per row) took
// 0.2065-0.2079 ms there. This form:
// - one warp a row, the row in registers: lane l holds the groups of 8
//   elements l, l + 32, ... (kPer of them, the smallest instantiated count
//   that covers W / 8), loaded 16 bytes at a time (8 bf16, or 2 x 4 f32)
//   and stored as 8 codes at once, so every load and store of the warp
//   covers consecutive addresses;
// - gamma and beta go into shared memory once a block, laid out so that the
//   warp's 16-byte reads of them are free of bank conflicts; each warp walks
//   rows with a stride of the grid, which holds as many blocks as the card
//   keeps resident (so each block's copy of gamma and beta serves many rows);
// - sx is one number for the tensor, so the division is y * (1 / sx) and
//   one correction by the exact FMA remainder (quant_code in common.cuh),
//   where __fdiv_rn takes a reciprocal and a range check an element;
//   pk_check_quant_code holds the code equal to __fdiv_rn's over every
//   float y.
// It needs W % 8 == 0 (every transformer width) and W <= 2048, with a
// ragged R and no padding. Measured at (256 * 257, 1024) bf16 on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py): 0.078-0.079 ms, 76-77 % of the
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;      // elements a lane loads and stores at once
constexpr int kMaxGroups = 8;  // groups a lane holds: W <= 32 * 8 * 8

__device__ __forceinline__ void load_group(const __nv_bfloat16* x, float (&v)[kGroup]) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(x));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load_group(const float* x, float (&v)[kGroup]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x));
  const float4 b = __ldg(reinterpret_cast<const float4*>(x) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Four codes (each in [-127, 127]) packed into a word, the first lowest.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (static_cast<uint32_t>(d) << 24);
}

// Shared memory: float4 i of half h (elements 4 h .. 4 h + 3) of group g of
// gamma at gb[h * groups + g], of beta at gb[(2 + h) * groups + g].
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads) ln_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ act_scale, int8_t* __restrict__ out, int rows, int w) {
  extern __shared__ float4 gb[];
  const int groups = w / kGroup;
  for (int i = threadIdx.x; i < 4 * groups; i += kThreads) {
    const int part = i / groups;  // gamma halves 0, 1; beta halves 2, 3
    const float* src = (part < 2 ? gamma : beta) + kGroup * (i % groups) + 4 * (part & 1);
    gb[i] = *reinterpret_cast<const float4*>(src);
  }
  __syncthreads();
  const float sx = fmaxf(__fdiv_rn(*act_scale, 127.0f), 1e-12f);
  const float rcp = __frcp_rn(sx);
  const float wf = static_cast<float>(w);
  const int lane = threadIdx.x % 32;

  for (int row = blockIdx.x * kWarps + threadIdx.x / 32; row < rows; row += gridDim.x * kWarps) {
    const T* xr = x + static_cast<size_t>(row) * w;
    float v[kPer][kGroup];
    float sum = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int g = lane + 32 * p;
      if (g < groups) {
        load_group(xr + kGroup * g, v[p]);
      } else {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) v[p][k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) sum += v[p][k];
    }
    const float mean = __fdiv_rn(warp_sum(sum), wf);
    float sq = 0.0f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const bool in = lane + 32 * p < groups;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        v[p][k] = in ? __fsub_rn(v[p][k], mean) : 0.0f;
        sq = __fadd_rn(sq, __fmul_rn(v[p][k], v[p][k]));
      }
    }
    const float var = __fdiv_rn(warp_sum(sq), wf);
    const float r = rsqrtf(__fadd_rn(var, 1e-5f));
    int8_t* dst = out + static_cast<size_t>(row) * w;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int g = lane + 32 * p;
      if (g < groups) {
        const float4 g0 = gb[g], g1 = gb[groups + g];
        const float4 b0 = gb[2 * groups + g], b1 = gb[3 * groups + g];
        const float gg[kGroup] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bb[kGroup] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        int code[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[p][k], r), gg[k]), bb[k]);
          code[k] = quant_code(y, sx, rcp);
        }
        *reinterpret_cast<uint2*>(dst + kGroup * g) =
            make_uint2(pack4(code[0], code[1], code[2], code[3]),
                       pack4(code[4], code[5], code[6], code[7]));
      }
    }
  }
}

template <typename T, int kPer>
int launch(const void* x, const void* gamma, const void* beta, const void* act_scale,
           void* out, int rows, int w, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(w / kGroup) * sizeof(float4);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_quant_kernel<T, kPer>,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (rows + kWarps - 1) / kWarps;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  ln_quant_kernel<T, kPer><<<needed < resident ? needed : resident, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(act_scale),
      static_cast<int8_t*>(out), rows, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* gamma, const void* beta, const void* act_scale,
             void* out, int rows, int w, cudaStream_t stream) {
#define PK_LN_CASE(PER)                                                                  \
  case PER:                                                                              \
    return launch<T, PER>(x, gamma, beta, act_scale, out, rows, w, stream);
  switch ((w / kGroup + 31) / 32) {
    PK_LN_CASE(1)
    PK_LN_CASE(2)
    PK_LN_CASE(3)
    PK_LN_CASE(4)
    PK_LN_CASE(5)
    PK_LN_CASE(6)
    PK_LN_CASE(7)
    PK_LN_CASE(kMaxGroups)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PK_LN_CASE
}

// Counts the floats y (every bit pattern) whose quant_code(y, sx, 1 / sx)
// is not clip(__float2int_rn(__fdiv_rn(y, sx)), -127, 127), for
// sx = max(s[i] / 127, 1e-12).
__global__ void check_quant_code_kernel(const float* __restrict__ s,
                                        unsigned long long* __restrict__ mismatches) {
  const float sx = fmaxf(__fdiv_rn(s[blockIdx.y], 127.0f), 1e-12f);
  const float rcp = __frcp_rn(sx);
  unsigned long long bad = 0;
  for (unsigned long long bits = blockIdx.x * blockDim.x + threadIdx.x; bits < (1ull << 32);
       bits += gridDim.x * blockDim.x) {
    const float y = __uint_as_float(static_cast<uint32_t>(bits));
    const int want = min(max(__float2int_rn(__fdiv_rn(y, sx)), -127), 127);
    bad += quant_code(y, sx, rcp) != want;
  }
  if (bad) atomicAdd(mismatches + blockIdx.y, bad);
}

}  // namespace

extern "C" {

// x (rows, w) contiguous and 16-byte aligned, f32 (bf16 == 0) or bf16
// (bf16 == 1); gamma, beta (w,) f32, 16-byte aligned; act_scale one f32 on
// the device -> out (rows, w) int8, 8-byte aligned.
// Requires w % 8 == 0 and 8 <= w <= 2048.
int pk_ln_quant(const void* x, const void* gamma, const void* beta, const void* act_scale,
                void* out, int rows, int w, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w % kGroup || w < kGroup) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (bf16) return dispatch<__nv_bfloat16>(x, gamma, beta, act_scale, out, rows, w, st);
  return dispatch<float>(x, gamma, beta, act_scale, out, rows, w, st);
}

// mismatches[i] (zeroed by the caller) = the number of floats y whose
// kernel code at the calibrated absmax s[i] differs from the one a
// correctly rounded division gives.
int pk_check_quant_code(const float* s, int ns, unsigned long long* mismatches, void* stream) {
  check_quant_code_kernel<<<dim3(1024, ns), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      s, mismatches);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
