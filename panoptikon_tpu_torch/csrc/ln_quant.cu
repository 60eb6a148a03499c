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
// a correctly rounded division and __float2int_rn (half to even), so the
// plain PyTorch version reproduces it up to the order of the two sums.
//
// One warp per row, the row held in registers: lane l holds elements
// l, l + 32, l + 64, ... (kPer of them, the smallest instantiated count that
// covers W: 40 a lane at W = 1280), so each load and store of the warp
// touches consecutive addresses. Ragged R and any W up to 32 * 64 need no
// padding: out-of-range elements are masked.
//
// What bounds it on an H100: the bytes. It reads each row once (2 bytes an
// element in bf16) and writes one int8 per element; the arithmetic is a few
// operations an element. At (256 * 257, 1024) that is 202 MB, about 60 us at
// 3.35 TB/s; the plain version makes about ten passes over f32 copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPer = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads) ln_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ act_scale, int8_t* __restrict__ out, int rows, int w) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * w;
  int8_t* dst = out + static_cast<size_t>(row) * w;
  const float wf = static_cast<float>(w);

  float v[kPer];
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int c = lane + 32 * t;
    v[t] = c < w ? to_f(xr[c]) : 0.0f;
    sum += v[t];
  }
  const float mean = __fdiv_rn(warp_sum(sum), wf);
  float sq = 0.0f;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int c = lane + 32 * t;
    v[t] = c < w ? __fsub_rn(v[t], mean) : 0.0f;
    sq = __fadd_rn(sq, __fmul_rn(v[t], v[t]));
  }
  const float var = __fdiv_rn(warp_sum(sq), wf);
  const float r = rsqrtf(__fadd_rn(var, 1e-5f));
  const float sx = fmaxf(__fdiv_rn(*act_scale, 127.0f), 1e-12f);
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int c = lane + 32 * t;
    if (c < w) {
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[t], r), gamma[c]), beta[c]);
      const int code = __float2int_rn(__fdiv_rn(y, sx));
      dst[c] = static_cast<int8_t>(min(max(code, -127), 127));
    }
  }
}

template <typename T, int kPer>
int launch(const void* x, const void* gamma, const void* beta, const void* act_scale,
           void* out, int rows, int w, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  ln_quant_kernel<T, kPer><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(act_scale),
      static_cast<int8_t*>(out), rows, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* gamma, const void* beta, const void* act_scale,
             void* out, int rows, int w, cudaStream_t stream) {
  const int per = (w + 31) / 32;
  if (per <= 8) return launch<T, 8>(x, gamma, beta, act_scale, out, rows, w, stream);
  if (per <= 16) return launch<T, 16>(x, gamma, beta, act_scale, out, rows, w, stream);
  if (per <= 24) return launch<T, 24>(x, gamma, beta, act_scale, out, rows, w, stream);
  if (per <= 32) return launch<T, 32>(x, gamma, beta, act_scale, out, rows, w, stream);
  if (per <= 40) return launch<T, 40>(x, gamma, beta, act_scale, out, rows, w, stream);
  if (per <= 48) return launch<T, 48>(x, gamma, beta, act_scale, out, rows, w, stream);
  if (per <= kMaxPer) return launch<T, kMaxPer>(x, gamma, beta, act_scale, out, rows, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x (rows, w) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); gamma, beta
// (w,) f32; act_scale one f32 on the device -> out (rows, w) int8.
// Requires 1 <= w <= 32 * 64.
int pk_ln_quant(const void* x, const void* gamma, const void* beta, const void* act_scale,
                void* out, int rows, int w, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (bf16) return dispatch<__nv_bfloat16>(x, gamma, beta, act_scale, out, rows, w, st);
  return dispatch<float>(x, gamma, beta, act_scale, out, rows, w, st);
}

}  // extern "C"
