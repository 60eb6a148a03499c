// Fused epilogue of an int8 GEMM in the static-int8 CLIP block: one pass
// over the GEMM's int32 output that writes what the next operation reads.
//
// It replaces no TPU kernel: on the TPU, XLA fuses the same chain of
// elementwise operations into the GEMM's consumer. On the card, PyTorch runs
// each operation of the chain as its own full pass over the output (to f32,
// two scales, the bias, to bf16, the residual add, GELU, the quantize of the
// MLP's hidden), which moved about 34 GB a ViT-L/14 layer at 256 images.
//
// What it computes, per value acc of an (R, N) int32 output, with the
// per-tensor step sx of the GEMM's input, the per-channel weight scale sw
// and the bias b (f32, or none) of its column:
//   y = bf16((f32(acc) * sx) * sw + b)                   mode 0 (qkv)
//   x + y, in f32, rounded to bf16 (x bf16, (R, N))       mode 1 (out, proj)
//   h = bf16(gelu_tanh(f32(y))),                          mode 2 (fc)
//   code = clip(rint(f32(h) / s3), -127, 127) as int8
// with s3 the step of the next GEMM's input. These are the rounding points
// of the plain PyTorch chain (ops/int8_epilogue.py): each multiply and add
// is one __fmul_rn or __fadd_rn in the chain's order, so no FMA contraction
// moves a rounding, and modes 0 and 1 are bit-equal to it. GELU is PyTorch's
// tanh form with the full-precision tanhf; the quotient is rounded as
// __fdiv_rn rounds it (quant_code in common.cuh), then half to even.
//
// What bounds it on an H100: the bytes. At 256 images of ViT-L/14 (R 65,792)
// the four epilogues of a layer read 2,426 MB of int32 (and 269 MB of
// residual) and write 943 MB: 1.09 ms a layer at 3.35 TB/s. The design:
// - a warp covers 256 columns of a row: lane l reads columns 4 l .. 4 l + 3
//   and 128 + 4 l .. 128 + 4 l + 3, 16 bytes of int32 each, so each of the
//   warp's loads covers 512 consecutive bytes, and its stores 256 (bf16) or
//   128 (int8) consecutive bytes;
// - a block is 8 warps on one tile of 256 columns; each lane keeps its 8
//   columns' sw and b in registers for every row it visits, walking the rows
//   with a stride of the grid, two rows' loads in flight before it computes;
// - the grid is the shape's column tiles times as many row blocks as fill
//   the card's resident blocks (rows permitting), so the 4,928 rows of the
//   text tower and the 65,792 of the image build both fill 132 SMs.
// It takes N % 4 == 0, a row stride of the output (ops/exact.int_mm cuts a
// padded output back to [:m, :n]) that is a multiple of 4, and 16-byte
// aligned operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 4;                  // values a lane loads at once (16 bytes of int32)
constexpr int kHalf = 32 * kVec;         // columns of one of a warp's loads
constexpr int kTile = 2 * kHalf;         // columns of a block's tile
constexpr int kRows = 2;                 // rows a warp loads before it computes

enum Mode { kBf16 = 0, kResidual = 1, kGeluQuant = 2 };

// GELU's tanh form, as PyTorch's CUDA kernel writes it: kBeta is
// M_SQRT2 * M_2_SQRTPI * 0.5 in double, then f32.
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fadd_rn(x, __fmul_rn(kKappa, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

__device__ __forceinline__ uint32_t pack_codes(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (static_cast<uint32_t>(d) << 24);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) int8_epilogue_kernel(
    const int32_t* __restrict__ acc, int ld, const float* __restrict__ step,
    const float* __restrict__ sw, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ residual, const float* __restrict__ out_step,
    void* __restrict__ out, int rows, int n) {
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kTile + kVec * lane;
  bool in[2];
  float s[2][kVec], b[2][kVec];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = col0 + h * kHalf;
    in[h] = c < n;
    const float4 sv = in[h] ? __ldg(reinterpret_cast<const float4*>(sw + c)) : make_float4(0, 0, 0, 0);
    const float4 bv = in[h] && bias ? __ldg(reinterpret_cast<const float4*>(bias + c))
                                    : make_float4(0, 0, 0, 0);
    s[h][0] = sv.x, s[h][1] = sv.y, s[h][2] = sv.z, s[h][3] = sv.w;
    b[h][0] = bv.x, b[h][1] = bv.y, b[h][2] = bv.z, b[h][3] = bv.w;
  }
  if (!in[0]) return;
  const float sx = *step;
  float qs = 1.0f, rcp = 1.0f;
  if (kMode == kGeluQuant) {
    qs = *out_step;
    rcp = __frcp_rn(qs);
  }
  const int stride = gridDim.y * kWarps;

  for (int row = blockIdx.y * kWarps + threadIdx.x / 32; row < rows; row += kRows * stride) {
    int4 a[kRows][2];
    uint2 x[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = row + r * stride;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + h * kHalf;
        if (rr < rows && in[h]) {
          a[r][h] = __ldcs(reinterpret_cast<const int4*>(acc + static_cast<size_t>(rr) * ld + c));
          if (kMode == kResidual) {
            x[r][h] = __ldcs(reinterpret_cast<const uint2*>(residual + static_cast<size_t>(rr) * n + c));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rr = row + r * stride;
      if (rr >= rows) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!in[h]) continue;
        const int c = col0 + h * kHalf;
        const int av[kVec] = {a[r][h].x, a[r][h].y, a[r][h].z, a[r][h].w};
        float y[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          float v = __fmul_rn(__fmul_rn(__int2float_rn(av[k]), sx), s[h][k]);
          if (bias) v = __fadd_rn(v, b[h][k]);
          y[k] = __bfloat162float(__float2bfloat16_rn(v));
        }
        const size_t o = static_cast<size_t>(rr) * n + c;
        if (kMode == kGeluQuant) {
          int code[kVec];
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const float hk = __bfloat162float(__float2bfloat16_rn(gelu_tanh(y[k])));
            code[k] = quant_code(hk, qs, rcp);
          }
          reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o)[0] =
              pack_codes(code[0], code[1], code[2], code[3]);
        } else {
          if (kMode == kResidual) {
            const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&x[r][h]);
#pragma unroll
            for (int k = 0; k < kVec / 2; ++k) {
              const float2 f = __bfloat1622float2(xv[k]);
              y[2 * k] = __fadd_rn(f.x, y[2 * k]);
              y[2 * k + 1] = __fadd_rn(f.y, y[2 * k + 1]);
            }
          }
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) =
              make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
        }
      }
    }
  }
}

// The card's resident blocks of one mode's kernel (SMs times blocks an SM
// holds), asked of the driver once a process: the grid takes it at every
// launch. 0 if the driver could not say.
template <int kMode>
int resident_blocks() {
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_epilogue_kernel<kMode>,
                                                      kThreads, 0) != cudaSuccess) {
      return 0;
    }
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  return resident;
}

template <int kMode>
int launch(const void* acc, int ld, const void* step, const void* sw, const void* bias,
           const void* residual, const void* out_step, void* out, int rows, int n,
           cudaStream_t stream) {
  const int resident = resident_blocks<kMode>();
  if (resident == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tiles = (n + kTile - 1) / kTile;
  const int row_blocks = (rows + kWarps - 1) / kWarps;
  int by = resident / tiles;
  by = by < 1 ? 1 : by;
  by = by < row_blocks ? by : row_blocks;
  by = by < 65535 ? by : 65535;
  int8_epilogue_kernel<kMode><<<dim3(tiles, by), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(acc), ld, static_cast<const float*>(step),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(residual), static_cast<const float*>(out_step), out,
      rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acc (rows, n) int32 with row stride ld (elements), 16-byte aligned; step
// and out_step one f32 each on the device; sw (n,) f32 and bias (n,) f32 or
// null, 16-byte aligned; residual (rows, n) bf16 contiguous, 8-byte aligned
// (mode 1 only) -> out (rows, n) contiguous: bf16 (modes 0, 1) or int8
// (mode 2, which reads out_step). Requires n % 4 == 0 and ld % 4 == 0.
int pk_int8_epilogue(const void* acc, int ld, const void* step, const void* sw,
                     const void* bias, const void* residual, const void* out_step, void* out,
                     int rows, int n, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % kVec || n < kVec || ld % kVec || ld < n) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  switch (mode) {
    case kBf16:
      return launch<kBf16>(acc, ld, step, sw, bias, residual, out_step, out, rows, n, st);
    case kResidual:
      return launch<kResidual>(acc, ld, step, sw, bias, residual, out_step, out, rows, n, st);
    case kGeluQuant:
      return launch<kGeluQuant>(acc, ld, step, sw, bias, residual, out_step, out, rows, n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
