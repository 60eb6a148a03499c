// Multi-head attention on the (B, N, H*D) layout: the Hopper port of
// panoptikon_tpu/ops/vit_attention.py::mha (kernel _attn_kernel) and ::mha_qkv
// (kernel _attn_qkv_kernel). One kernel serves both: it reads q, k and v
// through base pointers and a row stride, so it takes three (B, N, H*D)
// tensors (mha, row stride H*D) or the unsplit (B, N, 3*H*D) output of the
// fused qkv projection (mha_qkv, row stride 3*H*D, q | k | v at offsets 0,
// H*D and 2*H*D), with no split copies.
//
// Modes, which differ by one mask on the logits l = (q . k) * D^-0.5:
//   self (N_q == N_kv), cross (N_q != N_kv),
//   causal: l = -inf where key > query,
//   key-padding mask: l = l - 1e9 where the key is invalid (additive, so a
//   fully masked row softmaxes to uniform and never to NaN).
// Softmax runs in f32 in the reference's order: m = max l, e = exp(l - m),
// s = sum e, p = e / s; p is rounded to V's dtype before the AV product when
// D >= 32, and stays f32 below that (the reference computes head dims under
// 32 in f32); AV accumulates in f32. The output is in q's dtype, or, for
// mha_qkv with a static scale s, int8 quantized from the f32 accumulator:
// sx = max(s / 127, 1e-12), code = clip(rint(acc / sx), -127, 127), with a
// correctly rounded division and no FMA contraction, so the plain PyTorch
// version reproduces it.
//
// One block per (batch, head, 16-query block), four warps of four query
// rows each. Keys and values stream through shared memory in chunks of 64
// (stored as f32, K rows padded by one word against bank conflicts), so any
// N_kv works, whisper's 1500 included. A lane owns keys for the logits
// (lane, lane + 32) and output dims (lane, lane + 32, ...) for AV; each
// probability reaches the other lanes by a warp shuffle. Three passes over
// the keys (max, sum, AV) reproduce the reference's arithmetic instead of an
// online softmax; when N_kv fits one chunk, K is loaded once for all three.
//
// What bounds it on an H100: not the bytes (q/k/v in and the output out,
// 8 bytes per head element at bf16, a few percent of its time at the
// ViT-B/32 shape) but the f32 CUDA-core arithmetic: three passes of q.k and
// one of p.V, each FMA reading one operand from shared memory, with 16-row
// query blocks that pad N = 50 to 64. Tensor-core (mma/wgmma) tiles and
// one pass over the logits are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQBlock = 16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kQBlock / kWarps;
constexpr int kKeyChunk = 64;
constexpr int kMaxD = 128;
constexpr int kDimsPerLane = kMaxD / 32;
constexpr int kKeysPerLane = kKeyChunk / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// q, k, v: element (b, i, head, c) at b * n * ld + i * ld + head * d + c,
// with n = nq for q and nkv for k and v. out: (b, nq, h * d) contiguous, in
// T, or int8 (O = int8_t) at the static scale *out_scale.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) mha_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, O* __restrict__ out, int ld, int nq, int nkv,
    int h, int d, int causal, float scale, const float* __restrict__ out_scale) {
  extern __shared__ float sm[];
  float* qs = sm;                          // [kQBlock][d]
  float* ks = qs + kQBlock * d;            // [kKeyChunk][d + 1]
  float* vs = ks + kKeyChunk * (d + 1);    // [kKeyChunk][d]

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int i0 = blockIdx.x * kQBlock;
  const int hd = h * d;
  const T* qb = q + static_cast<size_t>(b) * nq * ld + head * d;
  const T* kb = k + static_cast<size_t>(b) * nkv * ld + head * d;
  const T* vb = v + static_cast<size_t>(b) * nkv * ld + head * d;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * nkv : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (nkv + kKeyChunk - 1) / kKeyChunk;
  const bool round_p = d >= 32;

  for (int e = threadIdx.x; e < kQBlock * d; e += kThreads) {
    const int r = e / d;
    qs[e] = i0 + r < nq ? to_f(qb[static_cast<size_t>(i0 + r) * ld + e % d]) : 0.0f;
  }

  // Logit of (query row r of this block, key j of the current chunk).
  auto logit = [&](int r, int jj, int j0) -> float {
    const float* qr = qs + r * d;
    const float* kr = ks + jj * (d + 1);
    float acc = 0.0f;
    for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
    float l = acc * scale;
    const int j = j0 + jj;
    if (causal && j > i0 + r) l = -INFINITY;
    if (mb && mb[j] == 0) l = l - 1e9f;
    return l;
  };
  auto load_chunk = [&](int j0, bool with_v) {
    const int kc = min(kKeyChunk, nkv - j0);
    __syncthreads();  // the previous chunk (or the q staging) is done with
    for (int e = threadIdx.x; e < kc * d; e += kThreads) {
      const int r = e / d;
      const int c = e % d;
      const size_t src = static_cast<size_t>(j0 + r) * ld + c;
      ks[r * (d + 1) + c] = to_f(kb[src]);
      if (with_v) vs[e] = to_f(vb[src]);
    }
    __syncthreads();
  };

  float m[kRowsPerWarp];
  float s[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    s[rr] = 0.0f;
#pragma unroll
    for (int t = 0; t < kDimsPerLane; ++t) acc[rr][t] = 0.0f;
  }

  // Pass 1: row max.
  for (int ch = 0; ch < chunks; ++ch) {
    const int j0 = ch * kKeyChunk;
    const int kc = min(kKeyChunk, nkv - j0);
    load_chunk(j0, chunks == 1);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      for (int jj = lane; jj < kc; jj += 32) m[rr] = fmaxf(m[rr], logit(r, jj, j0));
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m[rr] = fmaxf(m[rr], __shfl_xor_sync(0xffffffffu, m[rr], off));
    }
  }

  // Pass 2: sum of exp(l - m).
  for (int ch = 0; ch < chunks; ++ch) {
    const int j0 = ch * kKeyChunk;
    const int kc = min(kKeyChunk, nkv - j0);
    if (chunks > 1) load_chunk(j0, false);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      for (int jj = lane; jj < kc; jj += 32) s[rr] += expf(logit(r, jj, j0) - m[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[rr] += __shfl_xor_sync(0xffffffffu, s[rr], off);
    }
  }

  // Pass 3: p = e / s (rounded to V's dtype when D >= 32), then p @ V in f32.
  for (int ch = 0; ch < chunks; ++ch) {
    const int j0 = ch * kKeyChunk;
    const int kc = min(kKeyChunk, nkv - j0);
    if (chunks > 1) load_chunk(j0, true);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float p[kKeysPerLane];
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        const int jj = lane + 32 * t;
        float pv = 0.0f;
        if (jj < kc) {
          pv = expf(logit(r, jj, j0) - m[rr]) / s[rr];
          if (round_p) pv = to_f(from_f<T>(pv));
        }
        p[t] = pv;
      }
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        for (int src = 0; src < 32 && 32 * t + src < kc; ++src) {
          const int jj = 32 * t + src;
          const float pj = __shfl_sync(0xffffffffu, p[t], src);
#pragma unroll
          for (int u = 0; u < kDimsPerLane; ++u) {
            const int c = lane + 32 * u;
            if (c < d) acc[rr][u] = fmaf(pj, vs[jj * d + c], acc[rr][u]);
          }
        }
      }
    }
  }

  float sx = 1.0f;
  if constexpr (std::is_same<O, int8_t>::value) {
    sx = fmaxf(__fdiv_rn(*out_scale, 127.0f), 1e-12f);
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = i0 + warp * kRowsPerWarp + rr;
    if (i >= nq) continue;
    O* dst = out + static_cast<size_t>(b) * nq * hd + static_cast<size_t>(i) * hd + head * d;
#pragma unroll
    for (int t = 0; t < kDimsPerLane; ++t) {
      const int c = lane + 32 * t;
      if (c >= d) continue;
      if constexpr (std::is_same<O, int8_t>::value) {
        const int code = __float2int_rn(__fdiv_rn(acc[rr][t], sx));
        dst[c] = static_cast<int8_t>(min(max(code, -127), 127));
      } else {
        dst[c] = from_f<T>(acc[rr][t]);
      }
    }
  }
}

template <typename T, typename O>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           int ld, int b, int nq, int nkv, int h, int d, int causal, float scale,
           const void* out_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kQBlock) * d + kKeyChunk * (d + 1) + kKeyChunk * d);
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kQBlock - 1) / kQBlock, h, b);
  mha_kernel<T, O><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<O*>(out), ld, nq, nkv, h, d, causal,
      scale, static_cast<const float*>(out_scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (b, nq, h, d), k and v (b, nkv, h, d), contiguous, f32 (bf16 == 0) or
// bf16 (bf16 == 1); mask (b, nkv) uint8, nonzero = valid key, or null.
// out (b, nq, h, d) in the input dtype. Requires 1 <= d <= 128.
int pk_mha(const void* q, const void* k, const void* v, const void* mask, void* out,
           int b, int nq, int nkv, int h, int d, int causal, int bf16, float scale,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ld = h * d;
  if (bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, mask, out, ld, b, nq, nkv, h, d,
                                                causal, scale, nullptr, st);
  }
  return launch<float, float>(q, k, v, mask, out, ld, b, nq, nkv, h, d, causal, scale,
                              nullptr, st);
}

// qkv (b, n, 3 * h * d) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1).
// out (b, n, h * d): int8 at the static scale out_scale (one f32 on the
// device) when out_scale is not null, else in the input dtype.
// Requires 1 <= d <= 128.
int pk_mha_qkv(const void* qkv, void* out, const void* out_scale, int b, int n, int h,
               int d, int causal, int bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = h * d;
  const int ld = 3 * hd;
  const size_t es = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* base = static_cast<const char*>(qkv);
  const void* k = base + hd * es;
  const void* v = base + 2 * hd * es;
  if (bf16) {
    if (out_scale) {
      return launch<__nv_bfloat16, int8_t>(qkv, k, v, nullptr, out, ld, b, n, n, h, d, causal,
                                           scale, out_scale, st);
    }
    return launch<__nv_bfloat16, __nv_bfloat16>(qkv, k, v, nullptr, out, ld, b, n, n, h, d,
                                                causal, scale, nullptr, st);
  }
  if (out_scale) {
    return launch<float, int8_t>(qkv, k, v, nullptr, out, ld, b, n, n, h, d, causal, scale,
                                 out_scale, st);
  }
  return launch<float, float>(qkv, k, v, nullptr, out, ld, b, n, n, h, d, causal, scale,
                              nullptr, st);
}

}  // extern "C"
