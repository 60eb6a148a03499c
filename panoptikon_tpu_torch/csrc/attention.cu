// Multi-head attention on the (B, N, H*D) layout: the Hopper port of
// panoptikon_tpu/ops/vit_attention.py::mha (kernel _attn_kernel) and ::mha_qkv
// (kernel _attn_qkv_kernel). Each of its two kernels serves both: it reads q,
// k and v through base pointers and a row stride, so it takes three (B, N, H*D)
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
// Two routes, chosen by the Python wrapper from the dtype and head dim:
//
// Tensor-core route (pk_mha_tc; bf16, 32 <= D <= 128, D % 16 == 0: every CLIP
// tower). One block per (64 query rows, head, batch row); each warp owns 16
// query rows as one m16n8k16 A tile, loaded into registers once by
// ldmatrix. K and V tiles of 64 keys stream through shared memory in bf16 by
// 16-byte cp.async, double-buffered (tile j+1 in flight while tile j
// computes), rows padded by 16 bytes so the 8 row addresses of an ldmatrix
// fall in 8 different bank quads. QK^T and P.V are mma.sync bf16 -> f32;
// P goes from the accumulator registers straight into the A operand of the
// P.V mma (the FlashAttention-2 register layout), V by ldmatrix.trans.
// The reference rounds p = e / s to bf16 from the whole row's max and sum;
// the usual one-pass FlashAttention form rounds the unnormalised
// exp(l - m_running) instead, which moves more of mha_qkv's int8 codes at
// ViT-L/14 than the 0.5 % the checks allow (a CPU test shows it). So the
// row max m and sum s come first, in one of two forms (mha_tc_kernel): the
// f32 logits kept in shared memory (one QK^T and one expf a logit; up to
// the wrapper's TC_LOGITS_MAX_KEYS), or a first pass with an online m and
// s whose logits the second pass recomputes (any N_kv). Either way p = expf(l - m) / s
// with expf and a correctly rounded division (div_rn: one correction of
// e * (1/s), bit for bit __fdiv_rn's), l = acc * scale by __fmul_rn so no
// FMA contraction. Padded keys (>= N_kv) are -inf and exactly 0 in p;
// causal key tiles past a block's last row are skipped, as is a warp's
// whole tile above its diagonal or past N_q.
//
// What bounds it on an H100: at ViT-L/14 (N = 257, D = 64) one call moves
// 0.47-0.54 GB (0.14-0.16 ms at 3.35 TB/s) and does 70 GFLOP of bf16
// tensor-core work (0.07 ms at 989 TFLOP/s), yet takes about 1.2 ms. Not
// the tensor cores: the f32 softmax on the CUDA cores (an expf, a division
// and the mask and max a logit; __fdiv_rn in place of div_rn takes 1.82
// ms, python3 -m panoptikon_tpu_torch.profiling --attention) and latency,
// since the logits form's 107 KB of shared memory a block leave 2 blocks
// (8 warps) an SM and the two-pass form's 158 registers 3. wgmma tiles, a
// producer warp for the loads and a cheaper exact softmax are next.
//
// CUDA-core route (pk_mha, pk_mha_qkv; f32, bf16 with D < 32 or D not a
// multiple of 16, and, for mha alone, bf16 with 128 < D <= 512, where the
// tests hold 2e-5 in f32 and the reference keeps p in f32 below 32). One
// block per (batch, head, 16-query block), four warps of four query rows
// each. Keys and values stream through shared memory in chunks (stored as
// f32, K rows padded by one word against bank conflicts), so any N_kv
// works, whisper's 1500 included. A lane owns keys for the logits (lane,
// lane + 32, ...) and output dims (lane, lane + 32, ...) for AV, so it
// holds D/32 accumulators a row; each probability reaches the other lanes
// by a warp shuffle. Three passes over the keys (max, sum, AV) reproduce
// the reference's arithmetic; when N_kv fits one chunk, K is loaded once
// for all three. Two instantiations (mha_kernel's kMaxD and kKeyChunk):
// D <= 128 with 64-key chunks (the q block and one K and one V chunk in
// f32 are at most 74 KB of shared memory), and 128 < D <= 512 with 32-key
// chunks (at most 162 KB at D 512, 120 KB at the captioner's decoder's D
// 384; 64 accumulators a lane, the key loop of the AV pass unrolled by 4).
// Its f32 FMAs, one operand read from shared memory each, bound it; the
// shapes it takes are off the towers' hot paths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kQBlock = 16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kQBlock / kWarps;
// The two instantiations of mha_kernel: (kMaxD, kKeyChunk).
constexpr int kNarrowD = 128;
constexpr int kNarrowChunk = 64;
constexpr int kWideD = 512;
constexpr int kWideChunk = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// q, k, v: element (b, i, head, c) at b * n * ld + i * ld + head * d + c,
// with n = nq for q and nkv for k and v. out: (b, nq, h * d) contiguous, in
// T, or int8 (O = int8_t) at the static scale *out_scale. d <= kMaxD.
template <typename T, typename O, int kMaxD, int kKeyChunk>
__global__ void __launch_bounds__(kThreads) mha_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, O* __restrict__ out, int ld, int nq, int nkv,
    int h, int d, int causal, float scale, const float* __restrict__ out_scale) {
  constexpr int kDimsPerLane = kMaxD / 32;
  constexpr int kKeysPerLane = kKeyChunk / 32;
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
        // Key src's probability times its V row, into this lane's dims.
        auto av = [&](int src) {
          const int jj = 32 * t + src;
          const float pj = __shfl_sync(0xffffffffu, p[t], src);
#pragma unroll
          for (int u = 0; u < kDimsPerLane; ++u) {
            const int c = lane + 32 * u;
            if (c < d) acc[rr][u] = fmaf(pj, vs[jj * d + c], acc[rr][u]);
          }
        };
        if constexpr (kMaxD > kNarrowD) {
          // 16 dims a lane: left to the compiler, this loop unrolled whole,
          // built several times slower and ran slower.
#pragma unroll 4
          for (int src = 0; src < 32 && 32 * t + src < kc; ++src) av(src);
        } else {
          for (int src = 0; src < 32 && 32 * t + src < kc; ++src) av(src);
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

template <typename T, typename O, int kMaxD = kNarrowD, int kKeyChunk = kNarrowChunk>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           int ld, int b, int nq, int nkv, int h, int d, int causal, float scale,
           const void* out_scale, cudaStream_t stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kQBlock) * d + kKeyChunk * (d + 1) + kKeyChunk * d);
  cudaError_t err = cudaFuncSetAttribute(mha_kernel<T, O, kMaxD, kKeyChunk>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kQBlock - 1) / kQBlock, h, b);
  mha_kernel<T, O, kMaxD, kKeyChunk><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<O*>(out), ld, nq, nkv, h, d, causal,
      scale, static_cast<const float*>(out_scale));
  return static_cast<int>(cudaGetLastError());
}

// mha's CUDA-core launch: the narrow instantiation up to D 128, the wide
// one above (it refuses D > 512).
template <typename T>
int launch_mha(const void* q, const void* k, const void* v, const void* mask, void* out,
               int ld, int b, int nq, int nkv, int h, int d, int causal, float scale,
               cudaStream_t stream) {
  if (d <= kNarrowD) {
    return launch<T, T>(q, k, v, mask, out, ld, b, nq, nkv, h, d, causal, scale, nullptr,
                        stream);
  }
  return launch<T, T, kWideD, kWideChunk>(q, k, v, mask, out, ld, b, nq, nkv, h, d, causal,
                                          scale, nullptr, stream);
}


// ---------------------------------------------------------------------------
// Tensor-core route.

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // keys per shared-memory tile
constexpr int kPad = 8;    // bf16 of padding per shared-memory row (16 bytes)

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

// Fragment coordinates (m16n8k16, lane = 4 g + t): an accumulator tile's
// element e of a lane is at row g + 8 (e / 2), column 2 t + e % 2.
//
// q, k, v: element (b, i, head, c) at b * n * ld + i * ld + head * D + c, as
// mha_kernel; 16-byte aligned base pointers and ld % 8 == 0. out: (b, nq,
// h * D) contiguous, bf16 or int8 (O = int8_t) at the static scale
// *out_scale.
//
// Two forms of the softmax, the same rounding of p (smem_logits picks):
// - smem_logits == 0, any N_kv: pass 1 streams K and keeps an online m and
//   s; pass 2 streams K and V, recomputes QK^T and forms p from it.
// - smem_logits == 1, when a warp's 16 x N_kv f32 logits fit in shared
//   memory: pass 1 streams K and stores each lane's logits (a lane reads
//   back only its own, as float4 at lane-consecutive addresses) and its row
//   max; then each lane turns its logits into e = expf(l - m) in place,
//   summing s; pass 2 streams V alone and forms p = e / s from them. One
//   QK^T and one expf a logit instead of two.
template <int D, int kWarps, typename O>
__global__ void __launch_bounds__(kWarps * 32) mha_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ mask, O* __restrict__ out, int ld, int nq, int nkv, int h,
    int causal, int smem_logits, float scale, const float* __restrict__ out_scale) {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "head dim");
  constexpr int kThreads = kWarps * 32;
  constexpr int kRows = 16 * kWarps;
  constexpr int kLds = D + kPad;
  constexpr int kTileElems = kTile * kLds;
  constexpr int kSteps = D / 16;     // k-steps of QK^T; dim pairs of P.V
  constexpr int kDimTiles = D / 8;   // n-tiles of the output
  constexpr int kChunks = D / 8;     // 16-byte chunks of a row
  constexpr int kKeyTiles = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kRows][kLds]
  bf16* ks = qs + kRows * kLds;              // [2][kTile][kLds]
  // V's double buffer: K's in the logits form (pass 2 reads no K).
  bf16* vs = smem_logits ? ks : ks + 2 * kTileElems;
  float4* lg = reinterpret_cast<float4*>(ks + (smem_logits ? 2 : 4) * kTileElems);

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int i0 = blockIdx.x * kRows;
  const bf16* qb = q + static_cast<size_t>(b) * nq * ld + head * D;
  const bf16* kb = k + static_cast<size_t>(b) * nkv * ld + head * D;
  const bf16* vb = v + static_cast<size_t>(b) * nkv * ld + head * D;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * nkv : nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int iw = i0 + 16 * warp;  // this warp's first query row
  int tiles = (nkv + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, (min(i0 + kRows, nq) - 1) / kTile + 1);
  const int steps = 2 * tiles;  // pass 1 over K, then pass 2 over V (and K)
  // Whether this warp has work in key tile j0: rows past N_q have none, and
  // a causal tile wholly above the warp's diagonal is -inf throughout.
  auto warp_has = [&](int j0) { return iw < nq && !(causal && j0 > iw + 15); };

  // Rows [row0, row0 + rows) of src into dst; rows >= limit are zeros.
  auto stage = [&](bf16* dst, const bf16* src, int row0, int rows, int limit) {
    for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = e % kChunks;
      const bool ok = row0 + r < limit;
      cp_async16(smem_u32(dst + r * kLds + c * 8),
                 src + static_cast<size_t>(ok ? row0 + r : 0) * ld + c * 8, ok ? 16 : 0);
    }
  };
  auto issue = [&](int step) {
    const int j0 = (step % tiles) * kTile;
    if (step < tiles || !smem_logits) stage(ks + (step & 1) * kTileElems, kb, j0, kTile, nkv);
    if (step >= tiles) stage(vs + (step & 1) * kTileElems, vb, j0, kTile, nkv);
  };

  stage(qs, qb, i0, kRows, nq);
  issue(0);
  cp_async_commit();

  uint32_t qf[kSteps][4];
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float s[2] = {0.0f, 0.0f};
  float o[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (st == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        ldmatrix_x4(qf[kk], smem_u32(qs + (16 * warp + (lane & 15)) * kLds + kk * 16 +
                                     (lane >> 4) * 8));
      }
    }
    const bool second = st >= tiles;
    const int tile = st % tiles;
    const int j0 = tile * kTile;
    float4* lgt = lg + tile * kKeyTiles * kThreads + threadIdx.x;  // [tile][n][thread]
    if (warp_has(j0)) {
      float sc[kKeyTiles][4];
      if (!(second && smem_logits)) {
        const bf16* kt = ks + (st & 1) * kTileElems;
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
          for (int np = 0; np < kKeyTiles / 2; ++np) {
            uint32_t r[4];
            ldmatrix_x4(r, smem_u32(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLds +
                                    kk * 16 + ((lane >> 3) & 1) * 8));
            mma_bf16(sc[2 * np], qf[kk], r[0], r[1]);
            mma_bf16(sc[2 * np + 1], qf[kk], r[2], r[3]);
          }
        }
        // Logits in the reference's order: scale after the product, then the
        // causal -inf, then the additive key mask; padded keys are -inf. A
        // tile that is wholly inside the keys, below the warp's diagonal and
        // unmasked only scales.
        if (j0 + kTile <= nkv && !(causal && j0 + kTile - 1 > iw) && !mb) {
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = __fmul_rn(sc[n][e], scale);
          }
        } else {
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = iw + g + 8 * (e >> 1);
              const int j = j0 + 8 * n + 2 * t + (e & 1);
              float l = __fmul_rn(sc[n][e], scale);
              if (j >= nkv || (causal && j > i)) {
                l = -INFINITY;
              } else if (mb && mb[j] == 0) {
                l = l - 1e9f;
              }
              sc[n][e] = l;
            }
          }
        }
      }
      if (!second && smem_logits) {
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) {
          lgt[n * kThreads] = make_float4(sc[n][0], sc[n][1], sc[n][2], sc[n][3]);
          m[0] = fmaxf(m[0], fmaxf(sc[n][0], sc[n][1]));
          m[1] = fmaxf(m[1], fmaxf(sc[n][2], sc[n][3]));
        }
      } else if (!second) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
            tmax = fmaxf(tmax, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
          }
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float mn = fmaxf(m[r], tmax);
          if (mn == -INFINITY) continue;  // nothing but -inf so far
          float ts = 0.0f;
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
            ts += expf(sc[n][2 * r] - mn);
            ts += expf(sc[n][2 * r + 1] - mn);
          }
          s[r] = s[r] * expf(m[r] - mn) + ts;
          m[r] = mn;
        }
      } else {
        // p = e / s, rounded to bf16, straight into the A operand of P.V.
        if (smem_logits) {
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
            const float4 e = lgt[n * kThreads];
            sc[n][0] = e.x;
            sc[n][1] = e.y;
            sc[n][2] = e.z;
            sc[n][3] = e.w;
          }
        } else {
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = expf(sc[n][e] - m[e >> 1]);
          }
        }
        // pa[n] packs row g's (e = 0, 1) and row g + 8's (e = 2, 3) p of
        // key n-tile n; pa[2 k] and pa[2 k + 1] are the A operand of key
        // step k (keys 16 k to 16 k + 15).
        const float y[2] = {__frcp_rn(s[0]), __frcp_rn(s[1])};
        bool tiny = false;
#pragma unroll
        for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) tiny |= sc[n][e] > 0.0f && sc[n][e] < kDivRnMin;
        }
        uint32_t pa[kKeyTiles][2];
        if (!__any_sync(0xffffffffu, tiny)) {
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
            pa[n][0] = pack_bf16(div_rn(sc[n][0], s[0], y[0]), div_rn(sc[n][1], s[0], y[0]));
            pa[n][1] = pack_bf16(div_rn(sc[n][2], s[1], y[1]), div_rn(sc[n][3], s[1], y[1]));
          }
        } else {  // rare: a p under 2^-80 / s
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
            pa[n][0] = pack_bf16(div_rn_exact(sc[n][0], s[0], y[0]),
                                 div_rn_exact(sc[n][1], s[0], y[0]));
            pa[n][1] = pack_bf16(div_rn_exact(sc[n][2], s[1], y[1]),
                                 div_rn_exact(sc[n][3], s[1], y[1]));
          }
        }
        const bf16* vt = vs + (st & 1) * kTileElems;
#pragma unroll
        for (int ks16 = 0; ks16 < kTile / 16; ++ks16) {
          const uint32_t a[4] = {pa[2 * ks16][0], pa[2 * ks16][1], pa[2 * ks16 + 1][0],
                                 pa[2 * ks16 + 1][1]};
#pragma unroll
          for (int dp = 0; dp < kSteps; ++dp) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, smem_u32(vt + (ks16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                   kLds +
                                               dp * 16 + (lane >> 4) * 8));
            mma_bf16(o[2 * dp], a, r[0], r[1]);
            mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
          }
        }
      }
    }
    if (st == tiles - 1) {
      if (smem_logits) {
        // The row max is exact in any order: the four lanes of a row agree
        // on it; then each lane's logits become e = expf(l - m), summed.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
        }
        for (int tl = 0; tl < tiles; ++tl) {
          if (!warp_has(tl * kTile)) continue;
          float4* lt = lg + tl * kKeyTiles * kThreads + threadIdx.x;
#pragma unroll
          for (int n = 0; n < kKeyTiles; ++n) {
            float4 e = lt[n * kThreads];
            e.x = expf(e.x - m[0]);
            e.y = expf(e.y - m[0]);
            e.z = expf(e.z - m[1]);
            e.w = expf(e.w - m[1]);
            s[0] += e.x;
            s[0] += e.y;
            s[1] += e.z;
            s[1] += e.w;
            lt[n * kThreads] = e;
          }
        }
      }
      // The row sum: the four lanes of a row add their partial sums (the
      // butterfly gives all four the same value).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2);
      }
    }
    __syncthreads();  // every warp is done with buffer st & 1 before it refills
  }

  if (iw >= nq) return;
  float sx = 1.0f;
  if constexpr (std::is_same<O, int8_t>::value) {
    sx = fmaxf(__fdiv_rn(*out_scale, 127.0f), 1e-12f);
  }
  const int hd = h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw + g + 8 * r;
    if (i >= nq) continue;
    O* dst = out + (static_cast<size_t>(b) * nq + i) * hd + head * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kDimTiles; ++n) {
      const float a0 = o[n][2 * r];
      const float a1 = o[n][2 * r + 1];
      if constexpr (std::is_same<O, int8_t>::value) {
        const int c0 = min(max(__float2int_rn(__fdiv_rn(a0, sx)), -127), 127);
        const int c1 = min(max(__float2int_rn(__fdiv_rn(a1, sx)), -127), 127);
        *reinterpret_cast<char2*>(dst + 8 * n) =
            make_char2(static_cast<signed char>(c0), static_cast<signed char>(c1));
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(a0, a1);
      }
    }
  }
}

// Counts the floats a in [0, 1] (every bit pattern up to 1.0f) for which
// div_rn_exact(a, b[i], __frcp_rn(b[i])) differs from __fdiv_rn(a, b[i]).
__global__ void check_div_rn_kernel(const float* __restrict__ b, int nb,
                                    unsigned long long* __restrict__ mismatches) {
  constexpr uint32_t kOne = 0x3f800000u;
  const float bi = b[blockIdx.y];
  const float y = __frcp_rn(bi);
  unsigned long long bad = 0;
  for (uint32_t bits = blockIdx.x * blockDim.x + threadIdx.x; bits <= kOne;
       bits += gridDim.x * blockDim.x) {
    const float a = __uint_as_float(bits);
    bad += __float_as_uint(div_rn_exact(a, bi, y)) != __float_as_uint(__fdiv_rn(a, bi));
  }
  if (bad) atomicAdd(mismatches + blockIdx.y, bad);
}

// Shared memory of one block: q, two K tiles, two V tiles (the K tiles
// themselves in the logits form) and, in the logits form, each lane's f32
// logits of every key tile.
size_t tc_smem_bytes(int d, int rows, int nkv, int smem_logits) {
  const size_t row = sizeof(bf16) * static_cast<size_t>(d + kPad);
  size_t bytes = row * (rows + (smem_logits ? 2 : 4) * kTile);
  if (smem_logits) {
    bytes += sizeof(float) * static_cast<size_t>((nkv + kTile - 1) / kTile) * kTile * rows;
  }
  return bytes;
}

template <int D, int kWarps, typename O>
int launch_tc(const void* q, const void* k, const void* v, const void* mask, void* out,
              const void* out_scale, int ld, int b, int nq, int nkv, int h, int causal,
              int smem_logits, float scale, cudaStream_t stream) {
  constexpr int kRows = 16 * kWarps;
  const size_t smem = tc_smem_bytes(D, kRows, nkv, smem_logits);
  cudaError_t err = cudaFuncSetAttribute(
      mha_tc_kernel<D, kWarps, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kRows - 1) / kRows, h, b);
  mha_tc_kernel<D, kWarps, O><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<O*>(out), ld, nq, nkv, h, causal,
      smem_logits, scale, static_cast<const float*>(out_scale));
  return static_cast<int>(cudaGetLastError());
}

template <int kWarps, typename O>
int launch_tc_d(int d, const void* q, const void* k, const void* v, const void* mask, void* out,
                const void* out_scale, int ld, int b, int nq, int nkv, int h, int causal,
                int smem_logits, float scale, cudaStream_t stream) {
#define PK_TC_CASE(DIM)                                                                  \
  case DIM:                                                                              \
    return launch_tc<DIM, kWarps, O>(q, k, v, mask, out, out_scale, ld, b, nq, nkv, h,   \
                                     causal, smem_logits, scale, stream);
  switch (d) {
    PK_TC_CASE(32)
    PK_TC_CASE(48)
    PK_TC_CASE(64)
    PK_TC_CASE(80)
    PK_TC_CASE(96)
    PK_TC_CASE(112)
    PK_TC_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PK_TC_CASE
}

template <typename O>
int launch_tc_rows(int rows, int d, const void* q, const void* k, const void* v,
                   const void* mask, void* out, const void* out_scale, int ld, int b, int nq,
                   int nkv, int h, int causal, int smem_logits, float scale,
                   cudaStream_t stream) {
  if (rows == 64) {
    return launch_tc_d<4, O>(d, q, k, v, mask, out, out_scale, ld, b, nq, nkv, h, causal,
                             smem_logits, scale, stream);
  }
  if (rows == 128) {
    return launch_tc_d<8, O>(d, q, k, v, mask, out, out_scale, ld, b, nq, nkv, h, causal,
                             smem_logits, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (b, nq, h, d), k and v (b, nkv, h, d), f32 (bf16 == 0) or bf16 (bf16 ==
// 1), element (b, i, head, c) at (b * n + i) * ld + head * d + c (ld = h * d
// for contiguous tensors, 3 * h * d for the views of one fused qkv); mask
// (b, nkv) uint8, nonzero = valid key, or null. out (b, nq, h, d)
// contiguous, in the input dtype. Requires 1 <= d <= 512.
int pk_mha(const void* q, const void* k, const void* v, const void* mask, void* out,
           int ld, int b, int nq, int nkv, int h, int d, int causal, int bf16, float scale,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_mha<__nv_bfloat16>(q, k, v, mask, out, ld, b, nq, nkv, h, d, causal, scale,
                                     st);
  }
  return launch_mha<float>(q, k, v, mask, out, ld, b, nq, nkv, h, d, causal, scale, st);
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

// The tensor-core route. q, k, v: bf16 base pointers (16-byte aligned) of
// (b, nq | nkv, h, d) operands whose rows are ld elements apart (ld = h * d
// for three tensors, 3 * h * d for the unsplit qkv, ld % 8 == 0); mask (b,
// nkv) uint8, nonzero = valid key, or null. out (b, nq, h * d): int8 at the
// static scale out_scale (one f32 on the device) when out_scale is not null,
// else bf16. d in {32, 48, ..., 128}; rows (query rows a block) 64 or 128;
// smem_logits 1 keeps the logits in shared memory (tc_smem_bytes; a launch
// that needs more than the card's 227 KB a block fails), 0 recomputes them.
int pk_mha_tc(const void* q, const void* k, const void* v, const void* mask, void* out,
              const void* out_scale, int ld, int b, int nq, int nkv, int h, int d, int causal,
              float scale, int rows, int smem_logits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_scale) {
    return launch_tc_rows<int8_t>(rows, d, q, k, v, mask, out, out_scale, ld, b, nq, nkv, h,
                                  causal, smem_logits, scale, st);
  }
  return launch_tc_rows<bf16>(rows, d, q, k, v, mask, out, out_scale, ld, b, nq, nkv, h, causal,
                              smem_logits, scale, st);
}

// mismatches[i] (zeroed by the caller) = the number of floats a in [0, 1]
// whose div_rn(a, b[i]) is not __fdiv_rn(a, b[i]); each b[i] >= 1.
int pk_check_div_rn(const float* b, int nb, unsigned long long* mismatches, void* stream) {
  check_div_rn_kernel<<<dim3(1024, nb), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      b, nb, mismatches);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
