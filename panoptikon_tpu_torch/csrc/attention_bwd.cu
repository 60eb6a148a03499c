// The gradient of multi-head attention (kernel B3, csrc/attention.cu's
// pk_mha and pk_mha_tc) with respect to q, k and v. The JAX package's Pallas
// mha (panoptikon_tpu/ops/vit_attention.py::mha) has no backward; off the
// TPU its attention() is jax.nn.dot_product_attention, whose gradient XLA
// computes. This is the port's counterpart, written for the card.
//
// The forward it differentiates (every form pk_mha takes): logits
// l = (q . k) * D^-0.5 in f32, -inf where key > query (causal), l - 1e9
// where the key is masked (so a fully masked row is uniform), m = max l,
// p = exp(l - m) / s with s = sum exp(l - m), p~ = p rounded to V's dtype
// when D >= 32 (p itself below), out = p~ . V in f32. The gradient, given
// dO (B, N_q, H, D) in q's dtype, straight through the rounding of p:
//   dV = p~^T . dO
//   dP = dO . V^T                       (f32, not rounded)
//   delta = rowsum(p * dP)              (f32, from the unrounded p)
//   dS = p * (dP - delta)
//   dQ = dS . K * D^-0.5,  dK = dS^T . Q * D^-0.5
// accumulated in f32 and written in q's dtype. delta is rowsum(p * dP)
// rather than FlashAttention's rowsum(dO * O): O is p~ . V rounded to q's
// dtype, so that form differs from the gradient at bf16 level.
// vit_attention.mha_backward_plain is the same arithmetic in PyTorch.
//
// Three kernels on the CUDA cores, all f32 arithmetic, launched in order on
// one stream by pk_mha_bwd, each staging q, dO, K and V tiles in shared
// memory as f32 (rows padded to an odd length against bank conflicts):
//   1. mha_bwd_stats_kernel: one block a (tile of query rows, head, batch
//      row) recomputes each row's m and s and then delta in three passes
//      over the key tiles, into f32 (B, H, N_q) buffers.
// Each thread forms the dot products of a small block of (row, key)
// entries of a tile (Layout), reusing each value it reads from shared
// memory.
//   2. mha_bwd_dkdv_kernel: one block a (tile of keys, head, batch row)
//      loops over tiles of query rows, recomputes p~ and dS for the tile,
//      and accumulates dK and dV in registers (a lane owns a few keys at a
//      few dims, so each value read from shared memory serves several
//      FMAs; no atomics).
//   3. mha_bwd_dq_kernel: one block a (tile of query rows, head, batch row)
//      loops over tiles of keys and accumulates dQ the same way.
// Causal tiles that lie wholly above the diagonal are skipped. q, k and v
// are read through one row stride ld, as the forward reads them, so the
// views of a fused qkv (ld = 3 * H * D) need no copies; dO, dQ, dK and dV
// are contiguous (B, N, H, D).
//
// Two instantiations: D <= 128 with 32-row tiles, and 128 < D <= 512 (the
// captioner's decoder: D 384) with 8-row tiles; either way a block holds
// about 66 KB of shared memory and each thread 32 accumulators of dK and
// of dV (or of dQ).
//
// What bounds it on an H100: at the training shapes the bound is bytes (q,
// k, v, dO in, dq, dk, dv out: at ViT-B/32's image attention 68.8 MB, 0.021
// ms at the data sheet's 3.35 TB/s for an H100 SXM at 700 W), but the
// kernels do the five products of the backward (the logits, dP, dV, dK,
// dQ) and four more for the statistics (the logits three times, dP once),
// each of B * H * N_q * N_kv * D f32 FMAs on the CUDA cores with operands
// from shared memory. A simple, correct first form: bf16 tensor-core tiles
// (mma.sync, then wgmma) for the products, and the statistics saved by the
// forward instead of recomputed, are the next steps (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kNarrowD = 128;
constexpr int kNarrowTile = 32;
constexpr int kWideD = 512;
constexpr int kWideTile = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// x rounded to T and back, as the forward rounds p before the AV product.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The forward's logit from a dot product: scaled without FMA contraction,
// then masked. Every kernel here forms p from it, so p agrees across them.
__device__ __forceinline__ float masked_logit(float dot, float scale, int i, int j, int causal,
                                              const uint8_t* mb) {
  if (causal && j > i) return -INFINITY;
  float l = __fmul_rn(dot, scale);
  if (mb && mb[j] == 0) l = __fsub_rn(l, 1e9f);
  return l;
}

// Shared-memory layout of the three kernels, in floats: kTq rows of q and
// of dO, kTk rows of K and of V (each row `stride` floats, stride odd and
// >= d), p~ and dS of the tile ([kTq][kTk + 1] each), and m, s, delta of
// the tile's query rows.
__host__ __device__ constexpr int tile_stride(int d) { return d | 1; }
template <int kTq, int kTk>
__host__ __device__ size_t tile_floats(int d) {
  return static_cast<size_t>(2 * kTq + 2 * kTk) * tile_stride(d) + 2 * kTq * (kTk + 1) + 3 * kTq;
}

// How a tile's (query row, key) entries fall to the threads for the dot
// products: lane l of warp w takes keys kg + kKeyGroups * t (kg = l %
// kKeyGroups, t < kKn) of rows row0 + m (row0 = w * kRowsPerWarp +
// (l / kKeyGroups) * kRm, m < kRm), so each q, dO, K and V value it reads
// from shared memory serves several FMAs (a 2 x 4 block at 32 x 32 tiles).
// Warps past kTq / kRowsPerWarp hold no entries.
template <int kTq, int kTk>
struct Layout {
  static constexpr int kKn = kTk >= 32 ? 4 : 1;
  static constexpr int kRm = kTq >= 32 ? 2 : 1;
  static constexpr int kKeyGroups = kTk / kKn;
  static constexpr int kRowsPerWarp = (32 / kKeyGroups) * kRm;
  static_assert(32 % kKeyGroups == 0 && kTq % kRowsPerWarp == 0 &&
                kTq / kRowsPerWarp <= kWarps, "a tile's entries must fit the block's warps");

  static __device__ __forceinline__ int row0() {
    return (threadIdx.x / 32) * kRowsPerWarp + (threadIdx.x % 32) / kKeyGroups * kRm;
  }
  static __device__ __forceinline__ int key0() { return threadIdx.x % 32 % kKeyGroups; }
};

template <typename T, int kTq, int kTk>
struct Tile {
  using L = Layout<kTq, kTk>;
  float* qs;
  float* dos;
  float* ks;
  float* vs;
  float* ps;
  float* ds;
  float* tm;
  float* ts;
  float* tdelta;
  int stride;

  __device__ Tile(float* sm, int d) : stride(tile_stride(d)) {
    qs = sm;
    dos = qs + kTq * stride;
    ks = dos + kTq * stride;
    vs = ks + kTk * stride;
    ps = vs + kTk * stride;
    ds = ps + kTq * (kTk + 1);
    tm = ds + kTq * (kTk + 1);
    ts = tm + kTq;
    tdelta = ts + kTq;
  }

  // Rows i0.. of q and dO (zeros past nq).
  __device__ void load_rows(const T* qb, const T* ob, int i0, int nq, int ld, int hd, int d) {
    for (int e = threadIdx.x; e < kTq * d; e += kThreads) {
      const int r = e / d;
      const int c = e % d;
      const bool in = i0 + r < nq;
      qs[r * stride + c] = in ? to_f(qb[static_cast<size_t>(i0 + r) * ld + c]) : 0.0f;
      dos[r * stride + c] = in ? to_f(ob[static_cast<size_t>(i0 + r) * hd + c]) : 0.0f;
    }
  }

  // m, s and delta of rows i0.. (neutral past nq).
  __device__ void load_stats(const float* mb, const float* sb, const float* db, int i0, int nq) {
    for (int r = threadIdx.x; r < kTq; r += kThreads) {
      const bool in = i0 + r < nq;
      tm[r] = in ? mb[i0 + r] : 0.0f;
      ts[r] = in ? sb[i0 + r] : 1.0f;
      tdelta[r] = in ? db[i0 + r] : 0.0f;
    }
  }

  // Rows j0.. of K and V (zeros past nkv).
  __device__ void load_keys(const T* kb, const T* vb, int j0, int nkv, int ld, int d) {
    for (int e = threadIdx.x; e < kTk * d; e += kThreads) {
      const int r = e / d;
      const int c = e % d;
      const bool in = j0 + r < nkv;
      const size_t src = static_cast<size_t>(j0 + r) * ld + c;
      ks[r * stride + c] = in ? to_f(kb[src]) : 0.0f;
      vs[r * stride + c] = in ? to_f(vb[src]) : 0.0f;
    }
  }

  // This thread's entries (Layout): qk[m][t] = q_r . k_j and, with kDp,
  // dp[m][t] = dO_r . v_j, for rows r = row0 + m, keys jj = key0 +
  // kKeyGroups * t of the tiles (zero rows past nq or nkv give 0).
  template <bool kDp>
  __device__ void dots(int row0, int key0, int d, float (&qk)[L::kRm][L::kKn],
                       float (&dp)[L::kRm][L::kKn]) const {
#pragma unroll
    for (int m = 0; m < L::kRm; ++m) {
#pragma unroll
      for (int t = 0; t < L::kKn; ++t) {
        qk[m][t] = 0.0f;
        dp[m][t] = 0.0f;
      }
    }
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float qv[L::kRm];
      float ov[L::kRm];
      float kv[L::kKn];
      float vv[L::kKn];
#pragma unroll
      for (int m = 0; m < L::kRm; ++m) {
        qv[m] = qs[(row0 + m) * stride + c];
        if constexpr (kDp) ov[m] = dos[(row0 + m) * stride + c];
      }
#pragma unroll
      for (int t = 0; t < L::kKn; ++t) {
        kv[t] = ks[(key0 + L::kKeyGroups * t) * stride + c];
        if constexpr (kDp) vv[t] = vs[(key0 + L::kKeyGroups * t) * stride + c];
      }
#pragma unroll
      for (int m = 0; m < L::kRm; ++m) {
#pragma unroll
        for (int t = 0; t < L::kKn; ++t) {
          qk[m][t] = fmaf(qv[m], kv[t], qk[m][t]);
          if constexpr (kDp) dp[m][t] = fmaf(ov[m], vv[t], dp[m][t]);
        }
      }
    }
  }

  // p~ and dS of the tile (query rows i0.., keys j0..); 0 outside the
  // valid rows and keys and above the causal diagonal.
  __device__ void probs(int i0, int j0, int nq, int nkv, int d, int causal, float scale,
                        const uint8_t* mb, bool round_p) {
    const int row0 = L::row0();
    const int key0 = L::key0();
    if (row0 >= kTq) return;
    float qk[L::kRm][L::kKn];
    float dp[L::kRm][L::kKn];
    dots<true>(row0, key0, d, qk, dp);
#pragma unroll
    for (int m = 0; m < L::kRm; ++m) {
#pragma unroll
      for (int t = 0; t < L::kKn; ++t) {
        const int r = row0 + m;
        const int jj = key0 + L::kKeyGroups * t;
        const int i = i0 + r;
        const int j = j0 + jj;
        float p = 0.0f;
        float dsv = 0.0f;
        if (i < nq && j < nkv && !(causal && j > i)) {
          p = expf(masked_logit(qk[m][t], scale, i, j, causal, mb) - tm[r]) / ts[r];
          dsv = p * (dp[m][t] - tdelta[r]);
        }
        ps[r * (kTk + 1) + jj] = round_p ? round_to<T>(p) : p;
        ds[r * (kTk + 1) + jj] = dsv;
      }
    }
  }
};

// Row statistics of one tile of query rows: m and s (the forward's row max
// and sum) and delta = rowsum(p * dP), in three passes over the key tiles.
// A row's keys fall to the kKeyGroups lanes of one group (Layout), which
// combine their partial values by shuffles.
template <typename T, int kTq, int kTk>
__global__ void __launch_bounds__(kThreads) mha_bwd_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const T* __restrict__ dout, float* __restrict__ row_m,
    float* __restrict__ row_s, float* __restrict__ row_delta, int ld, int nq, int nkv, int h,
    int d, int causal, float scale) {
  using L = Layout<kTq, kTk>;
  extern __shared__ float sm[];
  Tile<T, kTq, kTk> t(sm, d);
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int i0 = blockIdx.x * kTq;
  const int hd = h * d;
  const int row0 = L::row0();
  const int key0 = L::key0();
  const bool active = row0 < kTq;
  const T* kb = k + static_cast<size_t>(b) * nkv * ld + head * d;
  const T* vb = v + static_cast<size_t>(b) * nkv * ld + head * d;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * nkv : nullptr;
  t.load_rows(q + static_cast<size_t>(b) * nq * ld + head * d,
              dout + static_cast<size_t>(b) * nq * hd + head * d, i0, nq, ld, hd, d);
  float m[L::kRm];
  float s[L::kRm];
  float delta[L::kRm];
#pragma unroll
  for (int u = 0; u < L::kRm; ++u) {
    m[u] = -INFINITY;
    s[u] = 0.0f;
    delta[u] = 0.0f;
  }
  // Causal: keys past the tile's last row are seen by none of its rows.
  const int end = causal ? min(nkv, i0 + kTq) : nkv;
  for (int pass = 0; pass < 3; ++pass) {
    for (int j0 = 0; j0 < end; j0 += kTk) {
      __syncthreads();  // the previous K and V tiles are used up
      t.load_keys(kb, vb, j0, nkv, ld, d);
      __syncthreads();
      if (!active) continue;
      float qk[L::kRm][L::kKn];
      float dp[L::kRm][L::kKn];
      if (pass < 2) {
        t.template dots<false>(row0, key0, d, qk, dp);
      } else {
        t.template dots<true>(row0, key0, d, qk, dp);
      }
#pragma unroll
      for (int u = 0; u < L::kRm; ++u) {
#pragma unroll
        for (int w = 0; w < L::kKn; ++w) {
          const int i = i0 + row0 + u;
          const int j = j0 + key0 + L::kKeyGroups * w;
          if (i >= nq || j >= nkv || (causal && j > i)) continue;
          const float l = masked_logit(qk[u][w], scale, i, j, causal, mb);
          if (pass == 0) {
            m[u] = fmaxf(m[u], l);
          } else if (pass == 1) {
            s[u] += expf(l - m[u]);
          } else {
            delta[u] = fmaf(expf(l - m[u]) / s[u], dp[u][w], delta[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < L::kRm; ++u) {
#pragma unroll
      for (int off = L::kKeyGroups / 2; off > 0; off >>= 1) {
        if (pass == 0) {
          m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], off));
        } else if (pass == 1) {
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        } else {
          delta[u] += __shfl_xor_sync(0xffffffffu, delta[u], off);
        }
      }
    }
  }
  if (!active || key0 != 0) return;
#pragma unroll
  for (int u = 0; u < L::kRm; ++u) {
    const int i = i0 + row0 + u;
    if (i >= nq) continue;
    const size_t at = (static_cast<size_t>(b) * h + head) * nq + i;
    row_m[at] = m[u];
    row_s[at] = s[u];
    row_delta[at] = delta[u];
  }
}

// dK and dV of one tile of keys, over every query row that sees them. Lane
// l of warp w accumulates keys w, w + 4, ... of the tile at dims l, l + 32,
// ...: each q and dO value it reads from shared memory serves every key it
// owns, each p~ and dS value (one address for the warp) every dim.
template <typename T, int kMaxD, int kTq, int kTk>
__global__ void __launch_bounds__(kThreads) mha_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ row_m, const float* __restrict__ row_s,
    const float* __restrict__ row_delta, T* __restrict__ dk, T* __restrict__ dv, int ld, int nq,
    int nkv, int h, int d, int causal, float scale) {
  constexpr int kCols = kMaxD / 32;
  constexpr int kKeys = kTk / kWarps;
  extern __shared__ float sm[];
  Tile<T, kTq, kTk> t(sm, d);
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int j0 = blockIdx.x * kTk;
  const int hd = h * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + static_cast<size_t>(b) * nq * ld + head * d;
  const T* ob = dout + static_cast<size_t>(b) * nq * hd + head * d;
  const size_t stat = (static_cast<size_t>(b) * h + head) * nq;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * nkv : nullptr;
  const bool round_p = d >= 32;

  t.load_keys(k + static_cast<size_t>(b) * nkv * ld + head * d,
              v + static_cast<size_t>(b) * nkv * ld + head * d, j0, nkv, ld, d);
  float acc_k[kKeys][kCols];
  float acc_v[kKeys][kCols];
#pragma unroll
  for (int w = 0; w < kKeys; ++w) {
#pragma unroll
    for (int a = 0; a < kCols; ++a) {
      acc_k[w][a] = 0.0f;
      acc_v[w][a] = 0.0f;
    }
  }
  // Causal: query rows before j0 see none of these keys.
  const int first = causal ? (j0 / kTq) * kTq : 0;
  for (int i0 = first; i0 < nq; i0 += kTq) {
    __syncthreads();  // the previous tile's p~ and dS are used up
    t.load_rows(qb, ob, i0, nq, ld, hd, d);
    t.load_stats(row_m + stat, row_s + stat, row_delta + stat, i0, nq);
    __syncthreads();
    t.probs(i0, j0, nq, nkv, d, causal, scale, mb, round_p);
    __syncthreads();
    for (int r = 0; r < kTq; ++r) {
      float qc[kCols];
      float oc[kCols];
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        const int c = lane + 32 * a;
        qc[a] = c < d ? t.qs[r * t.stride + c] : 0.0f;
        oc[a] = c < d ? t.dos[r * t.stride + c] : 0.0f;
      }
#pragma unroll
      for (int w = 0; w < kKeys; ++w) {
        const int jj = warp + kWarps * w;
        const float p = t.ps[r * (kTk + 1) + jj];
        const float dsv = t.ds[r * (kTk + 1) + jj];
#pragma unroll
        for (int a = 0; a < kCols; ++a) {
          if (32 * a >= d) break;
          acc_v[w][a] = fmaf(p, oc[a], acc_v[w][a]);
          acc_k[w][a] = fmaf(dsv, qc[a], acc_k[w][a]);
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kKeys; ++w) {
    const int j = j0 + warp + kWarps * w;
    if (j >= nkv) continue;
#pragma unroll
    for (int a = 0; a < kCols; ++a) {
      const int c = lane + 32 * a;
      if (c >= d) continue;
      const size_t at = (static_cast<size_t>(b) * nkv + j) * hd + head * d + c;
      dk[at] = from_f<T>(acc_k[w][a] * scale);
      dv[at] = from_f<T>(acc_v[w][a]);
    }
  }
}

// dQ of one tile of query rows, over every key it sees; lane l of warp w
// accumulates rows w, w + 4, ... at dims l, l + 32, ...
template <typename T, int kMaxD, int kTq, int kTk>
__global__ void __launch_bounds__(kThreads) mha_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ row_m, const float* __restrict__ row_s,
    const float* __restrict__ row_delta, T* __restrict__ dq, int ld, int nq, int nkv, int h,
    int d, int causal, float scale) {
  constexpr int kCols = kMaxD / 32;
  constexpr int kRows = kTq / kWarps;
  extern __shared__ float sm[];
  Tile<T, kTq, kTk> t(sm, d);
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int i0 = blockIdx.x * kTq;
  const int hd = h * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* kb = k + static_cast<size_t>(b) * nkv * ld + head * d;
  const T* vb = v + static_cast<size_t>(b) * nkv * ld + head * d;
  const size_t stat = (static_cast<size_t>(b) * h + head) * nq;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * nkv : nullptr;

  t.load_rows(q + static_cast<size_t>(b) * nq * ld + head * d,
              dout + static_cast<size_t>(b) * nq * hd + head * d, i0, nq, ld, hd, d);
  t.load_stats(row_m + stat, row_s + stat, row_delta + stat, i0, nq);
  float acc[kRows][kCols];
#pragma unroll
  for (int w = 0; w < kRows; ++w) {
#pragma unroll
    for (int a = 0; a < kCols; ++a) acc[w][a] = 0.0f;
  }
  // Causal: keys past the tile's last row are seen by none of its rows.
  const int end = causal ? min(nkv, i0 + kTq) : nkv;
  for (int j0 = 0; j0 < end; j0 += kTk) {
    __syncthreads();  // the previous K and V tiles and dS are used up
    t.load_keys(kb, vb, j0, nkv, ld, d);
    __syncthreads();
    t.probs(i0, j0, nq, nkv, d, causal, scale, mb, false);
    __syncthreads();
    for (int jj = 0; jj < kTk; ++jj) {
      float kc[kCols];
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        const int c = lane + 32 * a;
        kc[a] = c < d ? t.ks[jj * t.stride + c] : 0.0f;
      }
#pragma unroll
      for (int w = 0; w < kRows; ++w) {
        const float dsv = t.ds[(warp + kWarps * w) * (kTk + 1) + jj];
#pragma unroll
        for (int a = 0; a < kCols; ++a) {
          if (32 * a >= d) break;
          acc[w][a] = fmaf(dsv, kc[a], acc[w][a]);
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kRows; ++w) {
    const int i = i0 + warp + kWarps * w;
    if (i >= nq) continue;
#pragma unroll
    for (int a = 0; a < kCols; ++a) {
      const int c = lane + 32 * a;
      if (c >= d) continue;
      dq[(static_cast<size_t>(b) * nq + i) * hd + head * d + c] = from_f<T>(acc[w][a] * scale);
    }
  }
}

// The three kernels of one instantiation, in order on one stream: the row
// statistics, then dK and dV, then dQ.
template <typename T, int kMaxD, int kTile>
int launch_tiles(const void* q, const void* k, const void* v, const void* mask,
                 const void* dout, float* stats, void* dq, void* dk, void* dv, int ld, int b,
                 int nq, int nkv, int h, int d, int causal, float scale, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(b) * h * nq;
  float* row_m = stats;
  float* row_s = stats + rows;
  float* row_delta = stats + 2 * rows;
  const size_t smem = sizeof(float) * tile_floats<kTile, kTile>(d);
  auto stat = mha_bwd_stats_kernel<T, kTile, kTile>;
  auto dkdv = mha_bwd_dkdv_kernel<T, kMaxD, kTile, kTile>;
  auto dqk = mha_bwd_dq_kernel<T, kMaxD, kTile, kTile>;
  cudaError_t err = cudaFuncSetAttribute(stat, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  const uint8_t* mt = static_cast<const uint8_t*>(mask);
  const dim3 query_tiles((nq + kTile - 1) / kTile, h, b);
  stat<<<query_tiles, kThreads, smem, stream>>>(qt, kt, vt, mt, ot, row_m, row_s, row_delta, ld,
                                                nq, nkv, h, d, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3((nkv + kTile - 1) / kTile, h, b), kThreads, smem, stream>>>(
      qt, kt, vt, mt, ot, row_m, row_s, row_delta, static_cast<T*>(dk), static_cast<T*>(dv),
      ld, nq, nkv, h, d, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<query_tiles, kThreads, smem, stream>>>(qt, kt, vt, mt, ot, row_m, row_s, row_delta,
                                               static_cast<T*>(dq), ld, nq, nkv, h, d, causal,
                                               scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* mask, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int ld, int b, int nq, int nkv, int h,
               int d, int causal, float scale, cudaStream_t stream) {
  if (d < 1 || d > kWideD) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= kNarrowD) {
    return launch_tiles<T, kNarrowD, kNarrowTile>(q, k, v, mask, dout, stats, dq, dk, dv, ld, b,
                                                  nq, nkv, h, d, causal, scale, stream);
  }
  return launch_tiles<T, kWideD, kWideTile>(q, k, v, mask, dout, stats, dq, dk, dv, ld, b, nq,
                                            nkv, h, d, causal, scale, stream);
}

}  // namespace

extern "C" {

// q (b, nq, h, d), k and v (b, nkv, h, d), f32 (bf16 == 0) or bf16 (bf16 ==
// 1), element (b, i, head, c) at (b * n + i) * ld + head * d + c, as pk_mha
// reads them; mask (b, nkv) uint8, nonzero = valid key, or null; dout (b,
// nq, h, d) contiguous, in the input dtype. Writes dq (b, nq, h, d), dk and
// dv (b, nkv, h, d), contiguous, in the input dtype; stats is f32 scratch of
// 3 * b * h * nq. Requires 1 <= d <= 512 and, when causal, nq == nkv.
int pk_mha_bwd(const void* q, const void* k, const void* v, const void* mask, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int ld, int b, int nq, int nkv, int h,
               int d, int causal, int bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_bwd<__nv_bfloat16>(q, k, v, mask, dout, dq, dk, dv, stats, ld, b, nq, nkv, h,
                                     d, causal, scale, st);
  }
  return launch_bwd<float>(q, k, v, mask, dout, dq, dk, dv, stats, ld, b, nq, nkv, h, d, causal,
                           scale, st);
}

}  // extern "C"
