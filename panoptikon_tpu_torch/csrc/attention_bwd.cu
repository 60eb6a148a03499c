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
// Two routes, which vit_attention.backward_route picks from the dtype, the
// head dim and N_q, N_kv, as route() picks the forward's:
//
// The tensor-core route (pk_mha_bwd_tc, mha_bwd_tc_kernel below): bf16 with
// D in {32, 48, ..., 128} and N_q, N_kv <= 128, every shape training gives
// B3. One block a (head, batch row) holds q, K, V and dO whole in shared
// memory, forms every row's statistics from the row itself (nothing saved
// by the forward, no scratch), does the five products on the tensor cores
// (mma.sync bf16 -> f32) and writes dQ, dK and dV once each: one launch.
//
// The CUDA-core route (pk_mha_bwd): f32, the other head dims (D < 32, D
// not a multiple of 16, 128 < D <= 512) and N_q or N_kv past 128. Three
// kernels, all f32 arithmetic, launched in order on one stream, each
// staging q, dO, K and V tiles in shared memory as f32 (rows padded to an
// odd length against bank conflicts):
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
// Causal tiles that lie wholly above the diagonal are skipped on both
// routes. q, k and v are read through one row stride ld, as the forward
// reads them, so the views of a fused qkv (ld = 3 * H * D) need no copies;
// dO, dQ, dK and dV are contiguous (B, N, H, D).
//
// The CUDA-core route has two instantiations: D <= 128 with 32-row tiles,
// and 128 < D <= 512 (the captioner's decoder: D 384) with 8-row tiles;
// either way a block holds about 66 KB of shared memory and each thread 32
// accumulators of dK and of dV (or of dQ). An 8 x 8 tile has 64 (row, key)
// entries for the block's 128 threads: the wide instantiation splits each
// entry's dot products over kWideSplit lanes (PERF.md has both forms'
// times).
//
// What bounds it on an H100: at the training shapes the bound is bytes (q,
// k, v, dO in, dq, dk, dv out: at ViT-B/32's image attention 68.8 MB, 0.021
// ms at the data sheet's 3.35 TB/s for an H100 SXM at 700 W). The
// CUDA-core route does the five products of the backward (the logits, dP,
// dV, dK, dQ) and four more for the statistics (the logits three times, dP
// once), each of B * H * N_q * N_kv * D f32 FMAs with operands from shared
// memory, and reads q, k, v and dO in each of its three launches. The
// tensor-core route reads each input once and does the five products in
// bf16, so it is bound by the latency of one block's dependent steps (load,
// products, softmax, write) and by how many blocks the card holds at once:
// wgmma tiles and a pipelined load are the next steps (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kNarrowD = 128;
constexpr int kNarrowTile = 32;
constexpr int kWideD = 512;
constexpr int kWideTile = 8;
// Lanes an entry's dot products are split over in the wide instantiation
// (1: one lane an entry, as the narrow one).
constexpr int kWideSplit = 2;

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
template <int kTq, int kTk, int kSplit>
struct Layout {
  static constexpr int kKn = kTk >= 32 ? 4 : 1;
  static constexpr int kRm = kTq >= 32 ? 2 : 1;
  static constexpr int kKeyGroups = kTk / kKn;
  static constexpr int kRowsPerWarp = (32 / (kKeyGroups * kSplit)) * kRm;
  static_assert(32 % (kKeyGroups * kSplit) == 0 && kTq % kRowsPerWarp == 0 &&
                kTq / kRowsPerWarp <= kWarps, "a tile's entries must fit the block's warps");

  static __device__ __forceinline__ int row0() {
    return (threadIdx.x / 32) * kRowsPerWarp + (threadIdx.x % 32) / (kKeyGroups * kSplit) * kRm;
  }
  static __device__ __forceinline__ int key0() {
    return threadIdx.x % 32 / kSplit % kKeyGroups;
  }
  // Which of an entry's kSplit lanes this is: it sums dims part, part +
  // kSplit, ... of the entry's dot products.
  static __device__ __forceinline__ int part() { return threadIdx.x % kSplit; }
};

template <typename T, int kTq, int kTk, int kSplit>
struct Tile {
  using L = Layout<kTq, kTk, kSplit>;
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
  // kKeyGroups * t of the tiles (zero rows past nq or nkv give 0). With
  // kSplit > 1 an entry's lanes sum alternate dims and then add their
  // partial sums, so each holds the whole dot product.
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
    for (int c = L::part(); c < d; c += kSplit) {
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
#pragma unroll
    for (int off = 1; off < kSplit; off <<= 1) {
#pragma unroll
      for (int m = 0; m < L::kRm; ++m) {
#pragma unroll
        for (int t = 0; t < L::kKn; ++t) {
          qk[m][t] += __shfl_xor_sync(0xffffffffu, qk[m][t], off);
          if constexpr (kDp) dp[m][t] += __shfl_xor_sync(0xffffffffu, dp[m][t], off);
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
    if (L::part() != 0) return;  // its entries are the first lane's
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
template <typename T, int kTq, int kTk, int kSplit>
__global__ void __launch_bounds__(kThreads) mha_bwd_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const T* __restrict__ dout, float* __restrict__ row_m,
    float* __restrict__ row_s, float* __restrict__ row_delta, int ld, int nq, int nkv, int h,
    int d, int causal, float scale) {
  using L = Layout<kTq, kTk, kSplit>;
  extern __shared__ float sm[];
  Tile<T, kTq, kTk, kSplit> t(sm, d);
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
      for (int off = L::kKeyGroups * kSplit / 2; off >= kSplit; off >>= 1) {
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
  if (!active || key0 != 0 || L::part() != 0) return;
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
template <typename T, int kMaxD, int kTq, int kTk, int kSplit>
__global__ void __launch_bounds__(kThreads) mha_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ row_m, const float* __restrict__ row_s,
    const float* __restrict__ row_delta, T* __restrict__ dk, T* __restrict__ dv, int ld, int nq,
    int nkv, int h, int d, int causal, float scale) {
  constexpr int kCols = kMaxD / 32;
  constexpr int kKeys = kTk / kWarps;
  extern __shared__ float sm[];
  Tile<T, kTq, kTk, kSplit> t(sm, d);
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
template <typename T, int kMaxD, int kTq, int kTk, int kSplit>
__global__ void __launch_bounds__(kThreads) mha_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const T* __restrict__ dout,
    const float* __restrict__ row_m, const float* __restrict__ row_s,
    const float* __restrict__ row_delta, T* __restrict__ dq, int ld, int nq, int nkv, int h,
    int d, int causal, float scale) {
  constexpr int kCols = kMaxD / 32;
  constexpr int kRows = kTq / kWarps;
  extern __shared__ float sm[];
  Tile<T, kTq, kTk, kSplit> t(sm, d);
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
template <typename T, int kMaxD, int kTile, int kSplit>
int launch_tiles(const void* q, const void* k, const void* v, const void* mask,
                 const void* dout, float* stats, void* dq, void* dk, void* dv, int ld, int b,
                 int nq, int nkv, int h, int d, int causal, float scale, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(b) * h * nq;
  float* row_m = stats;
  float* row_s = stats + rows;
  float* row_delta = stats + 2 * rows;
  const size_t smem = sizeof(float) * tile_floats<kTile, kTile>(d);
  auto stat = mha_bwd_stats_kernel<T, kTile, kTile, kSplit>;
  auto dkdv = mha_bwd_dkdv_kernel<T, kMaxD, kTile, kTile, kSplit>;
  auto dqk = mha_bwd_dq_kernel<T, kMaxD, kTile, kTile, kSplit>;
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
    return launch_tiles<T, kNarrowD, kNarrowTile, 1>(q, k, v, mask, dout, stats, dq, dk, dv, ld,
                                                     b, nq, nkv, h, d, causal, scale, stream);
  }
  return launch_tiles<T, kWideD, kWideTile, kWideSplit>(q, k, v, mask, dout, stats, dq, dk, dv,
                                                        ld, b, nq, nkv, h, d, causal, scale,
                                                        stream);
}

// ---------------------------------------------------------------------------
// Tensor-core route: mha_bwd_tc_kernel, one block a (head, batch row).

using bf16 = __nv_bfloat16;

constexpr int kTcMaxKeys = 128;  // N_q and N_kv (vit_attention.BWD_TC_MAX_ROWS)
constexpr int kTcPad = 8;        // bf16 of padding a shared-memory row (16 bytes)
constexpr int kTcMaxWarps = 8;

// Shared memory of one block, in bytes: q, dO (nqp rows each) and K, V (nkp
// rows each) at D + kTcPad bf16 a row, then p~ and dS (nqp rows of nkp +
// kTcPad bf16 each). Every row is a multiple of 16 bytes and an odd number of
// 16-byte chunks, so ldmatrix's eight row addresses fall in distinct banks.
__host__ __device__ inline size_t tc_bwd_smem_bytes(int d, int nqp, int nkp) {
  return sizeof(bf16) * (static_cast<size_t>(2 * (nqp + nkp)) * (d + kTcPad) +
                         static_cast<size_t>(2 * nqp) * (nkp + kTcPad));
}

// The whole problem of one (head, batch row) in one block: N_q and N_kv up
// to kTcMaxKeys, padded to multiples of 16 (padded rows and keys are zeros
// in shared memory, padded keys -inf in the logits, padded rows' p zero).
// Warps take 16-row tiles of the query rows, then 16-key tiles of the keys.
//
// Phase 1, a warp a 16-row tile i0.. (mma.sync m16n8k16, ldmatrix
// fragments): S = Q K^T and dP = dO V^T over the keys the rows see; the
// logits and p as the forward forms them (below); delta = rowsum(p * dP)
// from the f32 p and dP in registers; dS = p * (dP - delta); p~ = bf16(p)
// and bf16(dS) to shared memory; dQ = dS K D^-0.5 with dS as bf16 in the A
// operand straight from registers, as the forward feeds P into P V.
// Phase 2, after one barrier, a warp a 16-key tile j0..: dV = p~^T dO and
// dK = dS^T Q D^-0.5, the A operands read by ldmatrix.trans from p~ and dS.
// dQ, dK and dV are written once each, with no atomics: the result is the
// same from run to run. Causal: a row tile reads no key n-tile past its last
// row, a key tile no query tile before its first key.
//
// p~ equals the forward's (mha_tc_kernel in its shared-memory-logits form,
// which every N_kv this route takes is) bit for bit: the same Q and K
// fragments go through the same mma k-steps in order from zero, the logit
// is acc * scale by __fmul_rn, then -inf (causal, padded) or l - 1e9
// (masked), m the row max, each lane sums expf(l - m) over its keys in
// ascending order (keys 8n + 2t, 8n + 2t + 1 of n-tile n) before the four
// lanes of a row add theirs by the same two shuffles, and p is the
// correctly rounded e / s (div_rn_exact, which equals the forward's div_rn
// wherever that one is taken). The card test of the route checks it.
//
// dS is rounded to bf16 for the dQ and dK products, a rounding that
// vit_attention.mha_backward_plain does not do; the result is held to the
// plain version at the same 1e-2 of the largest gradient element.
template <int D>
__global__ void __launch_bounds__(kTcMaxWarps * 32) mha_bwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ mask, const bf16* __restrict__ dout, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int ld, int nq, int nkv, int h, int causal,
    float scale) {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "head dim");
  constexpr int kLds = D + kTcPad;
  constexpr int kSteps = D / 16;    // k-steps over the dims; dim pairs of the outputs
  constexpr int kDimTiles = D / 8;  // n-tiles of dQ, dK, dV
  constexpr int kChunks = D / 8;    // 16-byte chunks of a row
  constexpr int kKeyTiles = kTcMaxKeys / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nqp = (nq + 15) & ~15;
  const int nkp = (nkv + 15) & ~15;
  const int ldp = nkp + kTcPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [nqp][kLds]
  bf16* os = qs + nqp * kLds;                // dO [nqp][kLds]
  bf16* ks = os + nqp * kLds;                // [nkp][kLds]
  bf16* vs = ks + nkp * kLds;                // [nkp][kLds]
  bf16* ps = vs + nkp * kLds;                // p~ [nqp][ldp]
  bf16* dss = ps + nqp * ldp;                // dS [nqp][ldp]

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int hd = h * D;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const uint8_t* mb = mask ? mask + static_cast<size_t>(b) * nkv : nullptr;

  // rows [0, rows) of src (row stride `stride`) into dst; rows >= limit are zeros.
  auto stage = [&](bf16* dst, const bf16* src, int rows, int limit, int stride) {
    for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
      const int r = e / kChunks;
      const int c = e % kChunks;
      const bool ok = r < limit;
      cp_async16(smem_u32(dst + r * kLds + c * 8),
                 src + static_cast<size_t>(ok ? r : 0) * stride + c * 8, ok ? 16 : 0);
    }
  };
  stage(qs, q + static_cast<size_t>(b) * nq * ld + head * D, nqp, nq, ld);
  stage(os, dout + static_cast<size_t>(b) * nq * hd + head * D, nqp, nq, hd);
  stage(ks, k + static_cast<size_t>(b) * nkv * ld + head * D, nkp, nkv, ld);
  stage(vs, v + static_cast<size_t>(b) * nkv * ld + head * D, nkp, nkv, ld);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Phase 1: a warp a 16-row tile.
  for (int mt = warp; mt < nqp / 16; mt += warps) {
    const int i0 = 16 * mt;
    // Key n-tiles the tile's rows see (causal: keys up to row i0 + 15).
    const int nend = causal ? min(nkp / 8, 2 * mt + 2) : nkp / 8;
    float sc[kKeyTiles][4];  // logits, then e = expf(l - m), then p
    float dp[kKeyTiles][4];  // dP, then dS
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qa[4];
      uint32_t oa[4];
      const int at = (i0 + (lane & 15)) * kLds + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(qa, smem_u32(qs + at));
      ldmatrix_x4(oa, smem_u32(os + at));
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        if (2 * np >= nend) break;
        const int kat = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLds + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(ks + kat));
        mma_bf16(sc[2 * np], qa, r[0], r[1]);
        mma_bf16(sc[2 * np + 1], qa, r[2], r[3]);
        ldmatrix_x4(r, smem_u32(vs + kat));
        mma_bf16(dp[2 * np], oa, r[0], r[1]);
        mma_bf16(dp[2 * np + 1], oa, r[2], r[3]);
      }
    }
    // Logits in the forward's order: scale after the product, then the
    // causal -inf, then the additive key mask; padded keys are -inf.
    float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      if (n >= nend) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1);
        const int j = 8 * n + 2 * t + (e & 1);
        float l = __fmul_rn(sc[n][e], scale);
        if (j >= nkv || (causal && j > i)) {
          l = -INFINITY;
        } else if (mb && mb[j] == 0) {
          l = l - 1e9f;
        }
        sc[n][e] = l;
        m[e >> 1] = fmaxf(m[e >> 1], l);
      }
    }
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      if (n >= nend) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - m[e >> 1]);
        s[e >> 1] += sc[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2);
    }
    const float y[2] = {__frcp_rn(s[0]), __frcp_rn(s[1])};
    const bool live[2] = {i0 + g < nq, i0 + g + 8 < nq};
    float delta[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      if (n >= nend) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        sc[n][e] = live[r] ? div_rn_exact(sc[n][e], s[r], y[r]) : 0.0f;
        delta[r] = fmaf(sc[n][e], dp[n][e], delta[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
    // dS = p * (dP - delta); p~ and dS to shared memory as bf16, and dS
    // packed as the A operand of dQ (dsa[n] holds row g's and row g + 8's
    // pairs of key n-tile n).
    uint32_t dsa[kKeyTiles][2];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      if (n >= nend) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float d0 = sc[n][2 * r] * (dp[n][2 * r] - delta[r]);
        const float d1 = sc[n][2 * r + 1] * (dp[n][2 * r + 1] - delta[r]);
        const int at = (i0 + g + 8 * r) * ldp + 8 * n + 2 * t;
        dsa[n][r] = pack_bf16(d0, d1);
        *reinterpret_cast<uint32_t*>(ps + at) = pack_bf16(sc[n][2 * r], sc[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dss + at) = dsa[n][r];
      }
    }
    float acc[kDimTiles][4];
#pragma unroll
    for (int n = 0; n < kDimTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
      if (2 * kk >= nend) break;
      const uint32_t a[4] = {dsa[2 * kk][0], dsa[2 * kk][1], dsa[2 * kk + 1][0],
                             dsa[2 * kk + 1][1]};
#pragma unroll
      for (int dpi = 0; dpi < kSteps; ++dpi) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLds +
                                      dpi * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dpi], a, r[0], r[1]);
        mma_bf16(acc[2 * dpi + 1], a, r[2], r[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      if (i >= nq) continue;
      bf16* dst = dq + (static_cast<size_t>(b) * nq + i) * hd + head * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kDimTiles; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
      }
    }
  }
  __syncthreads();

  // Phase 2: a warp a 16-key tile. dV = p~^T dO, then dK = dS^T Q D^-0.5,
  // over the query tiles that see the keys (causal: from the tile's own).
  // p~ and dS are [query][key] in shared memory: ldmatrix.trans gives the A
  // fragments of their transposes (matrix i of lane l: query rows 8 (i / 2)
  // + l % 8 of the k-step, keys 8 (i % 2) of the tile).
  for (int nt = warp; nt < nkp / 16; nt += warps) {
    const int j0 = 16 * nt;
    const int first = causal ? nt : 0;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const bf16* at = pass == 0 ? ps : dss;   // A: p~, then dS (transposed)
      const bf16* bt = pass == 0 ? os : qs;    // B: dO, then Q
      bf16* out = pass == 0 ? dv : dk;
      const float mul = pass == 0 ? 1.0f : scale;
      float acc[kDimTiles][4];
#pragma unroll
      for (int n = 0; n < kDimTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
      for (int st = first; st < nqp / 16; ++st) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, smem_u32(at + (16 * st + (lane & 7) + ((lane >> 4) << 3)) * ldp +
                                      j0 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int dpi = 0; dpi < kSteps; ++dpi) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, smem_u32(bt + (16 * st + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                 kLds + dpi * 16 + (lane >> 4) * 8));
          mma_bf16(acc[2 * dpi], a, r[0], r[1]);
          mma_bf16(acc[2 * dpi + 1], a, r[2], r[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + g + 8 * r;
        if (j >= nkv) continue;
        bf16* dst = out + (static_cast<size_t>(b) * nkv + j) * hd + head * D + 2 * t;
#pragma unroll
        for (int n = 0; n < kDimTiles; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
              __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
        }
      }
    }
  }
}

template <int D>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* mask,
                  const void* dout, void* dq, void* dk, void* dv, int ld, int b, int nq, int nkv,
                  int h, int causal, float scale, cudaStream_t stream) {
  const int nqp = (nq + 15) & ~15;
  const int nkp = (nkv + 15) & ~15;
  const size_t smem = tc_bwd_smem_bytes(D, nqp, nkp);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Four warps up to 64 rows and keys (a tile each), eight past that.
  const int warps = max(nqp, nkp) > 64 ? kTcMaxWarps : kTcMaxWarps / 2;
  mha_bwd_tc_kernel<D><<<dim3(h, b), warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), ld, nq, nkv, h, causal, scale);
  return static_cast<int>(cudaGetLastError());
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

// The tensor-core route: bf16 q, k, v (16-byte aligned base pointers, rows
// ld elements apart, ld % 8 == 0), mask and dout as pk_mha_bwd's (dout
// 16-byte aligned); writes dq, dk, dv (bf16, contiguous). d in {32, 48, ...,
// 128}; 1 <= nq, nkv <= 128 and, when causal, nq == nkv. No scratch: each
// row's statistics come from the row itself.
int pk_mha_bwd_tc(const void* q, const void* k, const void* v, const void* mask,
                  const void* dout, void* dq, void* dk, void* dv, int ld, int b, int nq, int nkv,
                  int h, int d, int causal, float scale, void* stream) {
  if (nq < 1 || nkv < 1 || nq > kTcMaxKeys || nkv > kTcMaxKeys) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PK_BWD_TC_CASE(DIM)                                                              \
  case DIM:                                                                              \
    return launch_bwd_tc<DIM>(q, k, v, mask, dout, dq, dk, dv, ld, b, nq, nkv, h, causal, \
                              scale, st);
  switch (d) {
    PK_BWD_TC_CASE(32)
    PK_BWD_TC_CASE(48)
    PK_BWD_TC_CASE(64)
    PK_BWD_TC_CASE(80)
    PK_BWD_TC_CASE(96)
    PK_BWD_TC_CASE(112)
    PK_BWD_TC_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PK_BWD_TC_CASE
}

}  // extern "C"
