// Flash attention backward for Hopper (FlashAttention-2's backward): the
// gradients of q, k and v from the forward's output o and its per-row
// log-sum-exp lse, with the forward's masks (causal, sliding window, query
// offset) and grouped KV heads.
//
// Replaces the reference's custom-VJP backward, _bwd_rule of
// src/repro/kernels/flash_attention/chunked.py (a jnp lax.scan over KV
// chunks, not a Pallas kernel):
//
//     D_i  = rowsum(dO_i o_i)
//     p_ij = exp(s_ij - lse_i),   s_ij = q_i k_j^T scale (masked: p = 0)
//     dV_j = sum_i p_ij dO_i
//     dS   = p (dO V^T - D) scale
//     dQ_i = sum_j dS_ij k_j;   dK_j = sum_i dS_ij q_i
//
// dK and dV of a KV head sum over its G query heads h = kvh * G + g. A row
// with no visible key, whose forward output is the mean of v (lse is then
// NEG_INF and cannot give p back), weighs every key by 1 / Skv in dV and
// passes no gradient to q or k: the exact gradient of the forward, which
// the plain version attention_bwd_ref states in torch.
//
// Two variants, picked per call by the wrapper's plan (ops.py), both
// writing every output element once, with no atomics, so that two calls
// give the same bits. Both run dK/dV blocks that own a KV tile and loop
// over the G query heads of its KV head and over the query tiles that
// give any key of the tile a nonzero p (the same visibility rule as the
// forward's kv_range: a query tile is skipped only if it contributes
// exactly nothing), so the group sum stays inside the block, and a dQ
// pass of its own over (b, h, query tile) and the KV tiles its live rows
// see.
//
// What bounds it on an H100: at smollm's training shape (B 8, S 512, 9 / 3
// heads, D 64, causal) a call reads q, k, v, o, dO once and writes dq, dk,
// dv once (~28 MB in bf16), against ~10 D operations per visible (q, k)
// pair (S, dP, dV, dQ, dK): ~6 GFLOP, ~210 operations per byte, under the
// bf16 ridge (~295), so the bytes bound it (~8 us), the tensor cores'
// rate close behind (~6 us).
//
// mma (bf16 operands, 16-byte aligned rows: training). Five products on
// the tensor cores, mma.sync.m16n8k16 with bf16 operands and f32
// accumulators, fragments by ldmatrix from shared memory rows padded by
// 16 bytes, tiles by 16-byte cp.async into two-stage rings (the next tile
// in flight while this one computes). Two kernels:
//   1. flash_bwd_mma_dq: one block of 4 warps per (b, h, 64 query rows), a
//      warp per 16 rows, the last tiles (the heaviest under the causal
//      mask) first. It first writes D = rowsum(dO o) of its rows, which
//      the dK/dV pass reads, then loops over KV tiles of 64 keys (32 at D
//      256): S = Q K^T and dP = dO V^T with queries as rows, dS = p (dP -
//      D) scale in registers, and dQ += dS K with dS's accumulators as the
//      A fragment, as the forward feeds P to P V.
//   2. flash_bwd_mma_dkdv: one block of 4 warps per (b, kvh, 32 keys), the
//      first KV tiles (every later query sees them) first; a warp owns 16
//      keys. Keys are rows: S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
//      sit in accumulator layout and feed dV += P^T dO and dK += dS^T Q
//      straight from registers (dO and Q by ldmatrix.trans); lse, D and
//      each query's visible keys are per column, loaded with the query
//      tile into its stage. Two warps share each 64-query tile, one half
//      each; their partial dK and dV are added in a fixed order through
//      shared memory at the end. Under the causal mask the first KV tile
//      sees every query tile and the last one; blocks of 32 keys keep the
//      heaviest block at half of what a 64-key block carries. At D 256
//      the warps split the head dim instead (each recomputes its keys'
//      S^T and dP^T), so a warp's accumulators stay at 128 registers.
// The mask selects after exp and dS are computed for every entry, with no
// branch per entry, so that the entries' arithmetic interleaves; p is
// 2^(s scale log2 e - lse log2 e), one ex2 per entry. tools/
// flash_bwd_variants.py times these choices against their alternatives
// (64-key blocks, four query warps, each KV tile's pairs split over two
// blocks with a pass that adds their partials, per-entry branches).
// P and dS are f32 in the reference; as operands of dV, dK and dQ each is
// split into BWD_TERMS = 2 bf16 terms (hi and lo: 2**-18 of each entry
// left, the small term issued first) whose products sum in f32. A plain
// torch emulation of this arithmetic (tests/test_torch_flash_bwd.py)
// holds phase 12's gate with two terms at every shape chip_smoke.py
// checks, using at most 0.12 of the gate's 1e-5 slack beyond one bf16
// rounding (three terms 0.02; one term misses it 100-200x over); two
// terms issue 96 products per warp and step of the dK/dV pass at D 64
// (16 keys x 32 queries) where three issue 128.
//
// fma (f32 operands, and layouts mma cannot take): the first design.
// Three kernels: flash_bwd_dsum (D = rowsum(dO o), one warp per row, into
// the (B, H, Sq) f32 scratch), flash_bwd_dkdv (one block per (b, kvh, BT
// keys)) and flash_bwd_dq (one block per (b, h, query tile)), all f32 on
// the CUDA cores: operands converted to f32 in shared memory, products
// and sums in f32, outputs in the operands' dtype, as chunked.py casts
// them. 256 threads as a 16 x 16 grid (tx, ty); BT = 64 keys and queries
// per tile (32 at D 256), held as f32 rows padded by 4. A thread owns the
// scores (ty + 16 i, tx + 16 j) of a tile pair and reads their q, dO, k
// and v rows as float4 along the head dim; for dK, dV and dQ it owns R =
// BT / 16 consecutive keys or rows and the head dim's float4 chunks tx +
// 16 c.
//
// Head dims 32, 64, 80, 128 and 256 are built for both. Layouts are the
// JAX package's public ones, read and written through element strides:
// q, o, dO, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, KVH, D); lse (B, H,
// Sq) contiguous f32.
//
// C interface (loaded with ctypes): flash_attention_bwd_launch returns the
// CUDA error code of the launches. dtype codes: 0 = float32, 1 = bfloat16;
// variant codes: 0 = fma, 1 = mma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_util.cuh"

namespace {

constexpr int NT = 256;  // threads per block, a 16 x 16 grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

struct Strides {  // element strides of a (batch, seq, head, dim=1) tensor
  int64_t b, s, h;
};

struct Args {
  int B, H, KVH, Sq, Skv;
  Strides q, k, v, o, dO, dq, dk, dv;
  float scale;
  int causal;
  int64_t window, q_offset;
  const float* lse;  // (B, H, Sq)
  float* dsum;       // (B, H, Sq) scratch: D = rowsum(dO o)
};

// The keys [lo, hi) that the query at absolute position p sees (the
// forward's mask: k <= p if causal, k > p - window, k < Skv). lo >= hi
// means the row sees no key.
__device__ __forceinline__ void key_range(const Args& a, int64_t p, int64_t& lo, int64_t& hi) {
  lo = imax(0, p - a.window + 1);
  hi = a.causal ? imin(a.Skv, p + 1) : a.Skv;
}

// p and dS of query row `row` (tile-relative r) against key kj, from the
// score s = q k^T (unscaled), dp = dO v^T, and the row's lse and D.
__device__ __forceinline__ void p_ds(const Args& a, int row, int64_t kj, float s, float dp,
                                     float lse, float dsum, float& p, float& ds) {
  p = 0.f;
  ds = 0.f;
  if (row >= a.Sq || kj >= a.Skv) return;
  int64_t lo, hi;
  key_range(a, (int64_t)row + a.q_offset, lo, hi);
  if (lo >= hi) {
    p = 1.f / (float)a.Skv;  // no visible key: the forward took the mean of v
  } else if (kj >= lo && kj < hi) {
    p = expf(s * a.scale - lse);
    ds = p * (dp - dsum) * a.scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dsum(const T* __restrict__ o,
                                                     const T* __restrict__ dO, Args a, int D) {
  const int64_t row = (int64_t)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)a.B * a.H * a.Sq) return;
  const int64_t i = row % a.Sq, bh = row / a.Sq;
  const int64_t h = bh % a.H, b = bh / a.H;
  const T* op = o + b * a.o.b + h * a.o.h + i * a.o.s;
  const T* dp = dO + b * a.dO.b + h * a.dO.h + i * a.dO.s;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(dp[d]), to_f32(op[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.dsum[row] = s;
}

template <int D, int BT>
struct Tile {
  // f32 rows padded by 4 floats: 16-byte aligned for float4 reads, and the
  // 8 lanes of a quarter warp reading 8 different rows hit distinct banks
  static constexpr int LD = D + 4;    // a q, dO, k or v row
  static constexpr int LDP = BT + 4;  // a P or dS row
  // K, V, Q, dO [BT][LD]; P, dS [BT][LDP]; lse, D [BT]
  static constexpr size_t smem = sizeof(float) * ((size_t)4 * BT * LD + 2 * BT * LDP + 2 * BT);
};

// rows [r0, r0 + BT) of a (batch, seq, head) slice into a padded f32 tile;
// rows past `rows` are zeros
template <typename T, int D, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride, int r0,
                                          int rows) {
  constexpr int LD = Tile<D, BT>::LD;
  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r * LD + d] = r0 + r < rows ? to_f32(src[(int64_t)(r0 + r) * stride + d]) : 0.f;
  }
}

// N consecutive floats of shared memory (16- or 8-byte aligned for 4 or 2)
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x, dst[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// S = Q K^T and dP = dO V^T for the thread's scores (ty + 16 i, tx + 16 j),
// four head dims per float4 read
template <int D, int BT>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, float (&s)[BT / 16][BT / 16],
                                       float (&dp)[BT / 16][BT / 16]) {
  constexpr int R = BT / 16, LD = Tile<D, BT>::LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 kv[R], vv[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = ld4(Ks + (tx + 16 * j) * LD + d);
      vv[j] = ld4(Vs + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 qv = ld4(Qs + (ty + 16 * i) * LD + d);
      const float4 ov = ld4(dOs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = dot4(qv, kv[j], s[i][j]);
        dp[i][j] = dot4(ov, vv[j], dp[i][j]);
      }
    }
  }
}

// acc[a][b] += x[a] * row[4 (tx + 16 b) .. + 4) for the thread's float4
// chunks of the head dim (chunk tx + 16 b, those below D / 4)
template <int D, int A>
__device__ __forceinline__ void axpy_rows(float (&acc)[A][(D + 63) / 64][4], const float (&x)[A],
                                          const float* row) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int b = 0; b < (D + 63) / 64; ++b) {
    if ((D % 64 == 0) || tx + 16 * b < D / 4) {
      const float4 v = ld4(row + 4 * (tx + 16 * b));
#pragma unroll
      for (int a = 0; a < A; ++a) {
        acc[a][b][0] = fmaf(x[a], v.x, acc[a][b][0]);
        acc[a][b][1] = fmaf(x[a], v.y, acc[a][b][1]);
        acc[a][b][2] = fmaf(x[a], v.z, acc[a][b][2]);
        acc[a][b][3] = fmaf(x[a], v.w, acc[a][b][3]);
      }
    }
  }
}

// rows row0 + a of a (seq, dim) slice from acc[a][b] (chunks as axpy_rows)
template <typename T, int D, int A>
__device__ __forceinline__ void store_rows(T* base, int64_t stride, int64_t row0, int64_t rows,
                                           const float (&acc)[A][(D + 63) / 64][4]) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    if (row0 + a >= rows) continue;
    T* p = base + (row0 + a) * stride;
#pragma unroll
    for (int b = 0; b < (D + 63) / 64; ++b)
      if ((D % 64 == 0) || tx + 16 * b < D / 4)
#pragma unroll
        for (int e = 0; e < 4; ++e) store(p + 4 * (tx + 16 * b) + e, acc[a][b][e]);
  }
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv(const T* __restrict__ q,
                                                     const T* __restrict__ k,
                                                     const T* __restrict__ v,
                                                     const T* __restrict__ dO, T* __restrict__ dk,
                                                     T* __restrict__ dv, Args a) {
  constexpr int R = BT / 16, C4 = (D + 63) / 64, LD = Tile<D, BT>::LD, LDP = Tile<D, BT>::LDP;
  static_assert(D % 4 == 0 && BT % 16 == 0, "tiles split over a 16 x 16 thread grid");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Ps = dOs + BT * LD;
  float* dSs = Ps + BT * LDP;
  float* lse_s = dSs + BT * LDP;
  float* dsum_s = lse_s + BT;

  const int k0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D, BT>(Ks, k + b * a.k.b + kh * a.k.h, a.k.s, k0, a.Skv);
  load_tile<T, D, BT>(Vs, v + b * a.v.b + kh * a.v.h, a.v.s, k0, a.Skv);

  // this thread's keys R ty .. R ty + R - 1 of the tile, its float4 chunks of D
  float dk_acc[R][C4][4], dv_acc[R][C4][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][c][e] = dv_acc[i][c][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;  // this head's rows of lse and D
    for (int q0 = 0; q0 < a.Sq; q0 += BT) {
      // does a row of this query tile give a key of the KV tile a nonzero p?
      // (also the barrier after the previous tile pair's last reads)
      int touch = 0;
      if (threadIdx.x < BT && q0 + (int)threadIdx.x < a.Sq) {
        int64_t lo, hi;
        key_range(a, (int64_t)q0 + threadIdx.x + a.q_offset, lo, hi);
        touch = lo >= hi || (lo < (int64_t)k0 + BT && hi > k0);
      }
      if (!__syncthreads_or(touch)) continue;

      load_tile<T, D, BT>(Qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.Sq);
      load_tile<T, D, BT>(dOs, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.Sq);
      if (threadIdx.x < BT) {
        const bool in = q0 + (int)threadIdx.x < a.Sq;
        lse_s[threadIdx.x] = in ? a.lse[row0 + q0 + threadIdx.x] : 0.f;
        dsum_s[threadIdx.x] = in ? a.dsum[row0 + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      float s[R][R], dp[R][R];
      scores<D, BT>(Qs, dOs, Ks, Vs, s, dp);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          float p, ds;
          p_ds(a, q0 + r, (int64_t)k0 + c, s[i][j], dp[i][j], lse_s[r], dsum_s[r], p, ds);
          Ps[r * LDP + c] = p;
          dSs[r * LDP + c] = ds;
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's query rows
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        float pv[R], dsv[R];
        load_vec<R>(pv, Ps + r * LDP + R * ty);
        load_vec<R>(dsv, dSs + r * LDP + R * ty);
        axpy_rows<D, R>(dv_acc, pv, dOs + r * LD);
        axpy_rows<D, R>(dk_acc, dsv, Qs + r * LD);
      }
    }
  }

  store_rows<T, D, R>(dk + b * a.dk.b + kh * a.dk.h, a.dk.s, (int64_t)k0 + R * ty, a.Skv,
                      dk_acc);
  store_rows<T, D, R>(dv + b * a.dv.b + kh * a.dv.h, a.dv.s, (int64_t)k0 + R * ty, a.Skv,
                      dv_acc);
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(NT) flash_bwd_dq(const T* __restrict__ q,
                                                   const T* __restrict__ k,
                                                   const T* __restrict__ v,
                                                   const T* __restrict__ dO, T* __restrict__ dq,
                                                   Args a) {
  constexpr int R = BT / 16, C4 = (D + 63) / 64, LD = Tile<D, BT>::LD, LDP = Tile<D, BT>::LDP;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* dSt = dOs + BT * LD + BT * LDP;  // dS transposed, [key][row]; the P tile's room unused
  float* lse_s = dSt + BT * LDP;
  float* dsum_s = lse_s + BT;

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KVH);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;

  load_tile<T, D, BT>(Qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.Sq);
  load_tile<T, D, BT>(dOs, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.Sq);
  if (threadIdx.x < BT) {
    const bool in = q0 + (int)threadIdx.x < a.Sq;
    lse_s[threadIdx.x] = in ? a.lse[row0 + q0 + threadIdx.x] : 0.f;
    dsum_s[threadIdx.x] = in ? a.dsum[row0 + q0 + threadIdx.x] : 0.f;
  }
  // this thread's row of the tile (threads < BT): its visible keys
  int64_t lo = 0, hi = 0;
  if (threadIdx.x < BT && q0 + (int)threadIdx.x < a.Sq)
    key_range(a, (int64_t)q0 + threadIdx.x + a.q_offset, lo, hi);

  // this thread's rows R ty .. R ty + R - 1 of the tile, its float4 chunks of D
  float dq_acc[R][C4][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[i][c][e] = 0.f;

  for (int64_t k0 = 0; k0 < a.Skv; k0 += BT) {
    // does a live row see a key of this tile? (rows with no visible key
    // pass no gradient to q); also the barrier after the last tile's reads
    if (!__syncthreads_or(lo < hi && lo < k0 + BT && hi > k0)) continue;
    load_tile<T, D, BT>(Ks, k + b * a.k.b + kh * a.k.h, a.k.s, (int)k0, a.Skv);
    load_tile<T, D, BT>(Vs, v + b * a.v.b + kh * a.v.h, a.v.s, (int)k0, a.Skv);
    __syncthreads();

    float s[R][R], dp[R][R];
    scores<D, BT>(Qs, dOs, Ks, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float p, ds;
        p_ds(a, q0 + r, k0 + c, s[i][j], dp[i][j], lse_s[r], dsum_s[r], p, ds);
        dSt[c * LDP + r] = ds;
      }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int c_key = 0; c_key < BT; ++c_key) {
      float dsv[R];
      load_vec<R>(dsv, dSt + c_key * LDP + R * ty);
      axpy_rows<D, R>(dq_acc, dsv, Ks + c_key * LD);
    }
  }

  store_rows<T, D, R>(dq + b * a.dq.b + h * a.dq.h, a.dq.s, (int64_t)q0 + R * ty, a.Sq, dq_acc);
}

template <typename Kern>
int raise_smem(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO, void* dq,
           void* dk, void* dv, const Args& a, cudaStream_t s) {
  constexpr int BT = D <= 128 ? 64 : 32;
  constexpr size_t smem = Tile<D, BT>::smem;
  static_assert(smem <= 232448, "shared memory of one block exceeds 227 KB");
  static thread_local bool configured = false;  // the caps, once per host thread
  if (!configured) {
    int e = raise_smem(flash_bwd_dkdv<T, D, BT>, smem);
    if (e == 0) e = raise_smem(flash_bwd_dq<T, D, BT>, smem);
    if (e != 0) return e;
    configured = true;
  }
  const long long rows = (long long)a.B * a.H * a.Sq;
  const long long dsum_blocks = (rows + NT / 32 - 1) / (NT / 32);
  const long long kt = (a.Skv + BT - 1) / BT, qt = (a.Sq + BT - 1) / BT;
  if (dsum_blocks > 2147483647LL || kt > 2147483647LL || qt > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  flash_bwd_dsum<T><<<(unsigned)dsum_blocks, NT, 0, s>>>((const T*)o, (const T*)dO, a, D);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  flash_bwd_dkdv<T, D, BT><<<dim3((unsigned)kt, (unsigned)a.KVH, (unsigned)a.B), NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, (T*)dk, (T*)dv, a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  flash_bwd_dq<T, D, BT><<<dim3((unsigned)qt, (unsigned)a.H, (unsigned)a.B), NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, (T*)dq, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* o, const void* dO,
             void* dq, void* dk, void* dv, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, dO, dq, dk, dv, a, s);
    case 64: return launch<T, 64>(q, k, v, o, dO, dq, dk, dv, a, s);
    case 80: return launch<T, 80>(q, k, v, o, dO, dq, dk, dv, a, s);
    case 128: return launch<T, 128>(q, k, v, o, dO, dq, dk, dv, a, s);
    case 256: return launch<T, 256>(q, k, v, o, dO, dq, dk, dv, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 operands on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// bf16 terms of P (in dV) and of dS (in dK and dQ); see the note at the top
constexpr int BWD_TERMS = 2;
constexpr float LOG2E = 1.4426950408889634f;

// The query rows [q0, q0 + rows) of (b, h)'s tile: does one of them give a
// key of [k0, k1) a nonzero p (it sees one, or it sees no key at all and
// weighs every key by 1 / Skv)? Every lane of the warp gets the answer.
__device__ __forceinline__ bool q_tile_touches(const Args& a, int q0, int rows, int64_t k0,
                                               int64_t k1) {
  bool t = false;
  for (int r = threadIdx.x % 32; r < rows; r += 32) {
    if (q0 + r >= a.Sq) break;
    int64_t lo, hi;
    key_range(a, (int64_t)q0 + r + a.q_offset, lo, hi);
    t = t || lo >= hi || (lo < k1 && hi > k0);
  }
  return __any_sync(0xffffffffu, t);
}

// A row's visible keys [lo, hi) clamped to [0, Skv] (an empty range stays
// empty), and its weight in dV where it sees no key.
__device__ __forceinline__ void row_keys(const Args& a, int row, int& lo, int& hi, float& pdead) {
  lo = hi = 0;
  pdead = 0.f;
  if (row >= a.Sq) return;
  int64_t l, h;
  key_range(a, (int64_t)row + a.q_offset, l, h);
  lo = (int)imin(l, a.Skv);
  hi = (int)imax(h, 0);
  if (l >= h) pdead = 1.f / (float)a.Skv;
}

// dK/dV pass: one block per (b, kvh, BK keys); warp (kw, ds, qw) owns keys
// 16 kw .. 16 kw + 15 of the tile, head dims [ds DH, (ds + 1) DH) of their
// dK and dV, and queries [qw QPW, (qw + 1) QPW) of each query tile.
template <int D>
struct KvTile {
  static constexpr int KW = 2;                  // warps along the keys
  static constexpr int DS = D == 256 ? 2 : 1;   // warps along the head dim
  static constexpr int QW = 2 / DS;             // warps along a query tile
  static constexpr int NT = 32 * KW * DS * QW;  // 128
  static constexpr int BK = 16 * KW;            // keys per block
  static constexpr int BQ = D <= 128 ? 64 : 32;  // queries per step
  static constexpr int QPW = BQ / QW;           // queries per warp per step: 32
  static constexpr int DH = D / DS;             // head dims of a warp's dK and dV
  static constexpr int LD = D + 8;  // padded row: the 8 rows of an ldmatrix hit distinct banks
  // a stage: Q, dO [BQ][LD] bf16; lse, D, pdead [BQ] f32; lo, hi [BQ] int
  static constexpr size_t stage = sizeof(bf16) * 2 * BQ * LD + 5 * 4 * BQ;
  // K, V [BK][LD], then two stages
  static constexpr size_t smem = sizeof(bf16) * 2 * BK * LD + 2 * stage;
};

template <int D>
__global__ void __launch_bounds__(KvTile<D>::NT) flash_bwd_mma_dkdv(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dO, bf16* __restrict__ dk, bf16* __restrict__ dv, Args a) {
  using namespace mma;
  using C = KvTile<D>;
  constexpr int BK = C::BK, BQ = C::BQ, QPW = C::QPW, DH = C::DH, LD = C::LD, NT = C::NT;
  constexpr int CH = D / 8;     // 16-byte chunks of a row
  constexpr int ST = QPW / 8;   // n8 tiles of a warp's S^T
  constexpr int DT = DH / 8;    // n8 tiles of a warp's dK and dV
  static_assert(D % 16 == 0 && QPW % 16 == 0 && DT % 2 == 0, "tile does not split into k16 steps");
  static_assert(C::stage % 16 == 0, "stages keep 16-byte alignment");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  unsigned char* stages = reinterpret_cast<unsigned char*>(Vs + BK * LD);
  auto Qs = [&](int st) { return reinterpret_cast<bf16*>(stages + st * C::stage); };
  auto dOs = [&](int st) { return Qs(st) + BQ * LD; };
  auto lse_s = [&](int st) { return reinterpret_cast<float*>(dOs(st) + BQ * LD); };
  auto dsum_s = [&](int st) { return lse_s(st) + BQ; };
  auto pdead_s = [&](int st) { return lse_s(st) + 2 * BQ; };
  auto lo_s = [&](int st) { return reinterpret_cast<int*>(lse_s(st) + 3 * BQ); };
  auto hi_s = [&](int st) { return lo_s(st) + BQ; };

  // x runs over (b, kvh); y over the KV tiles, the first (under the causal
  // mask the heaviest: every later query sees it) first
  const int b = blockIdx.x / a.KVH, kh = blockIdx.x % a.KVH;
  const int k0 = blockIdx.y * BK;
  const int G = a.H / a.KVH, nqt = (a.Sq + BQ - 1) / BQ, npairs = G * nqt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp % C::KW, ds = (warp / C::KW) % C::DS, qw = warp / (C::KW * C::DS);
  const int g = lane / 4, tq = lane % 4;

  const bf16* kb = k + b * a.k.b + kh * a.k.h;
  const bf16* vb = v + b * a.v.b + kh * a.v.h;
  for (int idx = threadIdx.x; idx < BK * CH; idx += NT) {
    const int j = idx / CH, c = idx % CH;
    const bool in = k0 + j < a.Skv;
    cp_async16(Ks + j * LD + c * 8, in ? kb + (int64_t)(k0 + j) * a.k.s + c * 8 : kb, in ? 16 : 0);
    cp_async16(Vs + j * LD + c * 8, in ? vb + (int64_t)(k0 + j) * a.v.s + c * 8 : vb, in ? 16 : 0);
  }

  // the (query head, query tile) pairs it = g * nqt + qt that touch the
  // tile, in order; every warp finds the same ones
  auto next_pair = [&](int it) {
    for (; it < npairs; ++it)
      if (q_tile_touches(a, (it % nqt) * BQ, BQ, k0, (int64_t)k0 + BK)) break;
    return it;
  };
  auto issue = [&](int it, int st) {  // pair it's q, dO, lse, D and masks into stage st
    const int h = kh * G + it / nqt, q0 = (it % nqt) * BQ;
    const bf16* qb = q + b * a.q.b + h * a.q.h;
    const bf16* ob = dO + b * a.dO.b + h * a.dO.h;
    bf16* qd = Qs(st);
    bf16* od = dOs(st);
    for (int idx = threadIdx.x; idx < BQ * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH;
      const bool in = q0 + r < a.Sq;
      cp_async16(qd + r * LD + c * 8, in ? qb + (int64_t)(q0 + r) * a.q.s + c * 8 : qb,
                 in ? 16 : 0);
      cp_async16(od + r * LD + c * 8, in ? ob + (int64_t)(q0 + r) * a.dO.s + c * 8 : ob,
                 in ? 16 : 0);
    }
    const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq + q0;  // this tile's rows of lse and D
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool in = q0 + r < a.Sq;
      cp_async4(lse_s(st) + r, in ? a.lse + row0 + r : a.lse, in ? 4 : 0);
      cp_async4(dsum_s(st) + r, in ? a.dsum + row0 + r : a.dsum, in ? 4 : 0);
      row_keys(a, q0 + r, lo_s(st)[r], hi_s(st)[r], pdead_s(st)[r]);
    }
  };

  // one copy group per step (empty past the last), the first with K and V
  int cur = next_pair(0);
  if (cur < npairs) issue(cur, 0);
  cp_async_commit();
  int nxt = cur < npairs ? next_pair(cur + 1) : npairs;
  if (nxt < npairs) issue(nxt, 1);
  cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const LaneRC ar = a_rows(lane), br = b_rows(lane), bc = b_cols(lane);
  const bf16* krow = Ks + (16 * kw + ar.r) * LD + ar.c;  // A: the warp's keys of K
  const bf16* vrow = Vs + (16 * kw + ar.r) * LD + ar.c;  // A: and of V
  const int key[2] = {k0 + 16 * kw + g, k0 + 16 * kw + g + 8};
  const float scale2 = a.scale * LOG2E;  // exp(x scale - lse) = 2^(x scale2 - lse log2 e)

  for (int t = 0; cur < npairs; ++t) {
    if (t >= 1) {
      __syncthreads();  // every warp is done with step t - 1's stage
      if (nxt < npairs) issue(nxt, (t + 1) & 1);
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();  // step t has landed
    const int st = t & 1;
    const bf16* qs = Qs(st) + qw * QPW * LD;
    const bf16* os = dOs(st) + qw * QPW * LD;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and QPW queries
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, krow + kk * 16);
      ldsm_x4(va, vrow + kk * 16);
#pragma unroll
      for (int n = 0; n < ST; n += 2) {
        uint32_t qf[4], of[4];  // b0, b1 of query tiles n and n + 1
        ldsm_x4(qf, qs + (n * 8 + br.r) * LD + kk * 16 + br.c);
        ldsm_x4(of, os + (n * 8 + br.r) * LD + kk * 16 + br.c);
        mma_bf16(s[n], ka, qf[0], qf[1]);
        mma_bf16(s[n + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[n], va, of[0], of[1]);
        mma_bf16(dp[n + 1], va, of[2], of[3]);
      }
    }

    // P^T and dS^T in place: column c is query qw QPW + c of the tile.
    // Without branches: exp and dS are computed for every entry and the
    // mask selects, so the entries' arithmetic interleaves.
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = qw * QPW + n * 8 + 2 * tq + j;
        const float ls = lse_s(st)[c] * LOG2E, dd = dsum_s(st)[c], pd = pdead_s(st)[c];
        const int lo = lo_s(st)[c], hi = hi_s(st)[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + j;
          const bool vis = (key[r] >= lo) & (key[r] < hi);
          const float p = exp2f(fmaf(s[n][e], scale2, -ls));
          const float ds = p * (dp[n][e] - dd) * a.scale;
          s[n][e] = vis ? p : pd;
          dp[n][e] = vis ? ds : 0.f;
        }
      }

    // dV += P^T dO and dK += dS^T Q over the warp's queries: the
    // accumulators of query tiles 2kk, 2kk + 1 are the A fragment of
    // queries [16kk, 16kk + 16), split into BWD_TERMS bf16 terms
#pragma unroll
    for (int kk = 0; kk < QPW / 16; ++kk) {
      uint32_t pa[4][BWD_TERMS], sa[4][BWD_TERMS];
      split_bf16<BWD_TERMS>(s[2 * kk][0], s[2 * kk][1], pa[0]);
      split_bf16<BWD_TERMS>(s[2 * kk][2], s[2 * kk][3], pa[1]);
      split_bf16<BWD_TERMS>(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2]);
      split_bf16<BWD_TERMS>(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3]);
      split_bf16<BWD_TERMS>(dp[2 * kk][0], dp[2 * kk][1], sa[0]);
      split_bf16<BWD_TERMS>(dp[2 * kk][2], dp[2 * kk][3], sa[1]);
      split_bf16<BWD_TERMS>(dp[2 * kk + 1][0], dp[2 * kk + 1][1], sa[2]);
      split_bf16<BWD_TERMS>(dp[2 * kk + 1][2], dp[2 * kk + 1][3], sa[3]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t of[4], qf[4];  // b0, b1 of head-dim tiles n and n + 1
        const int at = (kk * 16 + bc.r) * LD + ds * DH + n * 8 + bc.c;
        ldsm_x4_t(of, os + at);
        ldsm_x4_t(qf, qs + at);
#pragma unroll
        for (int term = BWD_TERMS - 1; term >= 0; --term) {  // the small terms first
          const uint32_t pf[4] = {pa[0][term], pa[1][term], pa[2][term], pa[3][term]};
          const uint32_t sf[4] = {sa[0][term], sa[1][term], sa[2][term], sa[3][term]};
          mma_bf16(dv_acc[n], pf, of[0], of[1]);
          mma_bf16(dv_acc[n + 1], pf, of[2], of[3]);
          mma_bf16(dk_acc[n], sf, qf[0], qf[1]);
          mma_bf16(dk_acc[n + 1], sf, qf[2], qf[3]);
        }
      }
    }
    cur = nxt;
    if (nxt < npairs) nxt = next_pair(nxt + 1);
  }

  cp_async_wait<0>();
  // the query parts' partial sums, added in a fixed order (qw = 1, 2, ..)
  // through the stages' room: in turn, the qw = p warps write theirs and
  // the qw = 0 warps add them
  float* red = reinterpret_cast<float*>(stages) + ((ds * C::KW + kw) * DT * 8) * 32 + lane;
  static_assert(sizeof(float) * C::KW * C::DS * DH * 32 <= 2 * C::stage,
                "the partial sums fit in the stages' room");
  for (int part = 1; part < C::QW; ++part) {
    __syncthreads();  // every warp is done with the stages, or the last part's sums
    if (qw == part) {
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[((n * 4 + e) * 2) * 32] = dk_acc[n][e];
          red[((n * 4 + e) * 2 + 1) * 32] = dv_acc[n][e];
        }
    }
    __syncthreads();
    if (qw == 0) {
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk_acc[n][e] += red[((n * 4 + e) * 2) * 32];
          dv_acc[n][e] += red[((n * 4 + e) * 2 + 1) * 32];
        }
    }
  }
  if (qw != 0) return;

  bf16* dkb = dk + b * a.dk.b + kh * a.dk.h + ds * DH + 2 * tq;
  bf16* dvb = dv + b * a.dv.b + kh * a.dv.h + ds * DH + 2 * tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.Skv) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key[r] * a.dk.s + n * 8) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key[r] * a.dv.s + n * 8) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// dQ pass: one block per (b, h, BQ query rows), a warp per 16 rows; it also
// writes D = rowsum(dO o) of its rows for the dK/dV pass, which runs after.
template <int D>
struct QTile {
  static constexpr int NW = 4, NT = 32 * NW, BQ = 16 * NW;
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys per step
  static constexpr int LD = D + 8;
  // Q, dO [BQ][LD], then two stages of K, V [BK][LD]
  static constexpr size_t smem = sizeof(bf16) * (size_t)LD * (2 * BQ + 4 * BK);
};

template <int D>
__global__ void __launch_bounds__(QTile<D>::NT) flash_bwd_mma_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dO, bf16* __restrict__ dq, Args a) {
  using namespace mma;
  using C = QTile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::NT;
  constexpr int CH = D / 8, KT = BK / 8, DT = D / 8;
  static_assert(D % 16 == 0 && BK % 16 == 0 && DT % 2 == 0, "tile does not split into k16 steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                        // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                     // [2][BK][LD]

  // x runs over (b, h); y over the query tiles, the last (heaviest under
  // the causal mask) first
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kh = h / (a.H / a.KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;

  const bf16* qb = q + b * a.q.b + h * a.q.h;
  const bf16* ob = dO + b * a.dO.b + h * a.dO.h;
  const bf16* kb = k + b * a.k.b + kh * a.k.h;
  const bf16* vb = v + b * a.v.b + kh * a.v.h;
  for (int idx = threadIdx.x; idx < BQ * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const bool in = q0 + r < a.Sq;
    cp_async16(Qs + r * LD + c * 8, in ? qb + (int64_t)(q0 + r) * a.q.s + c * 8 : qb, in ? 16 : 0);
    cp_async16(dOs + r * LD + c * 8, in ? ob + (int64_t)(q0 + r) * a.dO.s + c * 8 : ob,
               in ? 16 : 0);
  }

  // the keys the block's live rows see: their ranges grow with the row and
  // overlap, so their union runs from the first live row's lo to the last's hi
  int64_t kv_lo = 0, kv_hi = 0;
  bool any = false;
  for (int r = 0; r < BQ && q0 + r < a.Sq; ++r) {
    int64_t lo, hi;
    key_range(a, (int64_t)q0 + r + a.q_offset, lo, hi);
    if (lo < hi) {
      if (!any) kv_lo = lo;
      kv_hi = hi;
      any = true;
    }
  }
  const int64_t kstart = (kv_lo / BK) * BK;
  const int ntiles = any ? (int)((kv_hi - kstart + BK - 1) / BK) : 0;

  auto load_kv = [&](int t) {  // KV step t into stage t % 2; keys past Skv are zeros
    const int64_t k0 = kstart + (int64_t)t * BK;
    bf16* ks = Ks + (t & 1) * BK * LD;
    bf16* vs = Vs + (t & 1) * BK * LD;
    for (int idx = threadIdx.x; idx < BK * CH; idx += NT) {
      const int j = idx / CH, c = idx % CH;
      const bool in = k0 + j < a.Skv;
      cp_async16(ks + j * LD + c * 8, in ? kb + (k0 + j) * a.k.s + c * 8 : kb, in ? 16 : 0);
      cp_async16(vs + j * LD + c * 8, in ? vb + (k0 + j) * a.v.s + c * 8 : vb, in ? 16 : 0);
    }
  };
  if (ntiles > 0) load_kv(0);
  cp_async_commit();
  if (ntiles > 1) load_kv(1);
  cp_async_commit();

  // D = rowsum(dO o) of the warp's 16 rows, from device memory while the
  // copies fly: lanes 2r, 2r + 1 sum the two halves of row r
  float dsum[2];
  {
    const int row = q0 + warp * 16 + lane / 2, half = lane % 2;
    float acc = 0.f;
    if (row < a.Sq) {
      const bf16* op = o + b * a.o.b + h * a.o.h + (int64_t)row * a.o.s + half * (D / 2);
      const bf16* dp = dO + b * a.dO.b + h * a.dO.h + (int64_t)row * a.dO.s + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(op + c);
        const uint4 y = *reinterpret_cast<const uint4*>(dp + c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 xf = unpack_bf16(xs[w]), yf = unpack_bf16(ys[w]);
          acc = fmaf(yf.x, xf.x, acc);
          acc = fmaf(yf.y, xf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0 && row < a.Sq) a.dsum[((int64_t)b * a.H + h) * a.Sq + row] = acc;
    dsum[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    dsum[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
  }
  // this thread's rows g and g + 8 of the warp's 16: visible keys and lse
  int lo[2], hi[2];
  float lse2[2], unused;  // lse log2 e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    row_keys(a, row, lo[r], hi[r], unused);
    lse2[r] = row < a.Sq ? a.lse[((int64_t)b * a.H + h) * a.Sq + row] * LOG2E : 0.f;
  }
  const float scale2 = a.scale * LOG2E;  // exp(x scale - lse) = 2^(x scale2 - lse log2 e)

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const LaneRC ar = a_rows(lane), br = b_rows(lane), bc = b_cols(lane);
  const bf16* qrow = Qs + (warp * 16 + ar.r) * LD + ar.c;   // A: Q
  const bf16* orow = dOs + (warp * 16 + ar.r) * LD + ar.c;  // A: dO

  for (int t = 0; t < ntiles; ++t) {
    if (t >= 1) {
      __syncthreads();  // every warp is done with step t - 1's stage
      if (t + 1 < ntiles) load_kv(t + 1);
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();  // step t (and, at t = 0, Q and dO) has landed
    const bf16* ks = Ks + (t & 1) * BK * LD;
    const bf16* vs = Vs + (t & 1) * BK * LD;
    const int k0 = (int)(kstart + (int64_t)t * BK);

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[KT][4], dp[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, qrow + kk * 16);
      ldsm_x4(oa, orow + kk * 16);
#pragma unroll
      for (int n = 0; n < KT; n += 2) {
        uint32_t kf[4], vf[4];  // b0, b1 of key tiles n and n + 1
        ldsm_x4(kf, ks + (n * 8 + br.r) * LD + kk * 16 + br.c);
        ldsm_x4(vf, vs + (n * 8 + br.r) * LD + kk * 16 + br.c);
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[n], oa, vf[0], vf[1]);
        mma_bf16(dp[n + 1], oa, vf[2], vf[3]);
      }
    }
    // dS in place of S (rows with no visible key pass no gradient),
    // computed for every entry and selected by the mask, without branches
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * tq + (e & 1), r = e >> 1;
        const bool vis = (kj >= lo[r]) & (kj < hi[r]);
        const float ds = exp2f(fmaf(s[n][e], scale2, -lse2[r])) * (dp[n][e] - dsum[r]) * a.scale;
        s[n][e] = vis ? ds : 0.f;
      }
    // dQ += dS K: dS's accumulators of key tiles 2kk, 2kk + 1 are the A
    // fragment of keys [16kk, 16kk + 16), split into BWD_TERMS bf16 terms
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4][BWD_TERMS];
      split_bf16<BWD_TERMS>(s[2 * kk][0], s[2 * kk][1], sa[0]);
      split_bf16<BWD_TERMS>(s[2 * kk][2], s[2 * kk][3], sa[1]);
      split_bf16<BWD_TERMS>(s[2 * kk + 1][0], s[2 * kk + 1][1], sa[2]);
      split_bf16<BWD_TERMS>(s[2 * kk + 1][2], s[2 * kk + 1][3], sa[3]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t kf[4];  // b0, b1 of head-dim tiles n and n + 1
        ldsm_x4_t(kf, ks + (kk * 16 + bc.r) * LD + n * 8 + bc.c);
#pragma unroll
        for (int term = BWD_TERMS - 1; term >= 0; --term) {  // the small terms first
          const uint32_t sf[4] = {sa[0][term], sa[1][term], sa[2][term], sa[3][term]};
          mma_bf16(acc[n], sf, kf[0], kf[1]);
          mma_bf16(acc[n + 1], sf, kf[2], kf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* qd = dq + b * a.dq.b + h * a.dq.h + 2 * tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(qd + (int64_t)row * a.dq.s + n * 8) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* o, const void* dO,
               void* dq, void* dk, void* dv, const Args& a, cudaStream_t s) {
  constexpr size_t smem_kv = KvTile<D>::smem, smem_q = QTile<D>::smem;
  static_assert(smem_kv <= 232448 && smem_q <= 232448, "shared memory of one block exceeds 227 KB");
  static thread_local bool configured = false;  // the caps, once per host thread
  if (!configured) {
    int e = raise_smem(flash_bwd_mma_dkdv<D>, smem_kv);
    if (e == 0) e = raise_smem(flash_bwd_mma_dq<D>, smem_q);
    if (e != 0) return e;
    configured = true;
  }
  const long long nq = (a.Sq + QTile<D>::BQ - 1) / QTile<D>::BQ;
  const long long nk = (a.Skv + KvTile<D>::BK - 1) / KvTile<D>::BK;
  if ((long long)a.B * a.H > 2147483647LL || nq > 65535 || nk > 65535)
    return (int)cudaErrorInvalidValue;
  // dQ first: it writes D, which the dK/dV pass reads
  flash_bwd_mma_dq<D><<<dim3((unsigned)(a.B * a.H), (unsigned)nq), QTile<D>::NT, smem_q, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dO, (bf16*)dq,
      a);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  flash_bwd_mma_dkdv<D><<<dim3((unsigned)(a.B * a.KVH), (unsigned)nk), KvTile<D>::NT, smem_kv,
                          s>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO,
                               (bf16*)dk, (bf16*)dv, a);
  return (int)cudaGetLastError();
}

int launch_mma_d(int D, const void* q, const void* k, const void* v, const void* o,
                 const void* dO, void* dq, void* dk, void* dv, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32: return launch_mma<32>(q, k, v, o, dO, dq, dk, dv, a, s);
    case 64: return launch_mma<64>(q, k, v, o, dO, dq, dk, dv, a, s);
    case 80: return launch_mma<80>(q, k, v, o, dO, dq, dk, dv, a, s);
    case 128: return launch_mma<128>(q, k, v, o, dO, dq, dk, dv, a, s);
    case 256: return launch_mma<256>(q, k, v, o, dO, dq, dk, dv, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// strides: 24 element strides, (batch, seq, head) of q, k, v, o, dO, dq, dk,
// dv in that order; every head-dim stride is 1. lse is a contiguous
// (B, H, Sq) f32 buffer; dsum a (B, H, Sq) f32 scratch the launch writes.
// variant: 0 = fma (f32 or bf16, any such strides), 1 = mma (bf16; bases
// 16-byte aligned and the other strides multiples of 8, as the wrapper's
// plan checks).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dO, const void* lse, void* dsum, void* dq, void* dk,
                               void* dv, int B, int H, int KVH, int Sq, int Skv, int D,
                               const long long* strides, float scale, int causal,
                               long long window, long long q_offset, int dtype, int variant,
                               void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  Args a{B, H, KVH, Sq, Skv,
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
         {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         {st[18], st[19], st[20]}, {st[21], st[22], st[23]},
         scale, causal, window, q_offset, (const float*)lse, (float*)dsum};
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_mma_d(D, q, k, v, o, dO, dq, dk, dv, a, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_d<float>(D, q, k, v, o, dO, dq, dk, dv, a, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(D, q, k, v, o, dO, dq, dk, dv, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
