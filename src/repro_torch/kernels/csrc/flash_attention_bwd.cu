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
// Three kernels, each writing every output element once, with no atomics,
// so that two calls give the same bits:
//   1. flash_bwd_dsum: D_i = rowsum(dO o), one warp per row, into a small
//      (B, H, Sq) f32 scratch;
//   2. flash_bwd_dkdv: one block per (b, kvh, KV tile of BT keys). It holds
//      its K and V tile in shared memory and loops over the G query heads
//      of its KV head and over the query tiles that give any key of the
//      tile a nonzero p (the same visibility rule as the forward's
//      kv_range: a query tile is skipped only if it contributes exactly
//      nothing), recomputes S and dP for the tile pair, and accumulates dK
//      and dV in f32 registers; the group sum stays inside the block;
//   3. flash_bwd_dq: one block per (b, h, query tile), looping over the KV
//      tiles its live rows see, accumulating dQ in f32 registers.
//
// What bounds it on an H100: at smollm's training shape (B 8, S 512, 9 / 3
// heads, D 64, causal) a call reads q, k, v, o, dO once and writes dq, dk,
// dv once (~28 MB in bf16), against ~10 D operations per visible (q, k)
// pair (S, dP, dV, dQ, dK): ~6 GFLOP, above the bf16 ridge. This first
// design runs them in f32 on the CUDA cores (loads of f32 or bf16
// operands converted to f32 in shared memory; products and sums in f32;
// outputs in the operands' dtype, as chunked.py casts them), so the f32
// FMA rate and shared memory bound it, far from the bound. A tensor-core
// design is later work.
//
// Tiles: 256 threads as a 16 x 16 grid (tx, ty). BT = 64 keys and queries
// per tile (32 at D 256), held in shared memory as f32 rows padded by 4.
// A thread owns the scores (ty + 16 i, tx + 16 j) of a tile pair and reads
// their q, dO, k and v rows as float4 along the head dim (strided rows, so
// the 8 lanes of a quarter warp read 8 distinct rows on distinct banks):
// 16 vector reads per 128 FMAs. For dK, dV and dQ it owns R = BT / 16
// consecutive keys or rows and the head dim's float4 chunks tx + 16 c,
// reading P or dS as one vector and dO, q or k as float4: 4 reads per 32
// FMAs at D 64. Head dims 32, 64, 80, 128 and 256 are built. Layouts are the JAX package's public ones, read and written
// through element strides: q, o, dO, dq (B, Sq, H, D); k, v, dk, dv
// (B, Skv, KVH, D); lse (B, H, Sq) contiguous f32.
//
// C interface (loaded with ctypes): flash_attention_bwd_launch returns the
// CUDA error code of the launches. dtype codes: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  static bool configured = false;  // raise the dynamic shared-memory caps once
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

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// strides: 24 element strides, (batch, seq, head) of q, k, v, o, dO, dq, dk,
// dv in that order; every head-dim stride is 1. lse is a contiguous
// (B, H, Sq) f32 buffer; dsum a (B, H, Sq) f32 scratch the launch writes.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dO, const void* lse, void* dsum, void* dq, void* dk,
                               void* dv, int B, int H, int KVH, int Sq, int Skv, int D,
                               const long long* strides, float scale, int causal,
                               long long window, long long q_offset, int dtype, void* stream) {
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
  if (dtype == 0) return launch_d<float>(D, q, k, v, o, dO, dq, dk, dv, a, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(D, q, k, v, o, dO, dq, dk, dv, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
