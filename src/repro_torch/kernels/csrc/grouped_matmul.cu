// Grouped GEMM for Hopper: the routed experts' products of a
// Mixture-of-Experts FFN, and their weight gradient.
//
// Replaces jax.lax.ragged_dot in the reference's moe_block
// (src/repro/models/moe.py), an XLA op, not a Pallas kernel. With the
// rows of x sorted by expert, group g owning rows [off_g, off_g + size_g)
// (off_g the sum of the sizes before it, formed here on the device):
//
//   forward  out[r] = x[r] @ w[g]            out (R, N) in x's type
//   dw       dw[g]  = x[rows of g]^T @ dy    (G, K, N) f32
//
// every product summed in f32. Rows past sum(size) are zero in out, as in
// ragged_dot; an empty group's dw is zero.
//
// What bounds it on an H100: the weights. deepseek-moe-16b's expert
// (2048 x 1408 bf16, 64 of them: 369 MB a call) is read once a call;
// a prefill's 3,072 rows do 17.7 GFLOP on it (~0.018 ms at 989 TFLOP/s
// against ~0.11 ms for the bytes), a decode step's 24 rows touch ~21
// experts. Training's 24,576 rows (141.7 GFLOP a call) are about
// balanced. So the forward reads each weight tile of a non-empty group
// once for each BM rows of the group, and no block reads the weight of
// an empty group: the grid is sized from R and G alone
// (ceil(R / BM) + G row tiles per column tile, enough for any sizes),
// and each block finds its group from the sizes (a warp's scan) or,
// past the last group's tiles, zeroes the rows past the sum, or exits.
//
// mma (bf16, 16-byte rows): 8 warps, 2 x 4, each a (16 MT) x 32 tile of
// mma.sync.m16n8k16 products (mma_util.cuh), BK = 64, a 3-stage cp.async
// ring, two blocks an SM (at most 128 registers a thread). BM = 32 MT rows: 32 at decode (a group holds a row or two),
// 64 at prefill, 128 in training. w is a strided view with either unit
// stride (BT: unit stride along k, w.transpose(-1, -2) of a (G, N, K)
// weight, as the backward's dX = dY w[g]^T reads it, with no copy); the
// tile is loaded as stored and the fragments come from ldmatrix with or
// without .trans. fma (f32, or bf16 rows off 16 bytes): 64 x 64 tiles of
// f32 FMAs on 256 threads, any strides.
//
// dw: one block per (n tile, k tile, group), summing the group's rows in
// order, 64 (mma) or 16 (fma) at a time: no atomics, so two calls give
// the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_util.cuh"

// The launch arguments (outside the anonymous namespace: the C interface
// takes them).
struct GmmArgs {
  long long R, K, N, G;
  long long sxr, sxk;       // x (R, K)
  long long swg, swk, swn;  // w (G, K, N)
  int dtype;                // 0 f32, 1 bf16
  int variant;              // 0 fma, 1 mma
  int bm;                   // mma: 32, 64 or 128
};

struct DwArgs {
  long long R, K, N, G;
  long long sxr, sxk;  // x (R, K)
  long long sdr, sdn;  // dy (R, N)
  int dtype, variant;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;     // threads a block, every kernel
constexpr int BN = 128;     // mma: output columns a block
constexpr int BK = 64;      // mma: depth a pipeline stage
constexpr int STAGES = 3;   // mma: cp.async ring
constexpr int PAD = 8;      // bf16 padding of a shared-memory row (16 bytes)
constexpr int F_BM = 64, F_BN = 64, F_BK = 16;  // fma tiles
constexpr int DW_BK = 128;  // dw mma: rows of dw (the K axis) a block
constexpr int DW_BR = 64;   // dw mma: rows of x and dy a stage

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// Inclusive prefix sum over a warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The rows of row tile `t` of BM rows: group g's rows are cut into
// ceil(size_g / bm) tiles starting at off_g, the groups in order (sizes
// clamped to R); tiles past the last group's cover the rows past the sum
// (g = -1). info = {g, first row, end row}; end <= first: nothing to do.
// Run by warp 0.
__device__ void find_tile(const int* __restrict__ sizes, int G, int R, int bm, int t,
                          int* info) {
  const int lane = threadIdx.x & 31;
  int rows = 0, tiles = 0;  // carried over the chunks of 32 groups
  for (int base = 0; base < G; base += 32) {
    const int g = base + lane;
    const int sz = g < G ? max(sizes[g], 0) : 0;
    const int r_incl = warp_scan(sz, lane);
    const int a = min(rows + r_incl - sz, R), b = min(rows + r_incl, R);
    const int nt = (b - a + bm - 1) / bm;
    const int t_incl = warp_scan(nt, lane);
    const int ts = tiles + t_incl - nt;
    if (g < G && t >= ts && t < ts + nt) {
      const int r0 = a + (t - ts) * bm;
      info[0] = g;
      info[1] = r0;
      info[2] = min(b, r0 + bm);
    }
    rows += __shfl_sync(0xffffffffu, r_incl, 31);
    tiles += __shfl_sync(0xffffffffu, t_incl, 31);
  }
  if (lane == 0 && t >= tiles) {
    const long long r0 = (long long)min(rows, R) + (long long)(t - tiles) * bm;
    info[0] = -1;
    info[1] = (int)min(r0, (long long)R);
    info[2] = (int)min(r0 + bm, (long long)R);
  }
}

// ---------------------------------------------------------------------------
// forward, mma
// ---------------------------------------------------------------------------

template <int MT, bool BT>
struct FwdSmem {
  static constexpr int BM = 32 * MT;
  static constexpr int A_ELEMS = BM * (BK + PAD);
  static constexpr int B_ELEMS = BT ? BN * (BK + PAD) : BK * (BN + PAD);
  static constexpr int BYTES = STAGES * (A_ELEMS + B_ELEMS) * 2;
};

template <int MT, bool BT>
__global__ void __launch_bounds__(NT, 2) gmm_fwd_mma(const bf16* __restrict__ x,
                                                  const bf16* __restrict__ w,
                                                  const int* __restrict__ sizes,
                                                  bf16* __restrict__ out, GmmArgs a) {
  typedef FwdSmem<MT, BT> L;
  constexpr int BM = L::BM, WM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * L::A_ELEMS;
  __shared__ int info[3];

  const int R = (int)a.R, K = (int)a.K, N = (int)a.N;
  const int n0 = blockIdx.x * BN;
  if (threadIdx.x < 32) find_tile(sizes, (int)a.G, R, BM, blockIdx.y, info);
  __syncthreads();
  const int g = info[0], row0 = info[1], row1 = info[2];
  if (row1 <= row0) return;
  if (g < 0) {  // rows past the sum: zero
    for (int i = threadIdx.x; i < (row1 - row0) * BN; i += NT) {
      const int r = row0 + i / BN, n = n0 + i % BN;
      if (n < N) out[(long long)r * N + n] = __float2bfloat16(0.f);
    }
    return;
  }
  const bf16* wg = w + (long long)g * a.swg;
  const long long ldw = BT ? a.swn : a.swk;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * L::A_ELEMS;
    bf16* bs = Bs + stage * L::B_ELEMS;
    for (int c = threadIdx.x; c < BM * (BK / 8); c += NT) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      const bool ok = gr < row1 && gk < K;
      const bf16* src = ok ? x + (long long)gr * a.sxr + gk : x;
      mma::cp_async16(as + r * (BK + PAD) + kc, src, ok ? min(16, (K - gk) * 2) : 0);
    }
    if (BT) {  // stored [n][k]
      for (int c = threadIdx.x; c < BN * (BK / 8); c += NT) {
        const int n = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const int gn = n0 + n, gk = k0 + kc;
        const bool ok = gn < N && gk < K;
        const bf16* src = ok ? wg + (long long)gn * ldw + gk : w;
        mma::cp_async16(bs + n * (BK + PAD) + kc, src, ok ? min(16, (K - gk) * 2) : 0);
      }
    } else {  // stored [k][n]
      for (int c = threadIdx.x; c < BK * (BN / 8); c += NT) {
        const int k = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        const int gk = k0 + k, gn = n0 + nc;
        const bool ok = gk < K && gn < N;
        const bf16* src = ok ? wg + (long long)gk * ldw + gn : w;
        mma::cp_async16(bs + k * (BN + PAD) + nc, src, ok ? min(16, (N - gn) * 2) : 0);
      }
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / 4, wn = warp % 4;
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    mma::cp_async_commit();
  }
  const mma::LaneRC la = mma::a_rows(lane);
  const mma::LaneRC lb = BT ? mma::b_rows(lane) : mma::b_cols(lane);
  for (int kt = 0; kt < KT; ++kt) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    mma::cp_async_commit();
    const bf16* as = As + (kt % STAGES) * L::A_ELEMS;
    const bf16* bs = Bs + (kt % STAGES) * L::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma::ldsm_x4(af[i], as + (wm * WM + i * 16 + la.r) * (BK + PAD) + kk + la.c);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int nb = wn * 32 + p * 16;
        if (BT)
          mma::ldsm_x4(bfr[p], bs + (nb + lb.r) * (BK + PAD) + kk + lb.c);
        else
          mma::ldsm_x4_t(bfr[p], bs + (kk + lb.r) * (BN + PAD) + nb + lb.c);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma::mma_bf16(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2], bfr[j / 2][(j % 2) * 2 + 1]);
    }
  }
  mma::cp_async_wait<0>();

  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm * WM + i * 16 + gq + h * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * tq;
        if (r >= row1) continue;
        bf16* o = out + (long long)r * N + n;
        if (n + 1 < N && (N % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (n < N) o[0] = __float2bfloat16(acc[i][j][2 * h]);
          if (n + 1 < N) o[1] = __float2bfloat16(acc[i][j][2 * h + 1]);
        }
      }
}

// ---------------------------------------------------------------------------
// forward, fma
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) gmm_fwd_fma(const T* __restrict__ x, const T* __restrict__ w,
                                                  const int* __restrict__ sizes,
                                                  T* __restrict__ out, GmmArgs a) {
  __shared__ float As[F_BK][F_BM + 4];
  __shared__ float Bs[F_BK][F_BN + 4];
  __shared__ int info[3];
  const int R = (int)a.R, K = (int)a.K, N = (int)a.N;
  const int n0 = blockIdx.x * F_BN;
  if (threadIdx.x < 32) find_tile(sizes, (int)a.G, R, F_BM, blockIdx.y, info);
  __syncthreads();
  const int g = info[0], row0 = info[1], row1 = info[2];
  if (row1 <= row0) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (g < 0) {
    for (int i = threadIdx.x; i < (row1 - row0) * F_BN; i += NT) {
      const int r = row0 + i / F_BN, n = n0 + i % F_BN;
      if (n < N) store(out + (long long)r * N + n, 0.f);
    }
    return;
  }
  const T* wg = w + (long long)g * a.swg;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = threadIdx.x; i < F_BM * F_BK; i += NT) {
      const int r = i / F_BK, k = i % F_BK;  // neighbouring threads along k: x's unit stride
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < row1 && gk < K) ? to_f(x[gr * a.sxr + gk * a.sxk]) : 0.f;
    }
    for (int i = threadIdx.x; i < F_BK * F_BN; i += NT) {
      const int k = i / F_BN, n = i % F_BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f(wg[gk * a.swk + gn * a.swn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= row1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) store(out + (long long)r * N + n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dw
// ---------------------------------------------------------------------------

// Rows [first, end) of group blockIdx.z, sizes clamped to R. Run by warp 0.
__device__ void group_rows(const int* __restrict__ sizes, int g, int R, int* info) {
  const int lane = threadIdx.x & 31;
  int off = 0;
  for (int base = 0; base < g; base += 32) {
    int v = base + lane < g ? max(sizes[base + lane], 0) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    off += v;
  }
  if (lane == 0) {
    info[0] = min(off, R);
    info[1] = min(off + max(sizes[g], 0), R);
  }
}

constexpr int DW_STAGE = 2 * DW_BR * (DW_BK + PAD);  // bf16 of x's and dy's tiles
constexpr int DW_SMEM = STAGES * DW_STAGE * 2;

__global__ void __launch_bounds__(NT, 2) gmm_dw_mma(const bf16* __restrict__ x,
                                                 const bf16* __restrict__ dy,
                                                 const int* __restrict__ sizes,
                                                 float* __restrict__ dw, DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* S = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int info[2];
  const int R = (int)a.R, K = (int)a.K, N = (int)a.N;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * DW_BK, g = blockIdx.z;
  if (threadIdx.x < 32) group_rows(sizes, g, R, info);
  __syncthreads();
  const int row0 = info[0], row1 = info[1];
  float* dwg = dw + (long long)g * K * N;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 (k) x 32 (n)
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int stage, int rt) {
    const int r0 = row0 + rt * DW_BR;
    bf16* xs = S + stage * DW_STAGE;
    bf16* ds = xs + DW_BR * (DW_BK + PAD);
    for (int c = threadIdx.x; c < DW_BR * (DW_BK / 8); c += NT) {
      const int r = c / (DW_BK / 8), kc = (c % (DW_BK / 8)) * 8;
      const int gr = r0 + r, gk = k0 + kc;
      const bool ok = gr < row1 && gk < K;
      const bf16* src = ok ? x + (long long)gr * a.sxr + gk : x;
      mma::cp_async16(xs + r * (DW_BK + PAD) + kc, src, ok ? min(16, (K - gk) * 2) : 0);
    }
    for (int c = threadIdx.x; c < DW_BR * (BN / 8); c += NT) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gr = r0 + r, gn = n0 + nc;
      const bool ok = gr < row1 && gn < N;
      const bf16* src = ok ? dy + (long long)gr * a.sdr + gn : dy;
      mma::cp_async16(ds + r * (BN + PAD) + nc, src, ok ? min(16, (N - gn) * 2) : 0);
    }
  };

  const int RT = (row1 - row0 + DW_BR - 1) / DW_BR;  // 0 for an empty group
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < RT) load(s, s);
    mma::cp_async_commit();
  }
  const mma::LaneRC la = mma::a_cols(lane);  // x^T: x's tile is stored [r][k]
  const mma::LaneRC lb = mma::b_cols(lane);  // dy's tile stored [r][n]
  for (int rt = 0; rt < RT; ++rt) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (rt + STAGES - 1 < RT) load((rt + STAGES - 1) % STAGES, rt + STAGES - 1);
    mma::cp_async_commit();
    const bf16* xs = S + (rt % STAGES) * DW_STAGE;
    const bf16* ds = xs + DW_BR * (DW_BK + PAD);
#pragma unroll
    for (int kk = 0; kk < DW_BR; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma::ldsm_x4_t(af[i], xs + (kk + la.r) * (DW_BK + PAD) + wm * 64 + i * 16 + la.c);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        mma::ldsm_x4_t(bfr[p], ds + (kk + lb.r) * (BN + PAD) + wn * 32 + p * 16 + lb.c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma::mma_bf16(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2], bfr[j / 2][(j % 2) * 2 + 1]);
    }
  }
  mma::cp_async_wait<0>();

  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wm * 64 + i * 16 + gq + h * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * tq;
        if (k >= K) continue;
        float* o = dwg + (long long)k * N + n;
        if (n + 1 < N && (N % 2) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (n < N) o[0] = acc[i][j][2 * h];
          if (n + 1 < N) o[1] = acc[i][j][2 * h + 1];
        }
      }
}

template <typename T>
__global__ void __launch_bounds__(NT) gmm_dw_fma(const T* __restrict__ x, const T* __restrict__ dy,
                                                 const int* __restrict__ sizes,
                                                 float* __restrict__ dw, DwArgs a) {
  __shared__ float Xs[F_BK][F_BM + 4];
  __shared__ float Ds[F_BK][F_BN + 4];
  __shared__ int info[2];
  const int R = (int)a.R, K = (int)a.K, N = (int)a.N;
  const int n0 = blockIdx.x * F_BN, k0 = blockIdx.y * F_BM, g = blockIdx.z;
  if (threadIdx.x < 32) group_rows(sizes, g, R, info);
  __syncthreads();
  const int row0 = info[0], row1 = info[1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int r0 = row0; r0 < row1; r0 += F_BK) {
    for (int i = threadIdx.x; i < F_BK * F_BM; i += NT) {
      const int r = i / F_BM, k = i % F_BM;
      const int gr = r0 + r, gk = k0 + k;
      Xs[r][k] = (gr < row1 && gk < K) ? to_f(x[gr * a.sxr + gk * a.sxk]) : 0.f;
    }
    for (int i = threadIdx.x; i < F_BK * F_BN; i += NT) {
      const int r = i / F_BN, n = i % F_BN;
      const int gr = r0 + r, gn = n0 + n;
      Ds[r][n] = (gr < row1 && gn < N) ? to_f(dy[gr * a.sdr + gn * a.sdn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < F_BK; ++r) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = Xs[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ds[r][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dwg = dw + (long long)g * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) dwg[(long long)k * N + n] = acc[i][j];
    }
  }
}

template <typename K_>
int set_smem(K_ kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int MT, bool BT>
int launch_fwd_mma(const void* x, const void* w, const int* sizes, void* out, const GmmArgs& a,
                   cudaStream_t s) {
  typedef FwdSmem<MT, BT> L;
  static_assert(L::BYTES <= 232448, "shared memory of one block exceeds 227 KB");
  static thread_local bool configured = false;  // the cap, once per host thread
  if (!configured) {
    const int e = set_smem(gmm_fwd_mma<MT, BT>, L::BYTES);
    if (e) return e;
    configured = true;
  }
  const long long tiles = (a.R + L::BM - 1) / L::BM + a.G;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((a.N + BN - 1) / BN), (unsigned)tiles);
  gmm_fwd_mma<MT, BT><<<grid, NT, L::BYTES, s>>>((const bf16*)x, (const bf16*)w, sizes,
                                                 (bf16*)out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_fma(const void* x, const void* w, const int* sizes, void* out, const GmmArgs& a,
                   cudaStream_t s) {
  const long long tiles = (a.R + F_BM - 1) / F_BM + a.G;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((a.N + F_BN - 1) / F_BN), (unsigned)tiles);
  gmm_fwd_fma<T><<<grid, NT, 0, s>>>((const T*)x, (const T*)w, sizes, (T*)out, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out (R, N) contiguous in x's type; x (R, K) and w (G, K, N) strided as
// the args say, one dtype. sizes: G int32 on the device. mma takes bf16
// with x's rows on 16 bytes (sxk 1, sxr a multiple of 8) and w with a
// unit stride along n (swn 1) or along k (swk 1), its other strides
// multiples of 8, every base 16-byte aligned.
int grouped_matmul_launch(const void* x, const void* w, const void* sizes, void* out,
                          const GmmArgs* a, void* stream) {
  if (a->R <= 0 || a->N <= 0 || a->G <= 0 || a->K < 0 || a->R > 2147483647LL ||
      a->K > 2147483647LL || a->N > 2147483647LL || (a->N + BN - 1) / BN > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int* sz = (const int*)sizes;
  cudaStream_t s = (cudaStream_t)stream;
  if (a->variant == 0)
    return a->dtype == 0 ? launch_fwd_fma<float>(x, w, sz, out, *a, s)
                         : launch_fwd_fma<bf16>(x, w, sz, out, *a, s);
  if (a->dtype != 1 || a->sxk != 1) return (int)cudaErrorInvalidValue;
  const bool bt = a->swk == 1 && a->swn != 1;
  if (!bt && a->swn != 1) return (int)cudaErrorInvalidValue;
  switch (a->bm * 2 + (bt ? 1 : 0)) {
    case 64: return launch_fwd_mma<1, false>(x, w, sz, out, *a, s);
    case 65: return launch_fwd_mma<1, true>(x, w, sz, out, *a, s);
    case 128: return launch_fwd_mma<2, false>(x, w, sz, out, *a, s);
    case 129: return launch_fwd_mma<2, true>(x, w, sz, out, *a, s);
    case 256: return launch_fwd_mma<4, false>(x, w, sz, out, *a, s);
    case 257: return launch_fwd_mma<4, true>(x, w, sz, out, *a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dw (G, K, N) f32 contiguous; x (R, K) and dy (R, N) strided, one dtype.
// mma takes bf16 with both operands' rows on 16 bytes (unit inner
// strides, row strides multiples of 8, bases 16-byte aligned).
int grouped_matmul_dw_launch(const void* x, const void* dy, const void* sizes, void* dw,
                             const DwArgs* a, void* stream) {
  if (a->R < 0 || a->N <= 0 || a->K <= 0 || a->G <= 0 || a->G > 65535 || a->R > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int* sz = (const int*)sizes;
  cudaStream_t s = (cudaStream_t)stream;
  if (a->variant == 0) {
    dim3 grid((unsigned)((a->N + F_BN - 1) / F_BN), (unsigned)((a->K + F_BM - 1) / F_BM),
              (unsigned)a->G);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (a->dtype == 0)
      gmm_dw_fma<float><<<grid, NT, 0, s>>>((const float*)x, (const float*)dy, sz, (float*)dw, *a);
    else
      gmm_dw_fma<bf16><<<grid, NT, 0, s>>>((const bf16*)x, (const bf16*)dy, sz, (float*)dw, *a);
    return (int)cudaGetLastError();
  }
  if (a->dtype != 1 || a->sxk != 1 || a->sdn != 1) return (int)cudaErrorInvalidValue;
  static thread_local bool configured = false;
  if (!configured) {
    const int e = set_smem(gmm_dw_mma, DW_SMEM);
    if (e) return e;
    configured = true;
  }
  dim3 grid((unsigned)((a->N + BN - 1) / BN), (unsigned)((a->K + DW_BK - 1) / DW_BK),
            (unsigned)a->G);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gmm_dw_mma<<<grid, NT, DW_SMEM, s>>>((const bf16*)x, (const bf16*)dy, sz, (float*)dw, *a);
  return (int)cudaGetLastError();
}

}  // extern "C"
