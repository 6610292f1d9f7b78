// Grouped GEMM for Hopper: the routed experts' products of a
// Mixture-of-Experts FFN, and their weight gradient.
//
// Replaces jax.lax.ragged_dot in the reference's moe_block
// (src/repro/models/moe.py), an XLA op, not a Pallas kernel. With the
// rows of x sorted by expert, group g owning rows [off_g, off_g + size_g)
// (off_g the sum of the sizes before it, formed here on the device):
//
//   forward  out[r] = x[r] @ w[g]            out (R, N) in x's type
//   dw       dw[g]  = x[rows of g]^T @ dy    (G, K, N) f32 or bf16
//
// every product summed in f32 (a bf16 dw is each f32 sum rounded once).
// Rows past sum(size) are zero in out, as in ragged_dot; an empty group's
// dw is zero. The sizes stay on the device: no launch waits for the host.
//
// What bounds it on an H100: deepseek-moe-16b's expert weights (2048 x
// 1408 bf16, 64 of them: 369 MB a call) are read once a call; a prefill's
// 3,072 rows do 17.7 GFLOP on them (~0.018 ms at 989 TFLOP/s against
// ~0.11 ms for the bytes), a decode step's 24 rows touch ~21 experts.
// Training's 24,576 rows (141.7 GFLOP a call, 0.143 ms of tensor-core
// time) are about balanced, and so is dw, whose output (369 MB in bf16)
// is most of its bytes. No block reads the weights of an empty group.
//
// wgmma (bf16, operands TMA can describe; every deepseek-moe-16b call,
// decode included). The shape of dos_matmul_wgmma: one producer thread
// issues TMA loads into a ring of stages (128-byte swizzle, a full and an
// empty mbarrier each), consumer warpgroups run wgmma.mma_async (m64, f32
// accumulators in registers, one stage in flight behind the issue). The
// blocks are persistent, one an SM, and walk a list of tiles that each
// block forms from the device sizes once, into shared memory (group_list:
// a warp's scan): tile t goes to block t % grid, so one tile's epilogue
// overlaps the producer's loads of the next, and tiles run in group order,
// so the blocks that read w[g] run together and w and x come from device
// memory about once. No tile belongs to an empty group.
//   forward: a tile is BM rows of one group (BM 128: two consumer
//   warpgroups; 64, where the groups hold at most 64 rows on average:
//   one) by 128 columns (W_BN).
//   x is a 2-D tensor map over (R, K); a tile's box starts at its first
//   row whatever that row is, rows of the next group that the box brings
//   in make accumulator rows that are never stored, and TMA zero-fills
//   rows past R and k past K. w is a 3-D map over (G, K, N), the group a
//   coordinate: row-major weights are MN-major B (64 x 64 boxes, the
//   transpose bit), dX's w.transpose(-1, -2) (unit stride along k) K-major
//   B (a BN x 64 box), neither copied. The epilogue: a warpgroup whose 64
//   rows all lie in the group writes its part of the tile into its own
//   staging boxes (128-byte swizzled) and one thread sends them with TMA
//   stores, which run while the next tile's products do (stores from
//   registers took a quarter of a training call: PERF.md); where the box
//   would also write the next group's rows, each thread stores its
//   fragment from registers (two bf16 a store, masked at the group's last
//   row and at N). The list ends with tiles that zero the rows past the
//   sum.
//   dw: a tile is 128 rows of dw (the K axis: two consumer warpgroups) by
//   128 columns of one group, the group's rows summed in order, 64 a stage
//   (no atomics: two calls give the same bits). Both operands are MN-major
//   from TMA: x^T as A (64 k x 64 rows boxes, the A transpose bit) and dy
//   as B. A stage starts at its rows' first row, so only a group's last
//   stage can hold rows of the next group: the consumers zero those rows
//   of both operands in shared memory (generic stores, then
//   fence.proxy.async and a barrier of the consumers) before any wgmma
//   reads the stage; the stage's empty barrier is armed only after the
//   wgmma that read it has finished, so the producer never refills a stage
//   still being zeroed. The epilogue is the forward's TMA stores (a dw
//   tile never crosses a group): dw's output is most of its bytes (bf16
//   369 MB at deepseek's shapes). An empty group's tiles have no stages
//   and write zeros.

// fma (f32, bf16 operands TMA cannot describe, or more groups than the
// wgmma tile list holds): 64 x 64 tiles of f32 FMAs on 256 threads, any
// strides. The grid is sized from R and G alone (ceil(R / 64) + G row
// tiles per column tile, enough for any sizes) and each block finds its
// rows from the sizes (find_tile) or, past the last group's tiles, zeroes
// the rows past the sum, or exits. dw: one block per (n tile, k tile,
// group), summing the group's rows in order, 16 at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_util.cuh"

// The launch arguments (outside the anonymous namespace: the C interface
// takes them).
struct GmmArgs {
  long long R, K, N, G;
  long long sxr, sxk;       // x (R, K)
  long long swg, swk, swn;  // w (G, K, N)
  int dtype;                // 0 f32, 1 bf16
  int variant;              // 0 fma, 1 wgmma
  int bm;                   // wgmma: 64 or 128
};

struct DwArgs {
  long long R, K, N, G;
  long long sxr, sxk;  // x (R, K)
  long long sdr, sdn;  // dy (R, N)
  int dtype, variant;  // variant as GmmArgs's
  int out_dtype;       // dw: 0 f32, 1 bf16
};

namespace {

using namespace sm90;  // mbarriers, TMA, wgmma, tensor maps (wgmma_util.cuh)

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;  // threads a block of fma
constexpr int F_BM = 64, F_BN = 64, F_BK = 16;  // fma tiles

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
// p[0], p[1] = v0, v1; one store where the pair is aligned (`pair`),
// else element by element, p[1] only below `end`
__device__ __forceinline__ void store2(float* p, float v0, float v1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (second) p[1] = v1;
  }
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (second) p[1] = __float2bfloat16(v1);
  }
}

// Inclusive prefix sum over a warp.
template <typename T>
__device__ __forceinline__ T warp_scan(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, o);
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

template <typename T, typename TOut>
__global__ void __launch_bounds__(NT) gmm_dw_fma(const T* __restrict__ x, const T* __restrict__ dy,
                                                 const int* __restrict__ sizes,
                                                 TOut* __restrict__ dw, DwArgs a) {
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
  TOut* dwg = dw + (long long)g * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) store(dwg + (long long)k * N + n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: persistent blocks over a tile list (forward and dw)
// ---------------------------------------------------------------------------

constexpr int W_BK = 64;             // depth of a ring stage: one 128-byte swizzle line of bf16
constexpr int W_MAX_G = 512;         // groups the tile list holds in shared memory
constexpr int W_SMEM = 208 * 1024;   // the ring of stages (and dw's staging)
constexpr int W_MAX_STAGES = 8;
// Columns of a forward tile. With the TMA-store epilogue 128 was faster
// than 256 at deepseek-moe-16b's training shapes or tied, and tied at its
// prefill: a 256-wide tile's staging leaves the ring 3 stages, a
// 128-wide one's 5 (tools/gmm_variants.py --probes; PERF.md).
constexpr int W_BN = 128;

// Each group's rows [a, b) (sizes clamped to R) and, for the forward,
// the index of its first tile in the list (per: tiles per row tile of
// bm rows); t[G] counts the groups' tiles, tail0 is the first row past
// the sum.
struct TileList {
  int a[W_MAX_G], b[W_MAX_G];
  int t[W_MAX_G + 1];
  int tail0;
};

// Fills `L` from the device sizes. Run by warp 0.
__device__ void group_list(const int* __restrict__ sizes, int G, int R, int bm, int per,
                           TileList& L) {
  const int lane = threadIdx.x & 31;
  long long rows = 0;  // carried over the chunks of 32 groups
  int tiles = 0;
  for (int base = 0; base < G; base += 32) {
    const int g = base + lane;
    const long long sz = g < G ? max(sizes[g], 0) : 0;
    const long long r_incl = warp_scan(sz, lane);
    const int a = (int)min(rows + r_incl - sz, (long long)R);
    const int b = (int)min(rows + r_incl, (long long)R);
    const int nt = (b - a + bm - 1) / bm * per;
    const int t_incl = warp_scan(nt, lane);
    if (g < G) {
      L.a[g] = a;
      L.b[g] = b;
      L.t[g] = tiles + t_incl - nt;
    }
    rows += __shfl_sync(0xffffffffu, r_incl, 31);
    tiles += __shfl_sync(0xffffffffu, t_incl, 31);
  }
  if (lane == 0) {
    L.t[G] = tiles;
    L.tail0 = (int)min(rows, (long long)R);
  }
}

struct FwdTile {
  int g, r0, r1, n0;
};

// Tile t < L.t[G] of the forward's list: group g (L.t[g] <= t < L.t[g+1];
// an empty group owns no tile), its n tiles in order, its row tiles
// inside each n tile.
template <int BM, int BN>
__device__ __forceinline__ FwdTile fwd_tile(const TileList& L, int G, int t) {
  int lo = 0, hi = G;  // L.t[lo] <= t < L.t[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (L.t[mid] <= t) lo = mid;
    else hi = mid;
  }
  const int a = L.a[lo], b = L.b[lo];
  const int rts = (b - a + BM - 1) / BM, local = t - L.t[lo];
  const int r0 = a + (local % rts) * BM;
  return {lo, r0, min(b, r0 + BM), (local / rts) * BN};
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {  // swizzle atoms: 1 KB aligned
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// A warpgroup's 64 x (NI IN) accumulator tile, rounded to TOut, written
// into its staging boxes as a TMA box with the 128-byte swizzle holds it
// (64 rows of 128 bytes a box; 16-byte chunk c of row r at chunk c ^ (r %
// 8)): no bank conflicts for two bf16 a store. row_w: the thread's first
// row in the warpgroup's 64, col_l its first column.
template <typename TOut, int NI, int RG>
__device__ __forceinline__ void stage_tile(const float (&acc)[NI][RG], uint8_t* stg, int row_w,
                                           int col_l) {
  constexpr int IN = 2 * RG, ES = sizeof(TOut);
#pragma unroll
  for (int q = 0; q < NI; ++q)
#pragma unroll
    for (int j = 0; j < RG; j += 2) {
      const int rr = row_w + 8 * ((j / 2) % 2);
      const int byte = (q * IN + 8 * (j / 4) + col_l) * ES;
      uint8_t* p = stg + (byte / 128) * 8192 + rr * 128 + ((((byte % 128) / 16) ^ (rr % 8)) * 16) +
                   byte % 16;
      if (ES == 2)
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[q][j], acc[q][j + 1]);
      else
        *reinterpret_cast<float2*>(p) = make_float2(acc[q][j], acc[q][j + 1]);
    }
}

template <int BM, int BN>
struct FwdCfg {
  static constexpr int CONS = BM / 64;  // consumer warpgroups, 64 rows each
  static constexpr int NT = 128 * (CONS + 1);  // and the producer's warpgroup
  static constexpr int A_BYTES = BM * W_BK * 2;
  static constexpr int B_BYTES = BN * W_BK * 2;  // MN-major BN / 64 boxes, K-major one
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGING = 64 * BN * 2;  // a warpgroup's 64 rows of the tile, bf16
  static constexpr int RING = W_SMEM - CONS * STAGING;
  static constexpr int STAGES = RING / STAGE < W_MAX_STAGES ? RING / STAGE : W_MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE + CONS * STAGING + 1024;  // + alignment
  static constexpr int IN = BN == 256 ? 128 : BN;     // N of one wgmma instruction
  static constexpr int NI = BN / IN;                  // instructions a k16 step
};

// BT: w is K-major (unit stride along k: dX's transposed view); else
// row-major, MN-major.
template <int BM, int BN, bool BT>
__global__ void __launch_bounds__(FwdCfg<BM, BN>::NT, 1)
gmm_fwd_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tout, const int* __restrict__ sizes,
              bf16* __restrict__ out, GmmArgs a) {
  using C = FwdCfg<BM, BN>;
  constexpr int ST = C::STAGES, IN = C::IN, NI = C::NI, RG = IN / 2;
  extern __shared__ uint8_t dyn_smem[];
  uint8_t* smem = align1024(dyn_smem);
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  __shared__ TileList L;
  const int R = (int)a.R, K = (int)a.K, N = (int)a.N, G = (int)a.G;
  const int n_tiles = (N + BN - 1) / BN, k_tiles = (K + W_BK - 1) / W_BK;
  if (threadIdx.x < 32) {
    group_list(sizes, G, R, BM, n_tiles, L);
  } else if (threadIdx.x == 32) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::CONS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int group_tiles = L.t[G];
  const int total = group_tiles + (R - L.tail0 + BM - 1) / BM * n_tiles;
  const int wgi = threadIdx.x / 128;

  if (wgi == C::CONS) {  // the producer warpgroup; one thread issues every load
    if (C::CONS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == C::CONS * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < group_tiles; t += gridDim.x) {
        const FwdTile tl = fwd_tile<BM, BN>(L, G, t);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % ST;
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::STAGE);
          uint8_t* st = smem + s * C::STAGE;
          const int k = kt * W_BK;
          tma_load(st, &tx, &full[s], k, tl.r0);
          if (BT) {
            tma_load3d(st + C::A_BYTES, &tw, &full[s], k, tl.n0, tl.g);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load3d(st + C::A_BYTES + j * 8192, &tw, &full[s], tl.n0 + 64 * j, k, tl.g);
          }
        }
      }
    }
  } else {  // consumer warpgroups
    if (C::CONS > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // fragment layout of m64nNk16: register j of a thread holds row
    // 16 * (warp % 4) + lane / 4 + 8 * ((j / 2) % 2), column 8 * (j / 4) + 2 * (lane % 4) + j % 2
    const int row_w = (warp % 4) * 16 + lane / 4, row_l = wgi * 64 + row_w;
    const int col_l = 2 * (lane % 4);
    const bool issuer = threadIdx.x % 128 == 0;  // the warpgroup's TMA stores
    const bool tma_out = N % 8 == 0;  // out's rows on 16 bytes: a tensor map (tout) describes it
    uint8_t* stg = smem + ST * C::STAGE + wgi * C::STAGING;
    float acc[NI][RG];
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      if (t >= group_tiles) {  // rows past the sum: zero
        const int u = t - group_tiles;
        const int r0 = L.tail0 + (u / n_tiles) * BM, n0 = (u % n_tiles) * BN;
        const int rows = min(R, r0 + BM) - r0;
        for (int i = threadIdx.x; i < rows * BN; i += C::CONS * 128) {
          const int n = n0 + i % BN;
          if (n < N) out[(long long)(r0 + i / BN) * N + n] = __float2bfloat16(0.f);
        }
        continue;
      }
      const FwdTile tl = fwd_tile<BM, BN>(L, G, t);
#pragma unroll
      for (int q = 0; q < NI; ++q)
#pragma unroll
        for (int j = 0; j < RG; ++j) acc[q][j] = 0.f;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        const uint32_t a_st = smem_u32(smem + s * C::STAGE) + wgi * 64 * 128;
        const uint32_t b_st = smem_u32(smem + s * C::STAGE + C::A_BYTES);
#pragma unroll
        for (int q = 0; q < NI; ++q) fence_regs(acc[q]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W_BK / 16; ++kk) {
          const uint64_t da = sw128_desc(a_st + kk * 32, 16, 1024);
#pragma unroll
          for (int q = 0; q < NI; ++q) {
            // K-major: IN rows of 128 bytes an instruction; MN-major: IN / 64 boxes of 8 KB
            const uint64_t db = BT ? sw128_desc(b_st + q * IN * 128 + kk * 32, 16, 1024)
                                   : sw128_desc(b_st + q * (IN / 64) * 8192 + kk * 2048, 8192,
                                                1024);
            Wgmma<IN, BT ? 0 : 1>::run(acc[q], da, db);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
        for (int q = 0; q < NI; ++q) fence_regs(acc[q]);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % ST]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < NI; ++q) fence_regs(acc[q]);
      if (k_tiles > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % ST]);
      const int r_w = tl.r0 + wgi * 64;  // the warpgroup's first row
      if (tma_out && r_w + 64 <= tl.r1) {
        // its 64 rows all in the group: through its staging boxes and TMA
        // stores, which run while the next tile's products do
        const int bar = 2 + wgi;
        if (issuer) bulk_wait_read<0>();  // the last tile's stores have read the staging
        asm volatile("bar.sync %0, 128;" :: "r"(bar) : "memory");
        stage_tile<bf16>(acc, stg, row_w, col_l);
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;" :: "r"(bar) : "memory");
        if (issuer) {
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            if (tl.n0 + 64 * b < N) tma_store2d(&tout, stg + b * 8192, tl.n0 + 64 * b, r_w);
          bulk_commit();
        }
        continue;
      }
      // rows of the next group among its 64 (a box would write them): from
      // registers, masked at the group's last row and at N
      const bool pair = N % 2 == 0;
#pragma unroll
      for (int q = 0; q < NI; ++q)
#pragma unroll
        for (int j = 0; j < RG; j += 2) {
          const int r = tl.r0 + row_l + 8 * ((j / 2) % 2);
          const int n = tl.n0 + q * IN + 8 * (j / 4) + col_l;
          if (r < tl.r1 && n < N)
            store2(out + (long long)r * N + n, acc[q][j], acc[q][j + 1], pair, n + 1 < N);
        }
    }
    if (issuer) bulk_wait<0>();
  }
}

template <int BN, typename TOut>
struct DwCfg {
  static constexpr int BM = 128;  // rows of dw (the K axis) a tile: two consumer warpgroups
  static constexpr int BR = 64;   // rows of x and dy a stage
  static constexpr int NT = 384;
  static constexpr int A_BYTES = BM * BR * 2;  // x^T: two boxes of 64 k x 64 rows
  static constexpr int B_BYTES = BN * BR * 2;  // dy: BN / 64 boxes of 64 n x 64 rows
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ES = sizeof(TOut);
  static constexpr int BOX = 128 / ES;         // dw columns of a 128-byte store box
  static constexpr int STAGING = 64 * BN * ES;  // a warpgroup's 64 rows of the tile
  static constexpr int RING = W_SMEM - 2 * STAGING;
  static constexpr int STAGES = RING / STAGE < W_MAX_STAGES ? RING / STAGE : W_MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGING + 1024;
  static constexpr int IN = BN;
  static constexpr int NI = 1;
  static_assert(STAGES >= 2, "the staging leaves no ring");
};

// dw tile t: group t / (k tiles x n tiles), its k tiles in order, the n
// tiles inside each. The tile goes out through shared memory (128-byte
// swizzled boxes) and TMA stores, so the next tile's products start
// while it is written.
template <int BN, typename TOut>
__global__ void __launch_bounds__(384, 1)
gmm_dw_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
             const __grid_constant__ CUtensorMap tdw, const int* __restrict__ sizes, DwArgs a) {
  using C = DwCfg<BN, TOut>;
  constexpr int ST = C::STAGES, IN = C::IN, NI = C::NI, RG = IN / 2, BR = C::BR;
  extern __shared__ uint8_t dyn_smem[];
  uint8_t* smem = align1024(dyn_smem);
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  __shared__ TileList L;
  const int R = (int)a.R, K = (int)a.K, N = (int)a.N, G = (int)a.G;
  const int n_tiles = (N + BN - 1) / BN, per_g = (K + C::BM - 1) / C::BM * n_tiles;
  if (threadIdx.x < 32) {
    group_list(sizes, G, R, 1, 0, L);
  } else if (threadIdx.x == 32) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int total = G * per_g;
  const int wgi = threadIdx.x / 128;

  if (wgi == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int g = t / per_g, l = t % per_g;
        const int k0 = (l / n_tiles) * C::BM, n0 = (l % n_tiles) * BN;
        for (int r = L.a[g]; r < L.b[g]; r += BR, ++it) {
          const int s = it % ST;
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::STAGE);
          uint8_t* st = smem + s * C::STAGE;
          tma_load(st, &tx, &full[s], k0, r);
          tma_load(st + 8192, &tx, &full[s], k0 + 64, r);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(st + C::A_BYTES + j * 8192, &tdy, &full[s], n0 + 64 * j, r);
        }
      }
    }
  } else {  // consumers: warpgroup wgi owns dw rows k0 + 64 wgi ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row_w = (warp % 4) * 16 + lane / 4, col_l = 2 * (lane % 4);
    const bool issuer = threadIdx.x % 128 == 0;  // the warpgroup's TMA stores
    uint8_t* stg = smem + ST * C::STAGE + wgi * C::STAGING;
    float acc[NI][RG];
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int g = t / per_g, l = t % per_g;
      const int k0 = (l / n_tiles) * C::BM, n0 = (l % n_tiles) * BN;
      const int row0 = L.a[g], row1 = L.b[g];
#pragma unroll
      for (int q = 0; q < NI; ++q)
#pragma unroll
        for (int j = 0; j < RG; ++j) acc[q][j] = 0.f;
      for (int r = row0; r < row1; r += BR, ++it) {
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        uint8_t* st = smem + s * C::STAGE;
        const int valid = row1 - r;
        if (valid < BR) {  // the group's last stage: zero the next group's rows, both operands
          constexpr int BOXES = C::STAGE / 8192;
          const int per_box = (BR - valid) * 8;  // 16-byte chunks
          for (int i = threadIdx.x; i < BOXES * per_box; i += 256) {
            const int box = i / per_box, c = i % per_box;
            *reinterpret_cast<uint4*>(st + box * 8192 + valid * 128 + c * 16) = make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async();
          asm volatile("bar.sync 1, 256;" ::: "memory");
        }
        const uint32_t a_st = smem_u32(st) + wgi * 8192;
        const uint32_t b_st = smem_u32(st + C::A_BYTES);
#pragma unroll
        for (int q = 0; q < NI; ++q) fence_regs(acc[q]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BR / 16; ++kk) {
          const uint64_t da = sw128_desc(a_st + kk * 2048, 8192, 1024);
#pragma unroll
          for (int q = 0; q < NI; ++q) {
            const uint64_t db = sw128_desc(b_st + q * (IN / 64) * 8192 + kk * 2048, 8192, 1024);
            Wgmma<IN, 1, 1>::run(acc[q], da, db);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < NI; ++q) fence_regs(acc[q]);
        if (r > row0 && lane == 0) mbar_arrive(&empty[(it - 1) % ST]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < NI; ++q) fence_regs(acc[q]);
      if (row1 > row0 && lane == 0) mbar_arrive(&empty[(it - 1) % ST]);
      // the epilogue: this warpgroup's 64 rows through its staging boxes
      const int bar = 2 + wgi;
      if (issuer) bulk_wait_read<0>();  // the last tile's stores have read the staging
      asm volatile("bar.sync %0, 128;" :: "r"(bar) : "memory");
      stage_tile<TOut>(acc, stg, row_w, col_l);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;" :: "r"(bar) : "memory");
      if (issuer && k0 + 64 * wgi < K) {
#pragma unroll
        for (int b = 0; b < BN / C::BOX; ++b)
          if (n0 + b * C::BOX < N) tma_store3d(&tdw, stg + b * 8192, n0 + b * C::BOX, k0 + 64 * wgi, g);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait<0>();
  }
}

template <typename K_>
int set_smem(K_ kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

// The persistent grid: one block an SM, no more than there are tiles.
int persistent_grid(long long tiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)(tiles < sms ? tiles : sms);
}

// A stride TMA takes for a dimension of extent 1 (whose stride no
// address uses): the next dimension's extent times its stride.
long long tma_stride(long long extent, long long stride, long long fallback) {
  return extent > 1 ? stride : fallback;
}

template <int BM, int BN, bool BT>
int launch_fwd_wgmma(const void* x, const void* w, const int* sizes, void* out, const GmmArgs& a,
                     cudaStream_t s) {
  using C = FwdCfg<BM, BN>;
  static_assert(C::SMEM + sizeof(TileList) + 2 * C::STAGES * 8 <= 232448,
                "shared memory of one block exceeds 227 KB");
  auto kernel = gmm_fwd_wgmma<BM, BN, BT>;
  static thread_local bool configured = false;  // the cap, once per host thread
  if (!configured) {
    const int e = set_smem(kernel, C::SMEM);
    if (e) return e;
    configured = true;
  }
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap tx, tw;
  const long long sxr = tma_stride(a.R, a.sxr, (a.K + 7) / 8 * 8);
  bool ok = encode2d(enc, &tx, x, a.K, a.R, sxr, W_BK, BM);
  if (BT) {  // (K, N, G), k unit stride
    const long long sn = tma_stride(a.N, a.swn, (a.K + 7) / 8 * 8);
    ok = ok && encode3d(enc, &tw, w, a.K, a.N, a.G, sn, tma_stride(a.G, a.swg, sn * a.N), W_BK, BN);
  } else {  // (N, K, G), n unit stride
    const long long sk = tma_stride(a.K, a.swk, (a.N + 7) / 8 * 8);
    ok = ok && encode3d(enc, &tw, w, a.N, a.K, a.G, sk, tma_stride(a.G, a.swg, sk * a.K), 64, W_BK);
  }
  // out (R, N) contiguous: boxes of 64 x 64, where its rows lie on 16 bytes
  // (the kernel stores from registers where they do not, and never reads
  // the map)
  CUtensorMap tout = tx;
  if (a.N % 8 == 0) ok = ok && encode2d(enc, &tout, out, a.N, a.R, a.N, 64, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long bound = ((a.R + BM - 1) / BM + a.G) * ((a.N + BN - 1) / BN);  // tiles at most
  kernel<<<persistent_grid(bound), C::NT, C::SMEM, s>>>(tx, tw, tout, sizes, (bf16*)out, a);
  return (int)cudaGetLastError();
}

template <int BN, typename TOut>
int launch_dw_wgmma(const void* x, const void* dy, const int* sizes, void* dw, const DwArgs& a,
                    cudaStream_t s) {
  using C = DwCfg<BN, TOut>;
  static_assert(C::SMEM + sizeof(TileList) + 2 * C::STAGES * 8 <= 232448,
                "shared memory of one block exceeds 227 KB");
  auto kernel = gmm_dw_wgmma<BN, TOut>;
  static thread_local bool configured = false;
  if (!configured) {
    const int e = set_smem(kernel, C::SMEM);
    if (e) return e;
    configured = true;
  }
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap tx, tdy, tdw;
  bool ok = encode2d(enc, &tx, x, a.K, a.R, tma_stride(a.R, a.sxr, (a.K + 7) / 8 * 8), 64, C::BR);
  ok = ok && encode2d(enc, &tdy, dy, a.N, a.R, tma_stride(a.R, a.sdr, (a.N + 7) / 8 * 8), 64, C::BR);
  ok = ok && encode3d(enc, &tdw, dw, a.N, a.K, a.G, a.N, a.K * a.N, C::BOX, 64, C::ES == 4);
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long tiles = a.G * ((a.K + C::BM - 1) / C::BM) * ((a.N + BN - 1) / BN);
  kernel<<<persistent_grid(tiles), C::NT, C::SMEM, s>>>(tx, tdy, tdw, sizes, a);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_dw(const void* x, const void* dy, const int* sz, void* dw, const DwArgs& a,
              cudaStream_t s) {
  if (a.variant == 0) {
    dim3 grid((unsigned)((a.N + F_BN - 1) / F_BN), (unsigned)((a.K + F_BM - 1) / F_BM),
              (unsigned)a.G);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (a.dtype == 0)
      gmm_dw_fma<float, TOut><<<grid, NT, 0, s>>>((const float*)x, (const float*)dy, sz,
                                                  (TOut*)dw, a);
    else
      gmm_dw_fma<bf16, TOut><<<grid, NT, 0, s>>>((const bf16*)x, (const bf16*)dy, sz, (TOut*)dw,
                                                 a);
    return (int)cudaGetLastError();
  }
  if (a.variant != 1 || a.dtype != 1 || a.sxk != 1 || a.sdn != 1 || a.G > W_MAX_G ||
      a.G * ((a.K + 127) / 128) * ((a.N + 127) / 128) > 2147483647LL ||
      a.N % (16 / sizeof(TOut)) != 0)  // dw's rows on 16 bytes: its TMA stores
    return (int)cudaErrorInvalidValue;
  return launch_dw_wgmma<128, TOut>(x, dy, sz, dw, a, s);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out (R, N) contiguous in x's type; x (R, K) and w (G, K, N) strided as
// the args say, one dtype. sizes: G int32 on the device. wgmma takes
// bf16 with x's rows on 16 bytes (sxk 1, sxr a multiple of 8) and w with
// a unit stride along n (swn 1) or along k (swk 1), its other strides
// multiples of 8, every base 16-byte aligned, K > 0 and at most W_MAX_G
// groups.
int grouped_matmul_launch(const void* x, const void* w, const void* sizes, void* out,
                          const GmmArgs* a, void* stream) {
  if (a->R <= 0 || a->N <= 0 || a->G <= 0 || a->K < 0 || a->R > 2147483647LL ||
      a->K > 2147483647LL || a->N > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int* sz = (const int*)sizes;
  cudaStream_t s = (cudaStream_t)stream;
  if (a->variant == 0)
    return a->dtype == 0 ? launch_fwd_fma<float>(x, w, sz, out, *a, s)
                         : launch_fwd_fma<bf16>(x, w, sz, out, *a, s);
  const bool bt = a->swk == 1 && a->swn != 1;
  if (a->variant != 1 || a->dtype != 1 || a->sxk != 1 || (!bt && a->swn != 1) || a->K == 0 ||
      a->G > W_MAX_G || (a->bm != 64 && a->bm != 128) ||
      ((a->R + a->bm - 1) / a->bm + a->G) * ((a->N + W_BN - 1) / W_BN) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (a->bm == 64)
    return bt ? launch_fwd_wgmma<64, W_BN, true>(x, w, sz, out, *a, s)
              : launch_fwd_wgmma<64, W_BN, false>(x, w, sz, out, *a, s);
  return bt ? launch_fwd_wgmma<128, W_BN, true>(x, w, sz, out, *a, s)
            : launch_fwd_wgmma<128, W_BN, false>(x, w, sz, out, *a, s);
}

// dw (G, K, N) contiguous, f32 or bf16 (out_dtype); x (R, K) and dy (R,
// N) strided, one dtype. wgmma takes bf16 with both operands' rows on 16
// bytes (unit inner strides, row strides multiples of 8, bases 16-byte
// aligned), dw's rows on 16 bytes, R > 0 and at most W_MAX_G groups.
int grouped_matmul_dw_launch(const void* x, const void* dy, const void* sizes, void* dw,
                             const DwArgs* a, void* stream) {
  if (a->R < 0 || a->N <= 0 || a->K <= 0 || a->G <= 0 || a->G > 65535 || a->R > 2147483647LL ||
      (a->variant == 1 && a->R == 0))
    return (int)cudaErrorInvalidValue;
  const int* sz = (const int*)sizes;
  cudaStream_t s = (cudaStream_t)stream;
  if (a->out_dtype == 0) return launch_dw<float>(x, dy, sz, dw, *a, s);
  if (a->out_dtype == 1) return launch_dw<bf16>(x, dy, sz, dw, *a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
