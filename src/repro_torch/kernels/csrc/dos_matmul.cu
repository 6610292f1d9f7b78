// dOS (distributed-output-stationary) matmul for Hopper: C(M,N) = A(M,K) @ B(K,N).
//
// Replaces the Pallas TPU kernel dos_matmul_kernel / dos_matmul_pallas
// (src/repro/kernels/dos_matmul/kernel.py). There the grid was
// (M/bm, N/bn, K/bk) with K innermost and sequential: each K block is one
// of the paper's "tiers", and an f32 output tile stays resident in VMEM
// while the tiers are summed into it. Here each block sums its tiers in
// f32 registers and writes its tile once. Where a grid of output tiles
// alone would leave most of the 132 SMs idle, the tiers of a tile are
// also split over the blocks of a thread-block cluster, and the partial
// tiles meet in one block through distributed shared memory, added in
// rank order: one launch, no atomics, bit-identical from call to call.
//
// The host planner (kernels/dos_matmul/ops.py::plan) picks one of four
// variants from the shape, before the launch, and passes its tiling:
//
// skinny (bf16, M <= 16: every decode projection). Bytes bound it: B is
// read once and each of its elements meets at most 16 rows of A, so a
// zamba2 decode GEMM does ~4 operations per byte against the card's ~295
// (bf16 peak over HBM rate). The design keeps HBM busy from as many SMs
// as possible: a block takes 4 rows of A (M up to 16 runs as up to four
// such chunks), the planner tiles N by 64 or 128 columns and splits K
// over a cluster of up to 8 blocks until the grid has ~1.5 blocks per SM;
// inside a block 256 threads split K again, each with two batches of
// eight 16-byte loads of B (one in flight while the other is summed; the
// first is issued before A is staged). A's rows sit in shared memory:
// f32 [k][m] for row-major B, read as broadcast float4, and bf16 [m][k]
// for the transposed view, one 16-byte vector per lane. The sums are
// f32 FMAs on the CUDA cores: at M = 4 they need ~7 TFMA/s at full HBM
// rate, a fifth of the cores' rate, so the tensor cores would buy
// nothing, and an mma.sync layout would cost a trip through shared
// memory. Partials meet by warp shuffles (a butterfly), then in warp
// order through shared memory; each block of a cluster then writes its
// partial tile into its slot of rank 0's shared memory, and after one
// cluster barrier rank 0 adds the slots in rank order, casts and stores.
//
// wgmma (bf16, M > 16, operands TMA can describe: prefill). At M = 512
// a product such as 2560x2560 needs ~390 operations per byte, above the
// ridge, so the tensor cores bound it, and only wgmma reaches their full
// rate. A block owns a 128 x BN tile (BN 64, 128, 192 or 256, picked by
// a wave model of the card's SMs): one producer thread issues TMA loads of
// A (128 x 64, K-major) and B into a ring of 4-5 stages in dynamic
// shared memory with the 128-byte swizzle, each stage guarded by a full
// and an empty mbarrier; two consumer warpgroups run
// wgmma.mma_async m64nNk16 on their 64-row halves with f32 accumulators
// in registers, one k-tile of wgmma in flight behind the issue. B is
// K-major for the tied unembedding's transposed view (box BN x 64) and
// MN-major for row-major weights (boxes of 64 x 64 and the descriptor's
// transpose bit); neither is copied. TMA zero-fills reads outside the
// matrix, so any M, N and K work without host padding. The epilogue
// stages the tile through the drained ring and writes 16-byte row
// vectors, masked at the edge. M tiles are adjacent in the grid, so the
// blocks that read one B tile run together and B comes from device
// memory about once. K is split over a cluster only for grids of a few
// tiles (2560x64 at M = 512 is 4): clusters of such whole-SM blocks
// measured slow in larger grids.
//
// skinny and wgmma write bf16 (the serve path's output type).
//
// general (bf16, M > 16 that TMA cannot describe: K or B's leading
// dimension not a multiple of 8, or a base not 16-byte aligned; and bf16
// operands asked for an f32 output, at any M). One block per 64x64 tile
// walks K with WMMA 16x16x16 and one tier of register prefetch; ragged
// edges are masked in the kernel.
//
// f32 (f32 operands): FMA on the CUDA cores, full f32 products (TF32
// would not keep them), 64x64 tiles, one tier of register prefetch.
//
// B is read through its strides, either one of which may be the unit
// one, so the tied unembedding's transposed view of the embedding table
// needs no copy in any variant.
//
// C interface (loaded with ctypes): dos_matmul_launch returns the CUDA
// error code of the launch (0 on success). dtype codes: 0 = float32,
// 1 = bfloat16. Variant codes: 0 general, 1 skinny, 2 wgmma, 3 f32.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One (SLOW x FAST) tile of a matrix whose FAST index has unit stride,
// staged through registers: load() issues every global read of the tile
// at once, store() writes it to shared memory (transposed if asked).
// With VEC each thread moves 16-byte vectors, which needs a 16-byte
// aligned base and a leading dimension that is a multiple of the vector;
// a vector that crosses the matrix edge is gathered element by element.
template <typename T, int V>
union Pack {  // one 16-byte vector, or its elements
  uint4 u;
  T e[V];
};
template <typename T>
union Pack<T, 1> {
  T e[1];
};

template <typename T, int SLOW, int FAST, int NT, bool VEC>
struct Tile {
  static constexpr int V = VEC ? 16 / sizeof(T) : 1;
  static constexpr int PER_ROW = FAST / V;
  static constexpr int N = SLOW * FAST / V / NT;  // vectors per thread
  static_assert(SLOW * FAST % (V * NT) == 0, "tile does not split over the threads");
  Pack<T, V> r[N];

  __device__ __forceinline__ void load(const T* __restrict__ p, int64_t ld, int64_t s0,
                                       int64_t f0, int64_t s_n, int64_t f_n) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int v = threadIdx.x + i * NT;
      const int64_t gs = s0 + v / PER_ROW, gf = f0 + (v % PER_ROW) * V;
      if constexpr (VEC) {
        if (gs < s_n && gf + V <= f_n) {
          r[i].u = *reinterpret_cast<const uint4*>(p + gs * ld + gf);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e)
        r[i].e[e] = (gs < s_n && gf + e < f_n) ? p[gs * ld + gf + e] : from_f32<T>(0.f);
    }
  }

  // element (s, f) goes to smem[s * lds + f], or smem[f * lds + s] if TRANS
  template <bool TRANS>
  __device__ __forceinline__ void store(T* smem, int lds) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int v = threadIdx.x + i * NT;
      const int s = v / PER_ROW, f = (v % PER_ROW) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (TRANS) smem[(f + e) * lds + s] = r[i].e[e];
        else smem[s * lds + f + e] = r[i].e[e];
      }
    }
  }
};

// The operand tiles of one tier: A (BM x BK) from row-major A; B (BK x BN)
// from B with unit stride along n (B_T = false) or along k (B_T = true).
template <typename T, int BM, int BN, int BK, int NT, bool VEC, bool B_T>
struct Tier {
  Tile<T, BM, BK, NT, VEC> a;
  Tile<T, B_T ? BN : BK, B_T ? BK : BN, NT, VEC> b;

  __device__ __forceinline__ void load(const T* A, const T* B, int64_t M, int64_t N,
                                       int64_t K, int64_t ldb, int64_t m0, int64_t n0,
                                       int64_t k0) {
    a.load(A, K, m0, k0, M, K);
    if (B_T) b.load(B, ldb, n0, k0, N, K);
    else b.load(B, ldb, k0, n0, K, N);
  }
  __device__ __forceinline__ void store(T* As, int lda, T* Bs, int ldb) const {
    a.template store<false>(As, lda);
    b.template store<B_T>(Bs, ldb);  // Bs is [k][n] either way
  }
};

// ---------------------------------------------------------------------------
// Cluster helpers: a barrier over every thread of the cluster (release
// and acquire: shared-memory writes before it, local or remote, are
// visible after it), and the generic address of a shared-memory location
// in another block of the cluster (plain loads and stores through it;
// the barrier's memory clobber keeps them on their side of it).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A block may touch another block's shared memory only once that block
// has started: every block arrives (relaxed, not waiting) when it starts
// and waits just before its first remote access, by which time the
// others have long arrived.
__device__ __forceinline__ void cluster_arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_started() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ const float* cluster_rank_ptr(const float* p, uint32_t rank) {
  uint64_t remote;
  asm("mapa.u64 %0, %1, %2;" : "=l"(remote) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(remote);
}

// ---------------------------------------------------------------------------
// general: __nv_bfloat16 operands on the tensor cores through WMMA, f32 sums.
// Block tile 64x64, K step 64, 4 warps each owning a 32x32 quarter.
// ---------------------------------------------------------------------------
constexpr int WM = 64, WN = 64, WK = 64, W_NT = 128;
constexpr int WLDA = WK + 8;  // __nv_bfloat16 leading dims: multiples of 8 (WMMA),
constexpr int WLDB = WN + 8;  // padded against shared-memory bank conflicts
constexpr int WLDC = WN + 4;  // f32 leading dim: a multiple of 4 (WMMA)

template <typename TOut, bool VEC, bool B_T>
__global__ void __launch_bounds__(W_NT)
dos_matmul_wmma_bf16(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                     TOut* __restrict__ c, int64_t M, int64_t N, int64_t K, int64_t ldb) {
  __shared__ __align__(128) __nv_bfloat16 As[WM * WLDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[WK * WLDB];
  __shared__ __align__(128) float Cs[WM * WLDC];

  const int64_t m0 = (int64_t)blockIdx.y * WM, n0 = (int64_t)blockIdx.x * WN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Tier<__nv_bfloat16, WM, WN, WK, W_NT, VEC, B_T> tier;
  tier.load(a, b, M, N, K, ldb, m0, n0, 0);
  for (int64_t k0 = 0; k0 < K; k0 += WK) {  // the dOS tiers
    tier.store(As, WLDA, Bs, WLDB);
    __syncthreads();
    if (k0 + WK < K) tier.load(a, b, M, N, K, ldb, m0, n0, k0 + WK);  // next tier, in flight
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * WLDA + kk, WLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * WLDB + wn + 16 * j, WLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * WLDC + wn + 16 * j, acc[i][j], WLDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < WM * WN; idx += W_NT) {
    int r = idx / WN, cc = idx % WN;
    int64_t gm = m0 + r, gn = n0 + cc;
    if (gm < M && gn < N) c[gm * N + gn] = from_f32<TOut>(Cs[r * WLDC + cc]);
  }
}

// ---------------------------------------------------------------------------
// f32 operands: FMA on the CUDA cores, full f32 products and sums.
// Block tile 64x64, K step 16, 256 threads each owning a 4x4 strided patch.
// ---------------------------------------------------------------------------
constexpr int FM = 64, FN = 64, FK = 16, F_NT = 256;
constexpr int FLDA = FK + 1, FLDB = FN + 4;

template <typename TOut, bool VEC, bool B_T>
__global__ void __launch_bounds__(F_NT)
dos_matmul_fma_f32(const float* __restrict__ a, const float* __restrict__ b,
                   TOut* __restrict__ c, int64_t M, int64_t N, int64_t K, int64_t ldb) {
  __shared__ float As[FM * FLDA];  // As[m][k]
  __shared__ float Bs[FK * FLDB];  // Bs[k][n]

  const int64_t m0 = (int64_t)blockIdx.y * FM, n0 = (int64_t)blockIdx.x * FN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};

  Tier<float, FM, FN, FK, F_NT, VEC, B_T> tier;
  tier.load(a, b, M, N, K, ldb, m0, n0, 0);
  for (int64_t k0 = 0; k0 < K; k0 += FK) {  // the dOS tiers
    tier.store(As, FLDA, Bs, FLDB);
    __syncthreads();
    if (k0 + FK < K) tier.load(a, b, M, N, K, ldb, m0, n0, k0 + FK);  // next tier, in flight
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(ty + 16 * i) * FLDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * FLDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int64_t gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) c[gm * N + gn] = from_f32<TOut>(acc[i][j]);
    }
}

// ---------------------------------------------------------------------------
// skinny: bf16, M <= 16. Grid (split, N tiles, M chunks of S_MT rows);
// the split blocks of one tile form a cluster and block x takes K rows
// [x * k_chunk, (x + 1) * k_chunk).
// ---------------------------------------------------------------------------
constexpr int S_NT = 256, S_NW = S_NT / 32;
constexpr int S_MT = 4;         // rows of A per block (one float4 of A per k)
constexpr int S_MAX_SPLIT = 8;  // blocks of a cluster: the gather buffer's slots
constexpr int S_KC = 1024;      // K rows of A staged in shared memory at a time
constexpr int S_U = 8;          // 16-byte loads of B per batch and thread (row-major B)
constexpr int S_TBN = 64;       // N tile of the transposed-B kernel: 8 rows per warp

typedef Pack<bf16, 8> Vec8;

__device__ __forceinline__ void unpack8(const Vec8& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 8 consecutive elements p[0..7], of which the first `valid` exist; a
// 16-byte load when VEC and all 8 exist, else element by element.
template <bool VEC>
__device__ __forceinline__ void load8(Vec8& v, const bf16* __restrict__ p, int valid) {
  if (VEC && valid >= 8) {
    v.u = __ldg(reinterpret_cast<const uint4*>(p));
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v.e[e] = e < valid ? p[e] : __float2bfloat16(0.f);
}

// Where this block writes its S_MT x BN partial tile: its slot (its rank)
// of the gather buffer of rank 0, through distributed shared memory.
__device__ __forceinline__ float* skinny_slot(float* gather, int tile) {
  const uint32_t rank = blockIdx.x;
  float* g = rank == 0 ? gather : const_cast<float*>(cluster_rank_ptr(gather, 0));
  return g + rank * tile;
}

// Once every block of the cluster has written its slot (one cluster
// barrier), rank 0 adds the slots in rank order, casts and stores.
template <int BN>
__device__ __forceinline__ void skinny_finish(const float* gather, bf16* __restrict__ c, int M,
                                              int N, int m0, int64_t n0) {
  const uint32_t split = gridDim.x;
  if (split > 1) cluster_sync();
  else __syncthreads();
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < S_MT * BN; i += S_NT) {
    const int m = i / BN, j = i % BN;
    if (m0 + m < M && n0 + j < N) {
      float v = gather[i];
      for (uint32_t r = 1; r < split; ++r) v += gather[r * S_MT * BN + i];
      c[(int64_t)(m0 + m) * N + n0 + j] = __float2bfloat16(v);
    }
  }
}

// Row-major B (unit stride along n). Thread t owns 8 columns
// (t % (BN/8)) and every KT-th k row from t / (BN/8).
template <int BN, bool VEC>
__global__ void __launch_bounds__(S_NT, 2)  // two blocks per SM
dos_matmul_skinny_rm(const bf16* __restrict__ a, const bf16* __restrict__ b,
                     bf16* __restrict__ c, int M, int N, int K, int64_t ldb, int k_chunk) {
  constexpr int NV = BN / 8, KT = S_NT / NV, LANES_K = 32 / NV;
  constexpr int SMEM = S_KC * S_MT > S_NW * S_MT * BN ? S_KC * S_MT : S_NW * S_MT * BN;
  __shared__ __align__(16) float sm[SMEM];  // A as [k][m] f32, then the warps' partials
  __shared__ __align__(16) float gather[S_MAX_SPLIT * S_MT * BN];  // rank 0's

  const int64_t n0 = (int64_t)blockIdx.y * BN;
  const int m0 = blockIdx.z * S_MT;
  const int kb = blockIdx.x * k_chunk, ke = min(K, kb + k_chunk);
  const int nv = threadIdx.x % NV, ks = threadIdx.x / NV;
  const int64_t n = n0 + nv * 8;
  if (gridDim.x > 1) cluster_arrive_started();
  const int n_valid = N - n >= 8 ? 8 : (N > n ? (int)(N - n) : 0);

  float acc[S_MT][8];
#pragma unroll
  for (int m = 0; m < S_MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  constexpr int STEP = KT * S_U;  // k rows of one batch of loads
  for (int c0 = kb; c0 < ke; c0 += S_KC) {
    const int cn = min(S_KC, ke - c0);
    Vec8 v0[S_U], v1[S_U];  // two batches: one in flight while the other is summed
    auto load_batch = [&](Vec8 (&v)[S_U], int k) {  // every load of a batch at once
#pragma unroll
      for (int u = 0; u < S_U; ++u) {
        const int kk = k + u * KT;
        load8<VEC>(v[u], b + (int64_t)(c0 + kk) * ldb + n, kk < cn ? n_valid : 0);
      }
    };
    auto sum_batch = [&](const Vec8 (&v)[S_U], int k) {
#pragma unroll
      for (int u = 0; u < S_U; ++u) {
        const int kk = k + u * KT;
        if (kk < cn) {
          float bv[8];
          unpack8(v[u], bv);
          const float4 t = *reinterpret_cast<const float4*>(sm + kk * S_MT);
          const float av[S_MT] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int m = 0; m < S_MT; ++m)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(av[m], bv[j], acc[m][j]);
        }
      }
    };
    load_batch(v0, ks);  // B's first batch is in flight while A is staged
    for (int i = threadIdx.x; i < cn * S_MT; i += S_NT) {
      const int m = i / cn, kk = i % cn;  // coalesced along k in A
      sm[kk * S_MT + m] =
          m0 + m < M ? __bfloat162float(a[(int64_t)(m0 + m) * K + c0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int k = ks; k < cn; k += 2 * STEP) {
      load_batch(v1, k + STEP);
      sum_batch(v0, k);
      if (k + 2 * STEP < cn) load_batch(v0, k + 2 * STEP);
      sum_batch(v1, k + STEP);
    }
    __syncthreads();
  }

  // lanes of a warp that share a column group differ in k: butterfly sum
#pragma unroll
  for (int off = NV; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < S_MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < NV) {
#pragma unroll
    for (int m = 0; m < S_MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) sm[(warp * S_MT + m) * BN + nv * 8 + j] = acc[m][j];
  }
  static_assert(LANES_K >= 1, "BN wider than a warp's vectors");
  __syncthreads();
  if (gridDim.x > 1) cluster_wait_started();
  float* slot = skinny_slot(gather, S_MT * BN);
  for (int i = threadIdx.x; i < S_MT * BN; i += S_NT) {  // the warps' partials, in warp order
    float v = sm[i];
#pragma unroll
    for (int w = 1; w < S_NW; ++w) v += sm[w * S_MT * BN + i];
    slot[i] = v;
  }
  skinny_finish<BN>(gather, c, M, N, m0, n0);
}

// Transposed B (unit stride along k: the tied unembedding's tok.T).
// Warp w owns the 8 rows n0 + 8w .. n0 + 8w + 7 of B^T; each lane reads
// 8 consecutive k of every row (a warp reads 512 contiguous bytes of a
// row), so A[m][k..k+7] is one 16-byte shared-memory vector per lane,
// reused for the 8 rows.
template <bool VEC>
__global__ void __launch_bounds__(S_NT, 2)
dos_matmul_skinny_t(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    bf16* __restrict__ c, int M, int N, int K, int64_t ldb, int k_chunk) {
  constexpr int NR = S_TBN / S_NW;  // rows of B^T per warp
  __shared__ __align__(16) bf16 sa[S_MT * S_KC];  // A as [m][k]
  __shared__ __align__(16) float gather[S_MAX_SPLIT * S_MT * S_TBN];  // rank 0's

  const int64_t n0 = (int64_t)blockIdx.y * S_TBN;
  const int m0 = blockIdx.z * S_MT;
  const int kb = blockIdx.x * k_chunk, ke = min(K, kb + k_chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (gridDim.x > 1) cluster_arrive_started();

  float acc[NR][S_MT];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int m = 0; m < S_MT; ++m) acc[r][m] = 0.f;

  for (int c0 = kb; c0 < ke; c0 += S_KC) {
    const int cn = min(S_KC, ke - c0), cn8 = (cn + 7) & ~7;
    Vec8 v[NR];
    auto load_rows = [&](int kk) {  // the warp's 8 rows in flight at once
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int64_t n = n0 + warp * NR + r;
        load8<VEC>(v[r], b + n * ldb + c0 + kk, n < N && kk < cn ? cn - kk : 0);
      }
    };
    load_rows(lane * 8);  // B's first rows are in flight while A is staged
    for (int i = threadIdx.x; i < cn8 * S_MT; i += S_NT) {
      const int m = i / cn8, kk = i % cn8;
      sa[m * S_KC + kk] = m0 + m < M && kk < cn ? a[(int64_t)(m0 + m) * K + c0 + kk]
                                                 : __float2bfloat16(0.f);
    }
    __syncthreads();
    for (int kk = lane * 8; kk < cn; kk += 32 * 8) {
      if (kk > lane * 8) load_rows(kk);
      float av[S_MT][8];
#pragma unroll
      for (int m = 0; m < S_MT; ++m) {
        Vec8 t;
        t.u = *reinterpret_cast<const uint4*>(sa + m * S_KC + kk);
        unpack8(t, av[m]);
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float bv[8];
        unpack8(v[r], bv);
#pragma unroll
        for (int m = 0; m < S_MT; ++m)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][m] = fmaf(av[m][e], bv[e], acc[r][m]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int off = 16; off > 0; off /= 2)  // butterfly over the warp's lanes (k)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int m = 0; m < S_MT; ++m) acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);
  if (gridDim.x > 1) cluster_wait_started();
  if (lane == 0) {
    float* slot = skinny_slot(gather, S_MT * S_TBN);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int m = 0; m < S_MT; ++m) slot[m * S_TBN + warp * NR + r] = acc[r][m];
  }
  skinny_finish<S_TBN>(gather, c, M, N, m0, n0);
}

// ---------------------------------------------------------------------------
// wgmma: bf16, M > 16, operands described by TMA. Block tile 128 x BN,
// K stage 64; warpgroups 0 and 1 consume (rows 0-63 and 64-127), warp 8
// (in warpgroup 2) produces. Grid (split, M tiles, N tiles); the split
// blocks of one tile form a cluster.
// ---------------------------------------------------------------------------
constexpr int G_BM = 128, G_BK = 64, G_NT = 384;
constexpr int G_A_BYTES = G_BM * G_BK * 2;  // 16 KB: 128 rows of 128 bytes

template <int BN>
struct WgCfg {
  static constexpr int B_BYTES = BN * G_BK * 2;
  static constexpr int STAGE = G_A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 4 : 5;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;  // + barriers, alignment
  static constexpr int IN = BN == 256 ? 128 : BN;  // N of one wgmma instruction
  static constexpr int NI = BN / IN;               // wgmma instructions per k16
  static_assert(G_BM * BN * 4 <= STAGES * STAGE, "the split's partial tile must fit the ring");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (it cannot see that they are still being written)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define D8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d(64 x N) += A(64 x 16, K-major) B(16 x N); TB: B is MN-major.
template <int N, int TB> struct Wgmma;

template <int TB> struct Wgmma<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n\t}"
        : D8(0), D8(8), D8(16), D8(24)
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  }
};

template <int TB> struct Wgmma<128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n\t}"
        : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  }
};
template <int TB> struct Wgmma<192, TB> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %98, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, 0, %99;\n\t}"
        : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72),
          D8(80), D8(88)
        : "l"(da), "l"(db), "r"(1), "n"(TB));
  }
};
#undef D8

// The block's 128 x BN result (each consumer thread's wgmma fragment,
// f32) cast to bf16, staged through shared memory (the drained ring) and
// written as 16-byte row vectors, masked at the matrix edge. Called by
// the 256 consumer threads together.
template <int BN, int NI, int R>
__device__ __forceinline__ void store_tile(const float (&acc)[NI][R], uint8_t* smem,
                                           bf16* __restrict__ c, int M, int N, int m0, int n0,
                                           int row_l, int col_l) {
  constexpr int IN = R * 2, VE = 8, VPR = BN / VE;  // VE: bf16 per 16 bytes
  constexpr int LDS = BN + VE;  // row pitch: 16-byte rows, shifted off the bank period
  static_assert(G_BM * LDS * 2 <= WgCfg<BN>::STAGES * WgCfg<BN>::STAGE, "tile fits");
  bf16* st = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int q = 0; q < NI; ++q)
#pragma unroll
    for (int j = 0; j < R; j += 2) {
      const int r = row_l + 8 * ((j / 2) % 2), cc = q * IN + 8 * (j / 4) + col_l;
      *reinterpret_cast<__nv_bfloat162*>(st + r * LDS + cc) =
          __floats2bfloat162_rn(acc[q][j], acc[q][j + 1]);
    }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const bool vec = N % VE == 0;  // every row starts 16-byte aligned
  for (int v = threadIdx.x; v < G_BM * VPR; v += 256) {
    const int r = v / VPR, cv = (v % VPR) * VE, row = m0 + r, col = n0 + cv;
    if (row >= M || col >= N) continue;
    const bf16* src = st + r * LDS + cv;
    bf16* dst = c + (int64_t)row * N + col;
    if (vec && col + VE <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < VE && col + e < N; ++e) dst[e] = src[e];
    }
  }
}

// B_T: B is the transposed view (K-major, TMA box BN x 64); else
// row-major (MN-major, BN/64 boxes of 64 k x 64 n).
template <int BN, bool B_T>
__global__ void __launch_bounds__(G_NT, 1)
dos_matmul_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 bf16* __restrict__ c, int M, int N, int k_tiles, int tiles_per_split) {
  using Cfg = WgCfg<BN>;
  constexpr int ST = Cfg::STAGES, NI = Cfg::NI, IN = Cfg::IN, R = IN / 2;
  extern __shared__ uint8_t dyn_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(dyn_smem) + 1023) &
                                             ~uintptr_t(1023));  // swizzle atoms: 1 KB aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * Cfg::STAGE);
  uint64_t* empty = full + ST;

  const uint32_t split = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.y * G_BM, n0 = blockIdx.z * BN;
  const int kt0 = rank * tiles_per_split;
  const int nkt = max(0, min(k_tiles, kt0 + tiles_per_split) - kt0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      for (int i = 0; i < nkt; ++i) {
        const int s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], Cfg::STAGE);
        uint8_t* st = smem + s * Cfg::STAGE;
        const int k = (kt0 + i) * G_BK;
        tma_load(st, &ta, &full[s], k, m0);
        if (B_T) {
          tma_load(st + G_A_BYTES, &tb, &full[s], k, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) tma_load(st + G_A_BYTES + j * 8192, &tb, &full[s], n0 + 64 * j, k);
        }
      }
    }
    __syncwarp();
    if (split > 1) {
      cluster_sync();
      cluster_sync();
    }
  } else {  // consumer warpgroups 0 and 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[NI][R];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    for (int i = 0; i < nkt; ++i) {
      const int s = i % ST;
      mbar_wait(&full[s], (i / ST) & 1);
      const uint32_t a_st = smem_u32(smem + s * Cfg::STAGE) + wg * 64 * 128;
      const uint32_t b_st = smem_u32(smem + s * Cfg::STAGE + G_A_BYTES);
#pragma unroll
      for (int q = 0; q < NI; ++q) fence_regs(acc[q]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G_BK / 16; ++kk) {
        const uint64_t da = sw128_desc(a_st + kk * 32, 16, 1024);
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          // q-th 128 columns of B start 128 rows (K-major) or 2 boxes (MN-major) on: 16 KB
          const uint64_t db = B_T ? sw128_desc(b_st + q * 16384 + kk * 32, 16, 1024)
                                  : sw128_desc(b_st + q * 16384 + kk * 2048, 8192, 1024);
          Wgmma<IN, B_T ? 0 : 1>::run(acc[q], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
      for (int q = 0; q < NI; ++q) fence_regs(acc[q]);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % ST]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < NI; ++q) fence_regs(acc[q]);

    // fragment layout of m64nNk16: register j of a thread holds row
    // 16 * (warp % 4) + lane / 4 + 8 * ((j / 2) % 2), column 8 * (j / 4) + 2 * (lane % 4) + j % 2
    const int row_l = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col_l = 2 * (lane % 4);
    asm volatile("bar.sync 1, 256;" ::: "memory");  // both warpgroups are done reading the ring
    if (split == 1) {
      store_tile<BN>(acc, smem, c, M, N, m0, n0, row_l, col_l);
    } else {
      // partial tiles meet through shared memory, in rank order, at rank 0
      float* part = reinterpret_cast<float*>(smem);  // [128][BN] f32, over the drained ring
      if (rank != 0) {
#pragma unroll
        for (int q = 0; q < NI; ++q)
#pragma unroll
          for (int j = 0; j < R; j += 2) {
            const int r = row_l + 8 * ((j / 2) % 2), cc = q * IN + 8 * (j / 4) + col_l;
            *reinterpret_cast<float2*>(part + r * BN + cc) = make_float2(acc[q][j], acc[q][j + 1]);
          }
      }
      cluster_sync();
      if (rank == 0) {
        for (uint32_t o = 1; o < split; ++o) {  // rank order; a rank's loads in flight together
          const float* remote = cluster_rank_ptr(part, o);
#pragma unroll
          for (int q = 0; q < NI; ++q)
#pragma unroll
            for (int j = 0; j < R; j += 2) {
              const int r = row_l + 8 * ((j / 2) % 2), cc = q * IN + 8 * (j / 4) + col_l;
              const float2 t = *reinterpret_cast<const float2*>(remote + r * BN + cc);
              acc[q][j] += t.x;
              acc[q][j + 1] += t.y;
            }
        }
        store_tile<BN>(acc, smem, c, M, N, m0, n0, row_l, col_l);  // its own ring is free
      }
      cluster_sync();  // no block leaves while rank 0 reads it
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out
// its address, so the library needs no link against libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 2-D bf16 tensor map: `inner` x `outer` elements, rows `ld` elements
// apart, box `box_inner` x `box_outer`, 128-byte swizzle, zero fill.
bool encode2d(EncodeTiled enc, CUtensorMap* map, const void* base, uint64_t inner,
              uint64_t outer, uint64_t ld, uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A launch of `kernel` on a grid whose x extent is one cluster.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                           cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = grid.x > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int BN, bool B_T>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K, int64_t ldb,
                         int split, int k_chunk, cudaStream_t s) {
  using Cfg = WgCfg<BN>;
  auto kernel = dos_matmul_wgmma<BN, B_T>;
  // once per instantiation and host thread: a thread whose first CUDA call
  // is this launch (autograd's backward thread, say) must raise the cap
  // itself; a flag shared by the threads made such a launch fail with
  // "invalid argument" after another thread had set it
  static thread_local bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  EncodeTiled enc = encode_fn();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap ta, tb;
  bool ok = encode2d(enc, &ta, a, K, M, K, G_BK, G_BM);
  ok = ok && (B_T ? encode2d(enc, &tb, b, K, N, ldb, G_BK, BN)
                  : encode2d(enc, &tb, b, N, K, ldb, 64, G_BK));
  if (!ok) return cudaErrorInvalidValue;
  const int k_tiles = (K + G_BK - 1) / G_BK, per = k_chunk / G_BK;
  // M tiles run next to each other, so the blocks that read one B tile
  // are resident together and B comes from device memory about once
  dim3 grid(split, (M + G_BM - 1) / G_BM, (N + BN - 1) / BN);
  return launch_cluster(kernel, grid, G_NT, Cfg::SMEM, s, ta, tb, (bf16*)c, M, N, k_tiles, per);
}

cudaError_t launch_wgmma_bn(int bn, bool b_t, const void* a, const void* b, void* c, int M,
                            int N, int K, int64_t ldb, int split, int k_chunk, cudaStream_t s) {
#define W_CASE(BN_)                                                                        \
  if (bn == BN_)                                                                           \
    return b_t ? launch_wgmma<BN_, true>(a, b, c, M, N, K, ldb, split, k_chunk, s)         \
               : launch_wgmma<BN_, false>(a, b, c, M, N, K, ldb, split, k_chunk, s);
  W_CASE(64)
  W_CASE(128)
  W_CASE(192)
  W_CASE(256)
#undef W_CASE
  return cudaErrorInvalidValue;
}

cudaError_t launch_skinny(int bn, bool b_t, bool vec, const void* a, const void* b, void* c,
                          int M, int N, int K, int64_t ldb, int split, int k_chunk,
                          cudaStream_t s) {
  const bf16* A = (const bf16*)a;
  const bf16* B = (const bf16*)b;
  bf16* C = (bf16*)c;
  dim3 grid(split, (N + bn - 1) / bn, (M + S_MT - 1) / S_MT);
  if (b_t) {
    if (bn != S_TBN) return cudaErrorInvalidValue;
    return launch_cluster(vec ? dos_matmul_skinny_t<true> : dos_matmul_skinny_t<false>, grid,
                          S_NT, 0, s, A, B, C, M, N, K, ldb, k_chunk);
  }
#define R_CASE(BN_, VEC_)                                                                   \
  if (bn == BN_ && vec == VEC_)                                                             \
    return launch_cluster(dos_matmul_skinny_rm<BN_, VEC_>, grid, S_NT, 0, s, A, B, C, M, N, K, \
                          ldb, k_chunk);
  R_CASE(64, true) R_CASE(64, false) R_CASE(128, true) R_CASE(128, false)
#undef R_CASE
  return cudaErrorInvalidValue;
}

template <typename TIn, typename TOut, bool VEC, bool B_T>
void launch(const void* a, const void* b, void* c, int64_t M, int64_t N, int64_t K, int64_t ldb,
            cudaStream_t s) {
  if constexpr (sizeof(TIn) == 2) {
    dim3 grid((unsigned)((N + WN - 1) / WN), (unsigned)((M + WM - 1) / WM));
    dos_matmul_wmma_bf16<TOut, VEC, B_T><<<grid, W_NT, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (TOut*)c, M, N, K, ldb);
  } else {
    dim3 grid((unsigned)((N + FN - 1) / FN), (unsigned)((M + FM - 1) / FM));
    dos_matmul_fma_f32<TOut, VEC, B_T><<<grid, F_NT, 0, s>>>((const float*)a, (const float*)b,
                                                            (TOut*)c, M, N, K, ldb);
  }
}

template <typename TIn, typename TOut>
void launch_layout(bool vec, bool b_t, const void* a, const void* b, void* c, int64_t M,
                   int64_t N, int64_t K, int64_t ldb, cudaStream_t s) {
  if (vec) {
    if (b_t) launch<TIn, TOut, true, true>(a, b, c, M, N, K, ldb, s);
    else launch<TIn, TOut, true, false>(a, b, c, M, N, K, ldb, s);
  } else {
    if (b_t) launch<TIn, TOut, false, true>(a, b, c, M, N, K, ldb, s);
    else launch<TIn, TOut, false, false>(a, b, c, M, N, K, ldb, s);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One launch's shape and plan. A and C are contiguous row-major; B
// element (k, n) lies at b[k * sbk + n * sbn], with sbn == 1 or sbk == 1.
// variant, bm, bn, split and k_chunk are the host planner's
// (ops.py::plan): general and f32 ignore the tiling; skinny takes bn,
// split and k_chunk (bm is its S_MT rows); wgmma takes bn, split and
// k_chunk (a multiple of 64) (bm is its 128 rows). skinny and wgmma store
// bf16 only. The host keeps one per shape, so a
// call converts five arguments, not sixteen.
struct DosLaunch {
  long long M, N, K, sbk, sbn;
  int in_dtype, out_dtype, variant, bm, bn, split, k_chunk;
};

// C(M,N) = A(M,K) @ B(K,N). A variant the shape does not allow is refused.
int dos_matmul_launch(const void* a, const void* b, void* c, const DosLaunch* l,
                      void* stream) {
  const long long M = l->M, N = l->N, K = l->K, sbk = l->sbk, sbn = l->sbn;
  const int in_dtype = l->in_dtype, out_dtype = l->out_dtype, variant = l->variant;
  const int bm = l->bm, bn = l->bn, split = l->split, k_chunk = l->k_chunk;
  const bool b_t = sbn != 1;  // B's unit stride runs along k (a transposed view)
  const int64_t ldb = b_t ? sbn : sbk;
  if (M <= 0 || N <= 0 || K < 0 || (b_t && sbk != 1) || (in_dtype != 0 && in_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) || (variant == 3) != (in_dtype == 0))
    return (int)cudaErrorInvalidValue;
  const int64_t vec_elems = in_dtype == 1 ? 8 : 4;  // elements in 16 bytes
  const bool aligned = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  const bool vec = aligned && K % vec_elems == 0 && ldb % vec_elems == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (variant == 1) {  // skinny
    const bool b_vec = (uintptr_t)b % 16 == 0 && ldb % 8 == 0 && k_chunk % 8 == 0;
    if (M > 16 || out_dtype != 1 || bm != S_MT || split < 1 || split > S_MAX_SPLIT ||
        k_chunk < 1 || (int64_t)split * k_chunk < K || N > (int64_t)65535 * bn || K > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    err = launch_skinny(bn, b_t, b_vec, a, b, c, M, N, K, ldb, split, k_chunk, s);
  } else if (variant == 2) {  // wgmma
    if (!vec || out_dtype != 1 || bm != G_BM || K == 0 || split < 1 || split > 8 ||
        k_chunk % G_BK || k_chunk <= 0 || (int64_t)split * k_chunk < K ||
        (M + G_BM - 1) / G_BM > 65535 || (N + bn - 1) / bn > 65535 || K > INT32_MAX ||
        M > INT32_MAX || N > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    err = launch_wgmma_bn(bn, b_t, a, b, c, M, N, K, ldb, split, k_chunk, s);
  } else if (variant == 0 || variant == 3) {  // general, f32
    if ((M + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
    if (in_dtype == 1 && out_dtype == 1)
      launch_layout<__nv_bfloat16, __nv_bfloat16>(vec, b_t, a, b, c, M, N, K, ldb, s);
    else if (in_dtype == 1)
      launch_layout<__nv_bfloat16, float>(vec, b_t, a, b, c, M, N, K, ldb, s);
    else if (out_dtype == 1)
      launch_layout<float, __nv_bfloat16>(vec, b_t, a, b, c, M, N, K, ldb, s);
    else
      launch_layout<float, float>(vec, b_t, a, b, c, M, N, K, ldb, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next call does not report it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
