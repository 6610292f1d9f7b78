// dOS (distributed-output-stationary) matmul for Hopper: C(M,N) = A(M,K) @ B(K,N).
//
// Replaces the Pallas TPU kernel dos_matmul_kernel / dos_matmul_pallas
// (src/repro/kernels/dos_matmul/kernel.py). There the grid was
// (M/bm, N/bn, K/bk) with K innermost and sequential: each K block is one
// of the paper's "tiers", and an f32 output tile stays resident in VMEM
// while the tiers are summed into it. Here one thread block owns one
// output tile for its whole life and walks K in a loop (the tiers), with
// the f32 partial sums held in registers (the stationary output); the
// tile is written once, cast to the output type, after the last tier.
//
// What bounds it on an H100: at the serve path's shapes it is bytes. A
// decode step has M = 4, so every weight byte is used 4 times (about
// 4 operations per byte against the card's ~295 for bf16); prefill at
// M = 512 is about 200 operations per byte, still under the ridge. So
// the design reads each operand tile from device memory once per block
// and reuses it from shared memory for the whole tile. The loads of the
// next tier are issued into registers before the current tier is
// multiplied, so their latency overlaps the arithmetic instead of
// adding up, and they are 16-byte vectors wherever the leading
// dimensions allow. bf16 multiplies on the tensor cores (WMMA 16x16x16,
// f32 sums); f32 multiplies with FMAs, which keeps full f32 products
// (TF32 would not). Not done yet: cp.async/TMA pipelines of several
// stages, wgmma, and split-K, which decode needs (N/64 blocks leave most
// SMs idle at M = 4).
//
// Any M, N and K: the ragged edges are masked inside the kernel (loads
// outside the matrix read zero, stores outside are skipped), so there is
// no host-side padding. B is read through its strides, either one of
// which may be the unit one, so the tied unembedding's transposed view
// of the embedding table needs no copy.
//
// C interface (loaded with ctypes): dos_matmul_launch returns the CUDA
// error code of the launch (0 on success). dtype codes: 0 = float32,
// 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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
// bf16 operands: tensor cores through WMMA, f32 accumulation.
// Block tile 64x64, K step 64, 4 warps each owning a 32x32 quarter.
// ---------------------------------------------------------------------------
constexpr int WM = 64, WN = 64, WK = 64, W_NT = 128;
constexpr int WLDA = WK + 8;  // bf16 leading dims: multiples of 8 (WMMA),
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

// C(M,N) = A(M,K) @ B(K,N). A and C are contiguous row-major; B element
// (k, n) lies at b[k * sbk + n * sbn], with sbn == 1 or sbk == 1.
int dos_matmul_launch(const void* a, const void* b, void* c, long long M, long long N,
                      long long K, long long sbk, long long sbn, int in_dtype, int out_dtype,
                      void* stream) {
  const bool b_t = sbn != 1;  // B's unit stride runs along k (a transposed view)
  const int64_t ldb = b_t ? sbn : sbk;
  if (M <= 0 || N <= 0 || K < 0 || (b_t && sbk != 1) || (M + 63) / 64 > 65535 ||
      (in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t vec_elems = in_dtype == 1 ? 8 : 4;  // elements in 16 bytes
  const bool vec = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 && K % vec_elems == 0 &&
                   ldb % vec_elems == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 1 && out_dtype == 1)
    launch_layout<__nv_bfloat16, __nv_bfloat16>(vec, b_t, a, b, c, M, N, K, ldb, s);
  else if (in_dtype == 1)
    launch_layout<__nv_bfloat16, float>(vec, b_t, a, b, c, M, N, K, ldb, s);
  else if (out_dtype == 1)
    launch_layout<float, __nv_bfloat16>(vec, b_t, a, b, c, M, N, K, ldb, s);
  else
    launch_layout<float, float>(vec, b_t, a, b, c, M, N, K, ldb, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
