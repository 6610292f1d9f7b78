// Chunked SSD (Mamba2) scan for Hopper: y and the final state of the
// linear recurrence s_t = exp(ld_t) s_{t-1} + B_t u_t^T, y_t = s_t^T C_t.
//
// Replaces the Pallas TPU kernel _ssd_kernel / ssm_scan_pallas
// (src/repro/kernels/ssm_scan/kernel.py). There the grid was
// (Bt*H, S/T) with the chunk dimension sequential, and an f32 N x P state
// stayed in VMEM scratch from one grid step to the next. Here one thread
// block owns one (b, h, P-tile) row and walks its chunks in a loop; the
// N x PT state stays on chip for the whole loop and is written to device
// memory once, after the last chunk. Per chunk of T steps,
// with la = cumsum(ld) inside the chunk:
//
//   G_ij    = (C_i . B_j) exp(la_i - la_j)   for j <= i, else 0   (T x T)
//   y_i     = sum_j G_ij U_j + exp(la_i) C_i S_prev               (T x PT)
//   S_new   = exp(la_T) S_prev + sum_j exp(la_T - la_j) B_j^T U_j  (N x PT)
//
// The exponent of G is formed only on j <= i: above the diagonal it is
// positive and its exp overflows (the reference masks before the exp).
//
// What bounds it on an H100: at zamba2's prefill (Bt 4, S 128, H 80,
// N = P = 64) a call reads u, ld, B, C once and writes y and the state,
// about 16 MB: ~5 us at 3.35 TB/s. Its ~0.76 G operations (at T = 32)
// take under 1 us on the bf16 tensor cores, so bytes and the latency of
// each chunk's dependent steps bound it. Two variants, picked per call by
// the wrapper's plan (ops.py), both one block per (b, h, 64-column P tile):
// 320 blocks at zamba2's prefill, all resident at once.
//
// mma (bf16 u, B, C with unit inner stride and 16-byte aligned rows, P a
// multiple of 8: zamba2's serving path). 4 warps, each owning 16 of the
// tile's columns for the whole sequence. Each chunk's u, B, C (16-byte
// cp.async copies) and ld (4-byte ones) land in a two-stage ring, the
// next chunk in flight while this one computes (a deeper ring measured
// no faster). Every warp scans ld itself (shuffles). The products run in
// mma.sync.m16n8k16 (bf16 in, f32 out) on ldmatrix fragments, with rows
// padded by 16 bytes (no bank conflicts):
//   - G = (C B^T) o exp(la_i - la_j), masked before the exp, once per
//     block: its 16 x 16 blocks at or below the diagonal are dealt round
//     the warps and stored in shared memory as split bf16 terms; one
//     block barrier, then each warp loads G^T's fragments with ldmatrix;
//   - a warp computes everything else transposed, P first: y^T (16 x T)
//     and its state S^T (16 x N) in f32 accumulator fragments, kept
//     across all chunks and written to device memory once, after the
//     last. So S^T's accumulators are the A fragments of
//     y^T = (S_prev^T C^T) diag(exp la) without leaving registers, and
//     the state update S^T = exp(la_T) S^T + (U o decay)^T B scales the
//     warp's U^T fragments in registers (16 x T values instead of B's
//     T x N);
//   - y and the state leave through shared memory in 16-byte stores.
// The operands the reference holds in f32 (G, S_prev, and the decayed B,
// here the decayed U) are split into two bf16 terms each (hi + lo, 16 of
// f32's 24 bits: 2**-16 of each value, against the gate's 1e-4 of the
// largest entry) and each product takes both terms into one f32
// accumulator. Two block barriers per chunk (the ring, G). mma.sync
// rather than wgmma: a 32-step chunk is below wgmma's 64 rows, and the
// bound is bytes.
//
// fma (f32 operands, and any layout mma cannot take): the N x PT state
// stays in shared memory; each thread takes a register tile (2 x 4 at
// T = 32) of each product, in f32 on the CUDA cores, one value read from
// shared memory feeding several FMAs.
//
// N and T are template parameters (N in 16, 64, 96; T in 32, 64); any P
// (the last tile is ragged) and any S (a ragged last chunk). fma's shared
// memory per block is T*PT + 2*T*(N+1) + T*(T+1) + N*PT + 3*T floats
// (45.8 KB at T = 32, N = 64); mma's is its ring of T rows of u, B, C
// and ld, each warp's staged y rows and G's terms (38.3 KB there).
//
// Inputs are read through their strides in the model's layout: u, y
// (Bt, S, H, P), ld (Bt, S, H) in f32, B, C (Bt, S, H, N) with any head
// stride (0 when the model broadcasts one B, C over the heads). u, B, C
// are f32 or bf16 (fma converts them to f32 on load); all sums are f32; y is
// written in u's type and the state (Bt, H, N, P) contiguous in f32. A
// ragged S is masked: steps past S are identity steps (ld = 0, u = B =
// C = 0), so the state passes through them unchanged.
//
// C interface (loaded with ctypes): ssm_scan_launch returns the CUDA
// error code of the launch. dtype codes: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_util.cuh"

namespace {

constexpr int NT = 256;  // threads per block, a 16 x 16 grid (ty, tx)
constexpr int PT = 64;   // P columns per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Args {
  int Bt, S, H, P;
  int64_t u[4], l[3], b[4], c[4], y[4];  // element strides
};

template <int T, int N>
constexpr size_t smem_floats() {
  return (size_t)T * PT + 2 * (size_t)T * (N + 1) + (size_t)T * (T + 1) + (size_t)N * PT + 3 * T;
}

template <typename E, int T, int N>
__global__ void __launch_bounds__(NT) ssd_fwd(const E* __restrict__ u, const float* __restrict__ ld,
                                              const E* __restrict__ Bm, const E* __restrict__ Cm,
                                              E* __restrict__ y, float* __restrict__ state, Args a) {
  static_assert(T % 16 == 0 && T <= NT && N % 16 == 0, "tile does not split over 16 x 16 threads");
  constexpr int RT = T / 16;   // chunk rows (and G columns) per thread
  constexpr int CP = PT / 16;  // P columns per thread
  constexpr int RN = N / 16;   // state rows per thread
  constexpr int LDN = N + 1;   // padded rows of B and C (column reads hit distinct banks)
  constexpr int LDG = T + 1;

  extern __shared__ float smem[];
  float* Us = smem;            // [T][PT]
  float* Bs = Us + T * PT;     // [T][LDN]
  float* Cs = Bs + T * LDN;    // [T][LDN]
  float* Gs = Cs + T * LDN;    // [T][LDG]
  float* Ss = Gs + T * LDG;    // [N][PT], the state
  float* la = Ss + N * PT;     // [T] cumulative log-decay in the chunk
  float* ein = la + T;         // [T] exp(la_i)
  float* eout = ein + T;       // [T] exp(la_T - la_j)

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const E* ub = u + b * a.u[0] + h * a.u[2];
  const float* lb = ld + b * a.l[0] + h * a.l[2];
  const E* bb = Bm + b * a.b[0] + h * a.b[2];
  const E* cb = Cm + b * a.c[0] + h * a.c[2];
  E* yb = y + b * a.y[0] + h * a.y[2];

  for (int idx = threadIdx.x; idx < N * PT; idx += NT) Ss[idx] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += T) {
    const int rows = a.S - c0 < T ? a.S - c0 : T;
    __syncthreads();  // the previous chunk is done with Us, Bs, Cs, Gs and the decays

    for (int idx = threadIdx.x; idx < T * PT; idx += NT) {
      const int t = idx / PT, p = idx % PT;
      Us[idx] = (t < rows && p0 + p < a.P)
                    ? to_f32(ub[(c0 + t) * a.u[1] + (p0 + p) * a.u[3]]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < T * N; idx += NT) {
      const int t = idx / N, n = idx % N;
      const bool in = t < rows;
      Bs[t * LDN + n] = in ? to_f32(bb[(c0 + t) * a.b[1] + n * a.b[3]]) : 0.f;
      Cs[t * LDN + n] = in ? to_f32(cb[(c0 + t) * a.c[1] + n * a.c[3]]) : 0.f;
    }
    if (threadIdx.x < 32) {  // warp 0: inclusive scan of ld, 32 steps per pass
      float carry = 0.f;
      for (int t0 = 0; t0 < T; t0 += 32) {
        const int t = t0 + threadIdx.x;
        float v = t < rows ? lb[(c0 + t) * a.l[1]] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, v, off);
          if ((int)threadIdx.x >= off) v += o;
        }
        v += carry;
        la[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    const float la_last = la[T - 1];  // = la of the last real step: padded steps add 0
    if (threadIdx.x < T) {
      ein[threadIdx.x] = expf(la[threadIdx.x]);
      eout[threadIdx.x] = expf(la_last - la[threadIdx.x]);
    }
    {  // G = (C B^T) o L, rows ty + 16 r, columns tx + 16 c
      float g[RT][RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c) g[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RT], bv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          cv[r] = Cs[(ty + 16 * r) * LDN + n];
          bv[r] = Bs[(tx + 16 * r) * LDN + n];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < RT; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c) {
          const int i = ty + 16 * r, j = tx + 16 * c;
          Gs[i * LDG + j] = j <= i ? g[r][c] * expf(la[i] - la[j]) : 0.f;  // mask, then exp
        }
    }
    __syncthreads();

    {  // y = exp(la_i) (C S_prev) + G U, rows ty + 16 r, columns tx + 16 c
      float acc[RT][CP];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RT], sv[CP];
#pragma unroll
        for (int r = 0; r < RT; ++r) cv[r] = Cs[(ty + 16 * r) * LDN + n];
#pragma unroll
        for (int c = 0; c < CP; ++c) sv[c] = Ss[n * PT + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float e = ein[ty + 16 * r];
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[r][c] *= e;
      }
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        float gv[RT], uv[CP];
#pragma unroll
        for (int r = 0; r < RT; ++r) gv[r] = Gs[(ty + 16 * r) * LDG + j];
#pragma unroll
        for (int c = 0; c < CP; ++c) uv[c] = Us[j * PT + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(gv[r], uv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ty + 16 * r;
        if (i >= rows) continue;
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int p = p0 + tx + 16 * c;
          if (p < a.P) store(yb + (c0 + i) * a.y[1] + p * a.y[3], acc[r][c]);
        }
      }
    }
    __syncthreads();  // every read of S_prev is done

    {  // S = exp(la_T) S + sum_j (exp(la_T - la_j) B_j)^T U_j; each thread owns its entries
      const float dtot = ein[T - 1];
      float s[RN][CP];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c) s[r][c] = Ss[(ty + 16 * r) * PT + tx + 16 * c] * dtot;
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        const float w = eout[j];
        float bv[RN], uv[CP];
#pragma unroll
        for (int r = 0; r < RN; ++r) bv[r] = Bs[j * LDN + ty + 16 * r] * w;
#pragma unroll
        for (int c = 0; c < CP; ++c) uv[c] = Us[j * PT + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c) s[r][c] = fmaf(bv[r], uv[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c) Ss[(ty + 16 * r) * PT + tx + 16 * c] = s[r][c];
    }
  }
  __syncthreads();

  float* sb = state + ((int64_t)b * a.H + h) * N * a.P;
  for (int idx = threadIdx.x; idx < N * PT; idx += NT) {
    const int n = idx / PT, p = idx % PT;
    if (p0 + p < a.P) sb[(int64_t)n * a.P + p0 + p] = Ss[idx];
  }
}

template <typename E, int T, int N>
int launch(const void* u, const float* ld, const void* B, const void* C, void* y, float* state,
           const Args& a, cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * smem_floats<T, N>();
  static_assert(smem <= 232448, "shared memory of one block exceeds 227 KB");
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ssd_fwd<E, T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)((a.P + PT - 1) / PT), (unsigned)a.H, (unsigned)a.Bt);
  ssd_fwd<E, T, N><<<grid, NT, smem, s>>>((const E*)u, ld, (const E*)B, (const E*)C, (E*)y,
                                          state, a);
  return (int)cudaGetLastError();
}

template <typename E, int T>
int launch_n(int N, const void* u, const float* ld, const void* B, const void* C, void* y,
             float* state, const Args& a, cudaStream_t s) {
  switch (N) {
    case 16: return launch<E, T, 16>(u, ld, B, C, y, state, a, s);  // the reduced configs
    case 64: return launch<E, T, 64>(u, ld, B, C, y, state, a, s);  // zamba2
    case 96: return launch<E, T, 96>(u, ld, B, C, y, state, a, s);  // xlstm's mLSTM
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
int launch_t(int chunk, int N, const void* u, const float* ld, const void* B, const void* C,
             void* y, float* state, const Args& a, cudaStream_t s) {
  switch (chunk) {
    case 32: return launch_n<E, 32>(N, u, ld, B, C, y, state, a, s);
    case 64: return launch_n<E, 64>(N, u, ld, B, C, y, state, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 operands on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int M_WARPS = PT / 16;  // a warp owns 16 columns of P
constexpr int M_NT = 32 * M_WARPS;
constexpr int S_TERMS = 2;  // bf16 terms of G, S_prev and U o decay (see the note at the top)

template <int T, int N>
struct SsdTile {
  static constexpr int LDU = PT + 8;  // padded rows: the 8 rows of an ldmatrix hit distinct banks
  static constexpr int LDN = N + 8;
  static constexpr int LDY = 16 + 8;  // a warp's staged y rows (bf16)
  static constexpr int LDG = T + 8;   // rows of G (bf16)
  static constexpr int LDS = 16 + 4;  // a warp's staged state rows (f32), at the end
  // one stage of the ring: U [T][LDU], B [T][LDN], C [T][LDN] (bf16), ld [T] (f32)
  static constexpr size_t stage = sizeof(bf16) * (size_t)T * (LDU + 2 * LDN) + sizeof(float) * T;
  static constexpr size_t ring = 2 * stage;
  // the ring, each warp's y rows [T][LDY], then G's split terms
  // [S_TERMS][T][LDG]; the state's staging [N][LDS] per warp takes the
  // ring's place after the last chunk
  static constexpr size_t gs = ring + sizeof(bf16) * M_WARPS * T * LDY;
  static constexpr size_t smem = gs + sizeof(bf16) * S_TERMS * T * LDG;
  static_assert(stage % 16 == 0 && ring % 16 == 0, "a stage must keep 16-byte alignment");
  static_assert(sizeof(float) * M_WARPS * N * LDS <= ring, "the state's staging exceeds the ring");
};

// A warp computes y^T (16 x T) and the state S^T (16 x N) of its 16
// columns, P first: S^T's f32 accumulators, split into bf16 terms, are
// then the A fragments of y^T = S^T C^T without leaving registers. G,
// the same for all four warps, is computed once per block (see the note
// at the top).
template <int T, int N>
__global__ void __launch_bounds__(M_NT)
    ssd_mma(const bf16* __restrict__ u, const float* __restrict__ ld, const bf16* __restrict__ Bm,
            const bf16* __restrict__ Cm, bf16* __restrict__ y, float* __restrict__ state, Args a) {
  using namespace mma;
  using L = SsdTile<T, N>;
  constexpr int LDU = L::LDU, LDN = L::LDN;
  constexpr int MT = T / 16;  // 16-step tiles of a chunk
  constexpr int TT = T / 8;   // 8-step tiles of a chunk
  constexpr int NN = N / 8;   // 8-wide tiles of N
  static_assert(T % 32 == 0 && N % 16 == 0, "tile does not split into k16 steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto Us = [&](int st) { return reinterpret_cast<bf16*>(smem_raw + st * L::stage); };
  auto Bs = [&](int st) { return Us(st) + T * LDU; };
  auto Cs = [&](int st) { return Us(st) + T * (LDU + LDN); };
  auto Ls = [&](int st) { return reinterpret_cast<float*>(Us(st) + T * (LDU + 2 * LDN)); };

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int pw = warp * 16;  // this warp's first column in the block's tile
  const LaneRC ar = a_rows(lane), ac = a_cols(lane), br = b_rows(lane), bc = b_cols(lane);
  bf16* ys = reinterpret_cast<bf16*>(smem_raw + L::ring) + warp * T * L::LDY;  // y rows, staged
  bf16* Gs = reinterpret_cast<bf16*>(smem_raw + L::gs);  // G's terms, [S_TERMS][T][LDG]
  const bf16* ub = u + b * a.u[0] + h * a.u[2];
  const float* lb = ld + b * a.l[0] + h * a.l[2];
  const bf16* bb = Bm + b * a.b[0] + h * a.b[2];
  const bf16* cb = Cm + b * a.c[0] + h * a.c[2];
  bf16* yb = y + b * a.y[0] + h * a.y[2];

  // chunk [c0, c0 + T) into stage st; steps past S are zeros (identity
  // steps: ld = 0, u = B = C = 0), so are columns past P
  auto load = [&](int c0, int st) {
    const int rows = a.S - c0 < T ? a.S - c0 : T;
    bf16 *us = Us(st), *bs = Bs(st), *cs = Cs(st);
    for (int idx = threadIdx.x; idx < T * (PT / 8); idx += M_NT) {
      const int t = idx / (PT / 8), p = p0 + (idx % (PT / 8)) * 8;
      const int n_in = t < rows ? min(8, max(0, a.P - p)) : 0;
      cp_async16(us + t * LDU + p - p0, n_in ? ub + (int64_t)(c0 + t) * a.u[1] + p : ub, 2 * n_in);
    }
    for (int idx = threadIdx.x; idx < T * (N / 8); idx += M_NT) {
      const int t = idx / (N / 8), n = (idx % (N / 8)) * 8;
      const bool in = t < rows;
      cp_async16(bs + t * LDN + n, in ? bb + (int64_t)(c0 + t) * a.b[1] + n : bb, in ? 16 : 0);
      cp_async16(cs + t * LDN + n, in ? cb + (int64_t)(c0 + t) * a.c[1] + n : cb, in ? 16 : 0);
    }
    if (threadIdx.x < T) {
      const int t = threadIdx.x;
      cp_async4(Ls(st) + t, t < rows ? lb + (int64_t)(c0 + t) * a.l[1] : lb, t < rows ? 4 : 0);
    }
  };

  // S^T of this warp's columns, f32, across all chunks: rows p = pw + g
  // (+ 8), columns n = 8j + 2tq (+ 1)
  float sT[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j) sT[j][0] = sT[j][1] = sT[j][2] = sT[j][3] = 0.f;

  const int nchunks = (a.S + T - 1) / T;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * T, st = c & 1, rows = a.S - c0 < T ? a.S - c0 : T;
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1's stage
    if (c + 1 < nchunks) {
      load(c0 + T, st ^ 1);  // in flight while this chunk computes
      cp_async_commit();
    }
    const bf16 *us = Us(st), *bs = Bs(st), *cs = Cs(st);

    // la = cumsum(ld) over the chunk, in every warp: lane t holds steps t and t + 32
    float la0 = Ls(st)[lane], la1 = T > 32 ? Ls(st)[32 + lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o0 = __shfl_up_sync(0xffffffffu, la0, off);
      const float o1 = __shfl_up_sync(0xffffffffu, la1, off);
      if (lane >= off) {
        la0 += o0;
        la1 += o1;
      }
    }
    la1 += __shfl_sync(0xffffffffu, la0, 31);
    const float la_T = __shfl_sync(0xffffffffu, T > 32 ? la1 : la0, 31);  // padded steps add 0
    // exp(la_t) and exp(la_T - la_t) of this lane's steps; any lane reads
    // step t's of x0/x1 with at(x0, x1, t) (every lane must call)
    const float ein0 = expf(la0), ein1 = expf(la1);
    const float eout0 = expf(la_T - la0), eout1 = expf(la_T - la1);
    auto at = [&](float x0, float x1, int t) {
      if (T == 32) return __shfl_sync(0xffffffffu, x0, t);
      const float v0 = __shfl_sync(0xffffffffu, x0, t & 31);
      const float v1 = __shfl_sync(0xffffffffu, x1, t & 31);
      return t < 32 ? v0 : v1;
    };
    auto la_at = [&](int t) { return at(la0, la1, t); };

    // U^T of the warp's columns, the A operand (m = p, k = t) of G U and
    // of the state update, one fragment per 16 steps
    uint32_t ua[MT][4];
#pragma unroll
    for (int kk = 0; kk < MT; ++kk)
      ldsm_x4_t(ua[kk], us + (kk * 16 + ac.r) * LDU + pw + ac.c);

    // G = (C B^T) o exp(la_i - la_j) for j <= i (masked before the exp),
    // once per block: its 16 x 16 blocks (s, kk) at or below the diagonal
    // dealt round the warps, stored as split bf16 terms [i][j]
#pragma unroll
    for (int s = 0, q = 0; s < MT; ++s)
#pragma unroll
      for (int kk = 0; kk <= s; ++kk, ++q) {
        if (q % M_WARPS != warp) continue;  // warp-uniform
        // C B^T, rows i = 16s + g (+ 8), columns j = 16kk + 8hf + 2tq (+ 1)
        float cbt[2][4] = {};
#pragma unroll
        for (int kn = 0; kn < N / 16; ++kn) {
          uint32_t ca[4], bf[4];
          ldsm_x4(ca, cs + (s * 16 + ar.r) * LDN + kn * 16 + ar.c);
          ldsm_x4(bf, bs + (kk * 16 + br.r) * LDN + kn * 16 + br.c);
          mma_bf16(cbt[0], ca, bf[0], bf[1]);
          mma_bf16(cbt[1], ca, bf[2], bf[3]);
        }
        const float la_i[2] = {la_at(s * 16 + g), la_at(s * 16 + 8 + g)};
        const float la_j[2][2] = {{la_at(kk * 16 + 2 * tq), la_at(kk * 16 + 2 * tq + 1)},
                                  {la_at(kk * 16 + 8 + 2 * tq), la_at(kk * 16 + 9 + 2 * tq)}};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = s * 16 + g + 8 * r, j = kk * 16 + hf * 8 + 2 * tq;
            const float d0 = j <= i ? la_i[r] - la_j[hf][0] : -INFINITY;
            const float d1 = j + 1 <= i ? la_i[r] - la_j[hf][1] : -INFINITY;
            const float g0 = cbt[hf][2 * r] * expf(d0), g1 = cbt[hf][2 * r + 1] * expf(d1);
            uint32_t gt[S_TERMS];
            split_bf16<S_TERMS>(g0, g1, gt);
#pragma unroll
            for (int k = 0; k < S_TERMS; ++k)
              *reinterpret_cast<uint32_t*>(Gs + (k * T + i) * L::LDG + j) = gt[k];
          }
      }

    // y^T = (S_prev^T C^T) diag(exp la), columns t; S^T split is the A
    // operand (while the other warps finish G)
    float yacc[TT][4];
#pragma unroll
    for (int m = 0; m < TT; ++m) yacc[m][0] = yacc[m][1] = yacc[m][2] = yacc[m][3] = 0.f;
    if (c > 0) {
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn) {
        uint32_t sa[4][S_TERMS];
        split_bf16<S_TERMS>(sT[2 * kn][0], sT[2 * kn][1], sa[0]);
        split_bf16<S_TERMS>(sT[2 * kn][2], sT[2 * kn][3], sa[1]);
        split_bf16<S_TERMS>(sT[2 * kn + 1][0], sT[2 * kn + 1][1], sa[2]);
        split_bf16<S_TERMS>(sT[2 * kn + 1][2], sT[2 * kn + 1][3], sa[3]);
#pragma unroll
        for (int m = 0; m < TT; m += 2) {
          uint32_t cf[4];  // C^T (k = n, n = t): b0, b1 of step tiles m and m + 1
          ldsm_x4(cf, cs + (m * 8 + br.r) * LDN + kn * 16 + br.c);
#pragma unroll
          for (int k = S_TERMS - 1; k >= 0; --k) {  // the small terms first
            const uint32_t af[4] = {sa[0][k], sa[1][k], sa[2][k], sa[3][k]};
            mma_bf16(yacc[m], af, cf[0], cf[1]);
            mma_bf16(yacc[m + 1], af, cf[2], cf[3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < TT; ++m) {
        const float e0 = at(ein0, ein1, m * 8 + 2 * tq), e1 = at(ein0, ein1, m * 8 + 2 * tq + 1);
        yacc[m][0] *= e0;
        yacc[m][1] *= e1;
        yacc[m][2] *= e0;
        yacc[m][3] *= e1;
      }
    }

    // y^T += U^T G^T: G^T's fragments (k = j, n = i) from G's rows
    __syncthreads();  // every warp's blocks of G are in
#pragma unroll
    for (int s = 0; s < MT; ++s)
#pragma unroll
      for (int kk = 0; kk <= s; ++kk)
#pragma unroll
        for (int k = S_TERMS - 1; k >= 0; --k) {  // the small terms first
          uint32_t gf[4];  // b0, b1 of row tiles 2s and 2s + 1
          ldsm_x4(gf, Gs + (k * T + s * 16 + br.r) * L::LDG + kk * 16 + br.c);
          mma_bf16(yacc[2 * s], ua[kk], gf[0], gf[1]);
          mma_bf16(yacc[2 * s + 1], ua[kk], gf[2], gf[3]);
        }
    // y: staged as rows t of the warp's 16 columns, then stored 16 bytes a lane
#pragma unroll
    for (int m = 0; m < TT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ys[(m * 8 + 2 * tq + (e & 1)) * L::LDY + g + 8 * (e >> 1)] =
            __float2bfloat16_rn(yacc[m][e]);
    __syncwarp();
#pragma unroll
    for (int idx = lane; idx < 2 * T; idx += 32) {
      const int t = idx / 2, p = p0 + pw + (idx % 2) * 8;
      if (t < rows && p < a.P)
        *reinterpret_cast<uint4*>(yb + (int64_t)(c0 + t) * a.y[1] + p) =
            *reinterpret_cast<const uint4*>(ys + t * L::LDY + (idx % 2) * 8);
    }

    // S^T = exp(la_T) S^T + (U o exp(la_T - la_t))^T B: the decay scales
    // the warp's U^T fragments (split in registers), and B's fragments
    // (k = t, n = n) come transposed from shared memory as they are
    const float dtot = expf(la_T);
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] *= dtot;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      const int t = kk * 16 + 2 * tq;
      const float w0 = at(eout0, eout1, t), w1 = at(eout0, eout1, t + 1);
      const float w8 = at(eout0, eout1, t + 8), w9 = at(eout0, eout1, t + 9);
      uint32_t ud[4][S_TERMS];  // a0, a1: steps t, t + 1; a2, a3: steps t + 8, t + 9
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack_bf16(ua[kk][r]);
        split_bf16<S_TERMS>(v.x * (r < 2 ? w0 : w8), v.y * (r < 2 ? w1 : w9), ud[r]);
      }
#pragma unroll
      for (int j = 0; j < NN; j += 2) {
        uint32_t bf[4];  // b0, b1 of state tiles j and j + 1
        ldsm_x4_t(bf, bs + (kk * 16 + bc.r) * LDN + j * 8 + bc.c);
#pragma unroll
        for (int k = S_TERMS - 1; k >= 0; --k) {
          const uint32_t af[4] = {ud[0][k], ud[1][k], ud[2][k], ud[3][k]};
          mma_bf16(sT[j], af, bf[0], bf[1]);
          mma_bf16(sT[j + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

  // the state: staged as rows n of the warp's 16 columns in the ring's
  // place, then stored 16 bytes a lane
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* ss = reinterpret_cast<float*>(smem_raw) + warp * N * L::LDS;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ss[(j * 8 + 2 * tq + (e & 1)) * L::LDS + g + 8 * (e >> 1)] = sT[j][e];
  __syncwarp();
  float* sb = state + ((int64_t)b * a.H + h) * N * a.P;
#pragma unroll
  for (int idx = lane; idx < 4 * N; idx += 32) {
    const int n = idx / 4, p = p0 + pw + (idx % 4) * 4;
    if (p < a.P)
      *reinterpret_cast<float4*>(sb + (int64_t)n * a.P + p) =
          *reinterpret_cast<const float4*>(ss + n * L::LDS + (idx % 4) * 4);
  }
}

template <int T, int N>
int launch_mma(const void* u, const float* ld, const void* B, const void* C, void* y, float* state,
               const Args& a, cudaStream_t s) {
  constexpr size_t smem = SsdTile<T, N>::smem;
  static_assert(smem <= 232448, "shared memory of one block exceeds 227 KB");
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ssd_mma<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    // all of the SM's 228 KB as shared memory, so that 4 blocks fit on an SM
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_mma<T, N>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)((a.P + PT - 1) / PT), (unsigned)a.H, (unsigned)a.Bt);
  ssd_mma<T, N><<<grid, M_NT, smem, s>>>((const bf16*)u, ld, (const bf16*)B, (const bf16*)C,
                                         (bf16*)y, state, a);
  return (int)cudaGetLastError();
}

template <int T>
int launch_mma_n(int N, const void* u, const float* ld, const void* B, const void* C, void* y,
                 float* state, const Args& a, cudaStream_t s) {
  switch (N) {
    case 16: return launch_mma<T, 16>(u, ld, B, C, y, state, a, s);
    case 64: return launch_mma<T, 64>(u, ld, B, C, y, state, a, s);
    case 96: return launch_mma<T, 96>(u, ld, B, C, y, state, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Strides are in elements, in the order of each tensor's dimensions:
// u and y (b, s, h, p), ld (b, s, h), B and C (b, s, h, n). variant: 0 = fma
// (f32 or bf16, any strides), 1 = mma (bf16; u, B, C with a unit inner
// stride, their other strides multiples of 8 and 16-byte aligned bases,
// P a multiple of 8, y contiguous: as the wrapper's plan checks).
int ssm_scan_launch(const void* u, const void* ld, const void* B, const void* C, void* y,
                    void* state, int Bt, int S, int H, int P, int N, long long usb,
                    long long uss, long long ush, long long usp, long long lsb, long long lss,
                    long long lsh, long long bsb, long long bss, long long bsh, long long bsn,
                    long long csb, long long css, long long csh, long long csn, long long ysb,
                    long long yss, long long ysh, long long ysp, int chunk, int dtype,
                    int variant, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || Bt > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{Bt, S, H, P, {usb, uss, ush, usp}, {lsb, lss, lsh}, {bsb, bss, bsh, bsn},
         {csb, css, csh, csn}, {ysb, yss, ysh, ysp}};
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)ld;
  float* st = (float*)state;
  if (variant == 1) {
    if (dtype != 1 || usp != 1 || bsn != 1 || csn != 1 || ysp != 1 || P % 8 != 0)
      return (int)cudaErrorInvalidValue;
    if (chunk == 32) return launch_mma_n<32>(N, u, l, B, C, y, st, a, s);
    if (chunk == 64) return launch_mma_n<64>(N, u, l, B, C, y, st, a, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_t<float>(chunk, N, u, l, B, C, y, st, a, s);
  if (dtype == 1) return launch_t<__nv_bfloat16>(chunk, N, u, l, B, C, y, st, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
