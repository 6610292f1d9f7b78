// Chunked SSD (Mamba2) scan for Hopper: y and the final state of the
// linear recurrence s_t = exp(ld_t) s_{t-1} + B_t u_t^T, y_t = s_t^T C_t.
//
// Replaces the Pallas TPU kernel _ssd_kernel / ssm_scan_pallas
// (src/repro/kernels/ssm_scan/kernel.py). There the grid was
// (Bt*H, S/T) with the chunk dimension sequential, and an f32 N x P state
// stayed in VMEM scratch from one grid step to the next. Here one thread
// block owns one (b, h, P-tile) row and walks its chunks in a loop; the
// N x PT state stays in shared memory for the whole loop and is written
// to device memory once, after the last chunk. Per chunk of T steps,
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
// would take under 1 us on the bf16 tensor cores, but this first version
// runs them in f32 on the CUDA cores (67 TFLOP/s peak: ~11 us), so
// arithmetic and shared-memory traffic bound it. The design keeps every
// intermediate (the T x T tile G, the state, the chunk's decays) in
// shared memory, reads each input element from device memory once per
// block, and gives each thread a register tile (2 x 4 at T = 32) so that
// each value read from shared memory feeds several FMAs. Not done yet:
// wgmma on bf16 tiles, TMA loads of the next chunk while this one
// computes.
//
// Tiling: P is cut into tiles of PT = 64 columns, one block each (y and
// the state of different columns are independent; G is recomputed per
// tile, T*T*N multiply-adds), so any P works. N and T are template
// parameters (N in 16, 64, 96; T in 32, 64); shared memory per
// block is T*PT + 2*T*(N+1) + T*(T+1) + N*PT + 3*T floats: 45.8 KB at
// T = 32, N = 64, so 4 blocks fit on an SM and zamba2's 320 blocks are
// all resident at once (83.5 KB and 2 per SM at T = 64). T = 32 also
// needs fewer operations (the T x T terms shrink); it is the default.
//
// Inputs are read through their strides in the model's layout: u, y
// (Bt, S, H, P), ld (Bt, S, H) in f32, B, C (Bt, S, H, N) with any head
// stride (0 when the model broadcasts one B, C over the heads). u, B, C
// are f32 or bf16, converted to f32 on load; all sums are f32; y is
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

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Strides are in elements, in the order of each tensor's dimensions:
// u and y (b, s, h, p), ld (b, s, h), B and C (b, s, h, n).
int ssm_scan_launch(const void* u, const void* ld, const void* B, const void* C, void* y,
                    void* state, int Bt, int S, int H, int P, int N, long long usb,
                    long long uss, long long ush, long long usp, long long lsb, long long lss,
                    long long lsh, long long bsb, long long bss, long long bsh, long long bsn,
                    long long csb, long long css, long long csh, long long csn, long long ysb,
                    long long yss, long long ysh, long long ysp, int chunk, int dtype,
                    void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || Bt > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{Bt, S, H, P, {usb, uss, ush, usp}, {lsb, lss, lsh}, {bsb, bss, bsh, bsn},
         {csb, css, csh, csn}, {ysb, yss, ysh, ysp}};
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)ld;
  float* st = (float*)state;
  if (dtype == 0) return launch_t<float>(chunk, N, u, l, B, C, y, st, a, s);
  if (dtype == 1) return launch_t<__nv_bfloat16>(chunk, N, u, l, B, C, y, st, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
