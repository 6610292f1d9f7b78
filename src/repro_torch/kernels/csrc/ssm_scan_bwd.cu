// Backward of the chunked SSD (Mamba2) scan for Hopper: du, d(ld), dB and
// dC of (y, state) = scan(u, ld, B, C), given dy and the gradient of the
// final state (or none: training drops the state).
//
// Replaces no TPU kernel: the JAX package differentiates its jnp twin of
// the forward, ssm_scan_chunked_jnp (src/repro/kernels/ssm_scan/ops.py:26),
// by autodiff, which on the card would be hundreds of small ops per Mamba2
// layer. This is the same gradient in closed form, chunked as the forward
// is (kernels/ssm_scan/ref.py::ssm_scan_bwd_ref is its plain version).
// Per (b, h) and chunk of T steps, with la = cumsum(ld) inside the chunk,
// L_ij = exp(la_i - la_j) for j <= i (masked before the exp: above the
// diagonal the exponent is positive and overflows), S_c the state
// entering the chunk (stored by the forward, ssm_scan.cu) and dS the
// gradient of the state leaving it:
//
//   du_j  = sum_i (C_i.B_j) L_ij dy_i + exp(la_T - la_j) dS^T B_j
//   dB_j  = sum_i L_ij (dy_i.u_j) C_i + exp(la_T - la_j) dS u_j
//   dC_i  = sum_j L_ij (dy_i.u_j) B_j + exp(la_i) S_c dy_i
//   dS   <- exp(la_T) dS + sum_i exp(la_i) C_i dy_i^T   (then chunk c - 1)
//   d(la): +a_ij at i, -a_ij at j (a_ij = (C_i.B_j)(dy_i.u_j) L_ij);
//          exp(la_i) C_i.(S_c dy_i) at i; f_j = exp(la_T - la_j) B_j.(dS u_j)
//          at la_T and -f_j at j; exp(la_T) <dS, S_c> at la_T;
//   dld   = the reverse cumsum of d(la) inside the chunk.
//
// Two variants, picked per call by the wrapper's plan (ops.py), both one
// block per (b, h, 64-column P tile) walking the chunks in reverse with the
// block's N x 64 columns of dS on chip; the columns of dS, du and S are
// independent, so a P tile needs nothing from another. dB, dC and d(ld) sum
// over all of P: each tile writes its share, and the wrapper adds the tiles
// in a fixed order. No atomics: two calls give the same bits.
//
// What bounds it on an H100: at zamba2's training shape (Bt 8, S 512, H 80,
// P = N = 64, T 32, bf16, B and C shared by the heads) a call reads u, dy
// (42 MB each), ld, B, C and the forward's states (168 MB f32) and writes
// du (42 MB), dld and dB, dC: 0.089 ms at 3.35 TB/s counting each byte
// once, B and C and their gradients once per step. Its 1.36e10 operations
// take 0.2 ms on the f32 CUDA cores, 0.014 ms on the bf16 tensor cores.
//
// mma (bf16 u, dy, B, C with unit inner stride and 16-byte aligned rows, P
// a multiple of 8: zamba2's training path). 8 warps in two roles, each
// role with its own loop over the chunks, meeting at two block barriers per
// chunk (barrier.sync, which the two loops may reach at different places):
//   - column warps (4), each owning 16 of the tile's columns: dS^T (16 x N)
//     in f32 accumulator fragments across all chunks, as the forward's mma
//     keeps S^T; du^T = dS^T B^T diag(exp(la_T - la)) + dy^T G; dS's split
//     terms into shared memory; dS^T = exp(la_T) dS^T + (dy o exp(la))^T C
//     (the warp's dy^T fragments scaled and split in registers); then dB^T
//     = (dS u^T) diag(exp(la_T - la)) + C^T A by 16-row tile of N;
//   - row warps (4): G = (C B^T) o L and A = (dy u^T) o L on the 16 x 16
//     blocks at or below the diagonal (masked before the exp), stored as
//     split terms, with the row and column sums of a = G o (dy u^T); the
//     reverse scan of the chunk after's d(la) into d(ld) (shuffles); then
//     dC^T = (S_c dy^T) diag(exp(la)) + B^T A^T and <dS, S_c> by tile, S_c
//     read from device memory a chunk ahead into registers.
// Every product is mma.sync.m16n8k16 (bf16 in, f32 out) on ldmatrix
// fragments, rows padded by 16 bytes (no bank conflicts). u, dy, B, C are
// exact in bf16; the operands the reference holds in f32 (G, A, dS, S_c
// and dy o exp(la)) are split into two bf16 terms each (16 of f32's 24
// bits), each product taking both into one f32 accumulator: with Mamba2's
// light decays one term of any of the five misses the gate
// (tests/test_torch_ssm_bwd_plan.py). u, dy, B, C and ld arrive through a
// two-stage cp.async ring, the chunk before in flight while this one
// computes; every warp scans ld itself. Exps are exp2f of log2 e-scaled
// arguments. 128 registers a thread, 2 blocks (16 warps) on an SM.
//
// With B and C shared by the heads (head stride 0), a thread-block cluster
// of up to 8 blocks along the heads (cl) sums its heads' dB and dC on chip:
// each warp puts its tile's f32 slice (16 columns, T rows) in shared memory
// and sends it with a bulk asynchronous copy (cp.async.bulk, the copy
// engine) into the shared memory of the rank that owns the slice, whose
// mbarrier counts the bytes; the owner adds the heads in rank order during
// the next chunk's first phase and writes the group's rows. A cluster
// barrier per chunk keeps a slice from landing before the last one was
// read. So a call writes one f32 partial per group of 8 heads (10 at
// zamba2's 80 heads: 21 MB, against 168 MB per head) and the wrapper adds
// the groups. Where a cluster's slices do not fit in shared memory (T 64,
// N 96) the wrapper asks for cl = 1 (ssm_scan_bwd_max_group).
//
// Chosen on the card (tools/ssm_bwd_variants.py times the choices that are
// edits of this source; PERF.md): two roles of 4 warps over one role of 4
// warps doing everything (which needs 255 registers, so 8 warps on an SM);
// the slices pushed by the copy engine over each rank reading them through
// distributed shared memory, and over scalar remote stores; the cluster
// wait just before the sends, not at the start of the second phase; S_c a
// chunk ahead, not at the start of its own chunk.
//
// fma (f32 operands, and any layout mma cannot take; heads summed by the
// wrapper): 256 threads as a 16 x 16 grid each holding a register tile of
// every product (f32 FMAs on the CUDA cores), dS in shared memory: C B^T
// and dy u^T (T x T, masked and scaled by L), then du, dB and dC, then the
// update of dS and d(la); four block barriers. Rows of 64 + 1 and N + 1
// floats keep every column read on distinct banks. Shared memory: 2 T
// (PT+1) + 2 T (N+1) + 2 N (PT+1) + 2 T (T+1) + 7 T + 16 T + 8 floats.
//
// N and T are template parameters (N in 16, 32, 64, 96; T in 32, 64); any
// P (the last tile is ragged) and any S (a ragged last chunk: steps past S
// are identity steps, ld = 0, u = B = C = dy = 0).
//
// Inputs are read through their strides in the model's layout: u, dy
// (Bt, S, H, P) and B, C (Bt, S, H, N) in f32 or bf16 (B, C with any head
// stride, 0 when shared by the heads), ld (Bt, S, H) f32, the states
// (Bt, H, n_chunks, N, P) and d_state (Bt, H, N, P) f32 contiguous. du is
// written contiguous in u's type; dld (n_ptiles, Bt, S, H) in f32; dB and
// dC in f32, per head (n_ptiles, Bt, S, H, N), or summed over each cluster
// (n_ptiles, H / cl, Bt, S, N).
//
// C interface (loaded with ctypes): ssm_scan_bwd_launch returns the CUDA
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

// The sum over the 16 lanes of a half-warp (the tx of one ty), the same
// order on every call. Every lane of the warp must call it.
__device__ __forceinline__ float sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

struct Args {
  int Bt, S, H, P;
  int64_t u[4], l[3], b[4], c[4], dy[4];  // element strides
};

template <int T, int N>
struct BwdTile {
  static constexpr int LDP = PT + 1, LDN = N + 1, LDT = T + 1;
  static constexpr size_t floats = 2 * (size_t)T * LDP + 2 * (size_t)T * LDN +
                                   2 * (size_t)N * LDP + 2 * (size_t)T * LDT + 7 * T + 16 * T + 8;
};

template <typename E, int T, int N>
__global__ void __launch_bounds__(NT)
    ssd_bwd(const E* __restrict__ u, const float* __restrict__ ld, const E* __restrict__ Bm,
            const E* __restrict__ Cm, const E* __restrict__ dy, const float* __restrict__ states,
            const float* __restrict__ dstate, E* __restrict__ du, float* __restrict__ dld,
            float* __restrict__ dB, float* __restrict__ dC, Args a) {
  static_assert(T % 16 == 0 && T <= NT && N % 16 == 0, "tile does not split over 16 x 16 threads");
  using L = BwdTile<T, N>;
  constexpr int LDP = L::LDP, LDN = L::LDN, LDT = L::LDT;
  constexpr int RT = T / 16;   // chunk rows per thread
  constexpr int CP = PT / 16;  // P columns per thread
  constexpr int RN = N / 16;   // state rows (or columns) per thread

  extern __shared__ float smem[];
  float* Us = smem;             // [T][LDP] u
  float* Ys = Us + T * LDP;     // [T][LDP] dy
  float* Bs = Ys + T * LDP;     // [T][LDN]
  float* Cs = Bs + T * LDN;     // [T][LDN]
  float* Ss = Cs + T * LDN;     // [N][LDP] the state entering the chunk
  float* dSs = Ss + N * LDP;    // [N][LDP] the gradient of the state leaving it
  float* Gm = dSs + N * LDP;    // [T][LDT] (C B^T) o L
  float* Am = Gm + T * LDT;     // [T][LDT] (dy u^T) o L
  float* la = Am + T * LDT;     // [T] cumulative log-decay in the chunk
  float* ein = la + T;          // [T] exp(la_i)
  float* eout = ein + T;        // [T] exp(la_T - la_j)
  float* rsum = eout + T;       // [T] sum_j a_ij
  float* eI = rsum + T;         // [T] exp(la_i) C_i.(S_c dy_i)
  float* fJ = eI + T;           // [T] f_j
  float* dla = fJ + T;          // [T]
  float* cpart = dla + T;       // [16][T] column sums of a, by ty
  float* red = cpart + 16 * T;  // [8] <dS, S_c> by warp

  const int pt = blockIdx.x, p0 = pt * PT, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nchunks = (a.S + T - 1) / T;
  const E* ub = u + b * a.u[0] + h * a.u[2];
  const float* lb = ld + b * a.l[0] + h * a.l[2];
  const E* bb = Bm + b * a.b[0] + h * a.b[2];
  const E* cb = Cm + b * a.c[0] + h * a.c[2];
  const E* yb = dy + b * a.dy[0] + h * a.dy[2];
  const float* sb = states + ((int64_t)b * a.H + h) * nchunks * N * a.P;
  // outputs: du (Bt, S, H, P); dld (tiles, Bt, S, H); dB, dC (tiles, Bt, S, H, N)
  const int64_t row0 = ((int64_t)pt * a.Bt + b) * a.S;  // (tile, b, step 0) of the f32 outputs

  for (int idx = threadIdx.x; idx < N * PT; idx += NT) {
    const int n = idx / PT, p = idx % PT;
    dSs[n * LDP + p] = (dstate && p0 + p < a.P)
                           ? dstate[(((int64_t)b * a.H + h) * N + n) * a.P + p0 + p] : 0.f;
  }

  for (int c = nchunks - 1; c >= 0; --c) {
    const int c0 = c * T, rows = a.S - c0 < T ? a.S - c0 : T;
    __syncthreads();  // the chunk after is done with every buffer; dS is its update

    for (int idx = threadIdx.x; idx < T * PT; idx += NT) {
      const int t = idx / PT, p = idx % PT;
      const bool in = t < rows && p0 + p < a.P;
      Us[t * LDP + p] = in ? to_f32(ub[(c0 + t) * a.u[1] + (p0 + p) * a.u[3]]) : 0.f;
      Ys[t * LDP + p] = in ? to_f32(yb[(c0 + t) * a.dy[1] + (p0 + p) * a.dy[3]]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < T * N; idx += NT) {
      const int t = idx / N, n = idx % N;
      const bool in = t < rows;
      Bs[t * LDN + n] = in ? to_f32(bb[(c0 + t) * a.b[1] + n * a.b[3]]) : 0.f;
      Cs[t * LDN + n] = in ? to_f32(cb[(c0 + t) * a.c[1] + n * a.c[3]]) : 0.f;
    }
    {
      const float* sc = sb + (int64_t)c * N * a.P;
      for (int idx = threadIdx.x; idx < N * PT; idx += NT) {
        const int n = idx / PT, p = idx % PT;
        Ss[n * LDP + p] = p0 + p < a.P ? sc[(int64_t)n * a.P + p0 + p] : 0.f;
      }
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

    // (1) C B^T and dy u^T on rows i = ty + 16 r, columns j = tx + 16 c;
    // G = (C B^T) o L, A = (dy u^T) o L and a = (C B^T)(dy u^T) o L, with
    // a's row sums (over the half-warp) and column partials (by ty)
    {
      const float la_last = la[T - 1];  // = la of the last real step: padded steps add 0
      if (threadIdx.x < T) {
        ein[threadIdx.x] = expf(la[threadIdx.x]);
        eout[threadIdx.x] = expf(la_last - la[threadIdx.x]);
      }
      float cbt[RT][RT], dyu[RT][RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < RT; ++q) cbt[r][q] = dyu[r][q] = 0.f;
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
          for (int q = 0; q < RT; ++q) cbt[r][q] = fmaf(cv[r], bv[q], cbt[r][q]);
      }
#pragma unroll 4
      for (int p = 0; p < PT; ++p) {
        float yv[RT], uv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          yv[r] = Ys[(ty + 16 * r) * LDP + p];
          uv[r] = Us[(tx + 16 * r) * LDP + p];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < RT; ++q) dyu[r][q] = fmaf(yv[r], uv[q], dyu[r][q]);
      }
      float colsum[RT];
#pragma unroll
      for (int q = 0; q < RT; ++q) colsum[q] = 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ty + 16 * r;
        float rs = 0.f;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          const int j = tx + 16 * q;
          const float l = j <= i ? expf(la[i] - la[j]) : 0.f;  // mask, then exp
          const float g = cbt[r][q] * l;
          Gm[i * LDT + j] = g;
          Am[i * LDT + j] = dyu[r][q] * l;
          const float av = g * dyu[r][q];
          rs += av;
          colsum[q] += av;
        }
        rs = sum16(rs);
        if (tx == 0) rsum[i] = rs;
      }
#pragma unroll
      for (int q = 0; q < RT; ++q) cpart[ty * T + tx + 16 * q] = colsum[q];
    }
    __syncthreads();

    // (2) du on rows j = ty + 16 r, columns p = tx + 16 q
    {
      float acc[RT][CP];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float bv[RT], sv[CP];
#pragma unroll
        for (int r = 0; r < RT; ++r) bv[r] = Bs[(ty + 16 * r) * LDN + n];
#pragma unroll
        for (int q = 0; q < CP; ++q) sv[q] = dSs[n * LDP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[r][q] = fmaf(bv[r], sv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float e = eout[ty + 16 * r];
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] *= e;
      }
#pragma unroll 4
      for (int i = 0; i < T; ++i) {
        float gv[RT], yv[CP];
#pragma unroll
        for (int r = 0; r < RT; ++r) gv[r] = Gm[i * LDT + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < CP; ++q) yv[q] = Ys[i * LDP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[r][q] = fmaf(gv[r], yv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int j = ty + 16 * r;
        if (j >= rows) continue;
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int p = p0 + tx + 16 * q;
          if (p < a.P) store(du + (((int64_t)b * a.S + c0 + j) * a.H + h) * a.P + p, acc[r][q]);
        }
      }
    }

    // (3) dB on rows j = ty + 16 r, columns n = tx + 16 q, and f_j
    {
      float acc[RT][RN], x[RT][RN];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[r][q] = x[r][q] = 0.f;
#pragma unroll 4
      for (int p = 0; p < PT; ++p) {
        float uv[RT], sv[RN];
#pragma unroll
        for (int r = 0; r < RT; ++r) uv[r] = Us[(ty + 16 * r) * LDP + p];
#pragma unroll
        for (int q = 0; q < RN; ++q) sv[q] = dSs[(tx + 16 * q) * LDP + p];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) x[r][q] = fmaf(uv[r], sv[q], x[r][q]);
      }
#pragma unroll 4
      for (int i = 0; i < T; ++i) {
        float av[RT], cv[RN];
#pragma unroll
        for (int r = 0; r < RT; ++r) av[r] = Am[i * LDT + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < RN; ++q) cv[q] = Cs[i * LDN + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(av[r], cv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int j = ty + 16 * r;
        const float e = eout[j];
        float f = 0.f;
        float* out = dB + ((row0 + c0 + j) * a.H + h) * N;
#pragma unroll
        for (int q = 0; q < RN; ++q) {
          const int n = tx + 16 * q;
          const float xv = e * x[r][q];
          f = fmaf(Bs[j * LDN + n], xv, f);
          if (j < rows) out[n] = acc[r][q] + xv;
        }
        f = sum16(f);
        if (tx == 0) fJ[j] = f;
      }
    }

    // (4) dC on rows i = ty + 16 r, columns n = tx + 16 q, and
    // exp(la_i) C_i.(S_c dy_i)
    {
      float acc[RT][RN], x[RT][RN];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[r][q] = x[r][q] = 0.f;
#pragma unroll 4
      for (int p = 0; p < PT; ++p) {
        float yv[RT], sv[RN];
#pragma unroll
        for (int r = 0; r < RT; ++r) yv[r] = Ys[(ty + 16 * r) * LDP + p];
#pragma unroll
        for (int q = 0; q < RN; ++q) sv[q] = Ss[(tx + 16 * q) * LDP + p];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) x[r][q] = fmaf(yv[r], sv[q], x[r][q]);
      }
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        float av[RT], bv[RN];
#pragma unroll
        for (int r = 0; r < RT; ++r) av[r] = Am[(ty + 16 * r) * LDT + j];
#pragma unroll
        for (int q = 0; q < RN; ++q) bv[q] = Bs[j * LDN + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ty + 16 * r;
        const float e = ein[i];
        float s = 0.f;
        float* out = dC + ((row0 + c0 + i) * a.H + h) * N;
#pragma unroll
        for (int q = 0; q < RN; ++q) {
          const int n = tx + 16 * q;
          const float xv = e * x[r][q];
          s = fmaf(Cs[i * LDN + n], xv, s);
          if (i < rows) out[n] = acc[r][q] + xv;
        }
        s = sum16(s);
        if (tx == 0) eI[i] = s;
      }
    }

    {  // <dS, S_c> over the tile: by thread, then by warp
      float s = 0.f;
      for (int idx = threadIdx.x; idx < N * PT; idx += NT) {
        const int k = (idx / PT) * LDP + idx % PT;
        s = fmaf(dSs[k], Ss[k], s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
    }
    __syncthreads();  // every read of dS (the chunk after's) is done

    // (5) dS = exp(la_T) dS + sum_i exp(la_i) C_i dy_i^T on rows n = ty + 16 r,
    // columns p = tx + 16 q; and d(la)
    {
      const float dtot = ein[T - 1];
      float s[RN][CP];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) s[r][q] = dSs[(ty + 16 * r) * LDP + tx + 16 * q] * dtot;
#pragma unroll 4
      for (int i = 0; i < T; ++i) {
        const float e = ein[i];
        float cv[RN], yv[CP];
#pragma unroll
        for (int r = 0; r < RN; ++r) cv[r] = Cs[i * LDN + ty + 16 * r] * e;
#pragma unroll
        for (int q = 0; q < CP; ++q) yv[q] = Ys[i * LDP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) s[r][q] = fmaf(cv[r], yv[q], s[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) dSs[(ty + 16 * r) * LDP + tx + 16 * q] = s[r][q];
    }
    if (threadIdx.x < T) {
      const int t = threadIdx.x;
      float cs = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) cs += cpart[k * T + t];
      float v = rsum[t] - cs + eI[t] - fJ[t];
      if (t == T - 1) {
        float fs = 0.f, ds = 0.f;
        for (int k = 0; k < T; ++k) fs += fJ[k];
        for (int w = 0; w < NT / 32; ++w) ds += red[w];
        v += fs + ein[T - 1] * ds;
      }
      dla[t] = v;
    }
    __syncthreads();

    if (threadIdx.x < rows) {  // dld_t = sum of d(la) over steps t..T-1 of the chunk
      const int t = threadIdx.x;
      float v = 0.f;
      for (int m = T - 1; m >= t; --m) v += dla[m];
      dld[(row0 + c0 + t) * a.H + h] = v;
    }
  }
}

template <typename E, int T, int N>
int launch(const void* u, const float* ld, const void* B, const void* C, const void* dy,
           const float* states, const float* dstate, void* du, float* dld, float* dB, float* dC,
           const Args& a, cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * BwdTile<T, N>::floats;
  static_assert(smem <= 232448, "shared memory of one block exceeds 227 KB");
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd<E, T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)((a.P + PT - 1) / PT), (unsigned)a.H, (unsigned)a.Bt);
  ssd_bwd<E, T, N><<<grid, NT, smem, s>>>((const E*)u, ld, (const E*)B, (const E*)C,
                                          (const E*)dy, states, dstate, (E*)du, dld, dB, dC, a);
  return (int)cudaGetLastError();
}

template <typename E, int T>
int launch_n(int N, const void* u, const float* ld, const void* B, const void* C, const void* dy,
             const float* states, const float* dstate, void* du, float* dld, float* dB, float* dC,
             const Args& a, cudaStream_t s) {
  switch (N) {
    case 16: return launch<E, T, 16>(u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, s);
    case 32: return launch<E, T, 32>(u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, s);
    case 64: return launch<E, T, 64>(u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, s);
    case 96: return launch<E, T, 96>(u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
int launch_t(int chunk, int N, const void* u, const float* ld, const void* B, const void* C,
             const void* dy, const float* states, const float* dstate, void* du, float* dld,
             float* dB, float* dC, const Args& a, cudaStream_t s) {
  switch (chunk) {
    case 32: return launch_n<E, 32>(N, u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, s);
    case 64: return launch_n<E, 64>(N, u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 operands on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int C_WARPS = PT / 16;  // column warps: each owns 16 columns of P (of dS, du); dB
constexpr int R_WARPS = 4;        // row warps: G and A, dC, the heads' sums, d(ld)
constexpr int M_NT = 32 * (C_WARPS + R_WARPS);
constexpr int B_TERMS = 2;  // bf16 terms of G, A, dS, S_c and dy o exp(la) (see the note at the top)
constexpr float LOG2E = 1.4426950408889634f;

// exp(x) as exp2(x log2 e): MUFU.EX2 and one multiply; relative error
// about |x| 2**-24 more than expf's, below the split terms' 2**-16
__device__ __forceinline__ float fexp(float x) { return exp2f(x * LOG2E); }

// A barrier of the block's threads that they may reach at different places
// in the code (the two roles' loops), each warp converged.
__device__ __forceinline__ void block_sync() { asm volatile("barrier.sync 0;\n" ::: "memory"); }

// la = cumsum(ld) of a chunk as a warp holds it (lane t: steps t, t + 32),
// exp(la), exp(la_T - la) the same, and exp(la_T)
struct Decay {
  float la0, la1, ein0, ein1, eout0, eout1, dtot;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// `local`'s offset in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* local, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(mma::smem_u32(local)),
               "r"(rank));
  return remote;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mma::smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the one arrival of the barrier's phase, which also expects `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mma::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the phase of the given parity to complete; a copy that never
// lands traps (after ~seconds) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mma::smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}
// copy `bytes` of this block's shared memory into the cluster's shared
// memory at `dst` (mapped), completing on the barrier at `bar` (mapped)
__device__ __forceinline__ void bulk_to_cluster(uint32_t dst, const void* src, unsigned bytes,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(mma::smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk copies have read their sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's shared-memory writes, seen by the copy engine
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr size_t kMaxSmem = 232448;  // the dynamic shared memory one block may have

template <int T, int N>
struct BwdMmaTile {
  static constexpr int LDU = PT + 8;  // padded bf16 rows: the 8 rows of an ldmatrix hit distinct banks
  static constexpr int LDN = N + 8;
  static constexpr int LDG = T + 8;
  static constexpr int LDS = 16 + 4;  // f32 rows of a 16-column slice of dB or dC (rows 2 apart on
                                      // distinct banks)
  static constexpr int MT = T / 16, NTILE = N / 16;
  // per parity: the row and column sums of a by 16-step block [MT][T] each, f_j and
  // exp(la_i) C_i.(S_c dy_i) by 16-row tile of N [NTILE][T] each, <dS, S_c> by tile, exp(la_T)
  static constexpr int SUMS = 2 * MT * T + 2 * NTILE * T + NTILE + 1;
  // one stage of the ring: u, dy [T][LDU], B, C [T][LDN] (bf16), ld [T] (f32)
  static constexpr size_t stage = sizeof(bf16) * (size_t)T * (2 * LDU + 2 * LDN) + sizeof(float) * T;
  static constexpr size_t ga = 2 * stage;                                 // G, A terms [2][TERMS][T][LDG]
  static constexpr size_t ds = ga + sizeof(bf16) * 2 * B_TERMS * T * LDG;  // dS terms [TERMS][PT][LDN]
  static constexpr size_t sums = ds + sizeof(bf16) * B_TERMS * PT * LDN;  // [2][SUMS] f32
  static constexpr size_t bar = (sums + sizeof(float) * 2 * SUMS + 15) / 16 * 16;  // the heads' mbarrier
  static constexpr size_t smem = bar + 16;  // per head (a cluster of 1)
  // a cluster's sum of its heads: this head's dB, dC as 16-column slices
  // [2 NTILE][T][LDS], and the slices that come to this block to be summed,
  // [slot][head's rank][T][LDS], at most 2 NTILE rounded up to 8 in all
  static constexpr int SLICES = 2 * NTILE, RECV = (SLICES + 7) / 8 * 8;
  static constexpr size_t slice = sizeof(float) * (size_t)T * LDS;
  static constexpr size_t part = smem, recv = part + SLICES * slice;
  static constexpr size_t smem_heads = recv + RECV * slice;
  static_assert(stage % 16 == 0 && ga % 16 == 0 && ds % 16 == 0 && slice % 16 == 0,
                "a region must keep 16-byte alignment");
};

// One block per (b, h, 64-column P tile), walking the chunks in reverse,
// its warps in two roles, each with its own loop; a cluster of `cl` blocks
// along the heads (B and C shared by them) sums its heads' dB and dC on
// chip. See the note at the top.
template <int T, int N>
__global__ void __launch_bounds__(M_NT, 2)
    ssd_bwd_mma(const bf16* __restrict__ u, const float* __restrict__ ld,
                const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                const bf16* __restrict__ dy, const float* __restrict__ states,
                const float* __restrict__ dstate, bf16* __restrict__ du, float* __restrict__ dld,
                float* __restrict__ dB, float* __restrict__ dC, Args a, int cl) {
  using namespace mma;
  using L = BwdMmaTile<T, N>;
  constexpr int LDU = L::LDU, LDN = L::LDN, LDG = L::LDG, LDS = L::LDS, SUMS = L::SUMS;
  constexpr int MT = L::MT, NTILE = L::NTILE;
  constexpr int TT = T / 8;   // 8-step tiles of a chunk
  constexpr int NN = N / 8;   // 8-wide tiles of N
  constexpr int KP = PT / 16; // 16-column steps of the P tile
  static_assert(T % 32 == 0 && N % 16 == 0, "tile does not split into k16 steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto Us = [&](int st) { return reinterpret_cast<bf16*>(smem_raw + st * L::stage); };
  auto Ys = [&](int st) { return Us(st) + T * LDU; };
  auto Bs = [&](int st) { return Us(st) + 2 * T * LDU; };
  auto Cs = [&](int st) { return Us(st) + 2 * T * LDU + T * LDN; };
  auto Ls = [&](int st) { return reinterpret_cast<float*>(Us(st) + 2 * T * (LDU + LDN)); };
  bf16* Gs = reinterpret_cast<bf16*>(smem_raw + L::ga);  // G's terms [TERMS][T][LDG], [i][j]
  bf16* As = Gs + B_TERMS * T * LDG;                     // A's terms, the same
  bf16* Ds = reinterpret_cast<bf16*>(smem_raw + L::ds);  // dS's terms [TERMS][PT][LDN], [p][n]
  float* sums = reinterpret_cast<float*>(smem_raw + L::sums);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L::bar);
  float* part = reinterpret_cast<float*>(smem_raw + L::part);  // with cl > 1 only
  float* recv = reinterpret_cast<float*>(smem_raw + L::recv);

  const int pt = blockIdx.x, p0 = pt * PT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const bool col = warp < C_WARPS;  // warp-uniform: a column warp, else a row warp
  const int rw = warp - C_WARPS;    // a row warp's index
  const int pw = warp * 16;         // a column warp's first column of dS and du
  const LaneRC ar = a_rows(lane), ac = a_cols(lane), br = b_rows(lane), bc = b_cols(lane);
  const int nchunks = (a.S + T - 1) / T;
  const int groups = a.H / cl, grp = h / cl;
  const unsigned rank = cl > 1 ? cluster_rank() : 0u;
  const bf16* ub = u + b * a.u[0] + h * a.u[2];
  const bf16* yb = dy + b * a.dy[0] + h * a.dy[2];
  const float* lb = ld + b * a.l[0] + h * a.l[2];
  const bf16* bb = Bm + b * a.b[0] + h * a.b[2];
  const bf16* cb = Cm + b * a.c[0] + h * a.c[2];
  const float* sb = states + ((int64_t)b * a.H + h) * nchunks * N * a.P;
  // outputs: du (Bt, S, H, P); dld (tiles, Bt, S, H); dB, dC (below)
  const int64_t row0 = ((int64_t)pt * a.Bt + b) * a.S;  // (tile, b, step 0) of the f32 outputs

  // chunk [c0, c0 + T) into stage st; steps past S are zeros (identity
  // steps), so are columns past P
  auto load = [&](int c0, int st) {
    const int rows = a.S - c0 < T ? a.S - c0 : T;
    bf16 *us = Us(st), *ys = Ys(st), *bs = Bs(st), *cs = Cs(st);
    for (int idx = threadIdx.x; idx < T * (PT / 8); idx += M_NT) {
      const int t = idx / (PT / 8), p = p0 + (idx % (PT / 8)) * 8;
      const bool in = t < rows && p < a.P;  // P is a multiple of 8
      cp_async16(us + t * LDU + p - p0, in ? ub + (int64_t)(c0 + t) * a.u[1] + p : ub, in ? 16 : 0);
      cp_async16(ys + t * LDU + p - p0, in ? yb + (int64_t)(c0 + t) * a.dy[1] + p : yb, in ? 16 : 0);
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

  // S_c's rows 16 mt .. 16 mt + 15 as A fragments (m = n, k = p), one per
  // 16 columns: a0 (n, p p+1), a1 (n + 8, ...), a2 (n, p + 8 ..), a3 (n + 8, p + 8 ..)
  auto load_sc = [&](int c, int mt, float2 (&scv)[KP][4]) {
    const float* sc = sb + (int64_t)c * N * a.P;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = mt * 16 + g + 8 * (r & 1), p = p0 + kp * 16 + 2 * tq + 8 * (r >> 1);
        scv[kp][r] = p < a.P ? *reinterpret_cast<const float2*>(sc + (int64_t)n * a.P + p)
                             : make_float2(0.f, 0.f);
      }
  };

  // d(ld) of chunk cc from its sums (the first row warp, after the next
  // chunk's first barrier): d(la) per step, then its reverse cumsum inside
  // the chunk
  auto finish_dld = [&](int cc) {
    const float* sm = sums + (cc & 1) * SUMS;
    const float *rpart = sm, *cpart = sm + MT * T, *fpart = sm + 2 * MT * T;
    const float *epart = fpart + NTILE * T, *dpart = epart + NTILE * T;
    const int c0 = cc * T, rows = a.S - c0 < T ? a.S - c0 : T;
    float v[T / 32], fs = 0.f;
#pragma unroll
    for (int q = 0; q < T / 32; ++q) {
      const int t = lane + 32 * q;
      float x = 0.f;
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        if (k <= t / 16) x += rpart[k * T + t];  // row sums of a: blocks left of the diagonal
        if (k >= t / 16) x -= cpart[k * T + t];  // column sums: blocks below it
      }
#pragma unroll
      for (int mt = 0; mt < NTILE; ++mt) {
        x += epart[mt * T + t] - fpart[mt * T + t];
        fs += fpart[mt * T + t];
      }
      v[q] = x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) fs += __shfl_xor_sync(0xffffffffu, fs, off);
    float dot = 0.f;
#pragma unroll
    for (int mt = 0; mt < NTILE; ++mt) dot += dpart[mt];
    if (lane == 31) v[T / 32 - 1] += fs + sm[SUMS - 1] * dot;  // at la_T
#pragma unroll
    for (int q = 0; q < T / 32; ++q)
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, v[q], off);
        if (lane + off < 32) v[q] += o;
      }
    if (T == 64) v[0] += __shfl_sync(0xffffffffu, v[T / 32 - 1], 0);
#pragma unroll
    for (int q = 0; q < T / 32; ++q) {
      const int t = lane + 32 * q;
      if (t < rows) dld[(row0 + c0 + t) * a.H + h] = v[q];
    }
  };

  // dB and dC: a cluster's sums of its heads, (tiles, H / cl, Bt, S, N);
  // per head (cl = 1), (tiles, Bt, S, H, N). out(s) is step s's row of N
  float* outs[2] = {dB, dC};
  const int64_t orow0 = (((int64_t)pt * groups + grp) * a.Bt + b) * a.S;  // a cluster's step 0
  auto out = [&](int o, int64_t s) {
    return outs[o] + (cl > 1 ? orow0 + s : (row0 + s) * a.H + h) * N;
  };
  // a cluster's sum of its heads' dB and dC: slice q (output q / NTILE,
  // columns 16 (q % NTILE) ..) goes from every head to rank q % cl, into
  // its slot q / cl; the rank sums the heads in rank order and writes the
  // group's rows. in_bytes: what lands in this block per chunk
  const unsigned in_bytes = (unsigned)(((L::SLICES - (int)rank + cl - 1) / cl) * cl * L::slice);
  auto reduce_heads = [&](int cc) {
    mbar_wait(bar, (unsigned)(nchunks - 1 - cc) & 1u);  // every head's slices have landed
    for (int q = rank, j = 0; q < L::SLICES; q += cl, ++j)  // by the row warps
      for (int idx = threadIdx.x - 32 * C_WARPS; idx < T * 4; idx += 32 * R_WARPS) {
        const int t = idx / 4, n = (idx % 4) * 4;
        const float* src = recv + ((size_t)j * cl * T + t) * LDS + n;
        float4 s = *reinterpret_cast<const float4*>(src);
        for (int r = 1; r < cl; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(src + (size_t)r * T * LDS);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        if (cc * T + t < a.S)
          *reinterpret_cast<float4*>(out(q / NTILE, cc * T + t) + (q % NTILE) * 16 + n) = s;
      }
  };
  // Every thread: chunk c's stage has landed (and every warp is done with
  // chunk c + 1), chunk c - 1 goes in flight, and la = cumsum(ld) over the
  // chunk in every warp (lane t holds steps t and t + 32)
  auto begin_chunk = [&](int c) {
    cp_async_wait<0>();
    block_sync();  // (1)
    if (c > 0) {
      load((c - 1) * T, (c - 1) & 1);
      cp_async_commit();
    }
    const float* lds = Ls(c & 1);
    float la0 = lds[lane], la1 = T > 32 ? lds[32 + lane] : 0.f;
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
    return Decay{la0, la1, fexp(la0), fexp(la1), fexp(la_T - la0), fexp(la_T - la1), fexp(la_T)};
  };
  // step t's of x0/x1 (lane t's of x0, t - 32's of x1; every lane must call)
  auto at = [&](float x0, float x1, int t) {
    if (T == 32) return __shfl_sync(0xffffffffu, x0, t);
    const float v0 = __shfl_sync(0xffffffffu, x0, t & 31);
    const float v1 = __shfl_sync(0xffffffffu, x1, t & 31);
    return t < 32 ? v0 : v1;
  };
  // dB^T or dC^T of a tile (rows n, columns t) to the cluster's slices (one
  // head's, cl > 1) or to the outputs
  auto put = [&](int o, int mt, int c, const float (&acc)[TT][4]) {
    const int c0 = c * T, rows = a.S - c0 < T ? a.S - c0 : T;
#pragma unroll
    for (int m = 0; m < TT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = mt * 16 + g + 8 * (e >> 1), t = m * 8 + 2 * tq + (e & 1);
        if (cl > 1)
          part[((o * NTILE + mt) * T + t) * LDS + n - mt * 16] = acc[m][e];
        else if (t < rows)
          out(o, c0 + t)[n] = acc[m][e];
      }
  };
  // a slice put by this warp goes to the rank that sums it
  auto send = [&](int o, int mt) {
    if (cl == 1) return;
    const int q = o * NTILE + mt, own = q % cl;
    fence_async_shared();
    __syncwarp();
    if (lane == 0)
      bulk_to_cluster(cluster_addr(recv + ((size_t)(q / cl) * cl + rank) * T * LDS, own),
                      part + (size_t)q * T * LDS, (unsigned)L::slice, cluster_addr(bar, own));
  };
  // sum over this lane's entries of X_tn acc_nt, then over the 8 lanes of a
  // column: the tile's share of sum_n X_tn acc_nt at each step t
  auto dot_rows = [&](const bf16* X, int mt, const float (&acc)[TT][4], float* to) {
#pragma unroll
    for (int m = 0; m < TT; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = m * 8 + 2 * tq + e, n = mt * 16 + g;
        float v = acc[m][e] * __bfloat162float(X[t * LDN + n]) +
                  acc[m][e + 2] * __bfloat162float(X[t * LDN + n + 8]);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) to[mt * T + t] = v;
      }
  };
  // the partial sums of d(la) of chunk c (see finish_dld)
  auto part_sums = [&](int c) { return sums + (c & 1) * SUMS; };

  if (cl > 1) {  // every block's barrier armed before any copy comes
    if (threadIdx.x == 32 * C_WARPS) {
      mbar_init(bar);
      mbar_expect(bar, in_bytes);
    }
    cluster_arrive();
    cluster_wait();
  }
  load((nchunks - 1) * T, (nchunks - 1) & 1);
  cp_async_commit();

  if (col) {
    // column warps: dS^T of this warp's columns, f32, across all chunks: rows
    // p = pw + g (+ 8), columns n = 8j + 2tq (+ 1); the gradient of the final
    // state first. Per chunk: du, dS's terms in shared memory, dS's update; dB
    float dS[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + pw + g + 8 * (e >> 1), n = j * 8 + 2 * tq + (e & 1);
        dS[j][e] = dstate && p < a.P ? dstate[(((int64_t)b * a.H + h) * N + n) * a.P + p] : 0.f;
      }
    for (int c = nchunks - 1; c >= 0; --c) {
      const Decay d = begin_chunk(c);
      const int c0 = c * T, st = c & 1, rows = a.S - c0 < T ? a.S - c0 : T;
      const bf16 *us = Us(st), *ys = Ys(st), *bs = Bs(st), *cs = Cs(st);
      if (threadIdx.x == 0) part_sums(c)[SUMS - 1] = d.dtot;

      // du^T = dS^T B^T diag(exp(la_T - la_t)) first (dS^T split is the A
      // operand, as the forward's S^T), G's part after the barrier; dS (the
      // gradient of the state leaving the chunk) goes to shared memory as
      // the same split terms, [p][n], for dB
      float duT[TT][4];
#pragma unroll
      for (int m = 0; m < TT; ++m) duT[m][0] = duT[m][1] = duT[m][2] = duT[m][3] = 0.f;
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn) {
        uint32_t sa[4][B_TERMS];
        split_bf16<B_TERMS>(dS[2 * kn][0], dS[2 * kn][1], sa[0]);
        split_bf16<B_TERMS>(dS[2 * kn][2], dS[2 * kn][3], sa[1]);
        split_bf16<B_TERMS>(dS[2 * kn + 1][0], dS[2 * kn + 1][1], sa[2]);
        split_bf16<B_TERMS>(dS[2 * kn + 1][2], dS[2 * kn + 1][3], sa[3]);
#pragma unroll
        for (int r = 0; r < 4; ++r)  // a0 (p, n n+1), a1 (p + 8, ...), a2 (p, n + 8 ..), a3
#pragma unroll
          for (int k = 0; k < B_TERMS; ++k)
            *reinterpret_cast<uint32_t*>(Ds + (k * PT + pw + g + 8 * (r & 1)) * LDN + kn * 16 +
                                         8 * (r >> 1) + 2 * tq) = sa[r][k];
#pragma unroll
        for (int m = 0; m < TT; m += 2) {
          uint32_t bf[4];  // B^T (k = n, n = t): b0, b1 of step tiles m and m + 1
          ldsm_x4(bf, bs + (m * 8 + br.r) * LDN + kn * 16 + br.c);
#pragma unroll
          for (int k = B_TERMS - 1; k >= 0; --k) {  // the small terms first
            const uint32_t af[4] = {sa[0][k], sa[1][k], sa[2][k], sa[3][k]};
            mma_bf16(duT[m], af, bf[0], bf[1]);
            mma_bf16(duT[m + 1], af, bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < TT; ++m) {
        const float e0 = at(d.eout0, d.eout1, m * 8 + 2 * tq);
        const float e1 = at(d.eout0, d.eout1, m * 8 + 2 * tq + 1);
        duT[m][0] *= e0;
        duT[m][1] *= e1;
        duT[m][2] *= e0;
        duT[m][3] *= e1;
      }

      // dS^T = exp(la_T) dS^T + (dy o exp(la))^T C: the warp's dy^T fragments
      // (kept for du) scaled and split in registers, C's (k = t, n = n) from
      // shared memory as they are
      uint32_t yaT[MT][4];
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) ldsm_x4_t(yaT[kk], ys + (kk * 16 + ac.r) * LDU + pw + ac.c);
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dS[j][e] *= d.dtot;
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        const int t = kk * 16 + 2 * tq;
        const float w0 = at(d.ein0, d.ein1, t), w1 = at(d.ein0, d.ein1, t + 1);
        const float w8 = at(d.ein0, d.ein1, t + 8), w9 = at(d.ein0, d.ein1, t + 9);
        uint32_t yd[4][B_TERMS];  // a0, a1: steps t, t + 1; a2, a3: steps t + 8, t + 9
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack_bf16(yaT[kk][r]);
          split_bf16<B_TERMS>(v.x * (r < 2 ? w0 : w8), v.y * (r < 2 ? w1 : w9), yd[r]);
        }
#pragma unroll
        for (int j = 0; j < NN; j += 2) {
          uint32_t bf[4];  // b0, b1 of state tiles j and j + 1
          ldsm_x4_t(bf, cs + (kk * 16 + bc.r) * LDN + j * 8 + bc.c);
#pragma unroll
          for (int k = B_TERMS - 1; k >= 0; --k) {
            const uint32_t af[4] = {yd[0][k], yd[1][k], yd[2][k], yd[3][k]};
            mma_bf16(dS[j], af, bf[0], bf[1]);
            mma_bf16(dS[j + 1], af, bf[2], bf[3]);
          }
        }
      }
      if (cl > 1 && c + 1 < nchunks) cluster_arrive();  // with the row warps' head sums
      block_sync();  // (2) G, A, dS's terms and a's sums are in
      if (cl > 1 && lane == 0) bulk_wait_read();  // this warp's last slices have left
      __syncwarp();

      // du^T += dy^T G: G's fragments (k = i, n = j) from its rows, transposed
#pragma unroll
      for (int kk = 0; kk < MT; ++kk)
#pragma unroll
        for (int jj = 0; jj <= kk; ++jj)
#pragma unroll
          for (int k = B_TERMS - 1; k >= 0; --k) {
            uint32_t gf[4];  // b0, b1 of step tiles 2jj and 2jj + 1
            ldsm_x4_t(gf, Gs + (k * T + kk * 16 + bc.r) * LDG + jj * 16 + bc.c);
            mma_bf16(duT[2 * jj], yaT[kk], gf[0], gf[1]);
            mma_bf16(duT[2 * jj + 1], yaT[kk], gf[2], gf[3]);
          }
      {  // du: each lane swaps one value with the lane of the next column, then
         // stores two neighbouring columns of one step
        const bool odd = g & 1;
        bf16* dub = du + ((int64_t)b * a.S + c0) * a.H * a.P + (int64_t)h * a.P + p0 + pw;
#pragma unroll
        for (int m = 0; m < TT; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float v0 = duT[m][2 * hf], v1 = duT[m][2 * hf + 1];
            const float x = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
            const int t = m * 8 + 2 * tq + odd, p = g - odd + 8 * hf;
            if (t < rows && p0 + pw + p < a.P)
              *reinterpret_cast<uint32_t*>(dub + (int64_t)t * a.H * a.P + p) =
                  odd ? pack_bf16(x, v1) : pack_bf16(v0, x);
          }
      }

      // dB^T = (dS u^T) diag(exp(la_T - la_t)) + C^T A by 16-row tile of N
      for (int mt = warp; mt < NTILE; mt += C_WARPS) {  // warp-uniform
        float acc[TT][4];
#pragma unroll
        for (int m = 0; m < TT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          uint32_t da[B_TERMS][4];  // dS (m = n, k = p)
#pragma unroll
          for (int k = 0; k < B_TERMS; ++k)
            ldsm_x4_t(da[k], Ds + (k * PT + kp * 16 + ac.r) * LDN + mt * 16 + ac.c);
#pragma unroll
          for (int m = 0; m < TT; m += 2) {
            uint32_t uf[4];  // u^T (k = p, n = t): b0, b1 of step tiles m and m + 1
            ldsm_x4(uf, us + (m * 8 + br.r) * LDU + kp * 16 + br.c);
#pragma unroll
            for (int k = B_TERMS - 1; k >= 0; --k) {
              mma_bf16(acc[m], da[k], uf[0], uf[1]);
              mma_bf16(acc[m + 1], da[k], uf[2], uf[3]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < TT; ++m) {
          const float e0 = at(d.eout0, d.eout1, m * 8 + 2 * tq);
          const float e1 = at(d.eout0, d.eout1, m * 8 + 2 * tq + 1);
          acc[m][0] *= e0;
          acc[m][1] *= e1;
          acc[m][2] *= e0;
          acc[m][3] *= e1;
        }
        dot_rows(bs, mt, acc, part_sums(c) + 2 * MT * T);  // f_t = B_t.(exp(la_T - la_t) dS u_t)
#pragma unroll
        for (int ii = 0; ii < MT; ++ii) {
          uint32_t ca[4];  // C^T (m = n, k = i)
          ldsm_x4_t(ca, cs + (ii * 16 + ac.r) * LDN + mt * 16 + ac.c);
#pragma unroll
          for (int jj = 0; jj <= ii; ++jj)
#pragma unroll
            for (int k = B_TERMS - 1; k >= 0; --k) {
              uint32_t af[4];  // A (k = i, n = j): b0, b1 of step tiles 2jj and 2jj + 1
              ldsm_x4_t(af, As + (k * T + ii * 16 + bc.r) * LDG + jj * 16 + bc.c);
              mma_bf16(acc[2 * jj], ca, af[0], af[1]);
              mma_bf16(acc[2 * jj + 1], ca, af[2], af[3]);
            }
        }
        put(0, mt, c, acc);
      }
      if (cl > 1 && c < nchunks - 1) cluster_wait();  // every block has read the chunk after's
      for (int mt = warp; mt < NTILE; mt += C_WARPS) send(0, mt);
    }
    if (cl > 1) cluster_arrive();  // with the row warps' last head sums
    block_sync();  // chunk 0's sums are in
  } else {
    // row warps: per chunk, d(ld) of the chunk after, G and A, the chunk
    // after's head sums; dC and <dS, S_c>. S_c's first tile a chunk ahead
    float2 scv[KP][4];
    if (rw < NTILE) load_sc(nchunks - 1, rw, scv);
    for (int c = nchunks - 1; c >= 0; --c) {
      const Decay d = begin_chunk(c);
      const int st = c & 1;
      const bf16 *us = Us(st), *ys = Ys(st), *bs = Bs(st), *cs = Cs(st);
      float* sm = part_sums(c);
      float *rpart = sm, *cpart = sm + MT * T, *epart = sm + 2 * MT * T + NTILE * T;
      float* dpart = epart + NTILE * T;
      if (rw == 0 && c + 1 < nchunks) finish_dld(c + 1);
      auto la_at = [&](int t) { return at(d.la0, d.la1, t); };

      // C B^T and dy u^T on the 16 x 16 blocks (s, kk) at or below the
      // diagonal, dealt round the row warps from the second (the first
      // finishes d(ld)): G = (C B^T) o L and A = (dy u^T) o L (masked before
      // the exp) as split terms [i][j]; a = G o (dy u^T), its row and column
      // sums by block
#pragma unroll
      for (int s = 0, q = 1; s < MT; ++s)
#pragma unroll
        for (int kk = 0; kk <= s; ++kk, ++q) {
          if (q % R_WARPS != rw) continue;  // warp-uniform
          float cbt[2][4] = {}, dut[2][4] = {};  // rows i = 16s + g (+ 8), columns j = 16kk + 8hf + 2tq (+ 1)
#pragma unroll
          for (int kn = 0; kn < N / 16; ++kn) {
            uint32_t ca[4], bf[4];
            ldsm_x4(ca, cs + (s * 16 + ar.r) * LDN + kn * 16 + ar.c);
            ldsm_x4(bf, bs + (kk * 16 + br.r) * LDN + kn * 16 + br.c);
            mma_bf16(cbt[0], ca, bf[0], bf[1]);
            mma_bf16(cbt[1], ca, bf[2], bf[3]);
          }
#pragma unroll
          for (int kp = 0; kp < KP; ++kp) {
            uint32_t ya[4], uf[4];
            ldsm_x4(ya, ys + (s * 16 + ar.r) * LDU + kp * 16 + ar.c);
            ldsm_x4(uf, us + (kk * 16 + br.r) * LDU + kp * 16 + br.c);
            mma_bf16(dut[0], ya, uf[0], uf[1]);
            mma_bf16(dut[1], ya, uf[2], uf[3]);
          }
          const float la_i[2] = {la_at(s * 16 + g), la_at(s * 16 + 8 + g)};
          const float la_j[2][2] = {{la_at(kk * 16 + 2 * tq), la_at(kk * 16 + 2 * tq + 1)},
                                    {la_at(kk * 16 + 8 + 2 * tq), la_at(kk * 16 + 9 + 2 * tq)}};
          float rs[2] = {0.f, 0.f}, cs2[2][2] = {};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = s * 16 + g + 8 * r, j = kk * 16 + hf * 8 + 2 * tq;
              const float l0 = fexp(j <= i ? la_i[r] - la_j[hf][0] : -INFINITY);
              const float l1 = fexp(j + 1 <= i ? la_i[r] - la_j[hf][1] : -INFINITY);
              const float g0 = cbt[hf][2 * r] * l0, g1 = cbt[hf][2 * r + 1] * l1;
              uint32_t gt[B_TERMS], at2[B_TERMS];
              split_bf16<B_TERMS>(g0, g1, gt);
              split_bf16<B_TERMS>(dut[hf][2 * r] * l0, dut[hf][2 * r + 1] * l1, at2);
#pragma unroll
              for (int k = 0; k < B_TERMS; ++k) {
                *reinterpret_cast<uint32_t*>(Gs + (k * T + i) * LDG + j) = gt[k];
                *reinterpret_cast<uint32_t*>(As + (k * T + i) * LDG + j) = at2[k];
              }
              const float x0 = g0 * dut[hf][2 * r], x1 = g1 * dut[hf][2 * r + 1];
              rs[r] += x0 + x1;
              cs2[hf][0] += x0;
              cs2[hf][1] += x1;
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // over the 4 lanes of a row
            float v = rs[r];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (tq == 0) rpart[kk * T + s * 16 + g + 8 * r] = v;
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {  // over the 8 lanes of a column
              float v = cs2[hf][e];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (g == 0) cpart[s * T + kk * 16 + hf * 8 + 2 * tq + e] = v;
            }
        }
      if (cl > 1 && c + 1 < nchunks) {  // the chunk after's head sums, its slices long in
        reduce_heads(c + 1);
        if (threadIdx.x == 32 * C_WARPS) mbar_expect(bar, in_bytes);  // this chunk's, from here on
        cluster_arrive();  // this block has read them (waited on before the next slices go)
      }
      block_sync();  // (2)
      if (cl > 1 && lane == 0) bulk_wait_read();  // this warp's last slices have left
      __syncwarp();

      // dC^T = (S_c dy^T) diag(exp(la_t)) + B^T A^T by 16-row tile of N, and
      // <dS, S_c> over the tile
      for (int mt = rw; mt < NTILE; mt += R_WARPS) {  // warp-uniform
        if (mt != rw) load_sc(c, mt, scv);
        float acc[TT][4];
        float dot = 0.f;
#pragma unroll
        for (int m = 0; m < TT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          uint32_t sa[4][B_TERMS];
#pragma unroll
          for (int r = 0; r < 4; ++r) split_bf16<B_TERMS>(scv[kp][r].x, scv[kp][r].y, sa[r]);
#pragma unroll
          for (int m = 0; m < TT; m += 2) {
            uint32_t yf[4];  // dy^T (k = p, n = t)
            ldsm_x4(yf, ys + (m * 8 + br.r) * LDU + kp * 16 + br.c);
#pragma unroll
            for (int k = B_TERMS - 1; k >= 0; --k) {
              const uint32_t af[4] = {sa[0][k], sa[1][k], sa[2][k], sa[3][k]};
              mma_bf16(acc[m], af, yf[0], yf[1]);
              mma_bf16(acc[m + 1], af, yf[2], yf[3]);
            }
          }
          uint32_t da[B_TERMS][4];  // dS (m = n, k = p), as S_c's fragments
#pragma unroll
          for (int k = 0; k < B_TERMS; ++k)
            ldsm_x4_t(da[k], Ds + (k * PT + kp * 16 + ac.r) * LDN + mt * 16 + ac.c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float2 x = unpack_bf16(da[B_TERMS - 1][r]);
#pragma unroll
            for (int k = B_TERMS - 2; k >= 0; --k) {
              const float2 hh = unpack_bf16(da[k][r]);
              x.x += hh.x;
              x.y += hh.y;
            }
            dot = fmaf(x.x, scv[kp][r].x, dot);
            dot = fmaf(x.y, scv[kp][r].y, dot);
          }
        }
#pragma unroll
        for (int m = 0; m < TT; ++m) {
          const float e0 = at(d.ein0, d.ein1, m * 8 + 2 * tq);
          const float e1 = at(d.ein0, d.ein1, m * 8 + 2 * tq + 1);
          acc[m][0] *= e0;
          acc[m][1] *= e1;
          acc[m][2] *= e0;
          acc[m][3] *= e1;
        }
        dot_rows(cs, mt, acc, epart);  // exp(la_t) C_t.(S_c dy_t)
#pragma unroll
        for (int jj = 0; jj < MT; ++jj) {
          uint32_t ba[4];  // B^T (m = n, k = j)
          ldsm_x4_t(ba, bs + (jj * 16 + ac.r) * LDN + mt * 16 + ac.c);
#pragma unroll
          for (int ii = jj; ii < MT; ++ii)
#pragma unroll
            for (int k = B_TERMS - 1; k >= 0; --k) {
              uint32_t af[4];  // A^T (k = j, n = i): b0, b1 of step tiles 2ii and 2ii + 1
              ldsm_x4(af, As + (k * T + ii * 16 + br.r) * LDG + jj * 16 + br.c);
              mma_bf16(acc[2 * ii], ba, af[0], af[1]);
              mma_bf16(acc[2 * ii + 1], ba, af[2], af[3]);
            }
        }
        put(1, mt, c, acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == 0) dpart[mt] = dot;
      }
      if (cl > 1 && c < nchunks - 1) cluster_wait();  // every block has read the chunk after's
      for (int mt = rw; mt < NTILE; mt += R_WARPS) send(1, mt);
      if (rw < NTILE && c > 0) load_sc(c - 1, rw, scv);  // in flight through the next chunk
    }
    if (cl > 1) {
      reduce_heads(0);
      cluster_arrive();
    }
    block_sync();  // chunk 0's sums are in
    if (rw == 0) finish_dld(0);
  }
  if (cl > 1) {
    if (lane == 0) bulk_wait_read();
    cluster_wait();  // no block leaves while another may still send to it
  }
}

template <int T, int N>
int launch_mma(const void* u, const float* ld, const void* B, const void* C, const void* dy,
               const float* states, const float* dstate, void* du, float* dld, float* dB,
               float* dC, const Args& a, int cl, cudaStream_t s) {
  using L = BwdMmaTile<T, N>;
  static_assert(L::smem <= kMaxSmem, "shared memory of one block exceeds 227 KB");
  constexpr bool heads_fit = L::smem_heads <= kMaxSmem;
  if (cl > 1 && !heads_fit) return (int)cudaErrorInvalidValue;  // ssm_scan_bwd_max_group says 1
  const size_t smem = cl > 1 ? L::smem_heads : L::smem;
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd_mma<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(heads_fit ? L::smem_heads : L::smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_mma<T, N>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.P + PT - 1) / PT), (unsigned)a.H, (unsigned)a.Bt);
  cfg.blockDim = dim3(M_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)cl;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, ssd_bwd_mma<T, N>, (const bf16*)u, ld, (const bf16*)B,
                                     (const bf16*)C, (const bf16*)dy, states, dstate, (bf16*)du,
                                     dld, dB, dC, a, cl);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int T>
int launch_mma_n(int N, const void* u, const float* ld, const void* B, const void* C,
                 const void* dy, const float* states, const float* dstate, void* du, float* dld,
                 float* dB, float* dC, const Args& a, int cl, cudaStream_t s) {
  switch (N) {
    case 16: return launch_mma<T, 16>(u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, cl, s);
    case 32: return launch_mma<T, 32>(u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, cl, s);
    case 64: return launch_mma<T, 64>(u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, cl, s);
    case 96: return launch_mma<T, 96>(u, ld, B, C, dy, states, dstate, du, dld, dB, dC, a, cl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The most heads the mma variant sums on chip at this chunk and state dim:
// 8, or 1 where a cluster's slices do not fit in shared memory (T 64, N 96).
int ssm_scan_bwd_max_group(int chunk, int N) {
  auto fits = [](size_t heads_smem) { return heads_smem <= kMaxSmem ? 8 : 1; };
  switch (chunk * 1000 + N) {
    case 32016: return fits(BwdMmaTile<32, 16>::smem_heads);
    case 32032: return fits(BwdMmaTile<32, 32>::smem_heads);
    case 32064: return fits(BwdMmaTile<32, 64>::smem_heads);
    case 32096: return fits(BwdMmaTile<32, 96>::smem_heads);
    case 64016: return fits(BwdMmaTile<64, 16>::smem_heads);
    case 64032: return fits(BwdMmaTile<64, 32>::smem_heads);
    case 64064: return fits(BwdMmaTile<64, 64>::smem_heads);
    case 64096: return fits(BwdMmaTile<64, 96>::smem_heads);
    default: return 1;
  }
}

// strides: 19 element strides, in the order of each tensor's dimensions:
// u (b, s, h, p), ld (b, s, h), B (b, s, h, n), C (b, s, h, n), dy (b, s,
// h, p). dstate may be null (a zero gradient of the final state).
// variant: 0 = fma (f32 or bf16, any strides; heads_per_group 1), 1 = mma
// (bf16; u, dy, B, C with a unit inner stride, their other strides
// multiples of 8 and 16-byte aligned bases, P a multiple of 8: as the
// wrapper's plan checks). heads_per_group (1, 2, 4 or 8, dividing H; above
// 1 only for B and C of head stride 0): dB and dC are written summed over
// each group of that many heads, (n_ptiles, Bt, S, H / heads_per_group, N).
int ssm_scan_bwd_launch(const void* u, const void* ld, const void* B, const void* C,
                        const void* dy, const void* states, const void* dstate, void* du,
                        void* dld, void* dB, void* dC, int Bt, int S, int H, int P, int N,
                        const long long* strides, int chunk, int dtype, int variant,
                        int heads_per_group, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || Bt > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* x = strides;
  Args a{Bt, S, H, P, {x[0], x[1], x[2], x[3]}, {x[4], x[5], x[6]}, {x[7], x[8], x[9], x[10]},
         {x[11], x[12], x[13], x[14]}, {x[15], x[16], x[17], x[18]}};
  cudaStream_t s = (cudaStream_t)stream;
  const float *l = (const float*)ld, *st = (const float*)states, *ds = (const float*)dstate;
  float *o1 = (float*)dld, *o2 = (float*)dB, *o3 = (float*)dC;
  const int cl = heads_per_group;
  if (variant == 1) {
    if (dtype != 1 || a.u[3] != 1 || a.b[3] != 1 || a.c[3] != 1 || a.dy[3] != 1 || P % 8 != 0 ||
        !(cl == 1 || cl == 2 || cl == 4 || cl == 8) || H % cl != 0 ||
        (cl > 1 && (a.b[2] != 0 || a.c[2] != 0)))
      return (int)cudaErrorInvalidValue;
    if (chunk == 32) return launch_mma_n<32>(N, u, l, B, C, dy, st, ds, du, o1, o2, o3, a, cl, s);
    if (chunk == 64) return launch_mma_n<64>(N, u, l, B, C, dy, st, ds, du, o1, o2, o3, a, cl, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0 || cl != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_t<float>(chunk, N, u, l, B, C, dy, st, ds, du, o1, o2, o3, a, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(chunk, N, u, l, B, C, dy, st, ds, du, o1, o2, o3, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
