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
// Design: one block per (b, h, 64-column P tile) walks the chunks in
// reverse, carrying its N x 64 columns of dS in shared memory (f32) from
// one chunk to the one before; the columns of dS, du and S are independent,
// so a P tile needs nothing from another. dB, dC and d(ld) sum over all of
// P: each tile writes its share, per head, in f32, and the wrapper adds the
// tiles (and, for B and C shared by the heads, the heads) in a fixed
// order. No atomics: two calls give the same bits. Per chunk, with 256
// threads as a 16 x 16 grid each holding a register tile of every product
// (f32 FMAs on the CUDA cores): C B^T and dy u^T (T x T, masked and scaled
// by L), then du, dB and dC, then the update of dS and d(la); four block
// barriers. Rows of 64 + 1 and N + 1 floats keep every column read on
// distinct banks.
//
// What bounds it on an H100: at zamba2's training shape (Bt 8, S 512, H 80,
// P = N = 64, T 32, bf16) a call reads u, dy (42 MB each in bf16), ld, B,
// C (B and C once per step when shared by the heads) and the forward's
// states (168 MB f32), and writes du (42 MB), dld and the per-head f32 dB
// and dC (84 MB each): ~0.1 ms at 3.35 TB/s counting each byte once. Its
// ~1.2e10 f32 operations take ~0.18 ms at 67 TFLOP/s on the CUDA cores, so
// the operations bound it; a simple kernel, not yet the tensor cores.
//
// Shared memory per block: 2 T (PT+1) + 2 T (N+1) + 2 N (PT+1) +
// 2 T (T+1) + 7 T + 16 T + 8 floats (78 KB at T = 32, N = 64; 172 KB at
// T = 64, N = 96). N and T are template parameters (N in 16, 32, 64, 96;
// T in 32, 64); any P (the last tile is ragged) and any S (a ragged last
// chunk: steps past S are identity steps, ld = 0, u = B = C = dy = 0).
//
// Inputs are read through their strides in the model's layout: u, dy
// (Bt, S, H, P) and B, C (Bt, S, H, N) in f32 or bf16 (B, C with any head
// stride, 0 when shared by the heads), ld (Bt, S, H) f32, the states
// (Bt, H, n_chunks, N, P) and d_state (Bt, H, N, P) f32 contiguous. du is
// written contiguous in u's type; dld (n_ptiles, Bt, S, H), dB and dC
// (n_ptiles, Bt, S, H, N) contiguous in f32.
//
// C interface (loaded with ctypes): ssm_scan_bwd_launch returns the CUDA
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

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// strides: 19 element strides, in the order of each tensor's dimensions:
// u (b, s, h, p), ld (b, s, h), B (b, s, h, n), C (b, s, h, n), dy (b, s,
// h, p). dstate may be null (a zero gradient of the final state).
int ssm_scan_bwd_launch(const void* u, const void* ld, const void* B, const void* C,
                        const void* dy, const void* states, const void* dstate, void* du,
                        void* dld, void* dB, void* dC, int Bt, int S, int H, int P, int N,
                        const long long* strides, int chunk, int dtype, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || Bt > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* x = strides;
  Args a{Bt, S, H, P, {x[0], x[1], x[2], x[3]}, {x[4], x[5], x[6]}, {x[7], x[8], x[9], x[10]},
         {x[11], x[12], x[13], x[14]}, {x[15], x[16], x[17], x[18]}};
  cudaStream_t s = (cudaStream_t)stream;
  const float *l = (const float*)ld, *st = (const float*)states, *ds = (const float*)dstate;
  float *o1 = (float*)dld, *o2 = (float*)dB, *o3 = (float*)dC;
  if (dtype == 0) return launch_t<float>(chunk, N, u, l, B, C, dy, st, ds, du, o1, o2, o3, a, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(chunk, N, u, l, B, C, dy, st, ds, du, o1, o2, o3, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
