// sLSTM recurrence for Hopper: the backward of slstm.cu, walked step by
// step in reverse.
//
// Replaces the reference's autodiff of slstm_block's lax.scan
// (src/repro/models/xlstm.py); the reference has no kernel for it. Per
// batch b, head h (width D) and step t, from the forward's stored c_t,
// n_t and z_t (f32), with m = max(n_t, 1), q_j = c_tj / m, o_j =
// sigmoid(o_in_tj), and the gradients carried from step t + 1 (dh_j into
// h_t through the next step's matvec, dc_j into c_t, dn into n_t):
//
//   dh_j   = dy_tj + dh_j
//   do_in  = dh_j q_j o_j (1 - o_j)
//   dq_j   = dh_j o_j,          dc_j += dq_j / m
//   dn    += [n_t > 1] dm,      dm = -sum_j dq_j q_j / m
//   df     = sum_j dc_j c_{t-1,j} + dn n_{t-1},   di = sum_j dc_j z_j + dn
//   di_in  = di i [i_in < 10],  df_in = df f (1 - f)
//   dz_in_j = dc_j i (1 - z_j^2)             (= d rec_j)
//   carried to t - 1: dc_j f, dn f, and dh_k = sum_j r[h]_kj dz_in_j
//
// with i = exp(min(i_in, 10)) and f = sigmoid(f_in) recomputed. The two
// gates' ties split their gradient in halves as the reference's
// jnp.minimum and jnp.maximum do (lax.min/max's JVP): at i_in == 10 half
// of di reaches i_in, at n_t == 1 half of dm reaches n_t. The gradient of
// r is no part of the kernel: d rec = dz_in, so dr[h] = sum over b and t
// of h_{t-1}^T dz_in_t, one product per head that the wrapper forms from
// the forward's ys with torch.matmul. Then r alone is on chip.
//
// Two variants, both one block per (b, h) walking the steps from S - 1 to
// 0; at the end the block writes the gradients of the initial state
// (dc0, dn0, dh0). d_c, d_n, d_h of the final state may be null (zero):
// training drops the final state.
//
// reg (slstm_bwd_reg, D a multiple of 16 up to REG_MAX_D), the layout of
// slstm_reg.cuh with r transposed: a thread holds r[h]_kj for CPT rows k
// over one of KS slices of j, in registers for the whole walk, and the
// slices' partial sums of dh_k = sum_j r_kj dz_j meet by shuffles. Only the dz chain is serial: from the carried dh and dc,
// each lane takes its column through dh, dq, dc to dz_t, writes it into
// a double-buffered dz_s, and one block barrier a step publishes it;
// after the barrier the register matvec gives dh for step t - 1. The
// three per-head sums (sum dq q, sum dc c_{t-1}, sum dc z) are reduced
// per warp after that barrier, beside the matvec, and stored per step
// and warp (`part`, (B H, S, NW, 3)); the scalar recurrence dn <- (dn +
// [n > 1] dm) f and di_in, df_in, dn0 are finished after the walk: the
// sums over warps in parallel over t, then one thread's pass over dn,
// then di_in and df_in in parallel. Each step's inputs (c_t, z_t, o_in,
// dy_t; n_t, i_in, f_in) come through a ring of NSTAGE steps copied with
// cp.async NSTAGE - 1 steps ahead, one copy a thread spread over all the
// warps; c_{t-1} is the next stage's c_t. dz_in and do_in are stored
// after the barrier, off the chain. The gates' exp and sigmoid use
// __expf and __fdividef (10 % of the step).
//
// fma (slstm_bwd, any D up to 1024): r[h] transposed in shared memory
// (rt_jk = r_kj: the matvec dh_k = sum_j rt_jk dz_j reads consecutive k,
// no bank conflicts) and dz beside it. KS_MAX groups of DP = D rounded up
// to 32 threads, as in the forward: group 0's thread j owns dc_j and dh_j
// and applies the gates; the three sums over j are warp shuffles then a
// fixed-order sum over group 0's warps; thread (g, k) sums the matvec's
// row k over the g-th KS-th of j. Three block barriers a step.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_util.cuh"
#include "slstm_reg.cuh"

namespace {

constexpr int KS_MAX = 4;

struct Geometry {
  int dp, ks, kc;
};

inline Geometry geometry(int D) {
  Geometry g;
  g.dp = (D + 31) / 32 * 32;
  g.ks = KS_MAX;
  while (g.ks > 1 && g.dp * g.ks > 1024) g.ks /= 2;
  g.kc = (D + g.ks - 1) / g.ks;
  return g;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void slstm_bwd(const float* __restrict__ i_in, const float* __restrict__ f_in,
                          const float* __restrict__ o_in, const float* __restrict__ r,
                          const float* __restrict__ c0, const float* __restrict__ n0,
                          const float* __restrict__ c_all, const float* __restrict__ n_all,
                          const float* __restrict__ z_all, const float* __restrict__ dys,
                          const float* __restrict__ dc_T, const float* __restrict__ dn_T,
                          const float* __restrict__ dh_T, float* __restrict__ dz_in,
                          float* __restrict__ di_in, float* __restrict__ df_in,
                          float* __restrict__ do_in, float* __restrict__ dc0,
                          float* __restrict__ dn0, float* __restrict__ dh0, int S, int H, int D,
                          Geometry geo) {
  extern __shared__ float sm[];
  float* rt_s = sm;                 // D x D, rt_s[j * D + k] = r[h]_kj
  float* dz_s = rt_s + D * D;       // DP: this step's dz_in
  float* part = dz_s + geo.dp;      // KS x DP partial sums of dh
  float* red = part + geo.ks * geo.dp;  // 3 x (DP / 32): per-warp sums of group 0
  const int nw = geo.dp / 32;

  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const int E = H * D;
  const int tid = threadIdx.x, g = tid / geo.dp, j = tid % geo.dp;
  const bool act = j < D;
  const bool own = g == 0 && act;

  const float* rg = r + (size_t)hh * D * D;
  for (int idx = tid; idx < D * D; idx += blockDim.x) {
    const int k = idx / D, jj = idx % D;
    rt_s[jj * D + k] = rg[idx];
  }
  const size_t st_e = (size_t)b * E + (size_t)hh * D;
  const size_t st_h = (size_t)b * H + hh;
  float dc = 0.f, dh = 0.f;
  float dn = dn_T != nullptr ? dn_T[st_h] : 0.f;
  if (own) {
    if (dc_T != nullptr) dc = dc_T[st_e + j];
    if (dh_T != nullptr) dh = dh_T[st_e + j];
  }
  __syncthreads();

  const int j0 = min(D, g * geo.kc), j1 = min(D, j0 + geo.kc);
  const size_t base_e = (size_t)b * S * E + (size_t)hh * D;
  const size_t base_h = (size_t)b * S * H + hh;
  for (int t = S - 1; t >= 0; --t) {
    const size_t ie = base_e + (size_t)t * E + j, ih = base_h + (size_t)t * H;
    float m = 1.f, dct = 0.f, z = 0.f, n = 0.f, n_prev = 0.f, it = 0.f, ft = 0.f;
    if (g == 0) {
      n = n_all[ih];
      n_prev = t > 0 ? n_all[ih - H] : n0[st_h];
      it = i_in[ih];
      ft = f_in[ih];
      m = fmaxf(n, 1.f);
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if (act) {
        const float c = c_all[ie];
        const float c_prev = t > 0 ? c_all[ie - E] : c0[st_e + j];
        z = z_all[ie];
        const float og = sigmoidf_(o_in[ie]);
        const float dht = dys[ie] + dh;
        const float q = c / m;
        do_in[ie] = dht * q * og * (1.f - og);
        const float dq = dht * og;
        dct = dc + dq / m;
        s1 = dq * q;
        s2 = dct * c_prev;
        s3 = dct * z;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      s3 = warp_sum(s3);
      if ((j & 31) == 0) {
        red[j >> 5] = s1;
        red[nw + (j >> 5)] = s2;
        red[2 * nw + (j >> 5)] = s3;
      }
    }
    __syncthreads();
    if (g == 0) {
      float S1 = 0.f, S2 = 0.f, S3 = 0.f;
      for (int w = 0; w < nw; ++w) {
        S1 += red[w];
        S2 += red[nw + w];
        S3 += red[2 * nw + w];
      }
      const float ig = expf(fminf(it, 10.f));
      const float fg = sigmoidf_(ft);
      const float dm = -S1 / m;
      const float dnt = dn + (n > 1.f ? dm : (n == 1.f ? 0.5f * dm : 0.f));
      const float dfg = S2 + dnt * n_prev;
      const float dig = S3 + dnt;
      if (j == 0) {
        di_in[ih] = dig * ig * (it < 10.f ? 1.f : (it == 10.f ? 0.5f : 0.f));
        df_in[ih] = dfg * fg * (1.f - fg);
      }
      if (act) {
        const float dpre = dct * ig * (1.f - z * z);
        dz_in[ie] = dpre;
        dz_s[j] = dpre;
        dc = dct * fg;
      }
      dn = dnt * fg;
    }
    __syncthreads();
    float acc = 0.f;
    if (act) {
#pragma unroll 8
      for (int jj = j0; jj < j1; ++jj) acc = fmaf(dz_s[jj], rt_s[jj * D + j], acc);
    }
    part[g * geo.dp + j] = acc;
    __syncthreads();
    if (own) {
      dh = part[j];
      for (int q = 1; q < geo.ks; ++q) dh += part[q * geo.dp + j];
    }
  }
  if (own) {
    dc0[st_e + j] = dc;
    dh0[st_e + j] = dh;
    if (j == 0) dn0[st_h] = dn;
  }
}

// ---------------------------------------------------------------------------
// reg: r^T in registers, the dz chain alone serial, the inputs loaded ahead
// ---------------------------------------------------------------------------

template <int D>
struct Bwd {
  static constexpr int STAGE = 4 * D + 4;                       // c, z, o_in, dy; n, i_in, f_in
  static constexpr int SMEM = 2 * Reg<D>::HS + NSTAGE * STAGE;  // floats
  static_assert(3 * Reg<D>::NT <= NSTAGE * STAGE, "the tail's arrays fit in the ring");
};

template <int D>
__global__ void __launch_bounds__(Reg<D>::NT, 1)
    slstm_bwd_reg(const float* __restrict__ i_in, const float* __restrict__ f_in,
                  const float* __restrict__ o_in, const float* __restrict__ r,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ c_all, const float* __restrict__ n_all,
                  const float* __restrict__ z_all, const float* __restrict__ dys,
                  const float* __restrict__ dc_T, const float* __restrict__ dn_T,
                  const float* __restrict__ dh_T, float* __restrict__ dz_in,
                  float* __restrict__ di_in, float* __restrict__ df_in,
                  float* __restrict__ do_in, float* __restrict__ dc0, float* __restrict__ dn0,
                  float* __restrict__ dh0, float* __restrict__ part, int S, int H) {
  using G = Reg<D>;
  constexpr int NT = G::NT, NW = G::NW, KPT = G::KPT, STAGE = Bwd<D>::STAGE;
  extern __shared__ __align__(16) float sm[];
  float* dz_s = sm;              // dz_t and dz_{t-1}, 2 x HS, at pos(j)
  float* ring = sm + 2 * G::HS;  // NSTAGE x (c_t, z_t, o_in, dy_t; n_t, i_in, f_in)

  const int bh = blockIdx.x, b = bh / H, hh = bh % H, E = H * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane / LG;
  const int row0 = (warp * LG + lane % LG) * CPT;  // this thread's rows k of r
  const int j = row0 + g % CPT;                    // the column whose chain it walks
  const bool own = g < CPT;                        // and writes
  const size_t st_e = (size_t)b * E + (size_t)hh * D, st_h = (size_t)b * H + hh;
  const size_t base_e = (size_t)b * S * E + (size_t)hh * D, base_h = (size_t)b * S * H + hh;
  float* pw = part + (size_t)bh * S * NW * 3;  // (S, NW, 3): the per-warp sums of step t

  // A step's inputs are D copies of 16 bytes (c_t, z_t, o_in, dy_t, at 4 cq
  // in the stage) and three of 4 (n_t, i_in, f_in). Copy cq = (tid % 4) NT
  // / 4 + tid / 4 is this thread's in every step, so the copies spread
  // over all the warps; its source moves back by a step (E or H floats).
  static_assert(NT >= D + 3, "a copy a thread");
  const int cq = (tid % 4) * (NT / 4) + tid / 4, arr = cq / (D / 4);
  const bool wide = cq < D, copies = cq < D + 3;
  const float* src =
      wide ? (arr == 0 ? c_all : arr == 1 ? z_all : arr == 2 ? o_in : dys) + base_e +
                 4 * (cq % (D / 4))
           : (cq == D ? n_all : cq == D + 1 ? i_in : f_in) + base_h;
  const int src_step = wide ? E : H, dst = wide ? 4 * cq : 4 * D + cq - D;
  if (copies) src += (size_t)(S - 1) * src_step;  // step S - 1 first
  auto issue = [&](int u) {  // step S - 1 - u's inputs into its stage; u rises by one a call
    if (copies) {
      float* d = ring + (u % NSTAGE) * STAGE + dst;
      if (wide)
        mma::cp_async16(d, src, 16);
      else
        mma::cp_async4(d, src, 4);
      src -= src_step;
    }
  };
  for (int u = 0; u < NSTAGE - 1; ++u) {
    if (u < S) issue(u);
    mma::cp_async_commit();
  }

  float rr[KPT][CPT];  // r[h]_{row0 + c, j}, j = g KPT + i
  const float* rg = r + (size_t)hh * D * D + (size_t)row0 * D + g * KPT;
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) rr[i][c] = rg[(size_t)c * D + i];
  float* dz_t = dz_in + base_e + (size_t)(S - 1) * E + j;  // this column's dz_in, do_in at step t
  float* do_t = do_in + base_e + (size_t)(S - 1) * E + j;
  float* pw_t = pw + (size_t)(S - 1) * NW * 3 + warp * 3 + lane;  // this warp's sums at step t
  float dc = dc_T != nullptr ? dc_T[st_e + j] : 0.f;
  float dh = dh_T != nullptr ? dh_T[st_e + j] : 0.f;
  const float c_init = c0[st_e + j];
  mma::cp_async_wait<NSTAGE - 3>();  // the first two steps' inputs
  __syncthreads();

  for (int u = 0; u < S; ++u) {
    const int t = S - 1 - u;
    if (u + NSTAGE - 1 < S) issue(u + NSTAGE - 1);  // into the stage step u - 1 read
    mma::cp_async_commit();
    const float* st = ring + (u % NSTAGE) * STAGE;
    const float c = st[j], z = st[D + j], oin = st[2 * D + j], dy = st[3 * D + j];
    const float n = st[4 * D], it = st[4 * D + 1], ft = st[4 * D + 2];
    const float c_prev = t > 0 ? ring[((u + 1) % NSTAGE) * STAGE + j] : c_init;
    const float m = fmaxf(n, 1.f);
    const float og = sigmoid_fast(oin);
    const float ig = __expf(fminf(it, 10.f));
    const float fg = sigmoid_fast(ft);
    // the chain: dh -> dq -> dc -> dz_t
    const float dht = dy + dh;
    const float q = c / m;
    const float dq = dht * og;
    const float dct = dc + dq / m;
    const float dpre = dct * ig * (1.f - z * z);
    if (own) dz_s[(u & 1) * G::HS + G::pos(j)] = dpre;
    float s1 = own ? dq * q : 0.f, s2 = own ? dct * c_prev : 0.f, s3 = own ? dct * z : 0.f;
    dc = dct * fg;
    mma::cp_async_wait<NSTAGE - 3>();  // this thread's copies of step u + 2
    __syncthreads();                   // dz_t and step u + 2's inputs are in
    if (own) {  // step t's gradients, behind the barrier
      *dz_t = dpre;
      *do_t = dht * q * og * (1.f - og);
    }
    dz_t -= E;
    do_t -= E;
    // dh for step t - 1: the matvec over this thread's slice of dz_t
    const float* dzc = dz_s + (u & 1) * G::HS;
    float acc[CPT][2];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[cc][0] = acc[cc][1] = 0.f;
#pragma unroll
    for (int i = 0; i < KPT / 4; ++i) {
      const float4 zk = *reinterpret_cast<const float4*>(dzc + g * G::STR + 4 * i);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        float& a = acc[cc][i & 1];
        a = fmaf(zk.x, rr[4 * i][cc], a);
        a = fmaf(zk.y, rr[4 * i + 1][cc], a);
        a = fmaf(zk.z, rr[4 * i + 2][cc], a);
        a = fmaf(zk.w, rr[4 * i + 3][cc], a);
      }
    }
    // step t's per-head sums, per warp, off the chain
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      s3 += __shfl_xor_sync(0xffffffffu, s3, o);
    }
    if (lane < 3) *pw_t = lane == 0 ? s1 : lane == 1 ? s2 : s3;
    pw_t -= NW * 3;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      float p = acc[cc][0] + acc[cc][1];
#pragma unroll
      for (int o = LG; o < 32; o <<= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (g % CPT == cc) dh = p;
    }
  }
  if (own) {
    dc0[st_e + j] = dc;
    dh0[st_e + j] = dh;
  }
  __syncthreads();  // every warp's sums are in `part`; the ring is free

  // di_in, df_in and dn, NT steps at a time from the last
  float* a_s = ring;     // [n > 1] dm of each step (half at n == 1)
  float* f_s = a_s + NT;  // f
  float* d_s = f_s + NT;  // dn + a: the gradient into n_t
  float dn = dn_T != nullptr ? dn_T[st_h] : 0.f;
  for (int hi = S; hi > 0; hi -= NT) {
    const int lo = hi > NT ? hi - NT : 0, t = lo + tid;
    float S2 = 0.f, S3 = 0.f, ig = 0.f, fg = 0.f, gate = 0.f, n_prev = 0.f;
    if (t < hi) {
      float S1 = 0.f;
      for (int w = 0; w < NW; ++w) {
        const float* pp = pw + ((size_t)t * NW + w) * 3;
        S1 += pp[0];
        S2 += pp[1];
        S3 += pp[2];
      }
      const float n = n_all[base_h + (size_t)t * H];
      n_prev = t > 0 ? n_all[base_h + (size_t)(t - 1) * H] : n0[st_h];
      const float it = i_in[base_h + (size_t)t * H];
      ig = __expf(fminf(it, 10.f));
      fg = sigmoid_fast(f_in[base_h + (size_t)t * H]);
      gate = it < 10.f ? 1.f : (it == 10.f ? 0.5f : 0.f);
      const float dm = -S1 / fmaxf(n, 1.f);
      a_s[tid] = n > 1.f ? dm : (n == 1.f ? 0.5f * dm : 0.f);
      f_s[tid] = fg;
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll 8
      for (int k = hi - 1 - lo; k >= 0; --k) {
        const float dnt = dn + a_s[k];
        d_s[k] = dnt;
        dn = dnt * f_s[k];
      }
    }
    __syncthreads();
    if (t < hi) {
      const float dnt = d_s[tid];
      di_in[base_h + (size_t)t * H] = (S3 + dnt) * ig * gate;
      df_in[base_h + (size_t)t * H] = (S2 + dnt * n_prev) * fg * (1.f - fg);
    }
    __syncthreads();
  }
  if (tid == 0) dn0[st_h] = dn;
}

template <int D>
int launch_reg(const float* i_in, const float* f_in, const float* o_in, const float* r,
               const float* c0, const float* n0, const float* c_all, const float* n_all,
               const float* z_all, const float* dys, const float* dc_T, const float* dn_T,
               const float* dh_T, float* dz_in, float* di_in, float* df_in, float* do_in,
               float* dc0, float* dn0, float* dh0, float* part, int B, int S, int H,
               cudaStream_t s) {
  if constexpr (D % (CPT * LG) != 0) {  // no whole warps at this layout
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int smem = (int)sizeof(float) * Bwd<D>::SMEM;
    static_assert(smem <= 48 * 1024, "no opt-in to more shared memory");
    slstm_bwd_reg<D><<<B * H, Reg<D>::NT, smem, s>>>(i_in, f_in, o_in, r, c0, n0, c_all, n_all,
                                                     z_all, dys, dc_T, dn_T, dh_T, dz_in, di_in,
                                                     df_in, do_in, dc0, dn0, dh0, part, S, H);
    return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The scratch the reg variant needs per (b, h, step), in floats: each
// warp's three per-head sums (the wrapper allocates B H S times it).
int slstm_bwd_part_floats(int D) { return 3 * (D / CPT * KS / 32); }

int slstm_bwd_smem_bytes(int D) {
  const Geometry g = geometry(D);
  return (int)(sizeof(float) * ((size_t)D * D + g.dp + (size_t)g.ks * g.dp + 3 * (g.dp / 32)));
}

// Every tensor f32 and contiguous: i_in, f_in, n_all, di_in, df_in (B, S,
// H); o_in, c_all, z_all, dys, dz_in, do_in (B, S, E); r (H, D, D); c0,
// dc0, dh0, dc_T, dh_T (B, E); n0, dn0, dn_T (B, H). dc_T, dn_T, dh_T may
// be null (a zero gradient of the final state). variant 0: fma; 1: reg
// (D a multiple of 16 up to REG_MAX_D; c_all, z_all, o_in and dys 16-byte
// aligned; part: B H S slstm_bwd_part_floats(D) floats of scratch).
int slstm_scan_bwd_launch(const void* i_in, const void* f_in, const void* o_in, const void* r,
                          const void* c0, const void* n0, const void* c_all, const void* n_all,
                          const void* z_all, const void* dys, const void* dc_T, const void* dn_T,
                          const void* dh_T, void* dz_in, void* di_in, void* df_in, void* do_in,
                          void* dc0, void* dn0, void* dh0, void* part, int B, int S, int H,
                          int D, int variant, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 1024 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (part == nullptr) return (int)cudaErrorInvalidValue;
#define SLSTM_BWD_REG_ARGS                                                                      \
  (const float*)i_in, (const float*)f_in, (const float*)o_in, (const float*)r, (const float*)c0, \
      (const float*)n0, (const float*)c_all, (const float*)n_all, (const float*)z_all,          \
      (const float*)dys, (const float*)dc_T, (const float*)dn_T, (const float*)dh_T,            \
      (float*)dz_in, (float*)di_in, (float*)df_in, (float*)do_in, (float*)dc0, (float*)dn0,     \
      (float*)dh0, (float*)part, B, S, H, (cudaStream_t)stream
    switch (D) {
      case 16: return launch_reg<16>(SLSTM_BWD_REG_ARGS);
      case 32: return launch_reg<32>(SLSTM_BWD_REG_ARGS);
      case 48: return launch_reg<48>(SLSTM_BWD_REG_ARGS);
      case 64: return launch_reg<64>(SLSTM_BWD_REG_ARGS);
      case 80: return launch_reg<80>(SLSTM_BWD_REG_ARGS);
      case 96: return launch_reg<96>(SLSTM_BWD_REG_ARGS);
      case 112: return launch_reg<112>(SLSTM_BWD_REG_ARGS);
      case 128: return launch_reg<128>(SLSTM_BWD_REG_ARGS);
      case 144: return launch_reg<144>(SLSTM_BWD_REG_ARGS);
      case 160: return launch_reg<160>(SLSTM_BWD_REG_ARGS);
      case 176: return launch_reg<176>(SLSTM_BWD_REG_ARGS);
      case 192: return launch_reg<192>(SLSTM_BWD_REG_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
#undef SLSTM_BWD_REG_ARGS
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(D);
  const int smem = slstm_bwd_smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(slstm_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  slstm_bwd<<<B * H, g.dp * g.ks, smem, (cudaStream_t)stream>>>(
      (const float*)i_in, (const float*)f_in, (const float*)o_in, (const float*)r,
      (const float*)c0, (const float*)n0, (const float*)c_all, (const float*)n_all,
      (const float*)z_all, (const float*)dys, (const float*)dc_T, (const float*)dn_T,
      (const float*)dh_T, (float*)dz_in, (float*)di_in, (float*)df_in, (float*)do_in,
      (float*)dc0, (float*)dn0, (float*)dh0, S, H, D, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
