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
// One block per (b, h) walks the steps from S - 1 to 0 with r[h]
// transposed in shared memory (rt_jk = r_kj: the matvec dh_k = sum_j
// rt_jk dz_j reads consecutive k, no bank conflicts) and dz beside it. KS
// groups of DP = D rounded up to 32 threads, as in the forward: group 0's
// thread j owns dc_j and dh_j and applies the gates; the three sums over
// j are warp shuffles then a fixed-order sum over group 0's warps; thread
// (g, k) sums the matvec's row k over the g-th KS-th of j. Three block
// barriers a step. At the end the block writes the gradients of the
// initial state (dc0, dn0, dh0). d_c, d_n, d_h of the final state may be
// null (zero): training drops the final state.

#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int slstm_bwd_smem_bytes(int D) {
  const Geometry g = geometry(D);
  return (int)(sizeof(float) * ((size_t)D * D + g.dp + (size_t)g.ks * g.dp + 3 * (g.dp / 32)));
}

// Every tensor f32 and contiguous: i_in, f_in, n_all, di_in, df_in (B, S,
// H); o_in, c_all, z_all, dys, dz_in, do_in (B, S, E); r (H, D, D); c0,
// dc0, dh0, dc_T, dh_T (B, E); n0, dn0, dn_T (B, H). dc_T, dn_T, dh_T may
// be null (a zero gradient of the final state).
int slstm_scan_bwd_launch(const void* i_in, const void* f_in, const void* o_in, const void* r,
                          const void* c0, const void* n0, const void* c_all, const void* n_all,
                          const void* z_all, const void* dys, const void* dc_T, const void* dn_T,
                          const void* dh_T, void* dz_in, void* di_in, void* df_in, void* do_in,
                          void* dc0, void* dn0, void* dh0, int B, int S, int H, int D,
                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 1024 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
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
