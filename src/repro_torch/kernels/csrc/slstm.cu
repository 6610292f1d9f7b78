// sLSTM recurrence for Hopper: the forward of xLSTM's scalar-memory LSTM,
// walked step by step over the sequence.
//
// Replaces the reference's step function of slstm_block
// (src/repro/models/xlstm.py), a jnp lax.scan, not a Pallas kernel. Per
// batch b, head h (head width D) and step t, with every input in f32:
//
//   rec_j = sum_k h_{t-1,k} r[h]_kj               (the recurrent matvec)
//   z_j   = tanh(z_in_tj + rec_j)
//   i     = exp(min(i_in_t, 10)),  f = sigmoid(f_in_t)   (per head)
//   c_j   = f c_j + i z_j,         n = f n + i
//   h_tj  = sigmoid(o_in_tj) (c_j / max(n, 1))
//
// One block per (b, h) walks the steps in series; r[h] (D x D f32: 144 KiB
// at xlstm-125m's D = 192) stays in shared memory for the whole walk and
// h_{t-1} beside it. The block runs KS groups of DP = D rounded up to 32
// threads: thread (g, j) sums the matvec's column j over the g-th KS-th of
// k (r read along its rows: consecutive j, no bank conflicts), the
// partial sums meet in shared memory, and group 0 (thread j owning c_j)
// applies the gates. Two block barriers a step. Nothing else is on chip:
// each step reads z_in, o_in (D floats) and i_in, f_in (one each) from
// device memory and writes h.
//
// What bounds it on an H100: at xlstm-125m's training shape (B 8, S 512,
// H 4) a call moves ~38 MB (~11 us at 3.35 TB/s) and does ~1.2 GFLOP of
// f32 matvec (~18 us at 67 TFLOP/s), but its 512 steps are a dependent
// chain on 32 blocks: the latency of one step (a 48-long FMA chain, two
// barriers, the gates' exp, tanh and divides) sets the time.
//
// Training passes c_all, n_all and z_all, (B, S, E), (B, S, H), (B, S, E)
// f32, and the kernel stores each step's c, n and z there: what the
// backward (slstm_bwd.cu) reads. Serving passes null and stores nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KS_MAX = 4;  // thread groups that split the matvec's k

struct Geometry {
  int dp, ks, kc;  // group width (D rounded up to 32), groups, k per group
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

__global__ void slstm_fwd(const float* __restrict__ z_in, const float* __restrict__ i_in,
                          const float* __restrict__ f_in, const float* __restrict__ o_in,
                          const float* __restrict__ r, const float* __restrict__ c0,
                          const float* __restrict__ n0, const float* __restrict__ h0,
                          float* __restrict__ ys, float* __restrict__ c_out,
                          float* __restrict__ n_out, float* __restrict__ h_out,
                          float* __restrict__ c_all, float* __restrict__ n_all,
                          float* __restrict__ z_all, int S, int H, int D, Geometry geo) {
  extern __shared__ float sm[];
  float* r_s = sm;               // D x D, row k holds r[h]_k.
  float* h_s = r_s + D * D;      // h_{t-1}, DP
  float* part = h_s + geo.dp;    // KS x DP partial sums of rec

  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const int E = H * D;
  const int tid = threadIdx.x, g = tid / geo.dp, j = tid % geo.dp;
  const bool act = j < D;
  const bool own = g == 0 && act;  // thread j of group 0 owns c_j and h_j

  const float* rg = r + (size_t)hh * D * D;
  for (int idx = tid; idx < D * D; idx += blockDim.x) r_s[idx] = rg[idx];
  const size_t st_e = (size_t)b * E + (size_t)hh * D;  // (b, h*D) of a state (B, E)
  float c = 0.f, n = n0[(size_t)b * H + hh];
  if (own) {
    c = c0[st_e + j];
    h_s[j] = h0[st_e + j];
  }
  __syncthreads();

  const int k0 = min(D, g * geo.kc), k1 = min(D, k0 + geo.kc);
  const size_t base_e = (size_t)b * S * E + (size_t)hh * D;  // (b, 0, h*D) of (B, S, E)
  const size_t base_h = (size_t)b * S * H + hh;              // (b, 0, h) of (B, S, H)
  for (int t = 0; t < S; ++t) {
    const size_t ie = base_e + (size_t)t * E + j, ih = base_h + (size_t)t * H;
    float zt = 0.f, ot = 0.f, it = 0.f, ft = 0.f;
    if (own) {  // issued before the matvec, which hides their latency
      zt = z_in[ie];
      ot = o_in[ie];
      it = i_in[ih];
      ft = f_in[ih];
    }
    float acc = 0.f;
    if (act) {
#pragma unroll 8
      for (int k = k0; k < k1; ++k) acc = fmaf(h_s[k], r_s[k * D + j], acc);
    }
    part[g * geo.dp + j] = acc;
    __syncthreads();
    if (own) {
      float rec = part[j];
      for (int q = 1; q < geo.ks; ++q) rec += part[q * geo.dp + j];
      const float z = tanhf(zt + rec);
      const float ig = expf(fminf(it, 10.f));
      const float fg = sigmoidf_(ft);
      c = fg * c + ig * z;
      n = fg * n + ig;
      const float hv = sigmoidf_(ot) * (c / fmaxf(n, 1.f));
      ys[ie] = hv;
      h_s[j] = hv;
      if (c_all != nullptr) {
        c_all[ie] = c;
        z_all[ie] = z;
        if (j == 0) n_all[ih] = n;
      }
    }
    __syncthreads();
  }
  if (own) {
    c_out[st_e + j] = c;
    h_out[st_e + j] = h_s[j];
    if (j == 0) n_out[(size_t)b * H + hh] = n;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The shared memory a block of head width D takes, in bytes (the wrapper
// refuses a D whose block does not fit).
int slstm_smem_bytes(int D) {
  const Geometry g = geometry(D);
  return (int)(sizeof(float) * ((size_t)D * D + g.dp + (size_t)g.ks * g.dp));
}

// Every tensor f32 and contiguous: z_in, o_in, ys (B, S, E), i_in, f_in
// (B, S, H), r (H, D, D), the initial state c0, h0 (B, E), n0 (B, H) and
// the final one c_out, h_out, n_out in the same shapes, E = H * D.
// c_all, n_all, z_all: null (serving), or (B, S, E), (B, S, H), (B, S, E)
// buffers that receive each step's c, n and z (training).
int slstm_scan_launch(const void* z_in, const void* i_in, const void* f_in, const void* o_in,
                      const void* r, const void* c0, const void* n0, const void* h0, void* ys,
                      void* c_out, void* n_out, void* h_out, void* c_all, void* n_all,
                      void* z_all, int B, int S, int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 1024 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if ((c_all == nullptr) != (n_all == nullptr) || (c_all == nullptr) != (z_all == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(D);
  const int smem = slstm_smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(slstm_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  slstm_fwd<<<B * H, g.dp * g.ks, smem, (cudaStream_t)stream>>>(
      (const float*)z_in, (const float*)i_in, (const float*)f_in, (const float*)o_in,
      (const float*)r, (const float*)c0, (const float*)n0, (const float*)h0, (float*)ys,
      (float*)c_out, (float*)n_out, (float*)h_out, (float*)c_all, (float*)n_all, (float*)z_all,
      S, H, D, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
