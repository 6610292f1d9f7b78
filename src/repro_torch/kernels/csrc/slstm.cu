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
// What bounds it on an H100: at xlstm-125m's training shape (B 8, S 512,
// H 4) a call moves ~38 MB (~11 us at 3.35 TB/s) and does ~1.2 GFLOP of
// f32 matvec (~18 us at 67 TFLOP/s), but its 512 steps are a dependent
// chain on 32 blocks (one per (b, h)): what one step costs inside one SM
// sets the time. Two variants, both one block per (b, h):
//
// reg (slstm_fwd_reg, D a multiple of 16 up to REG_MAX_D), in the layout
// of slstm_reg.cuh. r[h] is read from device memory once and held in
// registers for the whole walk (96 floats a thread at D = 192, 384
// threads). The KS slices of k of a column share a warp, so their partial
// sums meet by shuffles (a butterfly: every lane of the group ends with
// the same bits) and every lane applies the gates of one of its columns.
// Shared memory carries only h (double-buffered, each slice's float4
// reads broadcast to its 8 lanes, the slices on distinct banks) and a
// ring of NSTAGE steps' inputs (z_in, o_in, i_in, f_in), copied with
// cp.async NSTAGE - 1 steps ahead, so no step waits on device memory;
// each thread makes at most one copy a step, the copies spread over all
// the warps, so that no warp reaches the barrier late.
// One block barrier a step: the one that publishes h_t. The gates that
// do not wait on the matvec (i, f, sigmoid(o), n) run beside it, with
// __expf and __fdividef (tools/slstm_variants.py: 15 % of the step, ~1e-6
// of the outputs' scale); tanh(z_in + rec) and c / max(n, 1), on the
// chain, stay precise (tanhf, a divide).
//
// fma (slstm_fwd, any D up to 1024): r[h] (D x D f32: 144 KiB at D = 192)
// stays in shared memory and h_{t-1} beside it. The block runs KS_MAX
// groups of DP = D rounded up to 32 threads: thread (g, j) sums the
// matvec's column j over the g-th KS-th of k, the partial sums meet in
// shared memory, and group 0 (thread j owning c_j) applies the gates. Two
// block barriers a step; each step reads its inputs from device memory.
//
// Training passes c_all, n_all and z_all, (B, S, E), (B, S, H), (B, S, E)
// f32, and the kernel stores each step's c, n and z there: what the
// backward (slstm_bwd.cu) reads. Serving passes null and stores nothing.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_util.cuh"
#include "slstm_reg.cuh"

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

// ---------------------------------------------------------------------------
// reg: r in registers, one barrier a step, the inputs loaded ahead
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  static constexpr int STAGE = 2 * D + 4;                       // z_in, o_in; i_in, f_in
  static constexpr int SMEM = 2 * Reg<D>::HS + NSTAGE * STAGE;  // floats
};

template <int D>
__global__ void __launch_bounds__(Reg<D>::NT, 1)
    slstm_fwd_reg(const float* __restrict__ z_in, const float* __restrict__ i_in,
                  const float* __restrict__ f_in, const float* __restrict__ o_in,
                  const float* __restrict__ r, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ h0,
                  float* __restrict__ ys, float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ h_out, float* __restrict__ c_all,
                  float* __restrict__ n_all, float* __restrict__ z_all, int S, int H) {
  using G = Reg<D>;
  constexpr int NT = G::NT, KPT = G::KPT, STAGE = Fwd<D>::STAGE;
  extern __shared__ __align__(16) float sm[];
  float* h_s = sm;               // h_{t-1} and h_t, 2 x HS, at pos(k)
  float* ring = sm + 2 * G::HS;  // NSTAGE x (z_in, o_in; i_in, f_in)

  const int b = blockIdx.x / H, hh = blockIdx.x % H, E = H * D;
  const int tid = threadIdx.x, lane = tid & 31, g = lane / LG;
  const int col0 = ((tid >> 5) * LG + lane % LG) * CPT;  // this thread's columns
  const int j = col0 + g % CPT;                          // the column whose gates it applies
  const bool own = g < CPT;                              // and writes
  const size_t st_e = (size_t)b * E + (size_t)hh * D;        // (b, h*D) of a state (B, E)
  const size_t base_e = (size_t)b * S * E + (size_t)hh * D;  // (b, 0, h*D) of (B, S, E)
  const size_t base_h = (size_t)b * S * H + hh;              // (b, 0, h) of (B, S, H)

  // A step's inputs are D / 2 copies of 16 bytes (z_in, then o_in, at 4 cq
  // in the stage) and two of 4 (i_in, f_in). Copy cq = (tid % 4) NT / 4 +
  // tid / 4 is this thread's in every step, so the copies spread over all
  // the warps; its source moves on by a step (E or H floats) a copy.
  static_assert(NT >= D / 2 + 2, "a copy a thread");
  const int cq = (tid % 4) * (NT / 4) + tid / 4;
  const bool wide = cq < D / 2, copies = cq < D / 2 + 2;
  const float* src = cq < D / 4 ? z_in + base_e + 4 * cq
                     : wide     ? o_in + base_e + (4 * cq - D)
                                : (cq == D / 2 ? i_in : f_in) + base_h;
  const int src_step = wide ? E : H, dst = wide ? 4 * cq : 2 * D + cq - D / 2;
  auto issue = [&](int t) {  // step t's inputs into its stage of the ring; t rises by one a call
    if (copies) {
      float* d = ring + (t % NSTAGE) * STAGE + dst;
      if (wide)
        mma::cp_async16(d, src, 16);
      else
        mma::cp_async4(d, src, 4);
      src += src_step;
    }
  };
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < S) issue(t);
    mma::cp_async_commit();
  }

  float rr[KPT][CPT];  // r[h]_{k, col0 + c}, k = g KPT + i
  const float* rg = r + (size_t)hh * D * D + (size_t)g * KPT * D + col0;
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) rr[i][c] = rg[(size_t)i * D + c];
  for (int q = tid; q < D; q += NT) h_s[G::pos(q)] = h0[st_e + q];
  float c = c0[st_e + j], n = n0[(size_t)b * H + hh], hv = h0[st_e + j];
  float* y_t = ys + base_e + j;  // this column's h_t (c_t, z_t) in ys (c_all, z_all): E a step
  const bool keep = c_all != nullptr;
  float* c_t = keep ? c_all + base_e + j : nullptr;
  float* z_t = keep ? z_all + base_e + j : nullptr;
  float* n_t = keep ? n_all + base_h : nullptr;
  mma::cp_async_wait<NSTAGE - 2>();  // step 0's inputs
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    const float* hc = h_s + (t & 1) * G::HS;
    if (t + NSTAGE - 1 < S) issue(t + NSTAGE - 1);  // into the stage step t - 1 read
    mma::cp_async_commit();
    const float* st = ring + (t % NSTAGE) * STAGE;
    const float zt = st[j], ot = st[D + j], it = st[2 * D], ft = st[2 * D + 1];
    // the gates that do not wait on the matvec
    const float ig = __expf(fminf(it, 10.f));
    const float fg = sigmoid_fast(ft);
    const float og = sigmoid_fast(ot);
    n = fg * n + ig;
    const float m = fmaxf(n, 1.f);
    float acc[CPT][2];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[cc][0] = acc[cc][1] = 0.f;
#pragma unroll
    for (int i = 0; i < KPT / 4; ++i) {
      const float4 hk = *reinterpret_cast<const float4*>(hc + g * G::STR + 4 * i);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        float& a = acc[cc][i & 1];
        a = fmaf(hk.x, rr[4 * i][cc], a);
        a = fmaf(hk.y, rr[4 * i + 1][cc], a);
        a = fmaf(hk.z, rr[4 * i + 2][cc], a);
        a = fmaf(hk.w, rr[4 * i + 3][cc], a);
      }
    }
    float rec = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      float p = acc[cc][0] + acc[cc][1];
#pragma unroll
      for (int o = LG; o < 32; o <<= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (g % CPT == cc) rec = p;
    }
    const float z = tanhf(zt + rec);
    c = fg * c + ig * z;
    hv = og * (c / m);
    if (own) {
      h_s[((t + 1) & 1) * G::HS + G::pos(j)] = hv;
      *y_t = hv;
      if (keep) {
        *c_t = c;
        *z_t = z;
      }
    }
    if (keep && tid == 0) *n_t = n;
    y_t += E;
    if (keep) {
      c_t += E;
      z_t += E;
      n_t += H;
    }
    mma::cp_async_wait<NSTAGE - 2>();  // this thread's copies of step t + 1
    __syncthreads();                   // h_t and step t + 1's inputs are in
  }
  if (own) {
    c_out[st_e + j] = c;
    h_out[st_e + j] = hv;
  }
  if (tid == 0) n_out[(size_t)b * H + hh] = n;
}

template <int D>
int launch_reg(const float* z_in, const float* i_in, const float* f_in, const float* o_in,
               const float* r, const float* c0, const float* n0, const float* h0, float* ys,
               float* c_out, float* n_out, float* h_out, float* c_all, float* n_all, float* z_all,
               int B, int S, int H, cudaStream_t s) {
  if constexpr (D % (CPT * LG) != 0) {  // no whole warps at this layout
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int smem = (int)sizeof(float) * Fwd<D>::SMEM;
    static_assert(smem <= 48 * 1024, "no opt-in to more shared memory");
    slstm_fwd_reg<D><<<B * H, Reg<D>::NT, smem, s>>>(z_in, i_in, f_in, o_in, r, c0, n0, h0, ys,
                                                     c_out, n_out, h_out, c_all, n_all, z_all, S,
                                                     H);
    return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The shared memory a block of the fma variant at head width D takes, in
// bytes (the wrapper refuses a D whose block does not fit).
int slstm_smem_bytes(int D) {
  const Geometry g = geometry(D);
  return (int)(sizeof(float) * ((size_t)D * D + g.dp + (size_t)g.ks * g.dp));
}

// Every tensor f32 and contiguous: z_in, o_in, ys (B, S, E), i_in, f_in
// (B, S, H), r (H, D, D), the initial state c0, h0 (B, E), n0 (B, H) and
// the final one c_out, h_out, n_out in the same shapes, E = H * D.
// c_all, n_all, z_all: null (serving), or (B, S, E), (B, S, H), (B, S, E)
// buffers that receive each step's c, n and z (training). variant 0:
// fma; 1: reg (D a multiple of 16 up to REG_MAX_D; z_in and o_in 16-byte
// aligned).
int slstm_scan_launch(const void* z_in, const void* i_in, const void* f_in, const void* o_in,
                      const void* r, const void* c0, const void* n0, const void* h0, void* ys,
                      void* c_out, void* n_out, void* h_out, void* c_all, void* n_all,
                      void* z_all, int B, int S, int H, int D, int variant, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > 1024 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if ((c_all == nullptr) != (n_all == nullptr) || (c_all == nullptr) != (z_all == nullptr))
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {
#define SLSTM_REG_ARGS                                                                           \
  (const float*)z_in, (const float*)i_in, (const float*)f_in, (const float*)o_in, (const float*)r, \
      (const float*)c0, (const float*)n0, (const float*)h0, (float*)ys, (float*)c_out,            \
      (float*)n_out, (float*)h_out, (float*)c_all, (float*)n_all, (float*)z_all, B, S, H,         \
      (cudaStream_t)stream
    switch (D) {
      case 16: return launch_reg<16>(SLSTM_REG_ARGS);
      case 32: return launch_reg<32>(SLSTM_REG_ARGS);
      case 48: return launch_reg<48>(SLSTM_REG_ARGS);
      case 64: return launch_reg<64>(SLSTM_REG_ARGS);
      case 80: return launch_reg<80>(SLSTM_REG_ARGS);
      case 96: return launch_reg<96>(SLSTM_REG_ARGS);
      case 112: return launch_reg<112>(SLSTM_REG_ARGS);
      case 128: return launch_reg<128>(SLSTM_REG_ARGS);
      case 144: return launch_reg<144>(SLSTM_REG_ARGS);
      case 160: return launch_reg<160>(SLSTM_REG_ARGS);
      case 176: return launch_reg<176>(SLSTM_REG_ARGS);
      case 192: return launch_reg<192>(SLSTM_REG_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
#undef SLSTM_REG_ARGS
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
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
