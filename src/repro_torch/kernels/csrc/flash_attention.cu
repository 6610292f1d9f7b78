// Flash attention forward for Hopper: online-softmax attention with a
// causal mask, a sliding window, a query offset and grouped KV heads.
//
// Replaces the Pallas TPU kernel _attn_kernel / flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py). There the grid was
// (B*H, Sq/bq, Skv/bk) with the KV blocks sequential, the output tile and
// the running max m and normaliser l kept in VMEM scratch between grid
// steps. Here one thread block owns one (b, h, q-tile) and loops over the
// KV tiles itself; the running m, l and the output rows stay in registers
// for the whole loop, and only the output is written to device memory.
//
// What bounds it on an H100: at prefill shapes (S = 128, D = 64) each
// (b, h) reads its q, k and v once and does about 2*S*D operations per
// element read, far under the bf16 ridge, so it is bytes and, at such
// small sizes, launch latency. The design reads q once per block and
// each k/v tile once per block into shared memory, converts to f32 there
// (the reference's math is f32), skips the KV tiles that the causal mask
// or the window excludes for every row of the block, and never writes
// the score matrix to device memory. The products run on the CUDA cores
// in f32; moving them to the tensor cores (P rounded to bf16, as the
// usual flash kernels do) is a later change.
//
// Head dims 32, 64, 80 (zamba2's shared attention), 128 and 256 are
// built. Layouts are the JAX package's public ones, read through strides:
// q, o (B, Sq, H, D) and k, v (B, Skv, KVH, D); query head h reads KV
// head h / (H / KVH). Sq and Skv may be any length (tails are masked).
// The window test k > q - window runs in 64-bit integers, so the global
// sentinel 2**30 cannot overflow. Masked scores take the reference's
// NEG_INF, so a row with no visible key returns the mean of v over Skv,
// as attention_ref does; keys past Skv are excluded outright.
//
// C interface (loaded with ctypes): flash_attention_launch returns the
// CUDA error code of the launch. dtype codes: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // ref.py NEG_INF
constexpr int NT = 256;                                    // threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

struct Strides {  // element strides of a (batch, seq, head, dim=1) tensor
  int64_t b, s, h;
};

struct Args {
  int B, H, KVH, Sq, Skv;
  Strides q, k, v, o;
  float scale;
  int causal;
  int64_t window, q_offset;
};

// Block tile: BT query rows and BT keys per KV step. Row i of the tile is
// owned by the TPR = NT / BT consecutive threads [i*TPR, (i+1)*TPR): they
// compute that row's scores, its softmax statistics and its output slice,
// so m, l and the output never leave registers.
template <typename T, int D, int BT>
__global__ void __launch_bounds__(NT) flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v, T* __restrict__ o,
                                                Args a) {
  constexpr int TPR = NT / BT;   // threads per row
  constexpr int SPT = BT / TPR;  // scores per thread per KV step
  constexpr int DPT = D / TPR;   // output columns per thread
  static_assert(D % TPR == 0, "head dim does not split over a row's threads");
  constexpr int LDQ = D + 1, LDK = D + 1, LDV = D, LDS = BT + 1;

  extern __shared__ float smem[];
  float* Qs = smem;              // [BT][LDQ], pre-scaled
  float* Ks = Qs + BT * LDQ;     // [BT][LDK]
  float* Vs = Ks + BT * LDK;     // [BT][LDV]
  float* Ps = Vs + BT * LDV;     // [BT][LDS]

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KVH);
  const int row = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const int64_t qi = (int64_t)q0 + row + a.q_offset;  // this row's absolute position

  const T* qb = q + b * a.q.b + h * a.q.h;
  const T* kb = k + b * a.k.b + kh * a.k.h;
  const T* vb = v + b * a.v.b + kh * a.v.h;

  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    int r = idx / D, d = idx % D;
    Qs[r * LDQ + d] = (q0 + r < a.Sq) ? to_f32(qb[(q0 + r) * a.q.s + d]) * a.scale : 0.f;
  }

  // Visible keys of position p: [max(0, p - window + 1), causal ? min(Skv, p + 1) : Skv).
  // If every row of the tile sees at least one key, tiles outside the union
  // of those ranges contribute exactly nothing and are skipped; otherwise
  // (a row with no visible key takes the mean of v) all tiles are visited.
  int64_t kv_lo = 0, kv_hi = a.Skv;
  {
    const int rows = a.Sq - q0 < BT ? a.Sq - q0 : BT;
    bool all_live = true;
    for (int r = 0; r < rows && all_live; ++r) {
      int64_t p = (int64_t)q0 + r + a.q_offset;
      int64_t lo = imax(0, p - a.window + 1);
      int64_t hi = a.causal ? imin(a.Skv, p + 1) : a.Skv;
      all_live = lo < hi;
    }
    if (all_live) {
      int64_t p0 = (int64_t)q0 + a.q_offset, p1 = (int64_t)q0 + rows - 1 + a.q_offset;
      kv_lo = imax(0, p0 - a.window + 1);
      kv_hi = a.causal ? imin(a.Skv, p1 + 1) : a.Skv;
    }
  }

  float m = NEG_INF, l = 0.f, acc[DPT];
#pragma unroll
  for (int u = 0; u < DPT; ++u) acc[u] = 0.f;

  for (int64_t k0 = (kv_lo / BT) * BT; k0 < kv_hi; k0 += BT) {
    __syncthreads();  // Qs is ready; the previous step's Ks/Vs/Ps are consumed
    for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
      int j = idx / D, d = idx % D;
      bool in = k0 + j < a.Skv;
      Ks[j * LDK + d] = in ? to_f32(kb[(k0 + j) * a.k.s + d]) : 0.f;
      Vs[j * LDV + d] = in ? to_f32(vb[(k0 + j) * a.v.s + d]) : 0.f;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int t = 0; t < SPT; ++t) s[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qd = Qs[row * LDQ + d];
#pragma unroll
      for (int t = 0; t < SPT; ++t) s[t] = fmaf(qd, Ks[(lane + TPR * t) * LDK + d], s[t]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < SPT; ++t) {
      int64_t kj = k0 + lane + TPR * t;
      bool visible = (!a.causal || kj <= qi) && (kj > qi - a.window);
      s[t] = kj >= a.Skv ? -INFINITY : (visible ? s[t] : NEG_INF);
      mx = fmaxf(mx, s[t]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < SPT; ++t) {
      float p = expf(s[t] - m_new);  // exp(-inf) = 0 for keys past Skv
      Ps[row * LDS + lane + TPR * t] = p;
      sum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // the row's P is written by threads of this warp only

#pragma unroll
    for (int u = 0; u < DPT; ++u) acc[u] *= corr;
    for (int j = 0; j < BT; ++j) {
      float p = Ps[row * LDS + j];
#pragma unroll
      for (int u = 0; u < DPT; ++u) acc[u] = fmaf(p, Vs[j * LDV + lane + TPR * u], acc[u]);
    }
  }

  if (q0 + row < a.Sq) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* ob = o + b * a.o.b + h * a.o.h + (int64_t)(q0 + row) * a.o.s;
#pragma unroll
    for (int u = 0; u < DPT; ++u) store(ob + lane + TPR * u, acc[u] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const Args& a,
           cudaStream_t s) {
  constexpr int BT = D <= 128 ? 64 : 32;
  constexpr size_t smem = sizeof(float) * BT * ((D + 1) * 2 + D + BT + 1);
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd<T, D, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)((a.Sq + BT - 1) / BT), (unsigned)a.H, (unsigned)a.B);
  flash_fwd<T, D, BT><<<grid, NT, smem, s>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o, const Args& a,
             cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, a, s);
    case 64: return launch<T, 64>(q, k, v, o, a, s);
    case 80: return launch<T, 80>(q, k, v, o, a, s);  // zamba2's shared attention
    case 128: return launch<T, 128>(q, k, v, o, a, s);
    case 256: return launch<T, 256>(q, k, v, o, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Strides are in elements; the last (head-dim) stride must be 1.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                           int KVH, int Sq, int Skv, int D, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss, long long ksh,
                           long long vsb, long long vss, long long vsh, long long osb,
                           long long oss, long long osh, float scale, int causal,
                           long long window, long long q_offset, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{B, H, KVH, Sq, Skv, {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
         {osb, oss, osh}, scale, causal, window, q_offset};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(D, q, k, v, o, a, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(D, q, k, v, o, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
