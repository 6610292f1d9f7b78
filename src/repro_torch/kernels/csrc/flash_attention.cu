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
// What bounds it on an H100: at prefill shapes (S = 128, D 64 or 80) each
// (b, h) reads its q, k and v once and does about 2*S*D operations per
// element read, far under the bf16 ridge: bytes and, at such small sizes,
// the latency of a few dependent loads. Two variants, picked per call by
// the wrapper's plan (ops.py):
//
// mma (bf16 operands, 16-byte aligned rows: both serving paths). The
// FlashAttention-2 forward: a block of 2 warps owns 32 query rows (so
// smollm's 4 x 9 heads x 4 tiles are 144 blocks on 132 SMs), each warp 16
// of them. K and V tiles of 64 keys (32 at D 256) come in 16-byte cp.async
// copies into a two-stage ring, the first two issued together and then
// the next in flight while this one computes; rows are padded by 16
// bytes so ldmatrix reads hit distinct
// banks (D 80's 160-byte rows included). S = Q K^T runs in
// mma.sync.m16n8k16 (bf16 in, f32 out: the products of bf16 operands are
// exact, as in the f32 kernel) with fragments from ldmatrix, and stays in
// registers; the scale, the masks and the online softmax run on those
// fragments (row max and sum over a quad, two shuffles). P then feeds
// P V straight from registers: the accumulators of two neighbouring key
// tiles are the A fragment of the next product. P is f32 in the
// reference, so it is split into three bf16 terms (hi, mid, lo: 24 bits,
// f32's own precision) and P V issues three products into one f32
// accumulator; two terms leave 2**-16 of P, which on rows with few keys
// comes close to the gate's 1e-5 absolute slack. The query tiles run
// heaviest first (the last tiles see the most keys under the causal
// mask). mma.sync rather than wgmma: the tiles are 16-32 rows and the
// bound is bytes; the tensor cores' rate is a hundred times the need.
//
// fma (f32 operands, and any layout mma cannot take): one thread block
// owns one (b, h, q-tile) and reads q once and each k/v tile once into
// shared memory, converts to f32 there, and runs the products on the
// CUDA cores in f32.
//
// Both skip the KV tiles that the causal mask or the window excludes for
// every row of the block, and never write the score matrix to device
// memory. Given an lse pointer (training: the backward in
// flash_attention_bwd.cu recomputes p from it), both also store each
// row's log-sum-exp m + log(l) of the scaled scores, (B, H, Sq) f32, with
// the reference's l == 0 guard (chunked.py _fwd_impl); a null pointer
// (serving) stores nothing.
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

#include "mma_util.cuh"

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
  float* lse;  // (B, H, Sq) log-sum-exp of the scaled scores, or null
};

// Visible keys of position p: [max(0, p - window + 1), causal ? min(Skv, p + 1) : Skv).
// If every row of the tile [q0, q0 + bt) sees at least one key, tiles outside
// the union of those ranges contribute exactly nothing and are skipped;
// otherwise (a row with no visible key takes the mean of v) all tiles are
// visited. Returns the keys [lo, hi) a tile must visit.
__device__ __forceinline__ void kv_range(const Args& a, int q0, int bt, int64_t& kv_lo,
                                         int64_t& kv_hi) {
  kv_lo = 0;
  kv_hi = a.Skv;
  const int rows = a.Sq - q0 < bt ? a.Sq - q0 : bt;
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

  int64_t kv_lo, kv_hi;
  kv_range(a, q0, BT, kv_lo, kv_hi);

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
    const float l_safe = l == 0.f ? 1.f : l, inv = 1.f / l_safe;
    T* ob = o + b * a.o.b + h * a.o.h + (int64_t)(q0 + row) * a.o.s;
#pragma unroll
    for (int u = 0; u < DPT; ++u) store(ob + lane + TPR * u, acc[u] * inv);
    if (a.lse != nullptr && lane == 0)  // Qs was pre-scaled: m is in scaled units
      a.lse[((int64_t)b * a.H + h) * a.Sq + q0 + row] = m + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const Args& a,
           cudaStream_t s) {
  constexpr int BT = D <= 128 ? 64 : 32;
  constexpr size_t smem = sizeof(float) * BT * ((D + 1) * 2 + D + BT + 1);
  static thread_local bool configured = false;  // the cap, once per host thread
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

// ---------------------------------------------------------------------------
// mma: bf16 operands on the tensor cores (FlashAttention-2's forward)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 2;            // a warp owns 16 query rows
constexpr int MMA_BQ = 16 * MMA_WARPS;  // query rows per block
constexpr int MMA_NT = 32 * MMA_WARPS;
constexpr int P_TERMS = 3;              // bf16 terms of P in P V (see the note at the top)

template <int D>
struct MmaTile {
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys per KV step
  static constexpr int LD = D + 8;  // padded row: the 8 rows of an ldmatrix hit distinct banks
  // Q [BQ][LD], then a two-stage ring of K [BK][LD] and V [BK][LD]
  static constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)LD * (MMA_BQ + 4 * BK);
};

using bf16 = __nv_bfloat16;

template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_mma(const bf16* __restrict__ q,
                                                    const bf16* __restrict__ k,
                                                    const bf16* __restrict__ v,
                                                    bf16* __restrict__ o, Args a) {
  using namespace mma;
  constexpr int BK = MmaTile<D>::BK, LD = MmaTile<D>::LD;
  constexpr int KT = BK / 8;  // n8 tiles of S per KV step
  constexpr int DT = D / 8;   // n8 tiles of the output
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  static_assert(D % 16 == 0 && BK % 16 == 0 && DT % 2 == 0, "tile does not split into k16 steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + MMA_BQ * LD;                     // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                     // [2][BK][LD]

  // x runs over (b, h); y over the query tiles, the last (heaviest under
  // the causal mask) first, so the grid's tail holds the light tiles
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;
  const int kh = h / (a.H / a.KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;

  const bf16* qb = q + b * a.q.b + h * a.q.h;
  const bf16* kb = k + b * a.k.b + kh * a.k.h;
  const bf16* vb = v + b * a.v.b + kh * a.v.h;

  for (int idx = threadIdx.x; idx < MMA_BQ * CH; idx += MMA_NT) {
    const int r = idx / CH, c = idx % CH;
    const bool in = q0 + r < a.Sq;
    cp_async16(Qs + r * LD + c * 8, in ? qb + (int64_t)(q0 + r) * a.q.s + c * 8 : qb, in ? 16 : 0);
  }

  int64_t kv_lo, kv_hi;
  kv_range(a, q0, MMA_BQ, kv_lo, kv_hi);
  const int64_t kstart = (kv_lo / BK) * BK;
  const int ntiles = (int)((kv_hi - kstart + BK - 1) / BK);

  auto load_kv = [&](int t) {  // KV step t into stage t % 2; keys past Skv are zeros
    const int64_t k0 = kstart + (int64_t)t * BK;
    bf16* ks = Ks + (t & 1) * BK * LD;
    bf16* vs = Vs + (t & 1) * BK * LD;
    for (int idx = threadIdx.x; idx < BK * CH; idx += MMA_NT) {
      const int j = idx / CH, c = idx % CH;
      const bool in = k0 + j < a.Skv;
      cp_async16(ks + j * LD + c * 8, in ? kb + (k0 + j) * a.k.s + c * 8 : kb, in ? 16 : 0);
      cp_async16(vs + j * LD + c * 8, in ? vb + (k0 + j) * a.v.s + c * 8 : vb, in ? 16 : 0);
    }
  };
  // one copy group per KV step (empty past the last), the first with Q:
  // steps 0 and 1 are in flight at once, and waiting until one group is
  // in flight means step t has landed
  load_kv(0);
  cp_async_commit();
  if (ntiles > 1) load_kv(1);
  cp_async_commit();

  // this thread's rows of the warp's 16: g and g + 8, at absolute positions qi[0], qi[1]
  const int64_t qi[2] = {(int64_t)q0 + warp * 16 + g + a.q_offset,
                         (int64_t)q0 + warp * 16 + g + 8 + a.q_offset};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const LaneRC qa_at = a_rows(lane), kb_at = b_rows(lane), vb_at = b_cols(lane);
  const bf16* qrow = Qs + (warp * 16 + qa_at.r) * LD + qa_at.c;  // A: Q

  for (int t = 0; t < ntiles; ++t) {
    if (t >= 1) {
      __syncthreads();  // every warp is done with step t - 1's stage
      if (t + 1 < ntiles) load_kv(t + 1);  // in flight while this step computes
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();  // step t has landed
    const bf16* ks = Ks + (t & 1) * BK * LD;
    const bf16* vs = Vs + (t & 1) * BK * LD;
    const int64_t k0 = kstart + (int64_t)t * BK;

    // S = Q K^T: exact bf16 products summed in f32, in registers
    float s[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qrow + kk * 16);
#pragma unroll
      for (int n = 0; n < KT; n += 2) {
        uint32_t kf[4];  // b0, b1 of key tiles n and n + 1
        ldsm_x4(kf, ks + (n * 8 + kb_at.r) * LD + kk * 16 + kb_at.c);
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
      }
    }

    // scale, mask, and the online softmax on the fragments: a row's four
    // owners are the lanes of one quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t kj = k0 + n * 8 + 2 * tq + (e & 1), qp = qi[e >> 1];
        const bool visible = (!a.causal || kj <= qp) && (kj > qp - a.window);
        const float x = kj >= a.Skv ? -INFINITY : (visible ? s[n][e] * a.scale : NEG_INF);
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);  // exp(-inf) = 0 for keys past Skv
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: P's accumulators of key tiles 2kk, 2kk + 1 are the A
    // fragment of keys [16kk, 16kk + 16), split into P_TERMS bf16 terms
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4][P_TERMS];
      split_bf16<P_TERMS>(s[2 * kk][0], s[2 * kk][1], pa[0]);
      split_bf16<P_TERMS>(s[2 * kk][2], s[2 * kk][3], pa[1]);
      split_bf16<P_TERMS>(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2]);
      split_bf16<P_TERMS>(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t vf[4];  // b0, b1 of head-dim tiles n and n + 1
        ldsm_x4_t(vf, vs + (kk * 16 + vb_at.r) * LD + n * 8 + vb_at.c);
#pragma unroll
        for (int term = P_TERMS - 1; term >= 0; --term) {  // the small terms first
          const uint32_t af[4] = {pa[0][term], pa[1][term], pa[2][term], pa[3][term]};
          mma_bf16(acc[n], af, vf[0], vf[1]);
          mma_bf16(acc[n + 1], af, vf[2], vf[3]);
        }
      }
    }
  }

  // normalise, stage the warp's 16 rows in its own rows of Qs, and store
  // them in 16-byte pieces
  const float l_safe[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  const float inv[2] = {1.f / l_safe[0], 1.f / l_safe[1]};
  if (a.lse != nullptr && tq == 0) {  // a row's quad holds one m and l; s was scaled before the max
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < a.Sq) a.lse[((int64_t)b * a.H + h) * a.Sq + row] = m[r] + logf(l_safe[r]);
    }
  }
  bf16* os = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * LD + n * 8 + 2 * tq) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + n * 8 + 2 * tq) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = o + b * a.o.b + h * a.o.h;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH, row = q0 + warp * 16 + r;
    if (row < a.Sq)
      *reinterpret_cast<uint4*>(ob + (int64_t)row * a.o.s + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, const Args& a,
               cudaStream_t s) {
  constexpr size_t smem = MmaTile<D>::smem;
  static_assert(smem <= 232448, "shared memory of one block exceeds 227 KB");
  static thread_local bool configured = false;  // the cap, once per host thread
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    // all of the SM's 228 KB as shared memory, so that 4 blocks fit on an SM
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_mma<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long bh = (long long)a.B * a.H, nq = (a.Sq + MMA_BQ - 1) / MMA_BQ;
  if (bh > 2147483647LL || nq > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)bh, (unsigned)nq);
  flash_mma<D><<<grid, MMA_NT, smem, s>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                                          a);
  return (int)cudaGetLastError();
}

int launch_mma_d(int D, const void* q, const void* k, const void* v, void* o, const Args& a,
                 cudaStream_t s) {
  switch (D) {
    case 32: return launch_mma<32>(q, k, v, o, a, s);
    case 64: return launch_mma<64>(q, k, v, o, a, s);
    case 80: return launch_mma<80>(q, k, v, o, a, s);
    case 128: return launch_mma<128>(q, k, v, o, a, s);
    case 256: return launch_mma<256>(q, k, v, o, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Strides are in elements; the last (head-dim) stride must be 1. variant:
// 0 = fma (f32 or bf16, any strides), 1 = mma (bf16; bases 16-byte aligned
// and the other strides multiples of 8, as the wrapper's plan checks).
// lse: null, or a contiguous (B, H, Sq) f32 buffer for the log-sum-exp.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                           int B, int H, int KVH, int Sq, int Skv, int D, long long qsb,
                           long long qss, long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss, long long vsh,
                           long long osb, long long oss, long long osh, float scale, int causal,
                           long long window, long long q_offset, int dtype, int variant,
                           void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{B, H, KVH, Sq, Skv, {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
         {osb, oss, osh}, scale, causal, window, q_offset, (float*)lse};
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_mma_d(D, q, k, v, o, a, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_d<float>(D, q, k, v, o, a, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(D, q, k, v, o, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
