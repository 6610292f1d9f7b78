// Decode attention for Hopper: one query token of every head against a
// KV cache, split over the cache's slots (flash-decoding).
//
// Replaces no Pallas kernel. The reference's decode_attention
// (src/repro/kernels/flash_attention/ops.py:106-159) is two jnp einsums
// that XLA compiles into batched GEMVs; the port's plain version
// (kernels/flash_attention/ops.py::decode_attention_ref) casts the whole
// cache to f32 on every call and issues ~15 ops. Per batch row b, query
// head h (KV head h / g, g = H / KVH) and visible slot s:
//
//   q'     = round_q(float(q[b, h]) * scale)      (q's dtype, as the reference)
//   x_s    = sum_d q'_d k[b, s, h / g, d]          (f32)
//   o[b,h] = sum_s softmax(x)_s v[b, s, h / g, :]
//
// over the slots lo <= s < hi, hi = min(length_b, S), lo = max(0, length_b -
// window): the window holds the newest slot. A row with no visible slot
// gives exact zeros (and lse -inf). Slots outside [lo, hi) are never read.
//
// What bounds it on an H100: bytes. Each visible K and V row is read once
// (2 D bytes a bf16 row) and each query head does 4 D flops on it, g flops
// a byte at most: far below the card's ~20 f32 flops a byte.
//
// The design: a block takes one (batch, KV head) pair and one of nsplit
// equal slices of that row's visible slots, and every query head of that
// KV head, so each K and V row is read once, in its storage dtype, with
// f32 accumulation. 128 threads walk the slice in tiles of 128 slots:
// each thread forms the g scores of one slot (16-byte loads of its K row,
// q' in shared memory), the block takes each head's max (online softmax),
// and then threads own output columns (D < 128: the tile's slots split
// over 128 / D groups) and sum p V over the tile from V rows the block
// stages in shared memory (coalesced 16-byte loads, all in flight at once:
// a thread walking the slots with a load each waits on every one of them).
// With nsplit = 1 the block writes o (and lse); otherwise each block
// writes its unnormalised sum, max and denominator, and a second launch
// (decode_combine, one block per (batch, head)) joins the slices by their
// maxima. nsplit is chosen by the wrapper from the shapes alone, so the
// grid never depends on the lengths, which may live on the device and are
// read here, never by the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads a block, and slots a tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;       // (B, H, D) contiguous, f32 or bf16 (out_f32)
  float* lse;    // (B, H) f32 or null
  float* part;   // (nsplit, B, H, D + 2) f32 when nsplit > 1
  int B, H, KVH, S, g, nsplit;
  long long qsb, qsh, qsd, ksb, kss, ksh, vsb, vss, vsh;
  long long length;       // when lengths is null
  const void* lengths;    // per-batch lengths (int32 or int64) on the device, or null
  int lengths_i64;
  long long lengths_stride;
  long long window;
  float scale;
  int q_bf16, out_f32;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The row's visible slots [lo, hi).
__device__ __forceinline__ void visible(const Args& a, int b, long long& lo, long long& hi) {
  long long len = a.length;
  if (a.lengths != nullptr)
    len = a.lengths_i64 ? ((const long long*)a.lengths)[b * a.lengths_stride]
                        : (long long)((const int*)a.lengths)[b * a.lengths_stride];
  hi = len < a.S ? len : (long long)a.S;
  lo = len - a.window;
  lo = lo > 0 ? lo : 0;
  if (hi < lo) hi = lo;
}

// Loads 8 (bf16) or 4 (f32) consecutive elements as floats, 16 bytes.
template <typename KT>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __low2float(h[i]);
      out[2 * i + 1] = __high2float(h[i]);
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  }
};

template <typename KT, int D, int GM>
__global__ void __launch_bounds__(NT) decode_split(Args a) {
  constexpr int NCOL = D < NT ? D : NT;  // output columns a group of threads covers
  constexpr int KS = NT / NCOL;          // groups, each summing every KS-th slot of a tile
  constexpr int CPT = D / NCOL;          // columns a thread owns
  // V rows staged at a time (16 KiB), and their 16-byte vectors a row
  constexpr int VC_FIT = 16384 / (D * (int)sizeof(KT));
  constexpr int VC = VC_FIT >= 64 ? 64 : (VC_FIT >= 32 ? 32 : 16);
  constexpr int VPR = D * (int)sizeof(KT) / 16;
  __shared__ __align__(16) float qs[GM][D];
  __shared__ __align__(16) KT vs[VC][D];
  __shared__ float ps[GM][NT];
  __shared__ float red[NT / 32][GM];
  __shared__ float xacc[KS > 1 ? KS : 1][KS > 1 ? GM * D + GM : 1];

  const int split = blockIdx.x;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;
  const int g = a.g;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  // q' = round_q(float(q) * scale), as floats
  for (int i = t; i < g * D; i += NT) {
    const int hh = i / D, d = i % D;
    const long long off = b * a.qsb + (long long)(kvh * g + hh) * a.qsh + d * a.qsd;
    float x;
    if (a.q_bf16) {
      x = __fmul_rn(__bfloat162float(((const __nv_bfloat16*)a.q)[off]), a.scale);
      x = __bfloat162float(__float2bfloat16_rn(x));
    } else {
      x = __fmul_rn(((const float*)a.q)[off], a.scale);
    }
    qs[hh][d] = x;
  }
  long long lo, hi;
  visible(a, b, lo, hi);
  const long long n = hi - lo;
  const long long s_lo = lo + n * split / a.nsplit, s_hi = lo + n * (split + 1) / a.nsplit;
  const KT* kbase = (const KT*)a.k + b * a.ksb + kvh * a.ksh;
  const KT* vbase = (const KT*)a.v + b * a.vsb + kvh * a.vsh;

  const int c0 = t % NCOL, ks = t / NCOL;
  float m[GM], l[GM], acc[GM][CPT];
#pragma unroll
  for (int h = 0; h < GM; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[h][j] = 0.f;
  }
  __syncthreads();

  for (long long t0 = s_lo; t0 < s_hi; t0 += NT) {
    const long long s = t0 + t;
    const bool valid = s < s_hi;
    float sc[GM];
#pragma unroll
    for (int h = 0; h < GM; ++h) sc[h] = 0.f;
    if (valid) {
      const KT* krow = kbase + s * a.kss;
#pragma unroll 4
      for (int d = 0; d < D; d += Vec<KT>::N) {
        float kf[Vec<KT>::N];
        Vec<KT>::load(krow + d, kf);
#pragma unroll
        for (int h = 0; h < GM; ++h) {
          if (h < g) {
#pragma unroll
            for (int i = 0; i < Vec<KT>::N; i += 4) {  // q' as 16-byte broadcasts
              const float4 qv = *reinterpret_cast<const float4*>(&qs[h][d + i]);
              sc[h] = fmaf(qv.x, kf[i], sc[h]);
              sc[h] = fmaf(qv.y, kf[i + 1], sc[h]);
              sc[h] = fmaf(qv.z, kf[i + 2], sc[h]);
              sc[h] = fmaf(qv.w, kf[i + 3], sc[h]);
            }
          }
        }
      }
    }
    // each head's max over the tile's valid slots
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      if (h < g) {
        float x = valid ? sc[h] : -INFINITY;
        for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
        if (lane == 0) red[warp][h] = x;
      }
    }
    __syncthreads();
    float alpha[GM];
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      if (h < g) {
        float mx = red[0][h];
#pragma unroll
        for (int w = 1; w < NT / 32; ++w) mx = fmaxf(mx, red[w][h]);
        const float mn = fmaxf(m[h], mx);  // finite: slot t0 is valid
        alpha[h] = expf(m[h] - mn);       // 0 on the first tile
        m[h] = mn;
        ps[h][t] = valid ? expf(sc[h] - mn) : 0.f;
      }
    }
    __syncthreads();
    const int nt = (int)((s_hi - t0) < NT ? (s_hi - t0) : NT);
    if (ks < KS) {
#pragma unroll
      for (int h = 0; h < GM; ++h) {
        if (h < g) {
          l[h] *= alpha[h];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[h][j] *= alpha[h];
        }
      }
    }
    // p V over the tile, VC slots at a time: the block copies their V rows
    // into shared memory (16-byte loads, all in flight at once), then each
    // thread sums its columns over its group's slots from there
    for (int c = 0; c < nt; c += VC) {
      const int nc = nt - c < VC ? nt - c : VC;
      for (int e = t; e < nc * VPR; e += NT) {
        const int r = e / VPR, x = e % VPR;
        reinterpret_cast<uint4*>(&vs[r][0])[x] =
            *reinterpret_cast<const uint4*>(vbase + (t0 + c + r) * a.vss + x * (16 / sizeof(KT)));
      }
      __syncthreads();
      if (ks < KS) {
#pragma unroll 4
        for (int i = ks; i < nc; i += KS) {
          float vf[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) vf[j] = to_f(vs[i][c0 + j * NCOL]);
#pragma unroll
          for (int h = 0; h < GM; ++h) {
            if (h < g) {
              const float p = ps[h][c + i];
              l[h] += p;
#pragma unroll
              for (int j = 0; j < CPT; ++j) acc[h][j] = fmaf(p, vf[j], acc[h][j]);
            }
          }
        }
      }
      __syncthreads();  // vs, and after the last chunk ps and red, are rewritten next
    }
  }

  if constexpr (KS > 1) {  // the groups' sums, joined in a fixed order by group 0
    if (ks > 0) {
#pragma unroll
      for (int h = 0; h < GM; ++h) {
        if (h < g) {
          xacc[ks][h * D + c0] = acc[h][0];
          if (c0 == 0) xacc[ks][GM * D + h] = l[h];
        }
      }
    }
    __syncthreads();
    if (ks == 0) {
      for (int r = 1; r < KS; ++r) {
#pragma unroll
        for (int h = 0; h < GM; ++h) {
          if (h < g) {
            acc[h][0] += xacc[r][h * D + c0];
            l[h] += xacc[r][GM * D + h];
          }
        }
      }
    }
  }
  if (ks != 0) return;

  const int hq0 = kvh * g;
  if (a.nsplit == 1) {
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      if (h < g) {
        const long long row = (long long)b * a.H + hq0 + h;
        const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float x = l[h] > 0.f ? acc[h][j] * inv : 0.f;
          const long long off = row * D + c0 + j * NCOL;
          if (a.out_f32)
            ((float*)a.o)[off] = x;
          else
            ((__nv_bfloat16*)a.o)[off] = __float2bfloat16_rn(x);
        }
        if (a.lse != nullptr && c0 == 0) a.lse[row] = l[h] > 0.f ? m[h] + logf(l[h]) : -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      if (h < g) {
        float* out = a.part + (((long long)split * a.B + b) * a.H + hq0 + h) * (D + 2);
#pragma unroll
        for (int j = 0; j < CPT; ++j) out[c0 + j * NCOL] = acc[h][j];
        if (c0 == 0) {
          out[D] = m[h];
          out[D + 1] = l[h];
        }
      }
    }
  }
}

// One block per (batch, head): the slices joined by their maxima.
__global__ void __launch_bounds__(NT) decode_combine(Args a, int D) {
  const long long row = blockIdx.x;
  const long long stride = (long long)a.B * a.H * (D + 2);
  const float* p = a.part + row * (D + 2);
  float mx = -INFINITY;
  for (int j = 0; j < a.nsplit; ++j)
    if (p[j * stride + D + 1] > 0.f) mx = fmaxf(mx, p[j * stride + D]);
  float den = 0.f;
  for (int j = 0; j < a.nsplit; ++j) {
    const float lj = p[j * stride + D + 1];
    if (lj > 0.f) den += expf(p[j * stride + D] - mx) * lj;
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  for (int c = threadIdx.x; c < D; c += NT) {
    float x = 0.f;
    for (int j = 0; j < a.nsplit; ++j) {
      const float lj = p[j * stride + D + 1];
      if (lj > 0.f) x = fmaf(expf(p[j * stride + D] - mx), p[j * stride + c], x);
    }
    x = den > 0.f ? x * inv : 0.f;
    if (a.out_f32)
      ((float*)a.o)[row * D + c] = x;
    else
      ((__nv_bfloat16*)a.o)[row * D + c] = __float2bfloat16_rn(x);
  }
  if (a.lse != nullptr && threadIdx.x == 0) a.lse[row] = den > 0.f ? mx + logf(den) : -INFINITY;
}

template <typename KT, int D>
cudaError_t launch_d(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.g <= 1)
    decode_split<KT, D, 1><<<grid, NT, 0, st>>>(a);
  else if (a.g <= 4)
    decode_split<KT, D, 4><<<grid, NT, 0, st>>>(a);
  else if (a.g <= 8)
    decode_split<KT, D, 8><<<grid, NT, 0, st>>>(a);
  else
    decode_split<KT, D, 16><<<grid, NT, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t launch_kt(const Args& a, int D, dim3 grid, cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<KT, 32>(a, grid, st);
    case 64: return launch_d<KT, 64>(a, grid, st);
    case 80: return launch_d<KT, 80>(a, grid, st);
    case 128: return launch_d<KT, 128>(a, grid, st);
    case 256: return launch_d<KT, 256>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The largest GQA group a block takes.
int decode_attention_max_group() { return 16; }

// q (B, 1, H, D) by its (b, h, d) strides, f32 or bf16 (q_bf16); k, v (B,
// S, KVH, D) by their (b, s, h) strides with unit d stride, both f32 or
// both bf16 (kv_bf16), 16-byte aligned rows; o (B, H, D) contiguous, f32
// (out_f32) or bf16; lse (B, H) f32 or null; part: nsplit x B x H x (D + 2)
// f32 scratch when nsplit > 1. lengths: null (every row's length is
// length) or a device vector of int32 / int64 (lengths_i64) read at
// b * lengths_stride. window: slots kept before the newest (huge: none).
int decode_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                            void* part, int B, int H, int KVH, int S, int D, long long qsb,
                            long long qsh, long long qsd, long long ksb, long long kss,
                            long long ksh, long long vsb, long long vss, long long vsh,
                            long long length, const void* lengths, int lengths_i64,
                            long long lengths_stride, long long window, float scale, int q_bf16,
                            int kv_bf16, int out_f32, int nsplit, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > 16 || S < 0 || nsplit < 1 ||
      (long long)B * KVH > 65535 || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, (float*)lse, (float*)part, B, H, KVH, S, H / KVH, nsplit,
         qsb, qsh, qsd, ksb, kss, ksh, vsb, vss, vsh, length, lengths, lengths_i64,
         lengths_stride, window, scale, q_bf16, out_f32};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(nsplit, B * KVH);
  cudaError_t err = kv_bf16 ? launch_kt<__nv_bfloat16>(a, D, grid, st)
                            : launch_kt<float>(a, D, grid, st);
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  decode_combine<<<B * H, NT, 0, st>>>(a, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
