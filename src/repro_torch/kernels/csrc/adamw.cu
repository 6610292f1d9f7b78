// AdamW for Hopper: one in-place pass over each f32 leaf, and the
// per-leaf sum of squares that the global-norm clip reads.
//
// Replaces no Pallas kernel. The reference writes the step in jnp
// (src/repro/optim/adamw.py:58-85, global_norm and adamw_update), and XLA
// fuses it into one pass; the port's plain version (kernels/adamw/ref.py)
// runs about twelve elementwise passes over the f32 state of each leaf.
//
// adamw_update, per element, in the reference's order of operations and
// with every product and sum rounded on its own (no contraction into an
// FMA: the __f*_rn intrinsics), so that the result is the plain version's
// bit for bit given the same scale, lr, bc1 and bc2:
//
//   g  = float(g) * scale
//   m  = m * b1 + g * (1 - b1)
//   v  = v * b2 + (g * (1 - b2)) * g
//   u  = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
//   p  = p - u * lr
//
// scale, lr, bc1 and bc2 are f32 scalars on the device, read by pointer
// (no host sync, nothing copied per call); b1, b2, 1 - b1, 1 - b2, eps and
// wd are f32 values as torch rounds the Python floats.
//
// What bounds it on an H100: bytes. Each element reads p, g, m, v and
// writes p, m, v: 28 B for an f32 gradient (26 for bf16) and ~15 flops, so
// at 3.35 TB/s a leaf of n elements takes at least 28 n / 3.35e12 s. The
// design: one launch per leaf, a grid-stride loop with 16-byte loads and
// stores where every operand is contiguous and aligned, strided indexing
// (up to 8 dims) otherwise.
//
// sum_squares writes sum(float(x)^2) of one leaf into one f32 slot. No
// float atomics: each block sums a fixed set of elements in a fixed tree
// and stores its partial; the last block to finish (an int counter)
// sums the partials in a fixed tree, writes the slot and resets the
// counter. The result is the same on every run. The counter and the
// partials are a workspace the wrapper keeps per device and stream,
// zeroed once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 8;
constexpr int THREADS = 256;
constexpr int NORM_BLOCKS_MAX = 1024;

// A tensor's layout: sizes shared by the four operands, strides per operand.
struct Layout {
  int ndim;
  long long size[MAX_DIMS];
  long long stride[4][MAX_DIMS];  // p, g, m, v
};

struct Consts {
  float b1, b2, one_b1, one_b2, eps, wd;
};

__device__ __forceinline__ long long offset_of(long long i, const Layout& L, int t) {
  long long off = 0;
  for (int d = L.ndim - 1; d >= 0; --d) {
    const long long s = L.size[d];
    off += (i % s) * L.stride[t][d];
    i /= s;
  }
  return off;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void step(float& p, float g, float& m, float& v, float scale,
                                     float lr, float bc1, float bc2, const Consts& c) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(g, c.one_b1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(g, c.one_b2), g));
  float u = __fdiv_rn(m, bc1);
  u = __fdiv_rn(u, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps));
  u = __fadd_rn(u, __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(u, lr));
}

template <typename G>
__global__ void adamw_flat(float* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
                           float* __restrict__ v, long long n, bool vec,
                           const float* __restrict__ scale_p, const float* __restrict__ lr_p,
                           const float* __restrict__ bc1_p, const float* __restrict__ bc2_p,
                           Consts c) {
  const float scale = *scale_p, lr = *lr_p, bc1 = *bc1_p, bc2 = *bc2_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {  // four elements a thread a turn: 16-byte p, m, v, 8- or 16-byte g
    const long long n4 = n / 4;
    for (long long i = i0; i < n4; i += stride) {
      float4 pp = reinterpret_cast<float4*>(p)[i];
      float4 mm = reinterpret_cast<float4*>(m)[i];
      float4 vv = reinterpret_cast<float4*>(v)[i];
      float gg[4];
      if constexpr (sizeof(G) == 4) {
        const float4 t = reinterpret_cast<const float4*>(g)[i];
        gg[0] = t.x, gg[1] = t.y, gg[2] = t.z, gg[3] = t.w;
      } else {
        const uint2 t = reinterpret_cast<const uint2*>(g)[i];
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
        gg[0] = __low2float(lo), gg[1] = __high2float(lo);
        gg[2] = __low2float(hi), gg[3] = __high2float(hi);
      }
      step(pp.x, gg[0], mm.x, vv.x, scale, lr, bc1, bc2, c);
      step(pp.y, gg[1], mm.y, vv.y, scale, lr, bc1, bc2, c);
      step(pp.z, gg[2], mm.z, vv.z, scale, lr, bc1, bc2, c);
      step(pp.w, gg[3], mm.w, vv.w, scale, lr, bc1, bc2, c);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
    done = n4 * 4;
  }
  for (long long i = done + i0; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    step(pp, to_f(g[i]), mm, vv, scale, lr, bc1, bc2, c);
    p[i] = pp, m[i] = mm, v[i] = vv;
  }
}

template <typename G>
__global__ void adamw_strided(float* __restrict__ p, const G* __restrict__ g,
                              float* __restrict__ m, float* __restrict__ v, long long n,
                              Layout L, const float* __restrict__ scale_p,
                              const float* __restrict__ lr_p, const float* __restrict__ bc1_p,
                              const float* __restrict__ bc2_p, Consts c) {
  const float scale = *scale_p, lr = *lr_p, bc1 = *bc1_p, bc2 = *bc2_p;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long op = offset_of(i, L, 0), om = offset_of(i, L, 2), ov = offset_of(i, L, 3);
    float pp = p[op], mm = m[om], vv = v[ov];
    step(pp, to_f(g[offset_of(i, L, 1)]), mm, vv, scale, lr, bc1, bc2, c);
    p[op] = pp, m[om] = mm, v[ov] = vv;
  }
}

// The block's sum of its threads' values, in a fixed tree; valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < THREADS / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

template <typename T>
__global__ void sum_squares(const T* __restrict__ x, long long n, bool flat, Layout L,
                            float* __restrict__ partials, unsigned int* __restrict__ counter,
                            float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  __shared__ bool last;
  float s = 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float e = to_f(x[flat ? i : offset_of(i, L, 0)]);
    s = __fadd_rn(s, __fmul_rn(e, e));
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float t = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
    t = __fadd_rn(t, __ldcg(partials + b));
  __syncthreads();  // red is reused
  t = block_sum(t, red);
  if (threadIdx.x == 0) {
    *out = t;
    *counter = 0u;  // ready for the next launch on this stream
  }
}

int grid_for(long long n, int per_thread, int max_blocks) {
  long long b = (n + (long long)THREADS * per_thread - 1) / ((long long)THREADS * per_thread);
  return (int)(b < 1 ? 1 : (b > max_blocks ? max_blocks : b));
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int adamw_norm_blocks_max() { return NORM_BLOCKS_MAX; }

// p, m, v f32 and g f32 (g_bf16 = 0) or bf16 (1), n elements laid out
// by (ndim, sizes, strides): strides holds 4 x ndim element strides, of
// p, g, m, v in turn. flat = 1: all four contiguous, and vec = 1 when
// their bases are 16-byte aligned (g's 8-byte for bf16). scale, lr, bc1,
// bc2: device pointers to f32 scalars.
int adamw_launch(void* p, const void* g, void* m, void* v, long long n, int g_bf16, int flat,
                 int vec, int ndim, const long long* sizes, const long long* strides,
                 const void* scale, const void* lr, const void* bc1, const void* bc2, float b1,
                 float b2, float one_b1, float one_b2, float eps, float wd, void* stream) {
  if (n <= 0) return 0;
  if (ndim < 0 || ndim > MAX_DIMS) return (int)cudaErrorInvalidValue;
  const Consts c{b1, b2, one_b1, one_b2, eps, wd};
  cudaStream_t st = (cudaStream_t)stream;
  const float *sp = (const float*)scale, *lp = (const float*)lr, *b1p = (const float*)bc1,
              *b2p = (const float*)bc2;
  if (flat) {
    const int grid = grid_for(n, vec ? 4 : 1, 132 * 16);
    if (g_bf16)
      adamw_flat<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          (float*)p, (const __nv_bfloat16*)g, (float*)m, (float*)v, n, vec != 0, sp, lp, b1p,
          b2p, c);
    else
      adamw_flat<float><<<grid, THREADS, 0, st>>>((float*)p, (const float*)g, (float*)m,
                                                   (float*)v, n, vec != 0, sp, lp, b1p, b2p, c);
  } else {
    Layout L{};
    L.ndim = ndim;
    for (int d = 0; d < ndim; ++d) {
      L.size[d] = sizes[d];
      for (int t = 0; t < 4; ++t) L.stride[t][d] = strides[t * ndim + d];
    }
    const int grid = grid_for(n, 1, 132 * 16);
    if (g_bf16)
      adamw_strided<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          (float*)p, (const __nv_bfloat16*)g, (float*)m, (float*)v, n, L, sp, lp, b1p, b2p, c);
    else
      adamw_strided<float><<<grid, THREADS, 0, st>>>((float*)p, (const float*)g, (float*)m,
                                                     (float*)v, n, L, sp, lp, b1p, b2p, c);
  }
  return (int)cudaGetLastError();
}

// out (one f32) = sum of float(x)^2 over x's n elements, f32 (x_bf16 = 0)
// or bf16 (1), laid out by (ndim, sizes, strides) unless flat = 1
// (contiguous). partials: NORM_BLOCKS_MAX floats; counter: one unsigned
// int, 0 on entry and left 0.
int sum_squares_launch(const void* x, long long n, int x_bf16, int flat, int ndim,
                       const long long* sizes, const long long* strides, void* partials,
                       void* counter, void* out, void* stream) {
  if (ndim < 0 || ndim > MAX_DIMS) return (int)cudaErrorInvalidValue;
  Layout L{};
  L.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    L.size[d] = sizes[d];
    L.stride[0][d] = strides[d];
  }
  const int grid = grid_for(n, 8, NORM_BLOCKS_MAX);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    sum_squares<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, n, flat != 0, L, (float*)partials, (unsigned int*)counter,
        (float*)out);
  else
    sum_squares<float><<<grid, THREADS, 0, st>>>((const float*)x, n, flat != 0, L,
                                                 (float*)partials, (unsigned int*)counter,
                                                 (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
