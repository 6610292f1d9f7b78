// Warp-level tensor-core helpers shared by the mma variants of
// flash_attention.cu and ssm_scan.cu: 16-byte asynchronous copies into
// shared memory, ldmatrix fragment loads, the bf16 m16n8k16 product with
// an f32 accumulator, and the split of an f32 operand into bf16 terms.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4):
//   A (16 x 16, 4 registers of 2 bf16): a0 = (row g, cols 2t, 2t+1),
//     a1 = (row g+8, cols 2t..), a2 = (row g, cols 2t+8..), a3 = (row g+8, cols 2t+8..)
//   B (16 x 8, 2 registers): b0 = (rows 2t, 2t+1, col g), b1 = (rows 2t+8, 2t+9, col g)
//   C, D (16 x 8, 4 f32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, ...)
// so the accumulators of two neighbouring n8 tiles are, element for
// element, the A fragment of the next product over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared without passing through registers; only
// the first `bytes` (0..16) are read, the rest of the 16 are zero-filled.
// Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// The same for 4 bytes (one f32; `bytes` 0 zero-fills it).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives (row g, cols 2t, 2t+1) of it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, transposed: register i receives (rows 2t, 2t+1, col g) of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Where a lane points an x4 ldmatrix, as (row, column) inside the 16 x 16
// block it loads, for each kind of fragment:
struct LaneRC {
  int r, c;
};
// A of a tile stored [m][k]: a0..a3 (rows 0-7 | 8-15, columns 0-7 | 8-15)
__device__ __forceinline__ LaneRC a_rows(int lane) { return {lane % 16, (lane / 16) * 8}; }
// A of a tile stored [k][m], loaded with ldsm_x4_t
__device__ __forceinline__ LaneRC a_cols(int lane) {
  return {lane % 8 + ((lane >> 4) & 1) * 8, ((lane >> 3) & 1) * 8};
}
// B of two n8 tiles of a tile stored [n][k]: b0, b1 of the first, b0, b1 of the second
__device__ __forceinline__ LaneRC b_rows(int lane) {
  return {lane % 8 + (lane / 16) * 8, ((lane / 8) % 2) * 8};
}
// B of two n8 tiles of a tile stored [k][n], loaded with ldsm_x4_t
__device__ __forceinline__ LaneRC b_cols(int lane) {
  return {lane % 8 + ((lane / 8) % 2) * 8, (lane / 16) * 8};
}

// d += A (16 x 16, bf16) B (16 x 8, bf16), products exact, sums in f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 in one register, x0 in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 of a register (as pack_bf16 lays them out) in f32, exactly.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Split the f32 pair (x0, x1) into TERMS bf16 pairs whose sum it is:
// term k = bf16(what terms 0..k-1 left), each subtraction exact in f32.
// Each term keeps 8 more significant bits (a bf16 rounding errs by at
// most 2**-8 of its input): two terms leave at most 2**-16 of |x|, three
// 2**-24, f32's own rounding.
template <int TERMS>
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t (&out)[TERMS]) {
#pragma unroll
  for (int k = 0; k < TERMS; ++k) {
    out[k] = pack_bf16(x0, x1);
    const float2 h = unpack_bf16(out[k]);
    x0 -= h.x;
    x1 -= h.y;
  }
}

}  // namespace mma
