// Hopper (sm_90a) helpers shared by the wgmma variants of dos_matmul.cu
// and grouped_matmul.cu: mbarriers, TMA tile loads (2-D and 3-D tensor
// maps) and stores, the cluster barrier, shared-memory matrix descriptors
// with the 128-byte swizzle, the wgmma.mma_async instructions with f32
// accumulators, and, on the host, the tensor-map encoder.
//
// Shared-memory layout of a TMA box with the 128-byte swizzle: each row
// of the box's inner dimension (64 bf16, 128 bytes) is one 128-byte line;
// the swizzle permutes the line's 16-byte chunks by the row's index
// modulo 8, so a row stays in its own line and rows of 8 form 1 KB atoms.
// A descriptor (sw128_desc) names such a tile:
//   K-major (the k index runs along the line): SBO 1024 bytes between 8-row
//     groups of m (or n); LBO unused (16). A k16 step moves the start by 32
//     bytes.
//   MN-major (m or n runs along the line, k one row after the other): LBO
//     between 64-element chunks of m or n (one box: 64 rows of 128 bytes,
//     8 KB, when boxes sit one after the other), SBO 1024 bytes between
//     8-row groups of k. A k16 step moves the start by 16 rows, 2048 bytes.
// wgmma's transpose bits select MN-major: TA for A, TB for B.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 2-D tensor map at element coordinates (c0 inner, c1 outer).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 3-D tensor map at (c0 inner, c1, c2 outer).
__device__ __forceinline__ void tma_load3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A box of shared memory written to a 3-D (2-D) tensor map at (c0, c1,
// c2); the parts outside the tensor are not written. Completes asynchronously:
// bulk_commit() closes a group of such stores, bulk_wait_read<N>() waits
// until at most N groups still read shared memory, bulk_wait<N>() until
// at most N are unfinished.
__device__ __forceinline__ void tma_store3d(const CUtensorMap* map, const void* src, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store2d(const CUtensorMap* map, const void* src, int c0,
                                            int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" :: "n"(N) : "memory");
}

// A barrier over every thread of the thread-block cluster (release and
// acquire: shared-memory writes before it, local or remote, are visible
// after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (it cannot see that they are still being written)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A generic-proxy write to shared memory made visible to the async proxy
// (wgmma, TMA) that reads it next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#define D8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d(64 x N) += A(64 x 16) B(16 x N), both from shared memory; TB: B is
// MN-major, TA: A is MN-major (else K-major).
template <int N, int TB, int TA = 0> struct Wgmma;

template <int TB, int TA> struct Wgmma<64, TB, TA> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n\t}"
        : D8(0), D8(8), D8(16), D8(24)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TB, int TA> struct Wgmma<128, TB, TA> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n\t}"
        : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TB, int TA> struct Wgmma<192, TB, TA> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %98, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, %99, %100;\n\t}"
        : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72),
          D8(80), D8(88)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
#undef D8

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out
// its address, so the library needs no link against libcuda.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A tensor map of `rank` (2 or 3) dimensions, innermost first: dims in
// elements, the outer dimensions' strides in elements, box in elements;
// 128-byte swizzle, zero fill outside the tensor. bf16 unless f32.
inline bool encode_nd(EncodeTiled enc, CUtensorMap* map, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                      bool f32 = false) {
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], estr[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = strides[i] * (f32 ? 4 : 2);
  }
  return enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), d, s, b, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D bf16 tensor map: `inner` x `outer` elements, rows `ld` elements
// apart, box `box_inner` x `box_outer`.
inline bool encode2d(EncodeTiled enc, CUtensorMap* map, const void* base, uint64_t inner,
                     uint64_t outer, uint64_t ld, uint32_t box_inner, uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer}, strides[1] = {ld};
  const uint32_t box[2] = {box_inner, box_outer};
  return encode_nd(enc, map, base, 2, dims, strides, box);
}

// A 3-D tensor map: (d0 inner, d1, d2) elements, d1 rows s1 apart and d2
// planes s2 apart, box (b0, b1, 1).
inline bool encode3d(EncodeTiled enc, CUtensorMap* map, const void* base, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b0,
                     uint32_t b1, bool f32 = false) {
  const uint64_t dims[3] = {d0, d1, d2}, strides[2] = {s1, s2};
  const uint32_t box[3] = {b0, b1, 1};
  return encode_nd(enc, map, base, 3, dims, strides, box, f32);
}

}  // namespace sm90
