// The layout the reg variants of slstm.cu and slstm_bwd.cu share: one
// block per (b, h) holds r[h] in registers for the whole walk. A thread
// holds CPT columns of r (rows, in the backward) over one of KS slices of
// the matvec's reduction index; lane = LG g + jj of a warp, so the KS
// slices g of one column group jj share a warp and their partial sums
// meet by shuffles. The vector the matvec reads (h, or dz) sits in shared
// memory with slice g starting at g STR, which puts the slices' float4
// reads on distinct banks. Each step's inputs come through a ring of
// NSTAGE steps in shared memory.

#pragma once

constexpr int KS = 4;           // slices of the matvec's reduction index; lane = LG g + jj
constexpr int CPT = 2;          // columns (rows) of r a thread holds
constexpr int LG = 32 / KS;     // column groups of a warp
constexpr int NSTAGE = 8;       // steps of inputs in the ring (NSTAGE - 1 in flight)
constexpr int REG_MAX_D = 192;  // registers: CPT * D / KS floats of r a thread

template <int D>
struct Reg {
  static constexpr int KPT = D / KS;                         // k of a slice
  static constexpr int STR = (KPT / 4) % 2 ? KPT : KPT + 4;  // slice g starts at g STR:
  static constexpr int HS = KS * STR;                        // 4 g STR / 16 distinct mod 8
  static constexpr int NT = D / CPT * KS, NW = NT / 32;      // threads, warps
  static_assert(D % 16 == 0 && D <= REG_MAX_D, "reg takes D a multiple of 16 up to REG_MAX_D");
  static __device__ __forceinline__ int pos(int j) { return j / KPT * STR + j % KPT; }
};

// the gates' sigmoid with the intrinsics (__expf, __fdividef: ~1e-6 of
// each output's scale on the card, under the 1e-4 gate)
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
