// The float32 CUDA-core tile loop of conv2d_im2col.cu's bfloat16 path
// (inputs widened to float32 as they are staged): C (BM x BN) += A (BM x K) . B (K x BN), accumulated in
// float32 registers, with both operands staged through shared memory in
// BK-deep slices.
//
// A block of NT = TX * TY threads owns a BM x BN output tile; thread (tx, ty)
// owns TM rows and TN columns of it, in chunks of 4: rows c * 4 * TX + tx * 4
// + 0..3 and columns c * 4 * TY + ty * 4 + 0..3, so each shared-memory read is
// one 16-byte load and neighbouring threads read neighbouring words. A is
// kept transposed in shared memory (As[k][m]), B as it is (Bs[k][n]); both
// rows are padded by 4 floats so that the transposing stores of the loaders
// spread over the banks.
//
// Two shared stages: while the block multiplies one slice, each thread holds
// the next slice's elements in registers (fetched from device memory before
// the multiply, stored after it), so a load's latency hides behind the
// multiply with one barrier per slice.
//
// The loaders are the caller's part:
//   fetch(k0, regs)  reads this thread's elements of slice k0 (0 outside the
//                    matrix or past the loop's last depth: the ragged edges
//                    are masked here, nothing is padded in device memory);
//   stash(smem, regs) writes them into a shared stage.

#pragma once

namespace repro_tile {

template <int TX_, int TY_, int TM_, int TN_>
struct Tile {
  static constexpr int TX = TX_, TY = TY_, TM = TM_, TN = TN_;
  static constexpr int NT = TX * TY;          // threads per block
  static constexpr int BM = TX * TM;          // output rows per block
  static constexpr int BN = TY * TN;          // output columns per block
  static constexpr int BK = 8;                // depth of one shared slice
  static constexpr int LDA = BM + 4;          // padded row of As[k][m]
  static constexpr int LDB = BN + 4;          // padded row of Bs[k][n]
  static constexpr int A_PER = BM * BK / NT;  // A elements each thread stages
  static constexpr int B_PER = BK * BN / NT;
  static constexpr int SMEM_FLOATS = 2 * BK * (LDA + LDB);
  static_assert(TM % 4 == 0 && TN % 4 == 0, "thread tiles are 4-wide chunks");
  static_assert(BM * BK % NT == 0 && BK * BN % NT == 0, "whole elements per thread");
};

// row (or column) of chunk c, element j for thread coordinate t along an
// axis with T threads
template <int T>
__device__ __forceinline__ int tile_pos(int c, int t, int j) {
  return c * 4 * T + t * 4 + j;
}

template <class Cfg>
__device__ __forceinline__ void tile_fma(const float* __restrict__ As,
                                         const float* __restrict__ Bs, int tx, int ty,
                                         float (&acc)[Cfg::TM][Cfg::TN]) {
#pragma unroll
  for (int kk = 0; kk < Cfg::BK; ++kk) {
    float a[Cfg::TM], b[Cfg::TN];
#pragma unroll
    for (int c = 0; c < Cfg::TM / 4; ++c) {
      const float4 v =
          *reinterpret_cast<const float4*>(As + kk * Cfg::LDA + tile_pos<Cfg::TX>(c, tx, 0));
      a[4 * c] = v.x; a[4 * c + 1] = v.y; a[4 * c + 2] = v.z; a[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < Cfg::TN / 4; ++c) {
      const float4 v =
          *reinterpret_cast<const float4*>(Bs + kk * Cfg::LDB + tile_pos<Cfg::TY>(c, ty, 0));
      b[4 * c] = v.x; b[4 * c + 1] = v.y; b[4 * c + 2] = v.z; b[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < Cfg::TM; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc = A . B over depths [k_begin, k_end) (k_begin a multiple of BK);
// smem holds SMEM_FLOATS floats (16-byte aligned)
template <class Cfg, class LoadA, class LoadB>
__device__ __forceinline__ void tile_loop(int k_begin, int k_end, LoadA& la, LoadB& lb,
                                          float* smem, int tx, int ty,
                                          float (&acc)[Cfg::TM][Cfg::TN]) {
  constexpr int A_STAGE = Cfg::BK * Cfg::LDA;
  constexpr int B_STAGE = Cfg::BK * Cfg::LDB;
  float* As = smem;                  // two stages of As, then two of Bs
  float* Bs = smem + 2 * A_STAGE;
#pragma unroll
  for (int i = 0; i < Cfg::TM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::TN; ++j) acc[i][j] = 0.f;

  float ra[Cfg::A_PER], rb[Cfg::B_PER];
  la.fetch(k_begin, ra);
  lb.fetch(k_begin, rb);
  la.stash(As, ra);
  lb.stash(Bs, rb);
  __syncthreads();
  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += Cfg::BK) {
    const bool more = k0 + Cfg::BK < k_end;
    if (more) {
      la.fetch(k0 + Cfg::BK, ra);
      lb.fetch(k0 + Cfg::BK, rb);
    }
    tile_fma<Cfg>(As + stage * A_STAGE, Bs + stage * B_STAGE, tx, ty, acc);
    if (more) {
      la.stash(As + (stage ^ 1) * A_STAGE, ra);
      lb.stash(Bs + (stage ^ 1) * B_STAGE, rb);
    }
    __syncthreads();   // the other stage is written; this one is free again
    stage ^= 1;
  }
}

}  // namespace repro_tile
