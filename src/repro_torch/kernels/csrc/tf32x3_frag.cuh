// Float32 products on the tensor cores in 3xTF32 with mma.sync m16n8k8, a
// warp at a time, operands read from float32 tiles in shared memory: the
// building blocks of the float32 flash attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu).
//
// 3xTF32 as tf32x3_tile.cuh does it: each operand x is split as hi =
// tf32(x) (two integer operations on the bits) and lo = x - hi, which the
// tensor cores read truncated to TF32; per k-step lo.hi and hi.lo go into a
// second accumulator and hi.hi into the main one, summed once at the end
// of the product (lo.lo, 2^-21 of the result, is dropped). Where a caller
// sums products over many tiles, it starts each tile's product from zero
// and adds it into its running float32 sum once a tile, so that a long sum
// never runs through the tensor cores' own accumulation (which truncates).
//
// Tiles are rows of W floats (W a multiple of 32), element (r, c) at r W +
// (c ^ swz(r)): the XOR moves 16-byte chunks whole within their 32-float
// group (so 16-byte cp.async copies fill them), and both fragment reads of
// product() fall on 32 distinct banks: a warp's 8 rows x 4 columns (an A
// operand, or a B operand stored transposed) and 4 rows x 8 columns (a B
// operand stored as it is). A product that contracts over a tile's rows
// reads the tile as it is, with no transposed copy.

#pragma once

#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace repro_tf32x3 {

__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

template <int W>
__device__ __forceinline__ int at(int r, int c) {
  return r * W + (c ^ swz(r));
}

// c (16 x 8) += a (16 x 8, TF32) . b (8 x 8, TF32), float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[m][n] (16 x 8, m < M, n < N) = A . B over K in 3xTF32. A is rows a_r0
// .. a_r0 + 16 M - 1 of the tile a (WA floats a row; a_r0 a multiple of
// 16), its columns 0 .. K - 1. B_KN: B's rows are the tile b's rows 0 .. K -
// 1 and its columns the tile's columns b0 + 8 n .. (b0 a multiple of 32);
// else B is stored transposed: B's column 8 n + j is the tile's row b0 + 8 n
// + j (b0 a multiple of 8) and B's rows the tile's columns 0 .. K - 1.
// Operands are split as they are read, each B fragment once for the M
// m-tiles. The result as mma.sync lays it out: element e of c[m][n] at row
// a_r0 + 16 m + lane / 4 + 8 (e / 2), column 8 n + 2 (lane % 4) + e % 2.
// The k-steps run 32 deep a loop iteration, so that the registers a
// product holds stay those of one iteration.
template <int M, int N, int K, int WA, int WB, bool B_KN>
__device__ __forceinline__ void product_m(float (&c)[M][N][4], const float* a, int a_r0,
                                          const float* b, int b0, int lane) {
  static_assert(K % 32 == 0 && WA % 32 == 0 && WB % 32 == 0, "32-deep steps, 32-float rows");
  const int gq = lane >> 2, t = lane & 3;
  const int sw = swz(gq);
  float sm[M][N][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][n][e] = sm[m][n][e] = 0.f;
  const float* ar = a + (a_r0 + gq) * WA;
  // B stored: rows k + t and k + t + 4 (their swizzles 8 t and 8 t + 4)
  const float* b_lo = b + t * WB + b0 + gq;
  const float* b_hi = b + (t + 4) * WB + b0 + (gq ^ 4);
  // B stored transposed: row b0 + 8 n + gq, swizzled as A's rows
  const float* bt = b + (b0 + gq) * WB;
#pragma unroll 1
  for (int kk = 0; kk < K; kk += 32) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // column kk + 8 q + t of a row of a (or of B^T), and + 4 = ca ^ 4
      const int ca = kk + ((8 * q + t) ^ sw);
      uint32_t ah[M][4], al[M][4];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float* am = ar + 16 * m * WA;
        split_tf32(am[ca], ah[m][0], al[m][0]);
        split_tf32(am[8 * WA + ca], ah[m][1], al[m][1]);
        split_tf32(am[ca ^ 4], ah[m][2], al[m][2]);
        split_tf32(am[8 * WA + (ca ^ 4)], ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float x0, x1;
        if constexpr (B_KN) {
          const int cb = (kk + 8 * q) * WB + 32 * (n >> 2) + 8 * ((n & 3) ^ t);
          x0 = b_lo[cb];
          x1 = b_hi[cb];
        } else {
          x0 = bt[8 * n * WB + ca];
          x1 = bt[8 * n * WB + (ca ^ 4)];
        }
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(x0, bh0, bl0);
        split_tf32(x1, bh1, bl1);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          mma_tf32(sm[m][n], al[m], bh0, bh1);
          mma_tf32(sm[m][n], ah[m], bl0, bl1);
          mma_tf32(c[m][n], ah[m], bh0, bh1);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][n][e] += sm[m][n][e];
}

// product_m over one m-tile: c[n] at row a_r0 + lane / 4 + 8 (e / 2)
template <int N, int K, int WA, int WB, bool B_KN>
__device__ __forceinline__ void product(float (&c)[N][4], const float* a, int a_r0,
                                        const float* b, int b0, int lane) {
  product_m<1, N, K, WA, WB, B_KN>(reinterpret_cast<float(&)[1][N][4]>(c), a, a_r0, b, b0,
                                   lane);
}

// Copies rows [row0, row0 + R) of a (rows, W) float32 matrix into a
// swizzled tile with 16-byte cp.async copies (THREADS threads); rows past
// n_rows are zeros.
template <int W, int R, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n_rows) {
  constexpr int CPR = W / 4;   // 16-byte chunks a row
#pragma unroll 4
  for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * 4;
    const bool valid = row0 + r < n_rows;
    cp_async16(dst + at<W>(r, c), valid ? src + (size_t)(row0 + r) * W + c : src, valid);
  }
}

// Copies src[row0 .. row0 + R) (zeros past n_rows) with 4-byte cp.async
// copies.
template <int R, int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int n_rows) {
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const bool valid = row0 + r < n_rows;
    cp_async4(dst + r, valid ? src + row0 + r : src, valid);
  }
}

}  // namespace repro_tf32x3
