// A float32 GEMM tile on the tensor cores in 3xTF32, shared by
// conv2d_im2col.cu's float32 path and matmul.cu's float32 path:
// C (128 x BN) = A (128 x K) . B (K x BN), with A and B staged through a
// STAGES-deep cp.async ring of BK-deep shared slices.
//
// 3xTF32. TF32 keeps 10 of float32's 23 significand bits, so one TF32
// product misses the float32 tolerance. Each operand is split as hi =
// tf32(x) (round to nearest, ties away) and lo = x - hi, which the tensor
// cores read as a TF32 value (truncated), so that hi + lo carries about 21
// bits of x. Every 8-deep k-step adds lo.hi and hi.lo into a float32
// accumulator of the small products and hi.hi into the main one; the two
// are summed once at the end, so two thirds of the accumulations, and of
// their rounding errors, stay off the main sum. The lo.lo product (2^-21 of the
// result) is dropped. Three tensor-core products still cost less than one
// float32 product on the CUDA cores: the card's TF32 peak is 495 TFLOP/s,
// its float32 peak 67.
//
// The products are wgmma m64nBNk8 (tf32 in, float32 accumulate): each of
// the block's two warpgroups owns 64 rows of the tile. wgmma reads TF32
// operands only K-major (there is no transpose bit below 16 bits), so:
// - A comes from registers, split as the fragments are read from shared
//   memory. Two staged layouts: As[k][m] (the conv's patch gather, rows
//   padded to BM + 8 floats) or As[m][k] (a row-major matrix copied as it
//   is, rows padded to BK + 4 floats); either padding puts a warp's 8 rows
//   x 4 depths of a fragment read on 32 distinct banks.
// - B comes from shared memory through wgmma descriptors: each slice's raw
//   B is split once into a hi and a lo tile, K-major rows of 32 TF32 values
//   (128 B) in the 128-byte swizzle. Two raw layouts: Bs[n][k] (the conv's
//   filters, rows padded to BK + 4) or Bs[k][n] (a row-major (K, N) matrix
//   copied as it is, rows padded to BN + 8); for the second the split pass
//   is also the transpose, each warp reading 8 columns x 4 depths (32 banks
//   at that padding) and writing them as 8 swizzled 16-byte chunks.
// A slice runs in two halves of two k-steps: a half's 6 products
// are issued asynchronously and half of the next slice's copies are issued
// while they run, so only one half's A fragments are held in registers
// (all four spilled past the 128 registers two blocks per SM allow). The hi
// part is rounded with two integer operations on the bits:
// cvt.rna.tf32.f32 gives the same value for finite x, but runs at a
// fraction of their rate, and as 32 conversions per thread and k-step it
// was the slowest part of the first version of this tile.
//
// The loaders are the part the caller supplies; each issues its thread's
// cp.async copies:
//   la.load(As_stage)        a whole A slice, slices in order 0, BK, 2 BK, ...
//                            (the patch gather advances its taps from call
//                            to call);
//   la.load_part<2>(As_stage, half)  half 0, then half 1, of the next slice;
//   lb.load(Bs_stage, k0)    B's slice at depth k0.
// Outside the matrix they copy zeros (cp.async with source size 0), so the
// ragged edges cost no branch on the data path.

#pragma once

#include <stdint.h>

namespace repro_tf32x3 {

// A_ROWS: A staged as As[m][k] (else As[k][m]); B_ROWS: raw B staged as
// Bs[k][n] (else Bs[n][k])
template <int BN_, bool A_ROWS_ = false, bool B_ROWS_ = false>
struct Tile {
  static constexpr int BM = 128, BN = BN_, BK = 32, STAGES = 3;
  static constexpr bool A_ROWS = A_ROWS_, B_ROWS = B_ROWS_;
  static constexpr int NT = 256;                       // two warpgroups
  static constexpr int ACC = BN / 2;                   // accumulator floats per thread
  static constexpr int LDA = A_ROWS ? BK + 4 : BM + 8;
  static constexpr int LDB = B_ROWS ? BN + 8 : BK + 4;   // 16-byte rows either way
  static constexpr int A_STAGE = A_ROWS ? BM * LDA : BK * LDA;
  static constexpr int B_STAGE = B_ROWS ? BK * LDB : BN * LDB;
  static constexpr int SPLIT = BN * BK;                // floats of B's hi (or lo) tile
  // B's hi and lo tiles (1024-byte aligned for the swizzle), the raw A and
  // B stages, and the slack to align the base
  static constexpr int SMEM_BYTES = 1024 + 4 * (2 * SPLIT + STAGES * (A_STAGE + B_STAGE));
  // blocks per SM the kernel's registers are held to (__launch_bounds__):
  // as many as the shared memory holds (228 KB an SM, 1 KB of it reserved
  // per block), at most 3. Left free, ptxas took more registers than two
  // blocks per SM leave at 64 filters, and one block per SM ran LeNet's
  // conv2 markedly slower on the H100; at 32 filters three blocks ran conv1
  // faster than two.
  static constexpr int FIT = 233472 / (SMEM_BYTES + 1024);
  static constexpr int MIN_BLOCKS = FIT < 1 ? 1 : FIT > 3 ? 3 : FIT;
  static_assert(BK * 4 == 128, "a B row is one 128-byte swizzle row");
  static_assert(BN % 32 == 0 && BN <= 128, "wgmma widths 32, 64, 128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies 4 (16) bytes from src, or writes zeros where !valid (src must
// still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo exactly, hi x rounded to a TF32 value (ties away from zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle
// (8-row groups 1024 B apart; the leading offset is unused)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x N, float32) += A (64 x 8, TF32 registers) . B (8 x N, shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// acc = A . B over depths [0, k_end); smem holds Cfg::SMEM_BYTES
template <class Cfg, class LoadA, class LoadB>
__device__ __forceinline__ void tile_loop(int k_end, LoadA& la, LoadB& lb, unsigned char* smem,
                                          float (&acc)[Cfg::ACC]) {
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  float* Bhi = reinterpret_cast<float*>(smem + (base - smem_u32(smem)));
  float* Blo = Bhi + Cfg::SPLIT;
  float* As = Blo + Cfg::SPLIT;
  float* Bs = As + Cfg::STAGES * Cfg::A_STAGE;
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32) * 16 + lane / 4;  // fragment rows row, row + 8
  const int t = lane % 4;                              // fragment depths t, t + 4
  float small[Cfg::ACC];
#pragma unroll
  for (int i = 0; i < Cfg::ACC; ++i) acc[i] = small[i] = 0.f;

  const int n_slices = (k_end + Cfg::BK - 1) / Cfg::BK;
#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < n_slices) {
      la.load(As + s * Cfg::A_STAGE);
      lb.load(Bs + s * Cfg::B_STAGE, s * Cfg::BK);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_slices; ++it) {
    cp_async_wait<Cfg::STAGES - 2>();   // slice it has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; the last slice's products are done
    const int s = it % Cfg::STAGES;
    // B's hi and lo tiles: element (n, k) in 16-byte chunk (k / 4) ^ (n % 8)
    // of row n
    const float* b = Bs + s * Cfg::B_STAGE;
#pragma unroll
    for (int e = 0; e < Cfg::SPLIT / Cfg::NT; ++e) {
      const int idx = threadIdx.x + e * Cfg::NT;
      int n, k;
      if (Cfg::B_ROWS) {   // a warp: 8 columns x 4 depths of Bs[k][n]
        const int w = idx / 32;
        n = (w % (Cfg::BN / 8)) * 8 + (idx % 32) / 4;
        k = (w / (Cfg::BN / 8)) * 4 + idx % 4;
      } else {             // a warp: one column's 32 depths of Bs[n][k]
        n = idx / Cfg::BK;
        k = idx % Cfg::BK;
      }
      uint32_t hi, lo;
      split_tf32(Cfg::B_ROWS ? b[k * Cfg::LDB + n] : b[n * Cfg::LDB + k], hi, lo);
      const int off = n * Cfg::BK + (((k >> 2) ^ (n & 7)) << 2) + (k & 3);
      Bhi[off] = __uint_as_float(hi);
      Blo[off] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for the wgmma reads
    __syncthreads();
    // the slice in two halves of HALF k-steps: split this thread's A
    // fragments of the half, issue its products, then issue half of the next
    // slice's copies while they run (only one half's fragments are in flight)
    const int next = it + Cfg::STAGES - 1;
    float* next_As = next < n_slices ? As + (next % Cfg::STAGES) * Cfg::A_STAGE : nullptr;
    constexpr int HALF = Cfg::BK / 16;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t ah[HALF][4], al[HALF][4];
      // fragment element (r, c) of k-step q: row row + r, depth 8 q + c
      // of the half
      constexpr int RS = Cfg::A_ROWS ? Cfg::LDA : 1;   // stride of a row
      constexpr int KS = Cfg::A_ROWS ? 1 : Cfg::LDA;   // stride of a depth
      const float* a = As + s * Cfg::A_STAGE + row * RS + (8 * HALF * half + t) * KS;
#pragma unroll
      for (int q = 0; q < HALF; ++q) {
        split_tf32(a[8 * q * KS], ah[q][0], al[q][0]);                  // (row, t)
        split_tf32(a[8 * q * KS + 8 * RS], ah[q][1], al[q][1]);         // (row + 8, t)
        split_tf32(a[(8 * q + 4) * KS], ah[q][2], al[q][2]);            // (row, t + 4)
        split_tf32(a[(8 * q + 4) * KS + 8 * RS], ah[q][3], al[q][3]);   // (row + 8, t + 4)
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < HALF; ++q) {
        const uint32_t hi = base + 32 * (HALF * half + q);
        const uint32_t lo = hi + 4 * Cfg::SPLIT;
        wgmma_tf32(small, al[q], desc_k(hi));
        wgmma_tf32(small, ah[q], desc_k(lo));
        wgmma_tf32(acc, ah[q], desc_k(hi));
      }
      wgmma_commit();
      if (next_As != nullptr) {
        la.template load_part<2>(next_As, half);
        if (half == 0) lb.load(Bs + (next % Cfg::STAGES) * Cfg::B_STAGE, next * Cfg::BK);
      }
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(small);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < Cfg::ACC; ++i) acc[i] += small[i];
}

}  // namespace repro_tf32x3
