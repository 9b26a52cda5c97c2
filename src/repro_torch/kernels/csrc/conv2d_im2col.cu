// 2-D convolution as an implicit GEMM for Hopper (sm_90a): NCHW input, OIHW
// filters with a square kernel, stride, symmetric zero padding, no bias, no
// dilation; float32 accumulation, the output (N, F, Ho, Wo) in x's dtype
// (float32 or bfloat16).
//
// Replaces the TPU kernel src/repro/kernels/conv2d_im2col.py (conv2d_im2col,
// body _conv_kernel): per image, the (Ho*Wo, C*k*k) patch matrix is built in
// VMEM only and multiplied by a (C*k*k, bf) filter tile, so the im2col
// intermediate never reaches HBM. Here the same product is one GEMM over the
// whole batch,
//   out[n, f, oh, ow] = sum_kk patch[m, kk] * w[f, kk],
//   m = (n * Ho + oh) * Wo + ow   (M = N * Ho * Wo),
//   kk = (c * k + ki) * k + kj     (K = C * k * k: channel-major, then kernel
//                                   row, then kernel column — the order of
//                                   the reference's patches and of the NN
//                                   library's (F, C*k*k) weights),
// whose A operand is never materialised: each block gathers its patch tile
// straight from x into shared memory, with the padding applied by predicate
// (a tap outside the image loads 0) and the stride by index arithmetic.
//
// What bounds it on an H100. LeNet's second conv (C 32, k 5, F 64, 14 x 14)
// does 20 kFLOP per output value: operations (200.7 GFLOP at 10,000 images,
// 3.0 ms at the float32 peak). Its first conv (C 1, k 5, F 32, 28 x 28) does
// 50 FLOP per output value: the 1.0 GB it writes at 10,000 images (0.30 ms).
// So the kernel keeps the arithmetic fed from registers (the float32 tile
// loop of fp32_tile.cuh, shared with matmul.cu) and writes its output once,
// in wide coalesced stores:
// - the block tile covers 32, 64 or 128 filters (the smallest that covers
//   F up to 128; 256 or 128 output positions), so a 32- or 64-filter layer
//   wastes no multiply-adds on padding filters;
// - each thread keeps one output position for the whole K loop: its image,
//   (oh, ow) and input base are computed once, and its patch taps (c, ki, kj)
//   advance incrementally from slice to slice with no division;
// - neighbouring threads own neighbouring output positions, so both the
//   gathered loads from x and the stores of each filter's output plane are
//   coalesced, and the output is written directly in (N, F, Ho, Wo) order,
//   4 positions per store where Ho * Wo is a multiple of 4 — no transpose
//   pass (the Pallas wrapper transposes (N, Ho*Wo, F) afterwards);
// - float32 on the CUDA cores in full float32 (no TF32); bfloat16 inputs are
//   widened to float32 as they are staged, on the CUDA cores too. A
//   tensor-core path is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro_tile::Tile;
using repro_tile::tile_pos;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(__ldg(p)); }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }

// four consecutive outputs; p is 16-byte (float) or 8-byte (bfloat16) aligned
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

struct ConvShape {
  int C, H, W, F, ks, stride, pad, Ho, Wo, M, K;
};

// A: the patch matrix (M, K), gathered from x -> As[k][m]. Each thread owns
// output position row = tid % BM of the block for the whole loop and the
// depths kk0 + e * (NT / BM) of every slice; fetch is called for slices
// 0, BK, 2 BK, ... in order.
template <class Cfg, class T>
struct LoadPatches {
  static constexpr int KSTEP = Cfg::NT / Cfg::BM;   // depth between a thread's elements
  static_assert(Cfg::NT % Cfg::BM == 0, "one output position per thread");
  const ConvShape s;
  const T* img = nullptr;     // x of this thread's image
  int ih0 = 0, iw0 = 0;       // top-left tap of its window (may be negative)
  bool valid = false;
  int c = 0, ki = 0, kj = 0;  // tap of depth kk0 in the next slice

  __device__ __forceinline__ LoadPatches(const T* x, const ConvShape& shape, int m0)
      : s(shape) {
    const int gm = m0 + threadIdx.x % Cfg::BM;
    valid = gm < s.M;
    if (valid) {
      const int hw = s.Ho * s.Wo;
      const int n = gm / hw;
      const int p = gm - n * hw;
      const int oh = p / s.Wo;
      const int ow = p - oh * s.Wo;
      img = x + (long long)n * s.C * s.H * s.W;
      ih0 = oh * s.stride - s.pad;
      iw0 = ow * s.stride - s.pad;
    }
    const int kk0 = threadIdx.x / Cfg::BM;
    c = kk0 / (s.ks * s.ks);
    ki = (kk0 / s.ks) % s.ks;
    kj = kk0 % s.ks;
  }

  // moves the tap (ch, row, col) `step` depths on, with no division
  __device__ __forceinline__ static void advance(int& ch, int& row, int& col, int step,
                                                 int ks) {
    col += step;
    while (col >= ks) {
      col -= ks;
      if (++row == ks) {
        row = 0;
        ++ch;
      }
    }
  }

  __device__ __forceinline__ void fetch(int /*k0*/, float (&r)[Cfg::A_PER]) {
    int cc = c, ii = ki, jj = kj;
#pragma unroll
    for (int e = 0; e < Cfg::A_PER; ++e) {
      const int ih = ih0 + ii;
      const int iw = iw0 + jj;
      r[e] = (valid && cc < s.C && (unsigned)ih < (unsigned)s.H && (unsigned)iw < (unsigned)s.W)
                 ? load_f(img + ((long long)cc * s.H + ih) * s.W + iw)
                 : 0.f;
      advance(cc, ii, jj, KSTEP, s.ks);
    }
    advance(c, ki, kj, Cfg::BK, s.ks);
  }

  __device__ __forceinline__ void stash(float* As, const float (&r)[Cfg::A_PER]) const {
    const int row = threadIdx.x % Cfg::BM;
    const int kk0 = threadIdx.x / Cfg::BM;
#pragma unroll
    for (int e = 0; e < Cfg::A_PER; ++e) As[(kk0 + e * KSTEP) * Cfg::LDA + row] = r[e];
  }
};

// B: the filters (F, K) row-major, read as (K, F) -> Bs[k][f]
template <class Cfg, class T>
struct LoadFilters {
  const T* __restrict__ w;
  int F, K, f0;

  __device__ __forceinline__ void fetch(int k0, float (&r)[Cfg::B_PER]) {
#pragma unroll
    for (int e = 0; e < Cfg::B_PER; ++e) {
      const int idx = threadIdx.x + e * Cfg::NT;
      const int gf = f0 + idx / Cfg::BK;
      const int gk = k0 + idx % Cfg::BK;
      r[e] = (gf < F && gk < K) ? load_f(w + (long long)gf * K + gk) : 0.f;
    }
  }

  __device__ __forceinline__ void stash(float* Bs, const float (&r)[Cfg::B_PER]) const {
#pragma unroll
    for (int e = 0; e < Cfg::B_PER; ++e) {
      const int idx = threadIdx.x + e * Cfg::NT;
      Bs[(idx % Cfg::BK) * Cfg::LDB + idx / Cfg::BK] = r[e];
    }
  }
};

// VEC4: Ho * Wo % 4 == 0 and out 16-byte aligned, so each thread's 4
// consecutive output positions lie in one image and store as one vector
template <class Cfg, class T, bool VEC4>
__global__ void __launch_bounds__(Cfg::NT)
repro_conv_im2col(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                  ConvShape s) {
  __shared__ __align__(16) float smem[Cfg::SMEM_FLOATS];
  const int tx = threadIdx.x % Cfg::TX;
  const int ty = threadIdx.x / Cfg::TX;
  const int m0 = blockIdx.x * Cfg::BM;
  const int f0 = blockIdx.y * Cfg::BN;
  LoadPatches<Cfg, T> la(x, s, m0);
  LoadFilters<Cfg, T> lb{w, s.F, s.K, f0};
  float acc[Cfg::TM][Cfg::TN];
  repro_tile::tile_loop<Cfg>(0, s.K, la, lb, smem, tx, ty, acc);

  const int hw = s.Ho * s.Wo;
#pragma unroll
  for (int ci = 0; ci < Cfg::TM / 4; ++ci) {
    const int gm0 = m0 + tile_pos<Cfg::TX>(ci, tx, 0);
    if (VEC4) {   // M % 4 == 0 and gm0 % 4 == 0: all 4 positions valid or none
      if (gm0 >= s.M) continue;
      const int n = gm0 / hw;
      T* base = out + (long long)n * s.F * hw + (gm0 - n * hw);
#pragma unroll
      for (int j = 0; j < Cfg::TN; ++j) {
        const int gf = f0 + tile_pos<Cfg::TY>(j / 4, ty, j % 4);
        if (gf < s.F)
          store4(base + (long long)gf * hw, acc[4 * ci][j], acc[4 * ci + 1][j],
                 acc[4 * ci + 2][j], acc[4 * ci + 3][j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = gm0 + i;
        if (gm >= s.M) continue;
        const int n = gm / hw;
        T* base = out + (long long)n * s.F * hw + (gm - n * hw);
#pragma unroll
        for (int j = 0; j < Cfg::TN; ++j) {
          const int gf = f0 + tile_pos<Cfg::TY>(j / 4, ty, j % 4);
          if (gf < s.F) store_f(base + (long long)gf * hw, acc[4 * ci + i][j]);
        }
      }
    }
  }
}

template <class Cfg, class T>
cudaError_t launch(const void* x, const void* w, void* out, const ConvShape& s, bool vec4,
                   cudaStream_t stream) {
  dim3 grid((s.M + Cfg::BM - 1) / Cfg::BM, (s.F + Cfg::BN - 1) / Cfg::BN);
  const T* tx = static_cast<const T*>(x);
  const T* tw = static_cast<const T*>(w);
  T* to = static_cast<T*>(out);
  if (vec4)
    repro_conv_im2col<Cfg, T, true><<<grid, Cfg::NT, 0, stream>>>(tx, tw, to, s);
  else
    repro_conv_im2col<Cfg, T, false><<<grid, Cfg::NT, 0, stream>>>(tx, tw, to, s);
  return cudaGetLastError();
}

// block tiles by filter count, 256 threads each: 4 x 8 outputs per thread
// keep more warps resident than 8 x 8 (about half the registers), which the
// patch gathers' latency needs; tried on the H100 at LeNet's two convs
// against 128-thread 8 x 8 and 4 x 4 tiles
using F32Tile = Tile<64, 4, 4, 8>;    // 256 positions x 32 filters, 4 x 8 per thread
using F64Tile = Tile<32, 8, 4, 8>;    // 128 x 64, 4 x 8 per thread
using F128Tile = Tile<16, 16, 8, 8>;  // 128 x 128, 8 x 8 per thread

template <class T>
cudaError_t launch_for_filters(const void* x, const void* w, void* out, const ConvShape& s,
                               bool vec4, cudaStream_t stream) {
  if (s.F <= 32) return launch<F32Tile, T>(x, w, out, s, vec4, stream);
  if (s.F <= 64) return launch<F64Tile, T>(x, w, out, s, vec4, stream);
  return launch<F128Tile, T>(x, w, out, s, vec4, stream);
}

}  // namespace

// out (n, f, ho, wo) = conv(x (n, c, h, w), w (f, c, ks, ks)), all contiguous;
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_conv2d_im2col(const void* x, const void* w, void* out, int dtype, int n,
                                   int c, int h, int wd, int f, int ks, int stride, int pad,
                                   void* stream) {
  if (n < 1 || c < 1 || f < 1 || ks < 1 || stride < 1 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvShape s;
  s.C = c; s.H = h; s.W = wd; s.F = f; s.ks = ks; s.stride = stride; s.pad = pad;
  s.Ho = (h + 2 * pad - ks) / stride + 1;
  s.Wo = (wd + 2 * pad - ks) / stride + 1;
  if (h + 2 * pad < ks || wd + 2 * pad < ks) return static_cast<int>(cudaErrorInvalidValue);
  s.M = n * s.Ho * s.Wo;
  s.K = c * ks * ks;
  const bool vec4 = (s.Ho * s.Wo) % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_for_filters<float>(x, w, out, s, vec4, st);
  else if (dtype == 1)
    err = launch_for_filters<bf16>(x, w, out, s, vec4, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
