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
// does 20 kFLOP per output value: operations (200.7 GFLOP at 10,000 images:
// 3.0 ms at the float32 CUDA-core peak, 1.2 ms as three TF32 tensor-core
// products). Its first conv (C 1, k 5, F 32, 28 x 28) does 50 FLOP per
// output value: the 1.0 GB it writes at 10,000 images (0.30 ms).
//
// What the design does about it.
// - float32 (repro_conv_tf32x3): the product runs on the tensor cores in
//   3xTF32 (tf32x3_tile.cuh: each operand split into TF32 hi and lo parts,
//   lo.hi + hi.lo into one float32 accumulator and hi.hi into another per
//   8-deep k-step, wgmma m64nFk8), which keeps float32's tolerance at three
//   times the tensor-core work. Block tiles of 128 output positions x 32,
//   64 or 128 filters (the smallest that covers F up to 128, so LeNet's 32-
//   and 64-filter layers waste no filters), two warpgroups, 32-deep slices
//   through a 3-stage cp.async ring: the patch taps are gathered with
//   4-byte cp.async (a tap outside the image copies zeros through the source
//   size 0, so padding costs no branch on the data path), each thread
//   owning one output position for the whole loop with its tap (c, ki, kj)
//   and the tap's 32-bit offset advanced without division, and issuing the
//   next slice's copies while the current slice's products run; the filters
//   (F, K) arrive with 16-byte cp.async where K % 4 == 0. The output is
//   written directly in (N, F, Ho, Wo) order, eight neighbouring positions
//   of one filter plane per quarter-warp — no transpose pass (the Pallas
//   wrapper transposes (N, Ho*Wo, F) afterwards).
// - bfloat16 inputs (repro_conv_im2col): widened to float32 as they are
//   staged and multiplied on the CUDA cores in the float32 tile loop of
//   fp32_tile.cuh, one output position per thread for the whole loop, 4
//   positions per store where Ho * Wo % 4 == 0. (tf32x3_tile.cuh is shared
//   with matmul.cu's float32 path.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_tile.cuh"
#include "tf32x3_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro_tile::Tile;
using repro_tile::tile_pos;

__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(__ldg(p)); }

__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }

// four consecutive outputs; p is 8-byte aligned
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

// moves the tap (ch, row, col) `step` depths on in the (c, ki, kj) order,
// with no division
__device__ __forceinline__ void advance_tap(int& ch, int& row, int& col, int step, int ks) {
  col += step;
  while (col >= ks) {
    col -= ks;
    if (++row == ks) {
      row = 0;
      ++ch;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// A: the patch matrix gathered with 4-byte cp.async into As[k][m]. Each
// thread owns output position m0 + tid % BM for the whole loop and the
// depths tid / BM + e * KSTEP of every slice; its tap (c, ki, kj) and the
// tap's offset from the window's top-left input element advance KSTEP
// depths after every element, so slices must be loaded in order. Offsets
// are 32-bit: the wrapper refuses tensors of 2^31 elements or more.
template <class Cfg>
struct GatherPatches {
  static constexpr int KSTEP = Cfg::NT / Cfg::BM;
  static constexpr int PER = Cfg::BK / KSTEP;        // elements per thread and slice
  static_assert(Cfg::NT % Cfg::BM == 0 && Cfg::BK % KSTEP == 0, "whole taps per thread");
  const ConvShape s;
  const float* x;             // also the (unread) source of zero-filled copies
  int corner = 0;             // x offset of the window's top-left tap (may lie outside)
  int ih0 = 0, iw0 = 0;       // its row and column (may be negative)
  bool valid = false;
  int c = 0, ki = 0, kj = 0;  // tap of the next element
  int off = 0;                // its offset from corner: (c H + ki) W + kj

  __device__ __forceinline__ GatherPatches(const float* x_, const ConvShape& shape, int m0)
      : s(shape), x(x_) {
    const int gm = m0 + threadIdx.x % Cfg::BM;
    valid = gm < s.M;
    if (valid) {
      const int hw = s.Ho * s.Wo;
      const int n = gm / hw;
      const int p = gm - n * hw;
      const int oh = p / s.Wo;
      const int ow = p - oh * s.Wo;
      ih0 = oh * s.stride - s.pad;
      iw0 = ow * s.stride - s.pad;
      corner = (n * s.C * s.H + ih0) * s.W + iw0;
    }
    const int kk0 = threadIdx.x / Cfg::BM;
    c = kk0 / (s.ks * s.ks);
    ki = (kk0 / s.ks) % s.ks;
    kj = kk0 % s.ks;
    off = (c * s.H + ki) * s.W + kj;
  }

  // part `part` of PARTS of this thread's elements of a slice; a slice's
  // parts in order, slices in order
  template <int PARTS>
  __device__ __forceinline__ void load_part(float* As, int part) {
    static_assert(PER % PARTS == 0, "whole elements per part");
    constexpr int N = PER / PARTS;
    float* dst =
        As + (threadIdx.x / Cfg::BM + part * N * KSTEP) * Cfg::LDA + threadIdx.x % Cfg::BM;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const bool in = valid && c < s.C && (unsigned)(ih0 + ki) < (unsigned)s.H &&
                      (unsigned)(iw0 + kj) < (unsigned)s.W;
      repro_tf32x3::cp_async4(dst + e * KSTEP * Cfg::LDA, in ? x + (corner + off) : x, in);
      // KSTEP depths on: kj, then ki, then c, with the offset alongside
      kj += KSTEP;
      off += KSTEP;
      while (kj >= s.ks) {
        kj -= s.ks;
        off += s.W - s.ks;
        if (++ki == s.ks) {
          ki = 0;
          ++c;
          off += (s.H - s.ks) * s.W;
        }
      }
    }
  }
  __device__ __forceinline__ void load(float* As) {
    load_part<1>(As, 0);
  }
};

// B: the filters (F, K) row-major into Bs[f][k]; VEC: 16-byte copies (K % 4
// == 0 and w 16-byte aligned, so a chunk lies wholly inside K or outside)
template <class Cfg, bool VEC>
struct CopyFilters {
  const float* __restrict__ w;
  int F, K, f0;

  __device__ __forceinline__ void load(float* Bs, int k0) const {
    constexpr int W = VEC ? 4 : 1;                     // floats per copy
    constexpr int PER_ROW = Cfg::BK / W;
    static_assert(Cfg::BN * PER_ROW % Cfg::NT == 0, "whole copies per thread");
#pragma unroll
    for (int e = 0; e < Cfg::BN * PER_ROW / Cfg::NT; ++e) {
      const int idx = threadIdx.x + e * Cfg::NT;
      const int n = idx / PER_ROW;
      const int kk = (idx % PER_ROW) * W;
      const int gf = f0 + n;
      const int gk = k0 + kk;
      const bool in = gf < F && gk < K;
      const float* src = in ? w + (long long)gf * K + gk : w;
      if (VEC)
        repro_tf32x3::cp_async16(Bs + n * Cfg::LDB + kk, src, in);
      else
        repro_tf32x3::cp_async4(Bs + n * Cfg::LDB + kk, src, in);
    }
  }
};

template <class Cfg, bool VEC_W>
__global__ void __launch_bounds__(Cfg::NT, Cfg::MIN_BLOCKS)
repro_conv_tf32x3(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, ConvShape s) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int m0 = blockIdx.x * Cfg::BM;
  const int f0 = blockIdx.y * Cfg::BN;
  GatherPatches<Cfg> la(x, s, m0);
  CopyFilters<Cfg, VEC_W> lb{w, s.F, s.K, f0};
  float acc[Cfg::ACC];
  repro_tf32x3::tile_loop<Cfg>(s.K, la, lb, smem_tc, acc);

  // accumulator 4 j + 2 h + c: position row + 8 h (row = 16 warp + lane / 4),
  // filter 8 j + 2 (lane % 4) + c
  const int lane = threadIdx.x % 32;
  const int hw = s.Ho * s.Wo;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + (threadIdx.x / 32) * 16 + lane / 4 + 8 * h;
    if (gm >= s.M) continue;
    const int n = gm / hw;
    float* base = out + (long long)n * s.F * hw + (gm - n * hw);
#pragma unroll
    for (int j = 0; j < Cfg::BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gf = f0 + 8 * j + 2 * (lane % 4) + c;
        if (gf < s.F) base[(long long)gf * hw] = acc[4 * j + 2 * h + c];
      }
    }
  }
}

template <class Cfg>
cudaError_t launch_tf32x3(const void* x, const void* w, void* out, const ConvShape& s,
                          cudaStream_t stream) {
  const bool vec_w = s.K % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  auto kernel = vec_w ? repro_conv_tf32x3<Cfg, true> : repro_conv_tf32x3<Cfg, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((s.M + Cfg::BM - 1) / Cfg::BM, (s.F + Cfg::BN - 1) / Cfg::BN);
  kernel<<<grid, Cfg::NT, Cfg::SMEM_BYTES, stream>>>(static_cast<const float*>(x),
                                                     static_cast<const float*>(w),
                                                     static_cast<float*>(out), s);
  return cudaGetLastError();
}

// block tiles by filter count: 128 positions x 32, 64 or 128 filters, two
// warpgroups of 64 positions each
using TC32 = repro_tf32x3::Tile<32>;
using TC64 = repro_tf32x3::Tile<64>;
using TC128 = repro_tf32x3::Tile<128>;

cudaError_t launch_f32(const void* x, const void* w, void* out, const ConvShape& s,
                       cudaStream_t stream) {
  if (s.F <= 32) return launch_tf32x3<TC32>(x, w, out, s, stream);
  if (s.F <= 64) return launch_tf32x3<TC64>(x, w, out, s, stream);
  return launch_tf32x3<TC128>(x, w, out, s, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: the float32 tile loop on the CUDA cores
// ---------------------------------------------------------------------------

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

  __device__ __forceinline__ void fetch(int /*k0*/, float (&r)[Cfg::A_PER]) {
    int cc = c, ii = ki, jj = kj;
#pragma unroll
    for (int e = 0; e < Cfg::A_PER; ++e) {
      const int ih = ih0 + ii;
      const int iw = iw0 + jj;
      r[e] = (valid && cc < s.C && (unsigned)ih < (unsigned)s.H && (unsigned)iw < (unsigned)s.W)
                 ? load_f(img + ((long long)cc * s.H + ih) * s.W + iw)
                 : 0.f;
      advance_tap(cc, ii, jj, KSTEP, s.ks);
    }
    advance_tap(c, ki, kj, Cfg::BK, s.ks);
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
    err = launch_f32(x, w, out, s, st);
  else if (dtype == 1)
    err = launch_for_filters<bf16>(x, w, out, s, vec4, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
