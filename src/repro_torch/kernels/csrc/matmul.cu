// Matrix product (M, K) @ (K, N) -> (M, N) for Hopper (sm_90a): float32 and
// bfloat16 operands, a float32 accumulator, the output in the operands'
// dtype, any M, N and K.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py (matmul, body
// _matmul_kernel): (bm x bk) @ (bk x bn) tiles staged through VMEM into a
// float32 accumulator, written once per output tile. The Pallas wrapper pads
// M, N and K up to its tiles with jnp.pad; here the ragged edges are masked
// in the kernel instead (predicated loads that zero-fill shared memory, and
// predicated stores), so nothing is copied or padded in device memory.
//
// What bounds it on an H100: operations, at every size the port gives it
// beyond a few hundred rows (a 1024^3 product does 2.1 GFLOP on 12.6 MB;
// LeNet's first affine layer at batch 10,000 does 32 GFLOP on 133 MB). So the
// design is about keeping the arithmetic units fed from registers:
// - float32: the CUDA cores, in full float32 (fmaf; no TF32, so the result
//   meets its plain version at the float32 tolerance). The tile loop of
//   fp32_tile.cuh: each thread accumulates an 8 x 8 (128 x 128 block tile,
//   256 threads) or 4 x 8 (64 x 64 block tile, 128 threads) block of the
//   output in registers, so each value it reads from shared memory feeds 8
//   or 4 multiply-adds. The larger tile is taken when it still gives every
//   SM a block, the smaller one otherwise (a 1024^3 product has 64 blocks of
//   128 x 128 for 132 SMs, but 256 of 64 x 64). Where even the small tiles
//   leave SMs idle and K is deep (LeNet's first affine layer at batch 64:
//   8 tiles, K = 3136), the wrapper asks for split-K: each block sums one
//   part of K, and a second pass adds the parts in a fixed order.
// - bfloat16: the tensor cores through mma.sync m16n8k16 (bfloat16 in,
//   float32 accumulate), as csrc/flash_attention.cu does. A block of 8 warps
//   owns a 128 x 128 output tile, each warp a 64 x 32 part of it (4 x 4 MMA
//   tiles, 64 float32 accumulators a thread); A and B reach the MMAs through
//   ldmatrix (B transposed on the fly) from padded, bank-conflict-free
//   shared rows, in 32-deep slices. K not a multiple of 16 is zero-filled.
// Both paths double-buffer shared memory: the next slice is read into
// registers before the current one is multiplied and stored after it.
// Loads are 16 bytes wide where rows allow it (K and N multiples of 4 in
// float32, of 8 in bfloat16, 16-byte aligned bases), else one element at a
// time. wgmma and TMA-fed tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_tile.cuh"

namespace {

using repro_tile::Tile;
using repro_tile::tile_pos;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// A (M, lda) row-major, depths below kend -> As[k][m]
template <class Cfg, bool VEC>
struct LoadA {
  const float* __restrict__ a;
  int M, lda, kend, m0;

  __device__ __forceinline__ void fetch(int k0, float (&r)[Cfg::A_PER]) {
    if (VEC) {
#pragma unroll
      for (int e = 0; e < Cfg::A_PER / 4; ++e) {
        const int idx = threadIdx.x + e * Cfg::NT;
        const int gm = m0 + idx / (Cfg::BK / 4);
        const int gk = k0 + (idx % (Cfg::BK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gm < M && gk < kend)
          v = __ldg(reinterpret_cast<const float4*>(a + (long long)gm * lda + gk));
        r[4 * e] = v.x; r[4 * e + 1] = v.y; r[4 * e + 2] = v.z; r[4 * e + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < Cfg::A_PER; ++e) {
        const int idx = threadIdx.x + e * Cfg::NT;
        const int gm = m0 + idx / Cfg::BK;
        const int gk = k0 + idx % Cfg::BK;
        r[e] = (gm < M && gk < kend) ? __ldg(a + (long long)gm * lda + gk) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void stash(float* As, const float (&r)[Cfg::A_PER]) const {
    if (VEC) {
#pragma unroll
      for (int e = 0; e < Cfg::A_PER / 4; ++e) {
        const int idx = threadIdx.x + e * Cfg::NT;
        const int row = idx / (Cfg::BK / 4);
        const int k = (idx % (Cfg::BK / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) As[(k + j) * Cfg::LDA + row] = r[4 * e + j];
      }
    } else {
#pragma unroll
      for (int e = 0; e < Cfg::A_PER; ++e) {
        const int idx = threadIdx.x + e * Cfg::NT;
        As[(idx % Cfg::BK) * Cfg::LDA + idx / Cfg::BK] = r[e];
      }
    }
  }
};

// B (K, N) row-major, depths below kend -> Bs[k][n]
template <class Cfg, bool VEC>
struct LoadB {
  const float* __restrict__ b;
  int N, kend, n0;

  __device__ __forceinline__ void fetch(int k0, float (&r)[Cfg::B_PER]) {
    if (VEC) {
#pragma unroll
      for (int e = 0; e < Cfg::B_PER / 4; ++e) {
        const int idx = threadIdx.x + e * Cfg::NT;
        const int gk = k0 + idx / (Cfg::BN / 4);
        const int gn = n0 + (idx % (Cfg::BN / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gk < kend && gn < N)
          v = __ldg(reinterpret_cast<const float4*>(b + (long long)gk * N + gn));
        r[4 * e] = v.x; r[4 * e + 1] = v.y; r[4 * e + 2] = v.z; r[4 * e + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < Cfg::B_PER; ++e) {
        const int idx = threadIdx.x + e * Cfg::NT;
        const int gk = k0 + idx / Cfg::BN;
        const int gn = n0 + idx % Cfg::BN;
        r[e] = (gk < kend && gn < N) ? __ldg(b + (long long)gk * N + gn) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void stash(float* Bs, const float (&r)[Cfg::B_PER]) const {
    if (VEC) {
#pragma unroll
      for (int e = 0; e < Cfg::B_PER / 4; ++e) {
        const int idx = threadIdx.x + e * Cfg::NT;
        *reinterpret_cast<float4*>(Bs + (idx / (Cfg::BN / 4)) * Cfg::LDB +
                                   (idx % (Cfg::BN / 4)) * 4) =
            make_float4(r[4 * e], r[4 * e + 1], r[4 * e + 2], r[4 * e + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < Cfg::B_PER; ++e) {
        const int idx = threadIdx.x + e * Cfg::NT;
        Bs[(idx / Cfg::BN) * Cfg::LDB + idx % Cfg::BN] = r[e];
      }
    }
  }
};

// Block (x, y, z) computes output tile (x, y) over depths [z * kchunk,
// (z + 1) * kchunk) into out + z * M * N: with one split (gridDim.z == 1,
// kchunk >= K) out is C itself, with several it is the float32 partial sums
// that repro_mm_splitk_sum adds up.
template <class Cfg, bool VEC>
__global__ void __launch_bounds__(Cfg::NT)
repro_mm_fp32(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
              int M, int N, int K, int kchunk) {
  __shared__ __align__(16) float smem[Cfg::SMEM_FLOATS];
  const int tx = threadIdx.x % Cfg::TX;
  const int ty = threadIdx.x / Cfg::TX;
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * Cfg::BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  LoadA<Cfg, VEC> la{a, M, K, k_end, m0};
  LoadB<Cfg, VEC> lb{b, N, k_end, n0};
  float acc[Cfg::TM][Cfg::TN];
  repro_tile::tile_loop<Cfg>(k_begin, k_end, la, lb, smem, tx, ty, acc);
  float* c = out + (long long)blockIdx.z * M * N;

#pragma unroll
  for (int i = 0; i < Cfg::TM; ++i) {
    const int gm = m0 + tile_pos<Cfg::TX>(i / 4, tx, i % 4);
    if (gm >= M) continue;
    float* row = c + (long long)gm * N;
#pragma unroll
    for (int cj = 0; cj < Cfg::TN / 4; ++cj) {
      const int gn = n0 + tile_pos<Cfg::TY>(cj, ty, 0);
      if (VEC) {   // N % 4 == 0: the 4 columns are all in or all out
        if (gn < N)
          *reinterpret_cast<float4*>(row + gn) =
              make_float4(acc[i][4 * cj], acc[i][4 * cj + 1], acc[i][4 * cj + 2],
                          acc[i][4 * cj + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) row[gn + j] = acc[i][4 * cj + j];
      }
    }
  }
}

// c = the sum of the splits' partial products, in a fixed order
__global__ void repro_mm_splitk_sum(const float* __restrict__ part, float* __restrict__ c,
                                    long long mn, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * mn + i];
    c[i] = s;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulate)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int MBM = 128;            // block tile rows
constexpr int MBN = 128;            // block tile columns
constexpr int MBK = 32;             // depth of one shared slice
constexpr int MNT = 256;            // 8 warps: 2 along M x 4 along N
constexpr int MLDA = MBK + 8;       // padded As row (80 bytes)
constexpr int MLDB = MBN + 8;       // padded Bs row (272 bytes)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) . b (16x8, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One slice of A (128 x 32) and of B (32 x 128), each 4096 values: with
// 16-byte rows two 8-value chunks of each per thread, else 16 single values.
template <bool VEC>
struct MmaStage;

template <>
struct MmaStage<true> {
  uint4 ra[2], rb[2];

  __device__ __forceinline__ void fetch(const bf16* a, const bf16* b, int M, int N, int K,
                                        int m0, int n0, int k0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = threadIdx.x + e * MNT;
      const int gm = m0 + (idx >> 2);
      const int gk = k0 + (idx & 3) * 8;
      ra[e] = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K)
        ra[e] = __ldg(reinterpret_cast<const uint4*>(a + (long long)gm * K + gk));
      const int gkb = k0 + (idx >> 4);
      const int gn = n0 + (idx & 15) * 8;
      rb[e] = make_uint4(0, 0, 0, 0);
      if (gkb < K && gn < N)
        rb[e] = __ldg(reinterpret_cast<const uint4*>(b + (long long)gkb * N + gn));
    }
  }

  __device__ __forceinline__ void stash(bf16* As, bf16* Bs) const {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = threadIdx.x + e * MNT;
      *reinterpret_cast<uint4*>(As + (idx >> 2) * MLDA + (idx & 3) * 8) = ra[e];
      *reinterpret_cast<uint4*>(Bs + (idx >> 4) * MLDB + (idx & 15) * 8) = rb[e];
    }
  }
};

template <>
struct MmaStage<false> {
  unsigned short ra[16], rb[16];

  __device__ __forceinline__ void fetch(const bf16* a, const bf16* b, int M, int N, int K,
                                        int m0, int n0, int k0) {
    const unsigned short* a16 = reinterpret_cast<const unsigned short*>(a);
    const unsigned short* b16 = reinterpret_cast<const unsigned short*>(b);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int idx = threadIdx.x + e * MNT;
      const int gm = m0 + (idx >> 5);
      const int gk = k0 + (idx & 31);
      ra[e] = (gm < M && gk < K) ? __ldg(a16 + (long long)gm * K + gk) : 0;
      const int gkb = k0 + (idx >> 7);
      const int gn = n0 + (idx & 127);
      rb[e] = (gkb < K && gn < N) ? __ldg(b16 + (long long)gkb * N + gn) : 0;
    }
  }

  __device__ __forceinline__ void stash(bf16* As, bf16* Bs) const {
    unsigned short* a16 = reinterpret_cast<unsigned short*>(As);
    unsigned short* b16 = reinterpret_cast<unsigned short*>(Bs);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int idx = threadIdx.x + e * MNT;
      a16[(idx >> 5) * MLDA + (idx & 31)] = ra[e];
      b16[(idx >> 7) * MLDB + (idx & 127)] = rb[e];
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(MNT)
repro_mm_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b, bf16* __restrict__ c,
              int M, int N, int K) {
  __shared__ __align__(16) bf16 As[2][MBM * MLDA];
  __shared__ __align__(16) bf16 Bs[2][MBK * MLDB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;            // 64-row half of the block tile
  const int wn = warp & 3;             // 32-column quarter
  const int m0 = blockIdx.x * MBM;
  const int n0 = blockIdx.y * MBN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  MmaStage<VEC> st;
  st.fetch(a, b, M, N, K, m0, n0, 0);
  st.stash(As[0], Bs[0]);
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += MBK) {
    const bool more = k0 + MBK < K;
    if (more) st.fetch(a, b, M, N, K, m0, n0, k0 + MBK);
    const bf16* as = As[stage];
    const bf16* bs = Bs[stage];
#pragma unroll
    for (int ks = 0; ks < MBK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm * 64 + mi * 16 + (lane & 15)) * MLDA + ks * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * MLDB +
                                   wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    if (more) st.stash(As[stage ^ 1], Bs[stage ^ 1]);
    __syncthreads();
    stage ^= 1;
  }

  const bool even_n = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm * 64 + mi * 16 + (lane >> 2) + half * 8;
      if (gm >= M) continue;
      bf16* row = c + (long long)gm * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int gn = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        const float v0 = acc[mi][ni][half * 2];
        const float v1 = acc[mi][ni][half * 2 + 1];
        if (even_n) {   // gn is even, so gn < N means gn + 1 < N too
          if (gn < N)
            *reinterpret_cast<__nv_bfloat162*>(row + gn) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (gn < N) row[gn] = __float2bfloat16(v0);
          if (gn + 1 < N) row[gn + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <class Cfg>
cudaError_t launch_fp32(const void* a, const void* b, void* c, void* part, int m, int n,
                        int k, int splits, bool vec, cudaStream_t s) {
  // depth per split: a whole number of slices
  const int kchunk = ((k + splits - 1) / splits + Cfg::BK - 1) / Cfg::BK * Cfg::BK;
  splits = (k + kchunk - 1) / kchunk;
  dim3 grid((m + Cfg::BM - 1) / Cfg::BM, (n + Cfg::BN - 1) / Cfg::BN, splits);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* out = static_cast<float*>(splits > 1 ? part : c);
  if (vec)
    repro_mm_fp32<Cfg, true><<<grid, Cfg::NT, 0, s>>>(fa, fb, out, m, n, k, kchunk);
  else
    repro_mm_fp32<Cfg, false><<<grid, Cfg::NT, 0, s>>>(fa, fb, out, m, n, k, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)m * n;
  const long long want_blocks = (mn + 255) / 256;
  const int blocks = static_cast<int>(want_blocks < 4LL * sm_count() ? want_blocks
                                                                      : 4LL * sm_count());
  repro_mm_splitk_sum<<<blocks, 256, 0, s>>>(out, static_cast<float*>(c), mn, splits);
  return cudaGetLastError();
}

using Big = Tile<16, 16, 8, 8>;     // 128 x 128, 256 threads, 8 x 8 each
using Small = Tile<16, 8, 4, 8>;    // 64 x 64, 128 threads, 4 x 8 each

}  // namespace

// c (m, n) = a (m, k) @ b (k, n), all row-major and contiguous; dtype: 0 =
// float32, 1 = bfloat16. float32 only: with splits > 1 the depth is cut
// into that many parts (split-K), whose float32 partial products go to part
// (splits x m x n floats) and are then summed into c — for a small m, whose
// few output tiles would leave most SMs idle. Returns the launches'
// cudaError_t.
extern "C" int repro_matmul(const void* a, const void* b, void* c, void* part, int dtype,
                            int m, int n, int k, int splits, void* stream) {
  if (m < 1 || n < 1 || k < 1 || splits < 1 || (splits > 1 && (dtype != 0 || !part)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool base_ok = aligned16(a) && aligned16(b) && aligned16(c) &&
                       (splits == 1 || aligned16(part));
  if (dtype == 0) {
    const bool vec = base_ok && k % 4 == 0 && n % 4 == 0;
    const long long big_blocks =
        (long long)((m + Big::BM - 1) / Big::BM) * ((n + Big::BN - 1) / Big::BN);
    const cudaError_t err = big_blocks >= sm_count() && splits == 1
                                ? launch_fp32<Big>(a, b, c, part, m, n, k, 1, vec, s)
                                : launch_fp32<Small>(a, b, c, part, m, n, k, splits, vec, s);
    return static_cast<int>(err);
  }
  if (dtype == 1) {
    const bool vec = base_ok && k % 8 == 0 && n % 8 == 0;
    dim3 grid((m + MBM - 1) / MBM, (n + MBN - 1) / MBN);
    const bf16* ba = static_cast<const bf16*>(a);
    const bf16* bb = static_cast<const bf16*>(b);
    bf16* bc = static_cast<bf16*>(c);
    if (vec)
      repro_mm_bf16<true><<<grid, MNT, 0, s>>>(ba, bb, bc, m, n, k);
    else
      repro_mm_bf16<false><<<grid, MNT, 0, s>>>(ba, bb, bc, m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
