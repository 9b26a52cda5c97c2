// Matrix product (M, K) @ (K, N) -> (M, N) for Hopper (sm_90a): float32 and
// bfloat16 operands, a float32 accumulator, the output in the operands'
// dtype, any M, N and K.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py (matmul, body
// _matmul_kernel): (bm x bk) @ (bk x bn) tiles staged through VMEM into a
// float32 accumulator, written once per output tile. The Pallas wrapper pads
// M, N and K up to its tiles with jnp.pad; here the ragged edges are masked
// in the kernel instead (copies that zero-fill shared memory, and
// predicated stores), so nothing is copied or padded in device memory.
//
// What bounds it on an H100: operations, at every size the port gives it
// beyond a few hundred rows (a 1024^3 product does 2.1 GFLOP on 12.6 MB;
// LeNet's first affine layer at batch 10,000 does 32 GFLOP on 152 MB). So the
// design is about the arithmetic units' rate:
// - float32 (repro_mm_tf32x3): the tensor cores in 3xTF32, through the
//   wgmma mainloop of tf32x3_tile.cuh shared with the float32 conv. Each
//   operand is split into a TF32 hi part and a lo part; hi.hi, hi.lo and
//   lo.hi are three TF32 products (495 TFLOP/s a card) that together meet
//   the float32 tolerance, where full float32 FMAs on the CUDA cores top
//   out at 67 TFLOP/s (the first version of this kernel ran there, at 4.9x
//   its 3xTF32 bound and 1.3x slower than cuBLAS's float32 SGEMM).
//   Block tiles of 128 rows x 32, 64 or 128 columns (the smallest that
//   covers N up to 128: LeNet's 10-way output layer wastes no columns), two
//   warpgroups of 64 rows, 32-deep slices through a 3-stage cp.async ring.
//   The dense loaders take the conv's patch gather's place: A (M, K)
//   row-major arrives as it is, with 16-byte copies, in As[m][k] rows
//   padded to 36 floats (a fragment read hits 32 banks); raw B (K, N)
//   arrives as Bs[k][n] with 16-byte copies, and the once-per-slice pass
//   that splits B into its swizzled hi and lo tiles also transposes it to
//   the K-major layout wgmma reads. Rows with K or N not a multiple of 4,
//   or misaligned bases, take 4-byte copies. Where even the 128-row tiles
//   leave SMs idle and K is deep (LeNet's first affine layer at batch 64:
//   4 tiles, K = 3136), the wrapper asks for split-K: each block sums one
//   part of K, and a second pass adds the parts in a fixed order, so the
//   result does not depend on the schedule.
// - bfloat16: the tensor cores through mma.sync m16n8k16 (bfloat16 in,
//   float32 accumulate), as csrc/flash_attention.cu does. A block of 8 warps
//   owns a 128 x 128 output tile, each warp a 64 x 32 part of it (4 x 4 MMA
//   tiles, 64 float32 accumulators a thread); A and B reach the MMAs through
//   ldmatrix (B transposed on the fly) from padded, bank-conflict-free
//   shared rows, in 32-deep slices, double-buffered: the next slice is read
//   into registers before the current one is multiplied and stored after
//   it. K not a multiple of 16 is zero-filled. No path of the port sends a
//   bfloat16 product here yet; wgmma fed by TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

using repro_tf32x3::cp_async16;
using repro_tf32x3::cp_async4;

// A (M, K) row-major, depths [k0, kend) -> As[m][k]; VEC: 16-byte copies
// (K % 4 == 0 and a 16-byte aligned, so a 4-wide chunk lies wholly inside
// K or outside). Slices are loaded in order from the block's first depth.
template <class Cfg, bool VEC>
struct RowsA {
  const float* __restrict__ a;   // also the (unread) source of zero-filled copies
  int M, K, kend, m0;
  int k0;                        // depth of the next slice

  template <int PARTS>
  __device__ __forceinline__ void load_part(float* As, int part) {
    constexpr int W = VEC ? 4 : 1;                     // floats per copy
    constexpr int PER_ROW = Cfg::BK / W;
    constexpr int PER = Cfg::BM * PER_ROW / Cfg::NT / PARTS;
    static_assert(Cfg::BM * PER_ROW % (Cfg::NT * PARTS) == 0, "whole copies per part");
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = threadIdx.x + (part * PER + e) * Cfg::NT;
      const int r = idx / PER_ROW;
      const int kk = (idx % PER_ROW) * W;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      const bool in = gm < M && gk < kend;
      const float* src = in ? a + (long long)gm * K + gk : a;
      if (VEC)
        cp_async16(As + r * Cfg::LDA + kk, src, in);
      else
        cp_async4(As + r * Cfg::LDA + kk, src, in);
    }
    if (part == PARTS - 1) k0 += Cfg::BK;
  }
  __device__ __forceinline__ void load(float* As) { load_part<1>(As, 0); }
};

// B (K, N) row-major, depths [kbase + k0, ...) below kend -> Bs[k][n];
// VEC: 16-byte copies (N % 4 == 0 and b 16-byte aligned)
template <class Cfg, bool VEC>
struct RowsB {
  const float* __restrict__ b;
  int N, kend, n0, kbase;

  __device__ __forceinline__ void load(float* Bs, int k0) const {
    constexpr int W = VEC ? 4 : 1;
    constexpr int PER_ROW = Cfg::BN / W;
    static_assert(Cfg::BK * PER_ROW % Cfg::NT == 0, "whole copies per thread");
#pragma unroll
    for (int e = 0; e < Cfg::BK * PER_ROW / Cfg::NT; ++e) {
      const int idx = threadIdx.x + e * Cfg::NT;
      const int r = idx / PER_ROW;
      const int nn = (idx % PER_ROW) * W;
      const int gk = kbase + k0 + r;
      const int gn = n0 + nn;
      const bool in = gk < kend && gn < N;
      const float* src = in ? b + (long long)gk * N + gn : b;
      if (VEC)
        cp_async16(Bs + r * Cfg::LDB + nn, src, in);
      else
        cp_async4(Bs + r * Cfg::LDB + nn, src, in);
    }
  }
};

// Block (x, y, z) computes output tile (x, y) over depths [z * kchunk,
// (z + 1) * kchunk) into out + z * M * N: with one split (gridDim.z == 1,
// kchunk >= K) out is C itself, with several it is the float32 partial sums
// that repro_mm_splitk_sum adds up.
template <class Cfg, bool VEC>
__global__ void __launch_bounds__(Cfg::NT, Cfg::MIN_BLOCKS)
repro_mm_tf32x3(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int M, int N, int K, int kchunk) {
  extern __shared__ __align__(16) unsigned char smem_mm[];
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * Cfg::BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  RowsA<Cfg, VEC> la{a, M, K, k_end, m0, k_begin};
  RowsB<Cfg, VEC> lb{b, N, k_end, n0, k_begin};
  float acc[Cfg::ACC];
  repro_tf32x3::tile_loop<Cfg>(k_end - k_begin, la, lb, smem_mm, acc);

  // accumulator 4 j + 2 h + c: row 16 warp + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + c
  float* c = out + (long long)blockIdx.z * M * N;
  const int lane = threadIdx.x % 32;
  const bool even_n = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + (threadIdx.x / 32) * 16 + lane / 4 + 8 * h;
    if (gm >= M) continue;
    float* row = c + (long long)gm * N;
#pragma unroll
    for (int j = 0; j < Cfg::BN / 8; ++j) {
      const int gn = n0 + 8 * j + 2 * (lane % 4);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (even_n) {   // gn is even, so gn < N means gn + 1 < N too
        if (gn < N) *reinterpret_cast<float2*>(row + gn) = make_float2(v0, v1);
      } else {
        if (gn < N) row[gn] = v0;
        if (gn + 1 < N) row[gn + 1] = v1;
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

// block tiles by output columns: 128 rows x 32, 64 or 128 columns
// (kernels/matmul.py's tile_n makes the same choice to count tiles for
// split-K); A row-major As[m][k], B row-major Bs[k][n]
using TC32 = repro_tf32x3::Tile<32, true, true>;
using TC64 = repro_tf32x3::Tile<64, true, true>;
using TC128 = repro_tf32x3::Tile<128, true, true>;

template <class Cfg>
cudaError_t launch_tf32x3(const void* a, const void* b, void* c, void* part, int m, int n,
                          int k, int splits, bool vec, cudaStream_t s) {
  // depth per split: a whole number of slices
  const int kchunk = ((k + splits - 1) / splits + Cfg::BK - 1) / Cfg::BK * Cfg::BK;
  splits = (k + kchunk - 1) / kchunk;
  auto kernel = vec ? repro_mm_tf32x3<Cfg, true> : repro_mm_tf32x3<Cfg, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((m + Cfg::BM - 1) / Cfg::BM, (n + Cfg::BN - 1) / Cfg::BN, splits);
  float* out = static_cast<float*>(splits > 1 ? part : c);
  kernel<<<grid, Cfg::NT, Cfg::SMEM_BYTES, s>>>(static_cast<const float*>(a),
                                                static_cast<const float*>(b), out, m, n, k,
                                                kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)m * n;
  const long long want_blocks = (mn + 255) / 256;
  const int blocks = static_cast<int>(want_blocks < 4LL * sm_count() ? want_blocks
                                                                      : 4LL * sm_count());
  repro_mm_splitk_sum<<<blocks, 256, 0, s>>>(out, static_cast<float*>(c), mn, splits);
  return cudaGetLastError();
}

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
    cudaError_t err;
    if (n <= 32)
      err = launch_tf32x3<TC32>(a, b, c, part, m, n, k, splits, vec, s);
    else if (n <= 64)
      err = launch_tf32x3<TC64>(a, b, c, part, m, n, k, splits, vec, s);
    else
      err = launch_tf32x3<TC128>(a, b, c, part, m, n, k, splits, vec, s);
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
