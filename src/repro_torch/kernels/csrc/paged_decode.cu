// Paged decode attention for Hopper (sm_90a), one query token per row.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, body _paged_decode_kernel). Same function:
//   out[b, h*g + r] = softmax_i(q[b, h*g + r] . K[slot(b, i), h] * D^-0.5) . V
// over the committed logical slots i < min(pos[b] + 1, Sc), where
//   slot(b, i) = min(tables[b, i / page], n_phys - 1) * page + i % page,
// with GQA folded (kv head h serves query rows h*g .. h*g + g - 1), scores
// masked to -1e30, an online softmax in float32 and a zero denominator
// treated as 1 (a row with nothing committed gives zeros).
//
// What bounds it on an H100: bytes. Every committed K and V row is read
// once. The TPU grid's sequential page axis becomes a split over slots:
// block (split, kv head h, row b) owns the committed slots
// [split * split_slots, (split + 1) * split_slots) of its row, reading its
// own pos[b] and page-table entries (the TPU kernel's scalar prefetch); a
// second, small kernel combines the splits' (max, denominator, accumulator)
// partials into the output. Blocks past the row's committed slots exit at
// once, and the combine reads only the splits that hold committed slots.
//
// bfloat16, D % 16 == 0 (the serving path): paged_mma_kernel.
// - Bytes in flight. The wrapper sizes split_slots (a multiple of 64) for
//   about two blocks per SM. Each of the block's 4 warps owns 16 slots of
//   every 64-slot tile of its split and walks them through its own 3-stage
//   cp.async ring in shared memory: lane r of a warp reads the page-table
//   entry of slot row r a sub-tile ahead (clamped before any address is
//   formed) and shares it by a shuffle; each 16-byte cp.async.cg copy
//   instruction of the warp reads two whole rows (zero-filled past the
//   split's committed end), and the next two sub-tiles are in flight while
//   one is computed. The warps never wait for each other inside the walk.
// - Arithmetic on the tensor cores. With g query heads per kv head each
//   K/V element carries 2g multiply-adds (8 per byte at g = 8), too many
//   for the CUDA cores at the memory rate. The g <= 16 query heads of the
//   kv head are the 16 rows of mma.sync m16n8k16 (rows >= g zero): S = Q K^T
//   with Q's bf16 fragments loaded once, unscaled, K's by ldmatrix; the
//   scale is applied to the float32 scores (in log2 units, exp2). P V takes
//   the score registers as its A fragments (as FlashAttention-2 does) and
//   V's by ldmatrix.trans. P is not rounded to bfloat16: it is split into
//   bfloat16 hi + lo and both products accumulate in float32, which keeps
//   ~16 bits of P (kernels/paged_attention.py::paged_attention_model
//   models this order; rounding P alone misses the bf16 tolerance).
// - Each warp keeps its own (max, denominator, 16 x D accumulator); the
//   four are merged once, through shared memory, when the split is done.
//
// float32, and bfloat16 with D % 16 != 0: paged_split_kernel, 128-slot
// splits on the CUDA cores. Each block stages 64-slot K and V tiles into
// shared memory with 16-byte loads, reads each K/V row once for all g query
// heads of its group, and keeps the g x D float32 accumulator in registers
// (16 elements a thread up to g x D = 2048, 32 up to the g = 16, D = 256
// bound).
//
// Host side: the dynamic shared memory opt-in (cudaFuncSetAttribute) runs
// once per kernel instantiation and device, not once per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // slots per tile (both kernels)
constexpr int kSplit = 128;      // slots per block of paged_split_kernel
constexpr int kMaxG = 16;        // query heads per kv head
constexpr int kMaxD = 256;       // head dim
constexpr int kMaxElems = 32;    // accumulator elements per thread (split kernel)
constexpr int kMaxDevices = 64;  // devices whose shared-memory opt-in is remembered
constexpr int kStages = 3;       // cp.async ring stages per warp (mma kernel)
constexpr int kWarpSlots = kTile / kWarps;   // 16 slots of a tile per warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The dynamic shared-memory opt-in of one kernel instantiation (the caller
// keeps `done`, one static array per instantiation), made once per device.
cudaError_t opt_in_once(const void* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // the largest shared-memory carveout, so that as many blocks as the
  // shared memory allows are resident on an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// float32 (and bfloat16 with D % 16 != 0): CUDA cores, 128-slot splits
// ---------------------------------------------------------------------------

// dynamic shared memory of one split block, in bytes
template <typename T>
constexpr size_t smem_bytes(int g, int d) {
  return 2 * sizeof(T) * kTile * d                 // K and V tiles
         + sizeof(float) * (g * d + g * kTile)     // query rows, probabilities
         + sizeof(long long) * kTile;              // row offsets of the tile
}

// ELEMS: accumulator elements per thread, g * D <= kThreads * ELEMS (16
// up to g * D = 2048, 32 above: recurrentgemma's g = 10 at D = 256)
template <typename T, int ELEMS>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q,             // (B, Hq, D)
                   const T* __restrict__ k,             // (n_slots, Hkv, D)
                   const T* __restrict__ v,             // (n_slots, Hkv, D)
                   const int32_t* __restrict__ tables,  // (B, n_tab)
                   const int32_t* __restrict__ pos,     // (B,)
                   float* __restrict__ part_acc,        // (B, Hkv, S, g, D)
                   float* __restrict__ part_ml,         // (B, Hkv, S, g, 2)
                   int hkv, int g, int d, int n_tab, int page, int sc,
                   int n_phys, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTile * d;
  float* q_s = reinterpret_cast<float*>(v_s + kTile * d);
  float* p_s = q_s + g * d;
  long long* off_s = reinterpret_cast<long long*>(p_s + g * kTile);
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = g * d;

  // committed slots of this row; slots past the table's pages are never
  // visited (the TPU grid spans exactly n_tab pages)
  const int n_valid = min(min(pos[b] + 1, sc), n_tab * page);
  const int s0 = split * kSplit;
  const int s1 = min(s0 + kSplit, n_valid);
  const size_t part = ((size_t)b * hkv + h) * n_splits + split;

  const size_t head_off = ((size_t)b * hkv * g + (size_t)h * g) * d;
  for (int e = tid; e < gd; e += kThreads) q_s[e] = to_f32(q[head_off + e]) * scale;
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ELEMS];
#pragma unroll
  for (int i = 0; i < ELEMS; ++i) acc[i] = 0.f;

  const long long slot_stride = (long long)hkv * d;
  const int chunks_per_row = d * (int)sizeof(T) / 16;   // 16-byte chunks

  for (int base = s0; base < s1; base += kTile) {
    const int tile_n = min(kTile, s1 - base);
    __syncthreads();  // q_s ready / previous tile's readers done
    if (tid < tile_n) {
      const int i = base + tid;
      int entry = tables[(size_t)b * n_tab + i / page];
      entry = max(0, min(entry, n_phys - 1));
      off_s[tid] = ((long long)entry * page + i % page) * slot_stride + (long long)h * d;
    }
    __syncthreads();
    for (int c = tid; c < tile_n * chunks_per_row; c += kThreads) {
      const int t = c / chunks_per_row;
      const int col = c - t * chunks_per_row;
      const uint4* ksrc = reinterpret_cast<const uint4*>(k + off_s[t]) + col;
      const uint4* vsrc = reinterpret_cast<const uint4*>(v + off_s[t]) + col;
      reinterpret_cast<uint4*>(k_s + t * d)[col] = __ldg(ksrc);
      reinterpret_cast<uint4*>(v_s + t * d)[col] = __ldg(vsrc);
    }
    __syncthreads();

    // scores: one warp per slot, lanes across D, all g query rows
    for (int t = warp; t < tile_n; t += kWarps) {
      float kv[kMaxD / 32];
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) {
        const int dd = lane + 32 * j;
        kv[j] = dd < d ? to_f32(k_s[t * d + dd]) : 0.f;
      }
      for (int r = 0; r < g; ++r) {
        float part_s = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxD / 32; ++j) {
          const int dd = lane + 32 * j;
          if (dd < d) part_s = fmaf(q_s[r * d + dd], kv[j], part_s);
        }
        part_s = warp_sum(part_s);
        if (lane == 0) p_s[r * kTile + t] = part_s;
      }
    }
    __syncthreads();

    // online softmax update: one warp per query row
    for (int r = warp; r < g; r += kWarps) {
      const bool v0 = lane < tile_n, v1 = lane + 32 < tile_n;
      const float sc0 = v0 ? p_s[r * kTile + lane] : kNegInf;
      const float sc1 = v1 ? p_s[r * kTile + lane + 32] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sc0, sc1)));
      const float p0 = v0 ? expf(sc0 - m_new) : 0.f;
      const float p1 = v1 ? expf(sc1 - m_new) : 0.f;
      if (v0) p_s[r * kTile + lane] = p0;
      if (v1) p_s[r * kTile + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P . V, each thread owning (row, d) elements
#pragma unroll
    for (int i = 0; i < ELEMS; ++i) {
      const int e = tid + i * kThreads;
      if (e < gd) {
        const int r = e / d;
        const int dd = e - r * d;
        const float* pr = p_s + r * kTile;
        float a = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int t = 0; t < tile_n; ++t) a = fmaf(pr[t], to_f32(v_s[t * d + dd]), a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < ELEMS; ++i) {
    const int e = tid + i * kThreads;
    if (e < gd) part_acc[part * gd + e] = acc[i];
  }
  if (tid < g) {
    part_ml[(part * g + tid) * 2] = m_s[tid];
    part_ml[(part * g + tid) * 2 + 1] = l_s[tid];
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D % 16 == 0: mma.sync on the GQA group, per-warp cp.async rings
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// 16 bytes from global to shared memory, bypassing L1; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
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

// p = hi + lo, each rounded to bfloat16: hi the nearest bfloat16 to p, lo
// the nearest to the rest (|p - hi - lo| <= 2^-18 |p|)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// bytes of dynamic shared memory of one mma block at head dim d: the query
// tile (16 rows) and kStages x kWarps x {K, V} sub-tiles of 16 slot rows,
// rows padded by 8 elements so that ldmatrix's 8 rows hit distinct banks
constexpr int mma_smem_bytes(int d) {
  return (16 + kStages * kWarps * 2 * kWarpSlots) * (d + 8) * 2;
}

// DMAX: the largest head dim of the instantiation (32, 64, 128 or 256);
// d <= DMAX, d % 16 == 0, and EXACT where d == DMAX (the loops over D then
// have no runtime bound). At DMAX = 256 the query fragments stay in shared
// memory (the 16 x 256 float32 accumulator takes 128 registers a thread).
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads, DMAX <= 128 ? 2 : 1)
paged_mma_kernel(const bf16* __restrict__ q,            // (B, Hq, D)
                 const bf16* __restrict__ k,            // (n_slots, Hkv, D)
                 const bf16* __restrict__ v,            // (n_slots, Hkv, D)
                 const int32_t* __restrict__ tables,    // (B, n_tab)
                 const int32_t* __restrict__ pos,       // (B,)
                 float* __restrict__ part_acc,          // (B, Hkv, S, g, D)
                 float* __restrict__ part_ml,           // (B, Hkv, S, g, 2)
                 int hkv, int g, int d, int n_tab, int page, int sc, int n_phys,
                 int split_slots, float c) {            // c = scale * log2(e)
  constexpr int KS = DMAX / 16;        // k-steps over D (also the d-pairs of P V)
  constexpr bool Q_IN_REGS = DMAX <= 128;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __shared__ float m_w[kWarps][16], l_w[kWarps][16];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_valid = min(min(pos[b] + 1, sc), n_tab * page);
  const int s0 = split * split_slots;
  if (s0 >= n_valid) return;           // nothing committed: the combine skips this split
  const int s1 = min(s0 + split_slots, n_valid);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (EXACT) d = DMAX;                 // a constant from here on
  const int ks_n = d >> 4;             // k-steps of this head dim
  const int ld = d + 8;                // padded row, in elements
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);
  bf16* ring = q_s + 16 * ld;          // [stage][warp][K, V][16 slots][ld]

  const size_t slot_stride = (size_t)hkv * d;
  const int32_t* table = tables + (size_t)b * n_tab;
  // sub-tiles of this warp: slots s0 + t * kTile + warp * 16 + [0, 16)
  const int first = s0 + warp * kWarpSlots;
  const int n_sub = first < s1 ? (s1 - first + kTile - 1) / kTile : 0;
  // this lane's 16-byte chunks of a sub-tile (16 rows of d / 8 chunks):
  // chunk lane + 32 j (j < d / 16), so that each copy instruction reads two
  // whole rows; as row << 16 | element offset in the row
  int chunk[KS];
  const int cpr = d >> 3;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int cidx = lane + 32 * j;
    const int row = cidx / cpr;
    chunk[j] = row << 16 | (cidx - row * cpr) * 8;
  }

  // the physical slot of this lane's row of sub-tile t (lanes 16-31 repeat
  // 0-15), -1 past the split's committed end; read a sub-tile ahead of its
  // copies, so the table read's latency hides behind a sub-tile's work
  auto slot_of = [&](int t) {
    const int i = first + t * kTile + (lane & 15);
    if (t >= n_sub || i >= s1) return -1;
    const int pg = i / page;
    return max(0, min(table[pg], n_phys - 1)) * page + (i - pg * page);
  };
  // copies of sub-tile t into its ring stage, rows at the slots `phys` of
  // lanes 0-15 (zeros past s1)
  auto issue = [&](int t, int phys) {
    bf16* ks_ = ring + ((t % kStages) * kWarps + warp) * 2 * kWarpSlots * ld;
    bf16* vs_ = ks_ + kWarpSlots * ld;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int row = chunk[j] >> 16;
      const int col = chunk[j] & 0xffff;
      const int p = __shfl_sync(0xffffffffu, phys, row & 15);
      if (j < ks_n) {
        const size_t off = (size_t)max(p, 0) * slot_stride + (size_t)h * d + col;
        const int dst = row * ld + col;
        cp_async16(ks_ + dst, k + off, p >= 0);
        cp_async16(vs_ + dst, v + off, p >= 0);
      }
    }
  };

  int ahead[kStages - 1];
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) ahead[t] = slot_of(t);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_sub) issue(t, ahead[t]);
    cp_async_commit();
  }
  int next = slot_of(kStages - 1);

  // the group's query rows, zero past g, while the first copies fly
  const size_t head_off = ((size_t)b * hkv * g + (size_t)h * g) * d;
  for (int e = tid; e < 16 * d; e += kThreads) {
    const int r = e / d;
    const int col = e - r * d;
    q_s[r * ld + col] = r < g ? q[head_off + e] : __float2bfloat16(0.f);
  }
  __syncthreads();                     // q_s complete

  uint32_t qf[Q_IN_REGS ? KS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      if (ks < ks_n)
        ldmatrix_x4(qf[ks], q_s + (lane & 15) * ld + ks * 16 + (lane >> 4) * 8);
  }

  float o[2 * KS][4];                  // 16 rows x D: rows lane/4 and lane/4 + 8
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float ms[2] = {kNegInf, kNegInf};    // running max of scores * c
  float l[2] = {0.f, 0.f};
  const int col0 = (lane & 3) * 2;

  for (int t = 0; t < n_sub; ++t) {
    cp_async_wait<kStages - 2>();      // sub-tile t has landed (this lane's copies)
    __syncwarp();                      // ... the warp's; sub-tile t - 1 is consumed
    if (t + kStages - 1 < n_sub) issue(t + kStages - 1, next);
    cp_async_commit();
    next = slot_of(t + kStages);
    const bf16* ks_ = ring + ((t % kStages) * kWarps + warp) * 2 * kWarpSlots * ld;
    const bf16* vs_ = ks_ + kWarpSlots * ld;

    // S = Q K^T: 16 query rows x 16 slots (n-tiles of slots 0-7 and 8-15)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks < ks_n) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks_ + ((lane & 7) + ((lane >> 4) << 3)) * ld + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        if constexpr (Q_IN_REGS) {
          mma_bf16(s[0], qf[ks], kf[0], kf[1]);
          mma_bf16(s[1], qf[ks], kf[2], kf[3]);
        } else {
          uint32_t a[4];
          ldmatrix_x4(a, q_s + (lane & 15) * ld + ks * 16 + (lane >> 4) * 8);
          mma_bf16(s[0], a, kf[0], kf[1]);
          mma_bf16(s[1], a, kf[2], kf[3]);
        }
      }
    }

    // online softmax of rows lane/4 (half 0) and lane/4 + 8 (half 1); the
    // other three lanes of the quad hold the rest of each row
    const int base = first + t * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[e >> 1][half * 2 + (e & 1)];
        if (base + 8 * (e >> 1) + col0 + (e & 1) >= s1) x = kNegInf;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float ms_new = fmaxf(ms[half], mx * c);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[e >> 1][half * 2 + (e & 1)];
        x = x == kNegInf ? 0.f : exp2f(fmaf(x, c, -ms_new));
        sum += x;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = exp2f(ms[half] - ms_new);
      l[half] = alpha * l[half] + sum;
      ms[half] = ms_new;
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j) {
        o[j][half * 2] *= alpha;
        o[j][half * 2 + 1] *= alpha;
      }
    }

    // O += P V with P = hi + lo: the score accumulators are the A fragment
    // of the 16 slots (n-tile 0: slots 0-7, n-tile 1: slots 8-15)
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < KS; ++dp) {
      if (dp < ks_n) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs_ + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + dp * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the four warps' (max, denominator, accumulator) through shared
  // memory (the ring, now consumed) into the split's partial
  if ((lane & 3) == 0) {
    m_w[warp][lane >> 2] = ms[0];
    m_w[warp][(lane >> 2) + 8] = ms[1];
    l_w[warp][lane >> 2] = l[0];
    l_w[warp][(lane >> 2) + 8] = l[1];
  }
  __syncthreads();                     // every warp is done with the ring
  float* o_s = reinterpret_cast<float*>(ring);   // [warp][16 rows][d]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = (lane >> 2) + half * 8;
    if (row < g) {
      float m_all = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_w[w][row]);
      const float f = exp2f(ms[half] - m_all);
      float* dst = o_s + (warp * 16 + row) * d + col0;
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j)
        if (j < 2 * ks_n)
          *reinterpret_cast<float2*>(dst + j * 8) =
              make_float2(o[j][half * 2] * f, o[j][half * 2 + 1] * f);
    }
  }
  __syncthreads();
  const int gd = g * d;
  const size_t part = ((size_t)b * hkv + h) * gridDim.x + split;
  for (int e = tid; e < gd; e += kThreads) {
    const int r = e / d;
    const int col = e - r * d;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += o_s[(w * 16 + r) * d + col];
    part_acc[part * gd + e] = sum;
  }
  if (tid < g) {
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_w[w][tid]);
    float l_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l_all += exp2f(m_w[w][tid] - m_all) * l_w[w][tid];
    part_ml[(part * g + tid) * 2] = m_all;
    part_ml[(part * g + tid) * 2 + 1] = l_all;
  }
}

// ---------------------------------------------------------------------------
// combine: out[b, h*g + r, :] = sum_s w_s acc_s / sum_s w_s l_s, with
// w_s = exp(m_s - max m) (exp2 where LOG2: the mma kernel's maxima are in
// log2 units), over the splits that hold committed slots. One block per
// (query row r, kv head h, row b): the weights are formed once per block,
// 128 splits at a time, and each thread sums its output elements' partials.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  __syncthreads();                     // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

template <typename T, bool LOG2>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     const int32_t* __restrict__ pos, T* __restrict__ out, int hkv, int g,
                     int d, int n_tab, int page, int sc, int n_splits, int split_slots) {
  __shared__ float w_s[kThreads], red[kWarps];
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_valid = min(min(pos[b] + 1, sc), n_tab * page);
  const int n_used = n_valid > 0 ? (n_valid + split_slots - 1) / split_slots : 0;
  const size_t first = ((size_t)b * hkv + h) * n_splits;
  const float* ml = part_ml + (first * g + r) * 2;            // split s at ml[2 g s]
  const float* acc = part_acc + (first * g + r) * d;          // split s at acc[g d s]

  float m = kNegInf;
  for (int s = tid; s < n_used; s += kThreads) m = fmaxf(m, ml[2 * g * s]);
  m = block_reduce(m, true, red);
  float l = 0.f;
  float o[kMaxD / kThreads] = {};
  for (int c0 = 0; c0 < n_used; c0 += kThreads) {
    const int n = min(kThreads, n_used - c0);
    __syncthreads();                   // the previous chunk's weights are read
    if (tid < n) {
      const float dm = ml[2 * g * (c0 + tid)] - m;
      w_s[tid] = LOG2 ? exp2f(dm) : expf(dm);
      l = fmaf(w_s[tid], ml[2 * g * (c0 + tid) + 1], l);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxD / kThreads; ++j) {
      const int e = tid + j * kThreads;
      if (e < d) {
        const float* a = acc + (size_t)g * d * c0 + e;
#pragma unroll 4
        for (int s = 0; s < n; ++s) o[j] = fmaf(w_s[s], a[(size_t)g * d * s], o[j]);
      }
    }
  }
  l = block_reduce(l, false, red);
  T* dst = out + ((size_t)b * hkv * g + (size_t)h * g + r) * d;
#pragma unroll
  for (int j = 0; j < kMaxD / kThreads; ++j) {
    const int e = tid + j * kThreads;
    if (e < d) dst[e] = from_f32<T>(o[j] / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int ELEMS>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* tables,
                         const void* pos, void* out, float* part_acc, float* part_ml,
                         int batch, int hkv, int g, int d, int n_tab, int page, int sc,
                         int n_phys, int n_splits, float scale, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err = opt_in_once(reinterpret_cast<const void*>(paged_split_kernel<T, ELEMS>),
                                static_cast<int>(smem_bytes<T>(kMaxG, kMaxD)), opted_in);
  if (err != cudaSuccess) return err;
  const int bytes = static_cast<int>(smem_bytes<T>(g, d));
  paged_split_kernel<T, ELEMS><<<dim3(n_splits, hkv, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(pos), part_acc,
      part_ml, hkv, g, d, n_tab, page, sc, n_phys, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T, false><<<dim3(g, hkv, batch), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<const int32_t*>(pos), static_cast<T*>(out), hkv, g, d,
      n_tab, page, sc, n_splits, kSplit);
  return cudaGetLastError();
}

template <int DMAX, bool EXACT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* tables,
                       const void* pos, void* out, float* part_acc, float* part_ml,
                       int batch, int hkv, int g, int d, int n_tab, int page, int sc,
                       int n_phys, int n_splits, int split_slots, float scale,
                       cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err = opt_in_once(reinterpret_cast<const void*>(paged_mma_kernel<DMAX, EXACT>),
                                mma_smem_bytes(DMAX), opted_in);
  if (err != cudaSuccess) return err;
  paged_mma_kernel<DMAX, EXACT><<<dim3(n_splits, hkv, batch), kThreads, mma_smem_bytes(d), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(pos), part_acc,
      part_ml, hkv, g, d, n_tab, page, sc, n_phys, split_slots, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<bf16, true><<<dim3(g, hkv, batch), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<const int32_t*>(pos), static_cast<bf16*>(out), hkv, g,
      d, n_tab, page, sc, n_splits, split_slots);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bfloat16 with d % 16 == 0 runs
// paged_mma_kernel and takes any split_slots that is a multiple of 64;
// the rest runs paged_split_kernel with split_slots = 128. part_acc /
// part_ml: float32 workspace of B*Hkv*n_splits*g*D and B*Hkv*n_splits*g*2
// elements, n_splits * split_slots >= min(sc, n_tab*page). K/V rows must be
// 16-byte aligned (D * itemsize % 16 == 0, 16-byte aligned base pointers).
// Returns the launches' cudaError_t.
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* tables, const void* pos, void* out,
                            void* part_acc, void* part_ml, int dtype, int batch, int hkv,
                            int g, int d, int n_tab, int page, int sc, int n_phys,
                            int n_splits, int split_slots, float scale, void* stream) {
  const bool mma = dtype == 1 && d % 16 == 0;
  const long long covered = (long long)n_splits * split_slots;
  static_assert(kMaxG * kMaxD <= kThreads * kMaxElems, "split accumulator bound");
  if (g < 1 || g > kMaxG || d < 1 || d > kMaxD ||
      n_splits < 1 || split_slots < 1 || covered < (long long)min(sc, n_tab * page) ||
      (mma ? split_slots % kTile != 0 : split_slots != kSplit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaError_t err;
  if (mma) {
    // the instantiation whose DMAX is the smallest of 32, 64, 128, 256 >= d
    auto run = [&](auto dmax) {
      constexpr int DMAX = decltype(dmax)::value;
      return d == DMAX ? launch_mma<DMAX, true>(q, k, v, tables, pos, out, pa, pm, batch,
                                                hkv, g, d, n_tab, page, sc, n_phys,
                                                n_splits, split_slots, scale, s)
                       : launch_mma<DMAX, false>(q, k, v, tables, pos, out, pa, pm, batch,
                                                 hkv, g, d, n_tab, page, sc, n_phys,
                                                 n_splits, split_slots, scale, s);
    };
    err = d <= 32    ? run(std::integral_constant<int, 32>{})
          : d <= 64  ? run(std::integral_constant<int, 64>{})
          : d <= 128 ? run(std::integral_constant<int, 128>{})
                     : run(std::integral_constant<int, 256>{});
  } else if (dtype == 0 || dtype == 1) {
    // the split kernel whose accumulator holds g * d in the fewest registers
    auto run = [&](auto type, auto elems) {
      using T = decltype(type);
      constexpr int ELEMS = decltype(elems)::value;
      return launch_split<T, ELEMS>(q, k, v, tables, pos, out, pa, pm, batch, hkv, g, d,
                                    n_tab, page, sc, n_phys, n_splits, scale, s);
    };
    using Half = std::integral_constant<int, kMaxElems / 2>;
    using Full = std::integral_constant<int, kMaxElems>;
    const bool half = g * d <= kThreads * kMaxElems / 2;
    err = dtype == 0 ? (half ? run(float{}, Half{}) : run(float{}, Full{}))
                     : (half ? run(bf16{}, Half{}) : run(bf16{}, Full{}));
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
