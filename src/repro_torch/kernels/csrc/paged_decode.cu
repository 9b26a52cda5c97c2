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
// once and does 2*g multiply-adds per element, far below the ~295
// operations per byte at which the tensor cores would become the limit.
//
// What the design does about it: enough independent reads in flight to
// approach the memory rate. The TPU grid's sequential page axis becomes a
// split over slots: block (split, kv head h, row b) owns the committed
// slots [split * 128, split * 128 + 128) of its row — reading its own
// pos[b] and page-table entries, the TPU kernel's scalar prefetch — so a
// batch-8, 2048-slot decode runs 512 blocks instead of 32. Each block stages
// 64-slot K and V tiles into shared memory with 16-byte loads (every load of
// a tile issued before any is used), reads each K/V row once for all g query
// heads of its group, and keeps the g x D float32 accumulator in registers.
// A sentinel table entry is clamped to a real page before any address is
// formed; the committed-slot mask keeps it out of the sum. Blocks past the
// row's committed slots load nothing and leave an empty partial. A second,
// small kernel combines the splits' (max, denominator, accumulator) triples
// into the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // slots staged per tile
constexpr int kSplit = 128;      // slots per block (split-K over slots)
constexpr int kMaxG = 16;        // query heads per kv head
constexpr int kMaxD = 256;       // head dim
constexpr int kMaxElems = 16;    // accumulator elements per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
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

// dynamic shared memory of one split block, in bytes
template <typename T>
constexpr size_t smem_bytes(int g, int d) {
  return 2 * sizeof(T) * kTile * d                 // K and V tiles
         + sizeof(float) * (g * d + g * kTile)     // query rows, probabilities
         + sizeof(long long) * kTile;              // row offsets of the tile
}

template <typename T>
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
  float acc[kMaxElems];
#pragma unroll
  for (int i = 0; i < kMaxElems; ++i) acc[i] = 0.f;

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
    for (int i = 0; i < kMaxElems; ++i) {
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
  for (int i = 0; i < kMaxElems; ++i) {
    const int e = tid + i * kThreads;
    if (e < gd) part_acc[part * gd + e] = acc[i];
  }
  if (tid < g) {
    part_ml[(part * g + tid) * 2] = m_s[tid];
    part_ml[(part * g + tid) * 2 + 1] = l_s[tid];
  }
}

// out[b, h*g + r, :] = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - max m)
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     T* __restrict__ out, int hkv, int g, int d, int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int gd = g * d;
  const size_t first = ((size_t)b * hkv + h) * n_splits;
  const size_t head_off = ((size_t)b * hkv * g + (size_t)h * g) * d;
  for (int e = threadIdx.x; e < gd; e += blockDim.x) {
    const int r = e / d;
    float m = kNegInf;
    for (int s = 0; s < n_splits; ++s) m = fmaxf(m, part_ml[((first + s) * g + r) * 2]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(part_ml[((first + s) * g + r) * 2] - m);
      l = fmaf(w, part_ml[((first + s) * g + r) * 2 + 1], l);
      o = fmaf(w, part_acc[(first + s) * gd + e], o);
    }
    out[head_off + e] = from_f32<T>(o / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tables,
                   const void* pos, void* out, float* part_acc, float* part_ml,
                   int batch, int hkv, int g, int d, int n_tab, int page, int sc,
                   int n_phys, int n_splits, float scale, cudaStream_t stream) {
  const int bytes = static_cast<int>(smem_bytes<T>(g, d));
  cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  paged_split_kernel<T><<<dim3(n_splits, hkv, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(pos), part_acc,
      part_ml, hkv, g, d, n_tab, page, sc, n_phys, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<dim3(hkv, batch), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), hkv, g, d, n_splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part_acc / part_ml: float32 workspace
// of B*Hkv*n_splits*g*D and B*Hkv*n_splits*g*2 elements with
// n_splits = ceil(min(sc, n_tab*page) / split_slots). K/V rows must be
// 16-byte aligned (D * itemsize % 16 == 0, 16-byte aligned base pointers).
// Returns the launches' cudaError_t.
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* tables, const void* pos, void* out,
                            void* part_acc, void* part_ml, int dtype, int batch, int hkv,
                            int g, int d, int n_tab, int page, int sc, int n_phys,
                            int n_splits, int split_slots, float scale, void* stream) {
  if (g < 1 || g > kMaxG || d < 1 || d > kMaxD || g * d > kThreads * kMaxElems ||
      n_splits < 1 || split_slots != kSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, tables, pos, out, pa, pm, batch, hkv, g, d, n_tab, page,
                        sc, n_phys, n_splits, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, tables, pos, out, pa, pm, batch, hkv, g, d, n_tab,
                                page, sc, n_phys, n_splits, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
