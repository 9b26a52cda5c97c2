// Flash attention forward for Hopper (sm_90a): GQA, causal and/or sliding
// window, q_offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel). Same function: for query row i of
// head hq (absolute position q_offset + i) and key j of kv head hq / g,
//   mask(i, j) = j < Sk && (!causal || j <= q_offset + i)
//                       && (window <= 0 || j > q_offset + i - window),
// scores q . k * D^-0.5 in float32 masked to -1e30, an online softmax in
// float32, P cast to V's dtype before the P.V product, and rows with no
// unmasked key giving zeros.
//
// What bounds it on an H100: operations. At prefill lengths each K/V tile
// is reused by a whole tile of queries (64 here), so the work per byte is
// far above the memory roofline, and only the tensor cores reach the
// card's rate.
//
// What the design does about it. Both paths: one block of 4 warps per
// (b * Hq, 64-row query tile) keeps its query tile in shared memory and
// loops over 64-key tiles of the kv head it reads (bh / g, so the GQA
// expansion is never materialized); kv tiles wholly outside the causal /
// window mask are skipped (they contribute exactly zero) and the ragged Sk
// tail is masked per element with no padding copy.
// - bfloat16 (the serving path): the tensor cores through mma.sync
//   m16n8k16 (bf16 in, float32 accumulate). Each warp owns 16 query rows;
//   its Q fragments stay in registers for the whole kv loop, K and V tiles
//   reach the MMAs through ldmatrix (V transposed on the fly) from padded,
//   bank-conflict-free shared rows, and the score accumulators are rounded
//   to bf16 in registers to become the P operand of the P.V product — S
//   and P never touch shared memory. Tiles are loaded synchronously;
//   cp.async/TMA pipelining and wgmma are later work.
// - float32: the CUDA cores. Each of the 128 threads owns an 8 x 4 block of
//   the score tile and an 8 x D/16 block of the output, so every shared
//   value it loads feeds 8 or 4 multiply-adds; K is stored transposed so the
//   score loop reads it with 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per kv tile
constexpr int NT = 128;                // threads per block (4 warps)
constexpr int KTP = BK + 4;            // padded row of the transposed K tile
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  return BQ * D + (D * KTP > BK * D ? D * KTP : BK * D) + BQ * BK;
}

// half-warp reductions: the 16 threads sharing one row group are
// consecutive lanes, so xor offsets below 16 stay inside the group
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT)
flash_fp32_kernel(const float* __restrict__ q,   // (B, Hq, Sq, D)
                  const float* __restrict__ k,   // (B, Hkv, Sk, D)
                  const float* __restrict__ v,   // (B, Hkv, Sk, D)
                  float* __restrict__ out,       // (B, Hq, Sq, D)
                  int hq, int hkv, int sq, int sk, int causal, int window,
                  int q_offset, float scale) {
  constexpr int DC = D / 16;           // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // BQ x D, pre-scaled
  float* kv_s = q_s + BQ * D;          // K^T (D x KTP), then V (BK x D)
  float* p_s = kv_s + (D * KTP > BK * D ? D * KTP : BK * D);  // BQ x BK

  const int tid = threadIdx.x;
  const int ty = tid >> 4;             // row group: rows ty*8 .. ty*8+7
  const int tx = tid & 15;             // score cols tx*4.., output cols tx+16j
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int g = hq / hkv;
  const int q0 = blockIdx.x * BQ;

  const float* qb = q + (size_t)bh * sq * D;
  const size_t kv_head = (size_t)b * hkv + h / g;
  const float* kb = k + kv_head * sk * D;
  const float* vb = v + kv_head * sk * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D;
    const int c = e - r * D;
    q_s[e] = (q0 + r < sq) ? qb[(size_t)(q0 + r) * D + c] * scale : 0.f;
  }

  float o[8][DC];
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[i][j] = 0.f;
  }

  // kv range that can hold an unmasked key for some row of this tile
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + BQ, sq) - 1;
  int kv_end = sk;
  if (causal) kv_end = min(kv_end, qhi + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, qlo - window + 1);
  kv_begin = (kv_begin / BK) * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile's P.V done before kv_s is overwritten
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D;
      const int dd = e - c * D;
      kv_s[dd * KTP + c] = (k0 + c < sk) ? kb[(size_t)(k0 + c) * D + dd] : 0.f;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float kk[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(&kv_s[(dd + j) * KTP + tx * 4]);
        kk[j][0] = t.x; kk[j][1] = t.y; kk[j][2] = t.z; kk[j][3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(&q_s[(ty * 8 + i) * D + dd]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = s[i][c];
          a = fmaf(qq.x, kk[0][c], a);
          a = fmaf(qq.y, kk[1][c], a);
          a = fmaf(qq.z, kk[2][c], a);
          a = fmaf(qq.w, kk[3][c], a);
          s[i][c] = a;
        }
      }
    }
    __syncthreads();  // everyone is done reading K before V replaces it

    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D;
      kv_s[e] = (k0 + c < sk) ? vb[(size_t)k0 * D + e] : 0.f;
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q_offset + q0 + ty * 8 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        ok[c] = kpos < sk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        if (!ok[c]) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float p[4];
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += p[c];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) o[i][j] *= alpha;
      // P is already in V's dtype (float32)
      *reinterpret_cast<float4*>(&p_s[(ty * 8 + i) * BK + tx * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();  // V tile and P tile complete

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pp[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&p_s[(ty * 8 + i) * BK + c]);
        pp[i][0] = t.x; pp[i][1] = t.y; pp[i][2] = t.z; pp[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float vv = kv_s[(c + cc) * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i) o[i][j] = fmaf(pp[i][cc], vv, o[i][j]);
        }
      }
    }
  }

  float* ob = out + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r < sq) {
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
      for (int j = 0; j < DC; ++j) ob[(size_t)r * D + tx + 16 * j] = o[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulate)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * 64 * (D + 8) * 2;  // Q, K and V tiles of padded bf16 rows
}

// Copies rows [row0, row0 + 64) of a (rows, D) bf16 matrix into a padded
// shared tile with 16-byte loads; rows past n_rows are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n_rows,
                                          int tid) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  for (int c = tid; c < 64 * CPR; c += NT) {
    const int r = c / CPR;
    const int col = c - r * CPR;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D) + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_mma_kernel(const bf16* __restrict__ q,   // (B, Hq, Sq, D)
                 const bf16* __restrict__ k,   // (B, Hkv, Sk, D)
                 const bf16* __restrict__ v,   // (B, Hkv, Sk, D)
                 bf16* __restrict__ out,       // (B, Hq, Sq, D)
                 int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                 float scale) {
  constexpr int LD = D + 8;            // padded row: ldmatrix rows hit distinct banks
  constexpr int KS = D / 16;           // k-steps over D
  constexpr int DN = D / 8;            // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + 64 * LD;
  bf16* v_s = k_s + 64 * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int g = hq / hkv;
  const int q0 = blockIdx.x * BQ;
  const size_t kv_head = (size_t)b * hkv + h / g;
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* kb = k + kv_head * sk * D;
  const bf16* vb = v + kv_head * sk * D;

  load_tile<D>(q_s, qb, q0, sq, tid);
  __syncthreads();
  uint32_t qf[KS][4];                  // this warp's 16 query rows, all of D
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);

  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};     // rows lane/4 and lane/4 + 8 of the warp
  float l[2] = {0.f, 0.f};
  const int qpos0 = q_offset + q0 + warp * 16 + (lane >> 2);

  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + BQ, sq) - 1;
  int kv_end = sk;
  if (causal) kv_end = min(kv_end, qhi + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, qlo - window + 1);
  kv_begin = (kv_begin / BK) * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile's ldmatrix reads done
    load_tile<D>(k_s, kb, k0, sk, tid);
    load_tile<D>(v_s, vb, k0, sk, tid);
    __syncthreads();

    float s[8][4];                     // 16 rows x 64 keys: 8 n-tiles
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, k_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = qpos0 + half * 8;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + n * 8 + (lane & 3) * 2 + c;
          const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          const float val = ok ? s[n][half * 2 + c] * scale : kNegInf;
          s[n][half * 2 + c] = val;
          mx = fmaxf(mx, val);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + n * 8 + (lane & 3) * 2 + c;
          const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          const float p = ok ? expf(s[n][half * 2 + c] - m_new) : 0.f;
          s[n][half * 2 + c] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m[half] - m_new);
      l[half] = alpha * l[half] + sum;
      m[half] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        o[j][half * 2] *= alpha;
        o[j][half * 2 + 1] *= alpha;
      }
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the bf16
    // A fragment of keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  bf16* ob = out + (size_t)bh * sq * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + warp * 16 + (lane >> 2) + half * 8;
    if (r < sq) {
      const float inv = 1.f / (l[half] == 0.f ? 1.f : l[half]);
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * D + col) =
            __floats2bfloat162_rn(o[j][half * 2] * inv, o[j][half * 2 + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, int batch,
                        int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                        float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fp32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, batch * hq);
  flash_fp32_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, sq, sk, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int batch,
                        int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                        float scale, cudaStream_t stream) {
  const int bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, batch * hq);
  flash_mma_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), hq, hkv, sq, sk, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out,
                   int batch, int hq, int hkv, int sq, int sk, int causal, int window,
                   int q_offset, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_fp32<D>(q, k, v, out, batch, hq, hkv, sq, sk, causal, window, q_offset,
                          scale, s);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, out, batch, hq, hkv, sq, sk, causal, window, q_offset,
                          scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}; bfloat16 rows must
// be 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int batch, int hq, int hkv, int sq, int sk, int d,
                               int causal, int window, int q_offset, float scale,
                               void* stream) {
  if (hkv < 1 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 32:
      err = launch<32>(dtype, q, k, v, out, batch, hq, hkv, sq, sk, causal, window, q_offset,
                       scale, s);
      break;
    case 64:
      err = launch<64>(dtype, q, k, v, out, batch, hq, hkv, sq, sk, causal, window, q_offset,
                       scale, s);
      break;
    case 128:
      err = launch<128>(dtype, q, k, v, out, batch, hq, hkv, sq, sk, causal, window, q_offset,
                        scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
