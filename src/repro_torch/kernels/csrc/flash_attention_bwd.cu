// Flash attention backward for Hopper (sm_90a): the gradient of the
// training forward (flash_attention.cu with its lse output), GQA, causal
// and/or sliding window, q_offset.
//
// The gradient of the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention), which has no Pallas backward: the reference computes it
// in XLA, as the custom VJP of src/repro/models/attention.py (_blocked_bwd,
// the recompute rule). This kernel computes what that rule computes:
// for query row i of head hq (absolute position q_offset + i) and key j of
// kv head hq / g, with mask(i, j) as in the forward,
//   p     = mask ? exp(q_i . k_j * scale - lse_i) : 0
//   delta = sum_d dout_i * out_i
//   ds    = p * (dout_i . v_j - delta_i) * scale
//   dv_j += p * dout_i,  dk_j += ds * q_i,  dq_i += ds * k_j
// with dk and dv summed over the g query heads of each kv head (K and V are
// never expanded). Rows that see no key (lse = -1e30) get dq = 0; keys that
// no query sees get dk = dv = 0.
//
// What bounds it on an H100: operations. Five products of 2 D FLOPs per
// unmasked (query, key) pair (S = Q.K^T, dP = dO.V^T, dV, dK, dQ) against
// q, k, v, out, dout read once and dq, dk, dv written once: at Yi's training
// shape hundreds of FLOPs per byte, far above the memory roofline.
//
// What the design does about it: the deterministic two-pass FlashAttention-2
// backward, every sum in a fixed order (two calls give identical bits), no
// atomics, no expanded K/V, nothing of size Sq x Sk in device memory.
// - pass 0 (flash_bwd_delta_kernel): delta = rowsum(dout * out) in float32,
//   one warp a row, into a (B, Hq, Sq) float32 scratch buffer.
// - pass 1 (dK, dV): one block per (64-key tile, batch row x kv head, column
//   chunk). The block keeps its K and V tiles in shared memory and its dK
//   and dV accumulators in registers, walks the g query heads of its group
//   and in each the query tiles the masks leave, and per query tile
//   recomputes S^T = K.Q^T and P^T = exp2(S^T * scale * log2(e) - lse *
//   log2(e)), then dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T * (dP^T - delta)
//   * scale and dK += dS^T.Q. It writes dK and dV once.
// - pass 2 (dQ): one block per (64-row query tile, batch row x query head,
//   column chunk). It walks the key tiles its rows see, recomputes S, P, dP
//   and dS the same way and accumulates dQ += dS.K. It writes dQ once.
// Both passes skip query or key tiles wholly outside the causal and window
// masks by the forward's rule and mask per element inside the tiles; the
// mask is applied before the exponential, so a row whose lse is -1e30 never
// overflows. P is recomputed in the exp2 domain in every pass and dtype
// (the bfloat16 forward's lse comes from its exp2-domain maximum).
// The accumulators of one thread cover a chunk of at most 128 of the D
// output columns: at D = 256 (recurrentgemma-2b) each pass runs two column
// chunks, each recomputing S and dP over the full D, since a 64-key tile's
// dK and dV over all 256 columns would not fit a thread's 255 registers.
// - bfloat16: mma.sync m16n8k16 with float32 accumulators, tiles of padded
//   bf16 rows in shared memory read through ldmatrix (.trans where the
//   contraction runs over the tile's rows), the S^T/S and dP^T/dP
//   accumulators reused in registers as the A operands of the next
//   products. P and dS are rounded to bfloat16 where they feed a product
//   (dV += P^T.dO, dK += dS^T.Q, dQ += dS.K); dS itself is computed from P
//   in float32. Pass 1: 4 warps x 16 keys, query tiles of 64 rows where the
//   column chunk is at most 64 wide, else 32 (dK and dV at 128 columns take
//   128 registers a thread). Pass 2: 4 warps x 16 rows, 64-key tiles.
// - float32 (the float32 training checks): the CUDA cores, 256 threads a block,
//   each thread one key (pass 1) or one row (pass 2) of the score tile and
//   the same row of its accumulators; P^T and dS^T (pass 1) or dS (pass 2)
//   go through shared memory into the accumulating products. Pass 1: 64
//   keys x 32-row query tiles; pass 2: 64 rows x 32-key tiles.
// Loads are synchronous (global -> registers -> shared); TMA, wgmma and
// a ring of stages are for a later pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int BKV = 64;      // keys per block of pass 1 (both dtypes), per tile of pass 2 (bf16)
constexpr int BQ = 64;       // query rows per block of pass 2 (both dtypes)
constexpr int NT = 128;      // threads of a bfloat16 block: 4 warps
constexpr int NTF = 256;     // threads of a float32 block
constexpr int FBM = 32;      // float32 pass 1: query rows per tile
constexpr int FBK = 32;      // float32 pass 2: keys per tile

// the most output columns a block accumulates
template <int D>
constexpr int CHUNK_COLS = D < 128 ? D : 128;

// bfloat16 pass 1: query rows per tile
template <int D>
constexpr int MMA_BM = CHUNK_COLS<D> <= 64 ? 64 : 32;

// (query row i, key j) seen: i < sq, j < sk and the causal / window masks
// at absolute query position q_offset + i
struct Mask {
  int sq, sk, causal, window, q_offset;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    const int qpos = q_offset + i;
    return i < sq && j < sk && (!causal || j <= qpos) && (window <= 0 || j > qpos - window);
  }
};

// the query rows [begin, end) that keys [k0, k0 + BKV) can be seen by,
// begin rounded down to a multiple of bm; empty when begin >= end
__device__ __forceinline__ void q_range(int k0, int sq, int sk, int causal, int window,
                                        int q_offset, int bm, int& begin, int& end) {
  const int k_last = min(k0 + BKV, sk) - 1;
  begin = causal ? max(0, k0 - q_offset) : 0;
  end = window > 0 ? min(sq, k_last + window - q_offset) : sq;
  begin = (begin / bm) * bm;
}

// the keys [begin, end) that query rows [q0, q_last] can see (the forward's
// kv_range), begin rounded down to a multiple of bk
__device__ __forceinline__ void k_range(int q0, int q_last, int sk, int causal, int window,
                                        int q_offset, int bk, int& begin, int& end) {
  end = causal ? min(sk, q_offset + q_last + 1) : sk;
  begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  begin = (begin / bk) * bk;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// pass 0: delta = rowsum(dout * out), one warp a row, lanes in a fixed order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + (size_t)row * d;
  const T* g = dout + (size_t)row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(g[c]), to_f32(o[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16, float32 accumulate
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
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

// Copies rows [row0, row0 + R) of a (rows, D) bf16 matrix into a shared
// tile of padded rows (D + 8: ldmatrix's 8 rows hit distinct banks) with
// 16-byte loads; rows past n_rows are zero.
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n_rows) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < R * CPR; c += NT) {
    const int r = c / CPR;
    const int col = c - r * CPR;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D) + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col * 8) = val;
  }
}

// acc (16 x 8 N) = A (16 rows of a, row-major over D) . B^T (N 8-row groups
// of b, row-major over D): the A fragment of rows a_row0 .. + 15 and the B
// fragments of rows 0 .. 8 N - 1 of b, both through ldmatrix, over all of D
template <int D, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N][4], const bf16* a, int a_row0,
                                           const bf16* b, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (a_row0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                           ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc (16 x DC) += X (16 x 16 KN, the float32 accumulators x of KN 16-wide
// column pairs, rounded to bf16 here) . B (16 KN rows of b, columns c0 ..
// c0 + DC - 1), B read through ldmatrix.trans
template <int D, int DC, int KN>
__device__ __forceinline__ void product_acc(float (&acc)[DC / 8][4], const float (&x)[2 * KN][4],
                                            const bf16* b, int c0, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DC / 16; ++dp) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
                                 dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], xa, bfr[0], bfr[1]);
      mma_bf16(acc[2 * dp + 1], xa, bfr[2], bfr[3]);
    }
  }
}

template <int D>
constexpr int mma_dkdv_smem() {
  return (2 * BKV + 2 * MMA_BM<D>) * (D + 8) * 2 + 2 * MMA_BM<D> * 4;
}

template <int D>
constexpr int mma_dq_smem() {
  return (2 * BQ + 2 * BKV) * (D + 8) * 2;
}

// Accumulator element e of n-tile n of a thread (lane): row lane / 4 + 8 (e
// / 2), column 8 n + 2 (lane % 4) + e % 2 (mma.sync's C layout).

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,      // (B, Hq, Sq, D)
                          const bf16* __restrict__ k,      // (B, Hkv, Sk, D)
                          const bf16* __restrict__ v,      // (B, Hkv, Sk, D)
                          const bf16* __restrict__ dout,   // (B, Hq, Sq, D)
                          const float* __restrict__ lse,   // (B, Hq, Sq)
                          const float* __restrict__ delta, // (B, Hq, Sq)
                          bf16* __restrict__ dk, bf16* __restrict__ dv,  // (B, Hkv, Sk, D)
                          int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                          float scale) {
  constexpr int LD = D + 8;
  constexpr int DC = CHUNK_COLS<D>;
  constexpr int BM = MMA_BM<D>;
  constexpr int QN = BM / 8;           // 8-wide query n-tiles of a tile
  extern __shared__ __align__(16) unsigned char smem_dkdv[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_dkdv);   // BKV x LD
  bf16* v_s = k_s + BKV * LD;
  bf16* q_s = v_s + BKV * LD;                        // BM x LD
  bf16* do_s = q_s + BM * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BM * LD);   // BM: lse * log2(e)
  float* dl_s = lse_s + BM;                                  // BM: delta

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BKV;
  const int bkv = blockIdx.y;            // batch row * hkv + kv head
  const int b = bkv / hkv;
  const int hk = bkv - b * hkv;
  const int c0 = blockIdx.z * DC;
  const int g = hq / hkv;
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};

  load_rows<D, BKV>(k_s, k + (size_t)bkv * sk * D, k0, sk);
  load_rows<D, BKV>(v_s, v + (size_t)bkv * sk * D, k0, sk);

  float dk_acc[DC / 8][4], dv_acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int key0 = k0 + warp * 16 + (lane >> 2);   // this thread's keys key0, key0 + 8
  const int col = 2 * (lane & 3);
  int qb, qe;
  q_range(k0, sq, sk, causal, window, q_offset, BM, qb, qe);

  for (int h = 0; h < g; ++h) {
    const size_t bh = (size_t)b * hq + (size_t)hk * g + h;
    const bf16* qh = q + bh * sq * D;
    const bf16* doh = dout + bh * sq * D;
    for (int q0 = qb; q0 < qe; q0 += BM) {
      __syncthreads();   // the last tile's ldmatrix reads are done
      load_rows<D, BM>(q_s, qh, q0, sq);
      load_rows<D, BM>(do_s, doh, q0, sq);
      for (int r = threadIdx.x; r < BM; r += NT) {
        const bool in = q0 + r < sq;
        lse_s[r] = in ? lse[bh * sq + q0 + r] * kLog2e : 0.f;
        dl_s[r] = in ? delta[bh * sq + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T (this warp's 16 keys x BM queries) = K . Q^T, then P^T
      float s[QN][4];
      product_nt<D, QN>(s, k_s, warp * 16, q_s, lane);
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + col + (e & 1);
          const bool seen = ok(q0 + qi, key0 + 8 * (e >> 1));
          s[n][e] = seen ? exp2f(fmaf(s[n][e], c, -lse_s[qi])) : 0.f;
        }
      // dV += P^T . dO (P^T rounded to bf16)
      product_acc<D, DC, BM / 16>(dv_acc, s, do_s, c0, lane);
      // dP^T = V . dO^T, then dS^T = P^T * (dP^T - delta) * scale
      float dp[QN][4];
      product_nt<D, QN>(dp, v_s, warp * 16, do_s, lane);
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (dp[n][e] - dl_s[n * 8 + col + (e & 1)]) * scale;
      // dK += dS^T . Q (dS^T rounded to bf16)
      product_acc<D, DC, BM / 16>(dk_acc, dp, q_s, c0, lane);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + 8 * half;
    if (key < sk) {
      const size_t base = ((size_t)bkv * sk + key) * D + c0 + col;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j) =
            __floats2bfloat162_rn(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j) =
            __floats2bfloat162_rn(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,      // (B, Hq, Sq, D)
                        const bf16* __restrict__ k,      // (B, Hkv, Sk, D)
                        const bf16* __restrict__ v,      // (B, Hkv, Sk, D)
                        const bf16* __restrict__ dout,   // (B, Hq, Sq, D)
                        const float* __restrict__ lse,   // (B, Hq, Sq)
                        const float* __restrict__ delta, // (B, Hq, Sq)
                        bf16* __restrict__ dq,           // (B, Hq, Sq, D)
                        int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                        float scale) {
  constexpr int LD = D + 8;
  constexpr int DC = CHUNK_COLS<D>;
  constexpr int KN = BKV / 8;          // 8-wide key n-tiles of a tile
  extern __shared__ __align__(16) unsigned char smem_dq[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_dq);   // BQ x LD
  bf16* do_s = q_s + BQ * LD;
  bf16* k_s = do_s + BQ * LD;                      // BKV x LD
  bf16* v_s = k_s + BKV * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int g = hq / hkv;
  const size_t kv_head = (size_t)b * hkv + h / g;
  const int c0 = blockIdx.z * DC;
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};

  load_rows<D, BQ>(q_s, q + (size_t)bh * sq * D, q0, sq);
  load_rows<D, BQ>(do_s, dout + (size_t)bh * sq * D, q0, sq);
  const int row0 = q0 + warp * 16 + (lane >> 2);   // this thread's rows row0, row0 + 8
  const int col = 2 * (lane & 3);
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    lse2[half] = r < sq ? lse[(size_t)bh * sq + r] * kLog2e : 0.f;
    dl[half] = r < sq ? delta[(size_t)bh * sq + r] : 0.f;
  }

  float dq_acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  int kb, ke;
  k_range(q0, min(q0 + BQ, sq) - 1, sk, causal, window, q_offset, BKV, kb, ke);
  const bf16* kh = k + kv_head * sk * D;
  const bf16* vh = v + kv_head * sk * D;
  for (int k0 = kb; k0 < ke; k0 += BKV) {
    __syncthreads();   // the last tile's ldmatrix reads are done (and Q, dO stored)
    load_rows<D, BKV>(k_s, kh, k0, sk);
    load_rows<D, BKV>(v_s, vh, k0, sk);
    __syncthreads();

    // S (this warp's 16 rows x 64 keys) = Q . K^T, then P
    float s[KN][4];
    product_nt<D, KN>(s, q_s, warp * 16, k_s, lane);
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool seen = ok(row0 + 8 * (e >> 1), k0 + n * 8 + col + (e & 1));
        s[n][e] = seen ? exp2f(fmaf(s[n][e], c, -lse2[e >> 1])) : 0.f;
      }
    // dP = dO . V^T, then dS = P * (dP - delta) * scale
    float dp[KN][4];
    product_nt<D, KN>(dp, do_s, warp * 16, v_s, lane);
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]) * scale;
    // dQ += dS . K (dS rounded to bf16)
    product_acc<D, DC, BKV / 16>(dq_acc, dp, k_s, c0, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    if (r < sq) {
      const size_t base = ((size_t)bh * sq + r) * D + c0 + col;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + 8 * j) =
            __floats2bfloat162_rn(dq_acc[j][2 * half], dq_acc[j][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// Copies rows [row0, row0 + R) of a (rows, D) float32 matrix into a shared
// tile of rows padded to D + 4 floats with 16-byte loads; rows past n_rows
// are zero.
template <int D, int R>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int row0,
                                              int n_rows) {
  constexpr int LD = D + 4;
  constexpr int CPR = D / 4;
  for (int c = threadIdx.x; c < R * CPR; c += NTF) {
    const int r = c / CPR;
    const int col = c - r * CPR;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D) + col);
    *reinterpret_cast<float4*>(dst + r * LD + col * 4) = val;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

template <int D>
constexpr int fp32_dkdv_smem() {
  return 4 * (2 * BKV * (D + 4) + 2 * FBM * (D + 4) + 2 * BKV * (FBM + 4) + 2 * FBM);
}

template <int D>
constexpr int fp32_dq_smem() {
  return 4 * (2 * BQ * (D + 4) + 2 * FBK * (D + 4) + BQ * (FBK + 4));
}

// Thread t: key (pass 1) or row (pass 2) t / 4 of the tile; of the score
// tile the columns t % 4 + 4 m; of the accumulators the columns c0 + 4 (t %
// 4) + 16 j .. + 3.
template <int D>
__global__ void __launch_bounds__(NTF)
flash_bwd_dkdv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
                           int sq, int sk, int causal, int window, int q_offset, float scale) {
  constexpr int LD = D + 4;
  constexpr int PL = FBM + 4;
  constexpr int DC = CHUNK_COLS<D>;
  constexpr int CJ = DC / 16;          // float4 column groups a thread accumulates
  constexpr int M = FBM / 4;           // score-tile columns a thread computes
  extern __shared__ float4 smem_f32_dkdv[];
  float* k_s = reinterpret_cast<float*>(smem_f32_dkdv);   // BKV x LD
  float* v_s = k_s + BKV * LD;
  float* q_s = v_s + BKV * LD;                             // FBM x LD
  float* do_s = q_s + FBM * LD;
  float* pt_s = do_s + FBM * LD;                           // BKV x PL: P^T
  float* ds_s = pt_s + BKV * PL;                           // BKV x PL: dS^T
  float* lse_s = ds_s + BKV * PL;                          // FBM
  float* dl_s = lse_s + FBM;                               // FBM

  const int tid = threadIdx.x;
  const int kl = tid >> 2;
  const int grp = tid & 3;
  const int k0 = blockIdx.x * BKV;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv;
  const int hk = bkv - b * hkv;
  const int c0 = blockIdx.z * DC;
  const int g = hq / hkv;
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};
  const int key = k0 + kl;

  load_rows_f32<D, BKV>(k_s, k + (size_t)bkv * sk * D, k0, sk);
  load_rows_f32<D, BKV>(v_s, v + (size_t)bkv * sk * D, k0, sk);

  float4 dk_acc[CJ], dv_acc[CJ];
#pragma unroll
  for (int j = 0; j < CJ; ++j) dk_acc[j] = dv_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  int qb, qe;
  q_range(k0, sq, sk, causal, window, q_offset, FBM, qb, qe);
  for (int h = 0; h < g; ++h) {
    const size_t bh = (size_t)b * hq + (size_t)hk * g + h;
    for (int q0 = qb; q0 < qe; q0 += FBM) {
      __syncthreads();   // the last tile's reads are done
      load_rows_f32<D, FBM>(q_s, q + bh * sq * D, q0, sq);
      load_rows_f32<D, FBM>(do_s, dout + bh * sq * D, q0, sq);
      for (int r = tid; r < FBM; r += NTF) {
        const bool in = q0 + r < sq;
        lse_s[r] = in ? lse[bh * sq + q0 + r] * kLog2e : 0.f;
        dl_s[r] = in ? delta[bh * sq + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[M], dp[M];
#pragma unroll
      for (int m = 0; m < M; ++m) s[m] = dp[m] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(k_s + kl * LD + d);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + kl * LD + d);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int qi = grp + 4 * m;
          s[m] = dot4(kk, *reinterpret_cast<const float4*>(q_s + qi * LD + d), s[m]);
          dp[m] = dot4(vv, *reinterpret_cast<const float4*>(do_s + qi * LD + d), dp[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int qi = grp + 4 * m;
        const float p = ok(q0 + qi, key) ? exp2f(fmaf(s[m], c, -lse_s[qi])) : 0.f;
        pt_s[kl * PL + qi] = p;
        ds_s[kl * PL + qi] = p * (dp[m] - dl_s[qi]) * scale;
      }
      __syncthreads();

      // dV += P^T . dO, dK += dS^T . Q over the tile's rows, in order
#pragma unroll 4
      for (int i = 0; i < FBM; ++i) {
        const float p = pt_s[kl * PL + i];
        const float ds = ds_s[kl * PL + i];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int cc = c0 + 4 * grp + 16 * j;
          axpy4(dv_acc[j], p, *reinterpret_cast<const float4*>(do_s + i * LD + cc));
          axpy4(dk_acc[j], ds, *reinterpret_cast<const float4*>(q_s + i * LD + cc));
        }
      }
    }
  }

  if (key < sk) {
    const size_t base = ((size_t)bkv * sk + key) * D + c0 + 4 * grp;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      *reinterpret_cast<float4*>(dk + base + 16 * j) = dk_acc[j];
      *reinterpret_cast<float4*>(dv + base + 16 * j) = dv_acc[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTF)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int hq, int hkv, int sq, int sk, int causal,
                         int window, int q_offset, float scale) {
  constexpr int LD = D + 4;
  constexpr int SL = FBK + 4;
  constexpr int DC = CHUNK_COLS<D>;
  constexpr int CJ = DC / 16;
  constexpr int M = FBK / 4;
  extern __shared__ float4 smem_f32_dq[];
  float* q_s = reinterpret_cast<float*>(smem_f32_dq);   // BQ x LD
  float* do_s = q_s + BQ * LD;
  float* k_s = do_s + BQ * LD;                           // FBK x LD
  float* v_s = k_s + FBK * LD;
  float* ds_s = v_s + FBK * LD;                          // BQ x SL: dS

  const int tid = threadIdx.x;
  const int rl = tid >> 2;
  const int grp = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int g = hq / hkv;
  const size_t kv_head = (size_t)b * hkv + h / g;
  const int c0 = blockIdx.z * DC;
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};
  const int row = q0 + rl;
  const float lse2 = row < sq ? lse[(size_t)bh * sq + row] * kLog2e : 0.f;
  const float dl = row < sq ? delta[(size_t)bh * sq + row] : 0.f;

  load_rows_f32<D, BQ>(q_s, q + (size_t)bh * sq * D, q0, sq);
  load_rows_f32<D, BQ>(do_s, dout + (size_t)bh * sq * D, q0, sq);

  float4 dq_acc[CJ];
#pragma unroll
  for (int j = 0; j < CJ; ++j) dq_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  int kb, ke;
  k_range(q0, min(q0 + BQ, sq) - 1, sk, causal, window, q_offset, FBK, kb, ke);
  const float* kh = k + kv_head * sk * D;
  const float* vh = v + kv_head * sk * D;
  for (int k0 = kb; k0 < ke; k0 += FBK) {
    __syncthreads();   // the last tile's reads are done (and Q, dO stored)
    load_rows_f32<D, FBK>(k_s, kh, k0, sk);
    load_rows_f32<D, FBK>(v_s, vh, k0, sk);
    __syncthreads();

    float s[M], dp[M];
#pragma unroll
    for (int m = 0; m < M; ++m) s[m] = dp[m] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(q_s + rl * LD + d);
      const float4 oo = *reinterpret_cast<const float4*>(do_s + rl * LD + d);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int kj = grp + 4 * m;
        s[m] = dot4(qq, *reinterpret_cast<const float4*>(k_s + kj * LD + d), s[m]);
        dp[m] = dot4(oo, *reinterpret_cast<const float4*>(v_s + kj * LD + d), dp[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int kj = grp + 4 * m;
      const float p = ok(row, k0 + kj) ? exp2f(fmaf(s[m], c, -lse2)) : 0.f;
      ds_s[rl * SL + kj] = p * (dp[m] - dl) * scale;
    }
    __syncthreads();

    // dQ += dS . K over the tile's keys, in order
#pragma unroll 4
    for (int j2 = 0; j2 < FBK; ++j2) {
      const float ds = ds_s[rl * SL + j2];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        axpy4(dq_acc[j], ds, *reinterpret_cast<const float4*>(k_s + j2 * LD + c0 + 4 * grp +
                                                               16 * j));
    }
  }

  if (row < sq) {
    const size_t base = ((size_t)bh * sq + row) * D + c0 + 4 * grp;
#pragma unroll
    for (int j = 0; j < CJ; ++j) *reinterpret_cast<float4*>(dq + base + 16 * j) = dq_acc[j];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* out,
                       const float* lse, const void* dout, float* delta, void* dq, void* dk,
                       void* dv, int batch, int hq, int hkv, int sq, int sk, int causal,
                       int window, int q_offset, float scale, cudaStream_t s) {
  constexpr int CHUNKS = D / CHUNK_COLS<D>;
  const int rows = batch * hq * sq;
  const dim3 grid_kv((sk + BKV - 1) / BKV, batch * hkv, CHUNKS);
  const dim3 grid_q((sq + BQ - 1) / BQ, batch * hq, CHUNKS);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *of = static_cast<const float*>(dout);
    if (rows > 0)
      flash_bwd_delta_kernel<float><<<(rows + 7) / 8, 256, 0, s>>>(
          static_cast<const float*>(out), of, delta, rows, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (grid_kv.x > 0 && grid_kv.y > 0) {
      if ((err = set_smem(flash_bwd_dkdv_fp32_kernel<D>, fp32_dkdv_smem<D>())) != cudaSuccess)
        return err;
      flash_bwd_dkdv_fp32_kernel<D><<<grid_kv, NTF, fp32_dkdv_smem<D>(), s>>>(
          qf, kf, vf, of, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), hq, hkv,
          sq, sk, causal, window, q_offset, scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (grid_q.x > 0 && grid_q.y > 0) {
      if ((err = set_smem(flash_bwd_dq_fp32_kernel<D>, fp32_dq_smem<D>())) != cudaSuccess)
        return err;
      flash_bwd_dq_fp32_kernel<D><<<grid_q, NTF, fp32_dq_smem<D>(), s>>>(
          qf, kf, vf, of, lse, delta, static_cast<float*>(dq), hq, hkv, sq, sk, causal, window,
          q_offset, scale);
      err = cudaGetLastError();
    }
    return err;
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(dout);
  if (rows > 0)
    flash_bwd_delta_kernel<bf16><<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(out),
                                                                ob, delta, rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (grid_kv.x > 0 && grid_kv.y > 0) {
    if ((err = set_smem(flash_bwd_dkdv_mma_kernel<D>, mma_dkdv_smem<D>())) != cudaSuccess)
      return err;
    flash_bwd_dkdv_mma_kernel<D><<<grid_kv, NT, mma_dkdv_smem<D>(), s>>>(
        qb, kb, vb, ob, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, sq,
        sk, causal, window, q_offset, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (grid_q.x > 0 && grid_q.y > 0) {
    if ((err = set_smem(flash_bwd_dq_mma_kernel<D>, mma_dq_smem<D>())) != cudaSuccess)
      return err;
    flash_bwd_dq_mma_kernel<D><<<grid_q, NT, mma_dq_smem<D>(), s>>>(
        qb, kb, vb, ob, lse, delta, static_cast<bf16*>(dq), hq, hkv, sq, sk, causal, window,
        q_offset, scale);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// The gradients of the training forward: q, out, dout (batch, hq, sq, d),
// k, v (batch, hkv, sk, d), all of one dtype (0 = float32, 1 = bfloat16),
// contiguous, 16-byte aligned; lse (batch, hq, sq) float32 as the forward
// wrote it; delta: float32 scratch of batch * hq * sq. Writes dq (the
// shape and dtype of q) and dk, dv (those of k). d in {32, 64, 128, 256};
// q_offset >= 0 (the caller resolves -1 to sk - sq). Three launches on
// `stream` (delta, dK/dV, dQ); returns the first failing one's
// cudaError_t, else 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, int dtype, int batch, int hq, int hkv,
                                   int sq, int sk, int d, int causal, int window, int q_offset,
                                   float scale, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || sq < 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  switch (d) {
    case 32:
      err = launch_bwd<32>(dtype, q, k, v, out, l, dout, dl, dq, dk, dv, batch, hq, hkv, sq, sk,
                           causal, window, q_offset, scale, s);
      break;
    case 64:
      err = launch_bwd<64>(dtype, q, k, v, out, l, dout, dl, dq, dk, dv, batch, hq, hkv, sq, sk,
                           causal, window, q_offset, scale, s);
      break;
    case 128:
      err = launch_bwd<128>(dtype, q, k, v, out, l, dout, dl, dq, dk, dv, batch, hq, hkv, sq, sk,
                            causal, window, q_offset, scale, s);
      break;
    case 256:
      err = launch_bwd<256>(dtype, q, k, v, out, l, dout, dl, dq, dk, dv, batch, hq, hkv, sq, sk,
                            causal, window, q_offset, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
