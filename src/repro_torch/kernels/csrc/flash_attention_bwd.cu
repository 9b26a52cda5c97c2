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
// atomics and no sum of dQ across blocks, no expanded K/V, nothing of size
// Sq x Sk in device memory. The price: S and dP are recomputed in both
// passes, seven products where the bound counts five.
// - pass 0 (flash_bwd_delta_kernel): delta = rowsum(dout * out) in float32,
//   one warp a row, into a (B, Hq, Sq) float32 scratch buffer.
// - pass 1 (dK, dV): one block per key tile and (batch row, kv head). The
//   block keeps its K and V tiles in shared memory and its dK and dV
//   accumulators in registers, walks the g query heads of its group and in
//   each the query tiles the masks leave, and per query tile recomputes
//   S^T = K.Q^T and P^T = exp2(S^T * scale * log2(e) - lse * log2(e)),
//   then dV += P^T.dO, dP^T = V.dO^T, dS^T = P^T * (dP^T - delta) * scale
//   and dK += dS^T.Q. It writes dK and dV once.
// - pass 2 (dQ): one block per query tile and (batch row, query head). It
//   walks the key tiles its rows see in ascending order, recomputes S, P,
//   dP and dS the same way and accumulates dQ += dS.K. It writes dQ once.
// Both passes skip query or key tiles wholly outside the causal and window
// masks by the forward's rule and mask per element inside the tiles; the
// mask is applied before the exponential, so a row whose lse is -1e30 never
// overflows. P is recomputed in the exp2 domain in every pass and dtype
// (the bfloat16 forward's lse comes from its exp2-domain maximum).
// - bfloat16 at D = 128 (Yi, InternVL2, Qwen3-MoE): TMA + wgmma with warp
//   specialisation, the forward's plumbing (hopper_wgmma.cuh). A block is
//   two consumer warpgroups and a producer warpgroup (setmaxnreg: consumers
//   240 registers, producer 24). Tiles are 64-column slabs of 128-byte rows,
//   128-byte swizzled, loaded by TMA through 3-D (D, S, heads) maps, so rows
//   past Sq or Sk load as zeros.
//   Pass 1: 128 keys a block, 64 a consumer. The producer loads K and V
//   once and streams 64-row Q and dO tiles, with their rows' lse * log2(e)
//   and delta (staged by the producer warp's lanes), through a two-stage
//   ring guarded by full and empty mbarriers. Per tile a consumer issues S^T
//   and dP^T (wgmma m64n64k16, K and V against Q and dO, all from shared
//   memory) as two groups; it forms P^T while dP^T is in flight, rounds it
//   to bf16 in place into the A fragments of dV += P^T.dO (m64n128k16, dO
//   read through the descriptor's transpose bit, as the forward reads V),
//   forms dS^T while that product runs and issues dK += dS^T.Q likewise.
//   dK 64 + dV 64 + S^T 32 + dP^T 32 accumulator registers a thread. Under
//   a causal or window mask kv heads vary fastest and key tiles go in order,
//   the first (which the most rows see) first; without one key tiles vary
//   fastest.
//   Pass 2: 128 rows a block, 64 a consumer; Q and dO loaded once, 64-key
//   K and V tiles through a two-stage ring. Per tile S and dP (m64n64k16),
//   P while dP is in flight, dS into dP's registers, rounded to bf16 into
//   the A fragments of dQ += dS.K (m64n128k16, K through the transpose bit):
//   dQ 64 + S 32 + dP 32 registers. Query tiles go longest first under a
//   mask, as the forward's do.
//   Both passes skip, per consumer, a tile none of whose pairs its rows or
//   keys see (an exact zero), and mask per element only where the Sq or Sk
//   tail, the diagonal or the window's edge crosses the tile. 2^x comes from
//   ex2.approx.ftz (one special-function instruction: within 2 ulp, below
//   P's bf16 rounding; P under 2^-126 becomes 0).
//   What bounds it: the chain of each consumer's tile (products, then the
//   exponentials, dS and the last product, then a wait), which the two
//   consumers overlap only in part; the registers hold it there: a deeper
//   wgmma pipeline makes ptxas serialise the products.
//   Variants timed on the card by tools/flash_bwd_sweep.py (H100 80GB
//   HBM3, 700 W; device ms at Yi's, InternVL2's and Qwen3-MoE's training
//   shapes, this design 1.1203, 0.6975, 2.1745): exp2f for ex2.approx
//   1.4389, 0.9101, 2.8262; a tile's S and dP in one group, the
//   exponentials after both, 1.1385, 0.7330, 2.2403; 128-key tiles in pass
//   2 1.1577, 0.7471, 2.2813; consumers at 232 registers with a
//   40-register producer (16 bytes of spill, wgmma serialised: C7512)
//   1.2480, 0.8049, 2.4461; three or four ring stages in either pass
//   within 6 % either way, no consistent gain. Also tried on the card and
//   dropped (builds not kept): the consumers taking turns to issue their
//   products through named barriers (no gain overall), pass 1's last wait
//   deferred into the next tile (it spilled), dS staged through shared
//   memory for a dQ product with both operands there (slower), and the
//   next tile's S and dP issued before the dQ product's wait (ptxas
//   serialised the wgmma, C7511: slower).
// - bfloat16 at D = 32, 64 and 256: mma.sync m16n8k16 with float32
//   accumulators, tiles of padded bf16 rows in shared memory read through
//   ldmatrix (.trans where the contraction runs over the tile's rows), the
//   S^T/S and dP^T/dP accumulators reused in registers as the A operands of
//   the next products. P and dS are rounded to bfloat16 where they feed a
//   product (dV += P^T.dO, dK += dS^T.Q, dQ += dS.K); dS itself is computed
//   from P in float32. Pass 1: 64-key blocks of 4 warps x 16 keys, query
//   tiles of 64 rows where the column chunk is at most 64 wide, else 32;
//   pass 2: 64-row blocks of 4 warps x 16 rows, 64-key tiles. The
//   accumulators of one thread cover a chunk of at most 128 of the D output
//   columns: at D = 256 (recurrentgemma-2b) each pass runs two column
//   chunks, each recomputing S and dP over the full D. Loads are
//   synchronous (global -> registers -> shared).
// - float32 (the float32 training checks): the CUDA cores, 256 threads a block,
//   each thread one key (pass 1) or one row (pass 2) of the score tile and
//   the same row of its accumulators; P^T and dS^T (pass 1) or dS (pass 2)
//   go through shared memory into the accumulating products. Pass 1: 64
//   keys x 32-row query tiles; pass 2: 64 rows x 32-key tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

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

// the query rows [begin, end) that keys [k0, k0 + bkv) can be seen by,
// begin rounded down to a multiple of bm; empty when begin >= end
__device__ __forceinline__ void q_range(int k0, int bkv, int sq, int sk, int causal, int window,
                                        int q_offset, int bm, int& begin, int& end) {
  const int k_last = min(k0 + bkv, sk) - 1;
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
  q_range(k0, BKV, sq, sk, causal, window, q_offset, BM, qb, qe);

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
  q_range(k0, BKV, sq, sk, causal, window, q_offset, FBM, qb, qe);
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
// bfloat16, D = 128: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

namespace hb {

using namespace wg;

constexpr int D = 128;
constexpr int SLABS = D / 64;            // 64-column slabs of a tile row
constexpr int THREADS = 384;             // warpgroups 0 and 1 consume, 2 produces
constexpr int CONSUMER_REGS = 240;       // after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65,536
constexpr int PRODUCER_REGS = 24;
// The dK/dV pass: a block's 128 keys (64 a consumer warpgroup) of one
// (batch row, kv head), K and V loaded once; a ring of STAGES query tiles
// of 64 rows (Q, dO, and the rows' lse * log2(e) and delta); shared memory
// holds K, V, the stages' Q and dO tiles, the stages' rows, the barriers.
struct Dkdv {
  static constexpr int BN = 128, BM = 64, STAGES = 2;
  static constexpr int KV_SLAB = BN * SLAB_ROW;
  static constexpr int KV_BYTES = SLABS * KV_SLAB;
  static constexpr int Q_SLAB = BM * SLAB_ROW;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int ROWS_BYTES = 2 * BM * 4;
  static constexpr int TILES = 2 * KV_BYTES + STAGES * 2 * Q_BYTES;
  static constexpr int BARRIERS = 1 + 2 * STAGES;      // kv_full; full and empty per stage
  static constexpr int SMEM_BYTES = 1024 + TILES + STAGES * ROWS_BYTES + 8 * BARRIERS;
  static_assert(SMEM_BYTES <= 232448, "the dK/dV pass's shared memory is past the limit");

  uint32_t base;
  __device__ __forceinline__ uint32_t k() const { return base; }
  __device__ __forceinline__ uint32_t v() const { return base + KV_BYTES; }
  __device__ __forceinline__ uint32_t q(int st) const {
    return base + 2 * KV_BYTES + 2 * st * Q_BYTES;
  }
  __device__ __forceinline__ uint32_t dout(int st) const { return q(st) + Q_BYTES; }
  __device__ __forceinline__ uint32_t rows(int st) const {
    return base + TILES + st * ROWS_BYTES;
  }
  __device__ __forceinline__ uint32_t bar(int i) const {
    return base + TILES + STAGES * ROWS_BYTES + 8u * i;
  }
  __device__ __forceinline__ uint32_t kv_full() const { return bar(0); }
  __device__ __forceinline__ uint32_t full(int st) const { return bar(1 + st); }
  __device__ __forceinline__ uint32_t empty(int st) const { return bar(1 + STAGES + st); }
};

// The dQ pass: a block's 128 query rows (64 a consumer warpgroup) of one
// (batch row, query head), Q and dO loaded once; a ring of STAGES key tiles
// of 64 keys (K and V).
struct Dq {
  static constexpr int BM = 128, BN = 64, STAGES = 2;
  static constexpr int Q_SLAB = BM * SLAB_ROW;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int KV_SLAB = BN * SLAB_ROW;
  static constexpr int KV_BYTES = SLABS * KV_SLAB;
  static constexpr int TILES = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int BARRIERS = 1 + 2 * STAGES;      // q_full; full and empty per stage
  static constexpr int SMEM_BYTES = 1024 + TILES + 8 * BARRIERS;
  static_assert(SMEM_BYTES <= 232448, "the dQ pass's shared memory is past the limit");

  uint32_t base;
  __device__ __forceinline__ uint32_t q() const { return base; }
  __device__ __forceinline__ uint32_t dout() const { return base + Q_BYTES; }
  __device__ __forceinline__ uint32_t k(int st) const {
    return base + 2 * Q_BYTES + 2 * st * KV_BYTES;
  }
  __device__ __forceinline__ uint32_t v(int st) const { return k(st) + KV_BYTES; }
  __device__ __forceinline__ uint32_t bar(int i) const { return base + TILES + 8u * i; }
  __device__ __forceinline__ uint32_t q_full() const { return bar(0); }
  __device__ __forceinline__ uint32_t full(int st) const { return bar(1 + st); }
  __device__ __forceinline__ uint32_t empty(int st) const { return bar(1 + STAGES + st); }
};

// whether some (query row in [r0, r_last], key in [k_lo, k_hi]) pair is seen:
// the keys rows r0 .. r_last see are the interval [q_offset + r0 - window +
// 1, q_offset + r_last] (each end only under its mask), since a window is at
// least one key wide
__device__ __forceinline__ bool meets(int r0, int r_last, int k_lo, int k_hi, int causal,
                                      int window, int q_offset) {
  const int lo = window > 0 ? q_offset + r0 - window + 1 : INT_MIN;
  const int hi = causal ? q_offset + r_last : INT_MAX;
  return r0 <= r_last && k_lo <= k_hi && k_lo <= hi && k_hi >= lo;
}

// whether every pair of rows [r0, r0 + nr) and keys [k0, k0 + nk) is seen,
// so that no element needs the mask
__device__ __forceinline__ bool inside(int r0, int nr, int k0, int nk, int sq, int sk,
                                       int causal, int window, int q_offset) {
  return r0 + nr <= sq && k0 + nk <= sk && (!causal || k0 + nk - 1 <= q_offset + r0) &&
         (window <= 0 || k0 > q_offset + r0 + nr - 1 - window);
}

// (d) = A (64 rows of a, K-major) . B^T (n rows of b, K-major) over D: D / 16
// k-steps, 4 in each 64-column slab; a_slab, b_slab the tiles' slab sizes
template <int N>
__device__ __forceinline__ void product_ss(float (&d)[N], uint32_t a, int a_slab, uint32_t b,
                                           int b_slab) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss(d, desc_k(a + (ks / 4) * a_slab + col), desc_k(b + (ks / 4) * b_slab + col), ks);
  }
}

// (d) += X (the A fragments of 16 KN rows' products, registers) . B (16 KN
// rows of b, D columns, MN-major: the descriptor's transpose bit)
template <int KN>
__device__ __forceinline__ void product_rs(float (&d)[64], const uint32_t (&x)[KN][4], uint32_t b,
                                           int b_slab) {
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) wgmma_rs(d, x[kk], desc(b + kk * 16 * SLAB_ROW, b_slab, 1024));
}

// a consumer thread's 64 x 128 float32 accumulator rows (row0, row0 + 8) into
// rows of a (rows, D) bf16 matrix, those below n_rows
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[64], int row0, int col0,
                                           int n_rows) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r < n_rows) {
      bf16* row = dst + (size_t)r * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

}  // namespace hb

// The dK/dV pass. Block: keys [k0, k0 + 128) of (batch row, kv head) bkv;
// consumer warpgroup w takes keys k0 + 64 w .. + 63, thread (warp, lane) of
// it the keys key0 = k0 + 64 w + 16 warp + lane / 4 and key0 + 8. Its S^T
// and dP^T accumulators (m64n64, 32 each) hold element 4 j + 2 i + c at
// (key key0 + 8 i, query q0 + 8 j + col0 + c); its dK and dV (m64n128, 64
// each) at (key key0 + 8 i, column 8 j + col0 + c).
__global__ void __launch_bounds__(hb::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,    // (D, Sq, B*Hq), 64 rows
                            const __grid_constant__ CUtensorMap tm_do,   // (D, Sq, B*Hq), 64 rows
                            const __grid_constant__ CUtensorMap tm_k,    // (D, Sk, B*Hkv), 128
                            const __grid_constant__ CUtensorMap tm_v,    // (D, Sk, B*Hkv), 128
                            const float* __restrict__ lse,     // (B, Hq, Sq)
                            const float* __restrict__ delta,   // (B, Hq, Sq)
                            bf16* __restrict__ dk, bf16* __restrict__ dv,   // (B, Hkv, Sk, D)
                            int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                            float scale) {
  using namespace hb;
  using L = Dkdv;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_dkdv_wg[];
  const uint32_t raw = smem_addr(smem_dkdv_wg);
  const L sm{(raw + 1023u) & ~1023u};
  unsigned char* const gbase = smem_dkdv_wg + (sm.base - raw);   // the same bytes, generic

  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full(), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(sm.full(st), 1 + 32);        // the TMA's bytes and the producer warp's rows
      mbar_init(sm.empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // under a causal or window mask, kv heads vary fastest and key tiles go
  // in order, the first (which the most query rows see under the causal
  // mask) first; without one, key tiles vary fastest, so the blocks resident
  // at once read the Q and dO of few heads
  const bool by_head = causal || window > 0;
  const int bkv = by_head ? blockIdx.x : blockIdx.y;
  const int k0 = (by_head ? blockIdx.y : blockIdx.x) * L::BN;
  const int b = bkv / hkv;
  const int hk = bkv - b * hkv;
  const int g = hq / hkv;
  int qb, qe;
  q_range(k0, L::BN, sq, sk, causal, window, q_offset, BM, qb, qe);
  const int n_q = qe > qb ? (qe - qb + BM - 1) / BM : 0;
  const int n_tiles = g * n_q;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (role == 2) {
    // ---- producer: one warp; lane 0 issues the TMA loads, every lane
    // stages two rows' lse * log2(e) and delta ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(sm.kv_full(), 2 * L::KV_BYTES);
#pragma unroll
      for (int j = 0; j < SLABS; ++j) {
        tma_load(sm.k() + j * L::KV_SLAB, &tm_k, sm.kv_full(), 64 * j, k0, bkv);
        tma_load(sm.v() + j * L::KV_SLAB, &tm_v, sm.kv_full(), 64 * j, k0, bkv);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const uint32_t phase = ((it / STAGES) & 1) ^ 1;   // the first round finds them free
      const int h = it / n_q;
      const int q0 = qb + (it - h * n_q) * BM;
      const int bh = (b * hkv + hk) * g + h;
      mbar_wait(sm.empty(st), phase);
      if (lane == 0) {
        mbar_expect_tx(sm.full(st), 2 * L::Q_BYTES);
#pragma unroll
        for (int j = 0; j < SLABS; ++j) {
          tma_load(sm.q(st) + j * L::Q_SLAB, &tm_q, sm.full(st), 64 * j, q0, bh);
          tma_load(sm.dout(st) + j * L::Q_SLAB, &tm_do, sm.full(st), 64 * j, q0, bh);
        }
      }
      float* rows = reinterpret_cast<float*>(gbase + (sm.rows(st) - sm.base));
#pragma unroll
      for (int r = lane; r < BM; r += 32) {
        const bool in = q0 + r < sq;
        rows[r] = in ? lse[(size_t)bh * sq + q0 + r] * kLog2e : 0.f;
        rows[BM + r] = in ? delta[(size_t)bh * sq + q0 + r] : 0.f;
      }
      mbar_arrive(sm.full(st));
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  const int lane = threadIdx.x % 32;
  const int kw0 = k0 + 64 * role;                          // this warpgroup's keys
  const int key0 = kw0 + (threadIdx.x % 128 / 32) * 16 + lane / 4;   // and + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t k_w = sm.k() + role * 64 * SLAB_ROW;     // its 64 rows of each slab
  const uint32_t v_w = sm.v() + role * 64 * SLAB_ROW;
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(sm.kv_full(), 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int q0 = qb + (it % n_q) * BM;
    mbar_wait(sm.full(st), (it / STAGES) & 1);
    if (meets(q0, min(q0 + BM, sq) - 1, kw0, min(kw0 + 64, sk) - 1, causal, window, q_offset)) {
      // S^T = K . Q^T and dP^T = V . dO^T, both over D from shared memory
      float s[32], dp[32];
      wgmma_fence();
      product_ss(s, k_w, L::KV_SLAB, sm.q(st), L::Q_SLAB);
      wgmma_commit();
      product_ss(dp, v_w, L::KV_SLAB, sm.dout(st), L::Q_SLAB);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // P^T = exp2(S^T * c - lse * log2(e)), masked before the exponential,
      // while dP^T is in flight
      const float* rows = reinterpret_cast<const float*>(gbase + (sm.rows(st) - sm.base));
      const bool masked = !inside(q0, BM, kw0, 64, sq, sk, causal, window, q_offset);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int qi = 8 * j + col0 + cc;
          const float l2 = rows[qi];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + cc;
            const bool seen = !masked || ok(q0 + qi, key0 + 8 * i);
            s[e] = seen ? ex2_ftz(fmaf(s[e], c, -l2)) : 0.f;
          }
        }
      // dV += P^T . dO, P^T rounded to bf16 in registers, dO read through
      // the transpose bit; then dP^T has landed
      uint32_t pa[BM / 16][4], da[BM / 16][4];
      pack_p(pa, s);
      wgmma_fence();
      product_rs(dv_acc, pa, sm.dout(st), L::Q_SLAB);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dp);
      // dS^T = P^T * (dP^T - delta) * scale while dV's product runs; dK +=
      // dS^T . Q, likewise
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float dl = rows[BM + 8 * j + col0 + cc];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + cc;
            dp[e] = s[e] * (dp[e] - dl) * scale;
          }
        }
      pack_p(da, dp);
      wgmma_fence();
      product_rs(dk_acc, da, sm.q(st), L::Q_SLAB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
    }
    mbar_arrive(sm.empty(st));
  }
  store_rows(dk + (size_t)bkv * sk * D, dk_acc, key0, col0, sk);
  store_rows(dv + (size_t)bkv * sk * D, dv_acc, key0, col0, sk);
}

// The dQ pass. Block: query rows [q0, q0 + 128) of (batch row, query head)
// bh; consumer warpgroup w takes rows q0 + 64 w .. + 63, thread (warp, lane)
// of it the rows row0 = q0 + 64 w + 16 warp + lane / 4 and row0 + 8. Its S
// and dP accumulators (m64n64, 32 each) hold element 4 j + 2 i + c at (row
// row0 + 8 i, key k0 + 8 j + col0 + c), its dQ (m64n128, 64) at (row row0 +
// 8 i, column 8 j + col0 + c). dQ sums the key tiles in ascending order.
__global__ void __launch_bounds__(hb::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,    // (D, Sq, B*Hq), 128 rows
                          const __grid_constant__ CUtensorMap tm_do,   // (D, Sq, B*Hq), 128 rows
                          const __grid_constant__ CUtensorMap tm_k,    // (D, Sk, B*Hkv), 64
                          const __grid_constant__ CUtensorMap tm_v,    // (D, Sk, B*Hkv), 64
                          const float* __restrict__ lse,     // (B, Hq, Sq)
                          const float* __restrict__ delta,   // (B, Hq, Sq)
                          bf16* __restrict__ dq,             // (B, Hq, Sq, D)
                          int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                          float scale) {
  using namespace hb;
  using L = Dq;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_dq_wg[];
  const L sm{(smem_addr(smem_dq_wg) + 1023u) & ~1023u};

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // under a causal or window mask, heads vary fastest and query tiles go
  // longest first (the forward's order); without one, query tiles vary
  // fastest, so the blocks resident at once read the K and V of few heads
  const bool by_head = causal || window > 0;
  const int bh = by_head ? blockIdx.x : blockIdx.y;
  const int tile = by_head ? blockIdx.y : blockIdx.x;
  const int q0 = ((by_head ? gridDim.y : gridDim.x) - 1 - tile) * L::BM;
  const int b = bh / hq;
  const int kvh = b * hkv + (bh - b * hq) / (hq / hkv);
  int kb, ke;
  k_range(q0, min(q0 + L::BM, sq) - 1, sk, causal, window, q_offset, BN, kb, ke);
  const int n_tiles = ke > kb ? (ke - kb + BN - 1) / BN : 0;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (role == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x != 256) return;
    mbar_expect_tx(sm.q_full(), 2 * L::Q_BYTES);
#pragma unroll
    for (int j = 0; j < SLABS; ++j) {
      tma_load(sm.q() + j * L::Q_SLAB, &tm_q, sm.q_full(), 64 * j, q0, bh);
      tma_load(sm.dout() + j * L::Q_SLAB, &tm_do, sm.q_full(), 64 * j, q0, bh);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const int k0 = kb + it * BN;
      mbar_wait(sm.empty(st), ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(sm.full(st), 2 * L::KV_BYTES);
#pragma unroll
      for (int j = 0; j < SLABS; ++j) {
        tma_load(sm.k(st) + j * L::KV_SLAB, &tm_k, sm.full(st), 64 * j, k0, kvh);
        tma_load(sm.v(st) + j * L::KV_SLAB, &tm_v, sm.full(st), 64 * j, k0, kvh);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + 64 * role;                             // this warpgroup's rows
  const int r_last = min(r0 + 64, sq) - 1;
  const int row0 = r0 + (threadIdx.x % 128 / 32) * 16 + lane / 4;   // and + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_w = sm.q() + role * 64 * SLAB_ROW;       // its 64 rows of each slab
  const uint32_t do_w = sm.dout() + role * 64 * SLAB_ROW;
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lse2[i] = r < sq ? lse[(size_t)bh * sq + r] * kLog2e : 0.f;
    dl[i] = r < sq ? delta[(size_t)bh * sq + r] : 0.f;
  }

  float dq_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;

  mbar_wait(sm.q_full(), 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int k0 = kb + it * BN;
    mbar_wait(sm.full(st), (it / STAGES) & 1);
    if (meets(r0, r_last, k0, min(k0 + BN, sk) - 1, causal, window, q_offset)) {
      // S = Q . K^T and dP = dO . V^T
      float s[BN / 2], dp[BN / 2];
      wgmma_fence();
      product_ss(s, q_w, L::Q_SLAB, sm.k(st), L::KV_SLAB);
      wgmma_commit();
      product_ss(dp, do_w, L::Q_SLAB, sm.v(st), L::KV_SLAB);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // P while dP is in flight, then dS = P * (dP - delta) * scale in dp's
      // registers
      const bool masked = !inside(r0, 64, k0, BN, sq, sk, causal, window, q_offset);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int e = 4 * j + 2 * i + cc;
            const bool seen = !masked || ok(row0 + 8 * i, k0 + 8 * j + col0 + cc);
            s[e] = seen ? ex2_ftz(fmaf(s[e], c, -lse2[i])) : 0.f;
          }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;
      // dQ += dS . K, dS rounded to bf16 in registers, K read through the
      // transpose bit
      uint32_t da[BN / 16][4];
      pack_p(da, dp);
      wgmma_fence();
      product_rs(dq_acc, da, sm.k(st), L::KV_SLAB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(da);
    }
    mbar_arrive(sm.empty(st));
  }
  store_rows(dq + (size_t)bh * sq * D, dq_acc, row0, col0, sq);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// bfloat16 at D = 128: the delta pass, then the TMA + wgmma dK/dV and dQ
// passes. Each tensor is mapped in the boxes of the pass that reads it: Q
// and dO in 64 rows (dK/dV) and 128 (dQ), K and V in 128 (dK/dV) and 64
// (dQ); rows past Sq or Sk load as zeros. With no
// query row or no key, no pair is seen: the gradients are zeros.
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* out,
                             const float* lse, const void* dout, float* delta, void* dq,
                             void* dk, void* dv, int batch, int hq, int hkv, int sq, int sk,
                             int causal, int window, int q_offset, float scale, cudaStream_t s) {
  constexpr int D = hb::D;
  const size_t kv_bytes = (size_t)batch * hkv * sk * D * sizeof(bf16);
  if (sq == 0 || sk == 0) {
    cudaError_t err = cudaMemsetAsync(dk, 0, kv_bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, kv_bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dq, 0, (size_t)batch * hq * sq * D * 2, s);
    return err;
  }
  const int rows = batch * hq * sq;
  flash_bwd_delta_kernel<bf16><<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq64, tdo64, tq128, tdo128, tk128, tv128, tk64, tv64;
  if (!make_map(enc, &tq64, q, D, sq, batch * hq, hb::Dkdv::BM) ||
      !make_map(enc, &tdo64, dout, D, sq, batch * hq, hb::Dkdv::BM) ||
      !make_map(enc, &tq128, q, D, sq, batch * hq, hb::Dq::BM) ||
      !make_map(enc, &tdo128, dout, D, sq, batch * hq, hb::Dq::BM) ||
      !make_map(enc, &tk128, k, D, sk, batch * hkv, hb::Dkdv::BN) ||
      !make_map(enc, &tv128, v, D, sk, batch * hkv, hb::Dkdv::BN) ||
      !make_map(enc, &tk64, k, D, sk, batch * hkv, hb::Dq::BN) ||
      !make_map(enc, &tv64, v, D, sk, batch * hkv, hb::Dq::BN))
    return cudaErrorInvalidValue;
  const bool by_head = causal || window > 0;
  const int k_tiles = (sk + hb::Dkdv::BN - 1) / hb::Dkdv::BN;
  const int q_tiles = (sq + hb::Dq::BM - 1) / hb::Dq::BM;
  if ((err = set_smem(flash_bwd_dkdv_wgmma_kernel, hb::Dkdv::SMEM_BYTES)) != cudaSuccess)
    return err;
  flash_bwd_dkdv_wgmma_kernel<<<by_head ? dim3(batch * hkv, k_tiles) : dim3(k_tiles, batch * hkv),
                                hb::THREADS, hb::Dkdv::SMEM_BYTES, s>>>(
      tq64, tdo64, tk128, tv128, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq,
      hkv, sq, sk, causal, window, q_offset, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(flash_bwd_dq_wgmma_kernel, hb::Dq::SMEM_BYTES)) != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<<<by_head ? dim3(batch * hq, q_tiles) : dim3(q_tiles, batch * hq),
                              hb::THREADS, hb::Dq::SMEM_BYTES, s>>>(
      tq128, tdo128, tk64, tv64, lse, delta, static_cast<bf16*>(dq), hq, hkv, sq, sk, causal,
      window, q_offset, scale);
  return cudaGetLastError();
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
  // bfloat16: D = 128 on the TMA + wgmma passes, the other head dims on
  // mma.sync
  if constexpr (D == hb::D) {
    return launch_bwd_wgmma(q, k, v, out, lse, dout, delta, dq, dk, dv, batch, hq, hkv, sq, sk,
                            causal, window, q_offset, scale, s);
  } else {
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
