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
//   16-byte loads, up to 32 lanes a row, into a (B, Hq, Sq) float32 scratch
//   buffer.
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
// masks by the forward's rule and mask per element inside the tiles; a
// masked element's P is 0 whatever its exponent (the wgmma passes select
// after the exponential, the others mask before it), so a row whose lse is
// -1e30 gives zeros. P is recomputed in the exp2 domain in every pass and dtype
// (the bfloat16 forward's lse comes from its exp2-domain maximum).
// - bfloat16 at D = 64, 128 and 256 (Whisper; Yi, InternVL2, Qwen3-MoE;
//   RecurrentGemma): TMA + wgmma with warp specialisation, the forward's
//   plumbing (hopper_wgmma.cuh), one kernel pair templated on D with a
//   per-D shape (hb::Shape<D>). A block is consumer warpgroups and a
//   producer warpgroup whose registers setmaxnreg moves to the consumers
//   (D = 128 and 256: two consumers at 240 registers, D = 64: three at 160;
//   the producer at 24). Tiles are 64-column slabs of 128-byte rows,
//   128-byte swizzled, loaded by TMA through 3-D (D, S, heads) maps, so rows
//   past Sq or Sk load as zeros.
//   Pass 1 (dK, dV): a block's keys of one (batch row, kv head), K and V
//   loaded once; the producer streams 64-row Q and dO tiles, with their
//   rows' lse * log2(e) and delta (staged by the producer warp's lanes),
//   through a ring guarded by full and empty mbarriers. Per tile a consumer
//   issues S^T and dP^T (wgmma m64n64k16, K and V against Q and dO, all from
//   shared memory) as two groups; it forms P^T while dP^T is in flight,
//   rounds it to bf16 in place into the A fragments of dV += P^T.dO (dO read
//   through the descriptor's transpose bit, as the forward reads V), forms
//   dS^T while that product runs and issues dK += dS^T.Q likewise.
//   D = 128: 128 keys a block, 64 a consumer, two stages; dK 64 + dV 64 +
//   S^T 32 + dP^T 32 accumulator registers a thread.
//   D = 64: 192 keys a block, 64 a consumer, three stages; dV's product
//   waits until dS^T is formed (DEFER_DV: both products issued together),
//   so that dK 32 + dV 32 + S^T 32 + dP^T 32 fit a third consumer's 160.
//   D = 256: dK and dV over 256 columns would take 256 registers a
//   consumer. A block takes one 64-key tile and each consumer half of the
//   output columns; both recompute S^T and dP^T over the full D (6 products
//   a pair where the two passes' bound counts 5) and nothing is exchanged;
//   64 + 64 + 32 + 32 registers; K, V and two stages of Q and dO fill 192
//   KB. RecurrentGemma's grid is then 4 x 1 x 32 = 128 blocks under 132
//   SMs, and under the causal mask key tile 0 walks every query tile of 10
//   heads while the last walks one: the host (bwd_kv_splits,
//   kernels/flash_attention.py) divides each kv head's query heads over
//   `splits` blocks where the blocks would not fill the card twice over,
//   each writing float32 partials that flash_bwd_sum_kernel adds in split
//   order (deterministic; 34 MB of scratch and ~11 us at that shape).
//   Under a causal or window mask kv heads (and splits) vary fastest and
//   key tiles go in order, the first (which the most rows see) first;
//   without one key tiles vary fastest.
//   Pass 2 (dQ): 64 rows a consumer (128 a block, 192 at D = 64); Q and dO
//   loaded once, 64-key K and V tiles through a ring. Per tile S and dP
//   (m64n64k16), P while dP is in flight, dS into dP's registers, rounded
//   to bf16 into the A fragments of dQ += dS.K (K through the transpose
//   bit; m64n128k16 per 128 output columns, m64n64k16 at D = 64): dQ D / 2
//   + S 32 + dP 32 registers. At D = 64 and 128 the ring holds stages of a
//   K and a V tile (3 and 2). At D = 256 the 128-row Q and dO tiles take 128
//   KB, which leaves room for three 32 KB tiles, not two stages of both: the
//   ring's three slots hold a K or a V tile each (K of tile t, then its V),
//   V's slot freed once dP has read it, so the next tile's K loads during
//   this one and V is waited on only once S is issued. Query tiles go
//   longest first under a mask, as the forward's do.
//   Both passes skip, per consumer, a tile none of whose pairs its rows or
//   keys see (an exact zero), and mask per element only where the Sq or Sk
//   tail, the diagonal or the window's edge crosses the tile: a tile's
//   exponentials are one of two loops, masked or not, chosen once a tile
//   (p_transposed / p_rows), and a row pair's lse and delta one 8-byte
//   shared load. 2^x comes from ex2.approx.ftz (one special-function
//   instruction: within 2 ulp, below P's bf16 rounding; P under 2^-126
//   becomes 0).
//   What bounds it: the chain of each consumer's tile (products, then the
//   exponentials, dS and the last product, then a wait), which the
//   consumers overlap only in part; at D = 64 the per-pair elementwise work
//   weighs as much as the products, so a third consumer helps more than
//   larger tiles.
//   Variants timed on the card by tools/flash_bwd_sweep.py (H100 80GB HBM3,
//   700 W; device ms, the L2 flushed, in turns with this design). D = 256
//   at RecurrentGemma's (4, 2048, 10/1, window 2048), this design 0.6741:
//   no query-head split 1.0505 (dK/dV 0.75 against 0.40), three splits
//   0.7091, dV deferred 0.6657 and 0.5999 (the second reading had every
//   pass faster, the untouched delta pass too: not taken as a gain); the
//   dQ pass's 64-key tile taken in two
//   32-key m64n32k16 steps 0.7258 (16 bytes of spill), and before the
//   exponentials were split into masked and unmasked loops the whole
//   64-key step spilled 512 bytes (C7512: wgmma serialised). D = 64 at
//   Whisper's encoder (8, 1500, 16/16), decoder (8, 448, causal) and cross
//   (448 x 1500) shapes, this design 0.6117, 0.0704, 0.2337: two consumers
//   at 240 registers (128 keys or rows a block) 0.7181, 0.0750, 0.2600, the
//   same with dV deferred 0.7081, 0.0747, 0.2593, three consumers with
//   two-stage rings 0.6113, 0.0761, 0.2363, and with 128-key dQ tiles
//   taken in two 64-key steps 0.5965, 0.0702, 0.2312 (dropped: a dQ key
//   tile other than the sum's grouping, for 2.5 %); with two consumers and
//   before the masked split, 128-row dK/dV query tiles spilled 48 bytes and
//   ran 5 % slower, 128-key dQ tiles 3 % slower. D = 128 at Yi's (4, 2048, 32/4), this design
//   0.8669: dV deferred 0.8722. Variants of the first D = 128 design
//   (before the masked split: 1.1203 at Yi's shape): exp2f for ex2.approx 1.4389; a tile's S and dP
//   in one group, the exponentials after both, 1.1385; 128-key tiles in
//   pass 2 1.1577; consumers at 232 registers with a 40-register producer
//   (16 bytes of spill, C7512) 1.2480; three or four ring stages within 6 %
//   either way. Also tried then and dropped (builds not kept): the
//   consumers taking turns to issue their products through named barriers,
//   pass 1's last wait deferred into the next tile (it spilled), dS staged
//   through shared memory for a dQ product with both operands there, and
//   the next tile's S and dP issued before the dQ product's wait (ptxas
//   serialised the wgmma, C7511).
// - bfloat16 at D = 32 (smoke configurations only): mma.sync m16n8k16 with
//   float32 accumulators, tiles of padded bf16 rows in shared memory read
//   through ldmatrix (.trans where the contraction runs over the tile's
//   rows), the S^T/S and dP^T/dP accumulators reused in registers as the A
//   operands of the next products. P and dS are rounded to bfloat16 where
//   they feed a product (dV += P^T.dO, dK += dS^T.Q, dQ += dS.K); dS itself
//   is computed from P in float32. Pass 1: 64-key blocks of 4 warps x 16
//   keys, 64-row query tiles; pass 2: 64-row blocks of 4 warps x 16 rows,
//   64-key tiles. Loads are synchronous (global -> registers -> shared).
// - float32 (the float32 training checks, float32 fine-tuning): 3xTF32 on
//   mma.sync m16n8k8, 8 warps a block (f3::Shape<D>), the products of
//   tf32x3_frag.cuh: each operand split as tf32x3_tile.cuh splits it (hi
//   rounded to TF32 by two integer operations, lo = x - hi) as its fragment
//   is read from shared memory; per k-step lo.hi and hi.lo go into a second
//   accumulator and hi.hi into the main one, summed once at the end of the
//   product. The products over the tile's rows or keys (dV, dK, dQ) go 32
//   output columns at a time into such a pair that starts from zero every
//   tile and is added once a tile into the running float32 sums (a rounded
//   add): sums over thousands of rows never run through the tensor cores'
//   own accumulation, which truncates. Tiles of float32 rows of D floats in
//   shared memory, filled by 16-byte cp.async copies, are swizzled so that
//   a fragment read in either orientation falls on 32 distinct banks: the
//   products that contract over a tile's rows read it as it is, with no
//   transposed copy. P^T and dS^T (pass 1) or dS (pass 2) are formed from
//   unrounded float32 P and stored in shared memory, from which every warp
//   reads the A fragments of the next product: a warp's S^T or S piece (16
//   or 32 keys or rows x a part of the tile) and its output block (the
//   same keys or rows x a part of the columns) are cut differently, so no
//   product is computed twice. 2^x comes from exp2f, as in the CUDA-core
//   passes this design replaced.
//   Pass 1: 64 keys a block (128 at D = 32 and 64; 32 at D = 256, so that
//   a warp's dK and dV are 16 keys x 64 columns), 64-row query tiles
//   through a two-stage ring (one at D = 256); pass 2: 128 rows a block
//   (32 at D = 256), 64-key tiles, two stages (one at D = 128 and 256,
//   where the Q and dO tiles take 128 KB). The host divides each kv
//   head's query heads over bwd_kv_splits blocks where the dK/dV pass's
//   blocks would not fill the
//   card (the train-check twins' (2, 512, 32/4) has 64), their float32
//   partials summed in split order by flash_bwd_sum_kernel<float>.
//   What bounds it: issue slots more than the tensor cores. Every operand
//   value costs a shared load and three split operations as it is read,
//   about four instructions beside each mma.sync, and a warp's S^T (S)
//   piece re-splits the B fragments that the other key (row) groups also
//   split. Where registers allow (D = 64, and D = 128's dK/dV pass) a warp
//   takes two 16-key (16-row) m-tiles, so that each B fragment it splits
//   feeds twice the products.
//   Variants timed on the card by tools/flash_bwd_sweep.py --dtype
//   float32 (H100 80GB HBM3, 700.00 W; device ms, the L2 flushed, in
//   turns). Against this design: one m-tile a warp in D = 128's dK/dV
//   pass, at the train-check twin's (2, 512, 32/4) 0.4298 against 0.4126
//   and at Yi-6B's (4, 2048, 32/4) 10.5707 against 10.1461; D = 128's dQ
//   pass at 64 rows with two m-tiles and two stages 0.4139 and 10.2956; at
//   D = 64 one m-tile a warp, Whisper-medium's encoder twin (2, 1500,
//   16/16) 1.6053 against 1.4320. In an earlier sweep two m-tiles in D =
//   128's dQ pass spilled 48 bytes, and in D = 256's dQ pass ran level
//   (RecurrentGemma-2B's twin (2, 512, 10/1, D 256) 0.3712 against 0.3724).
//   Before the m-tiles (one a warp everywhere; D = 128's dQ pass at 64 rows
//   and two stages, D = 64 at 64 keys or rows, up to 8 splits; the
//   train-check twin at 0.4569, Yi-6B at 10.9889): no split 0.9823 (the
//   twin), 4 splits 0.4337 (8 heads as 2 each; 5 splits left some 2 too),
//   32-key dK/dV blocks 0.4761 and 12.1513, 32-row tiles 0.4787 and
//   11.7041, one-stage rings 0.4691 and 11.3286, 128-row dQ blocks (one
//   stage) 0.4548 and 10.5856; the RecurrentGemma twin 0.3714, no split
//   1.2086, 4 splits 0.4728, 64-row dQ blocks of 32-key tiles 0.4063 (4
//   bytes of spill); the Whisper twin 1.7821, 128-key and 128-row blocks
//   1.6072. Before the D = 256 dK/dV pass took 32 keys a block, its 64 keys
//   and 32-row tiles spilled 56 bytes and the twin ran 0.598.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"
#include "tf32x3_frag.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int BKV = 64;      // bfloat16 mma.sync: keys per block of pass 1, per tile of pass 2
constexpr int BQ = 64;       // bfloat16 mma.sync: query rows per block of pass 2
constexpr int NT = 128;      // threads of a bfloat16 mma.sync block: 4 warps

// the most output columns a block accumulates
template <int D>
constexpr int CHUNK_COLS = D < 128 ? D : 128;

constexpr int MMA_BM = 64;   // bfloat16 mma.sync pass 1 (D = 32): query rows per tile

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

// ---------------------------------------------------------------------------
// pass 0: delta = rowsum(dout * out): a row's 16-byte chunks over
// min(32, chunks) lanes, each lane's chunks in order, then the lanes summed
// by a fixed butterfly
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DeltaShape {
  static constexpr int VEC = 16 / sizeof(T);                   // elements a 16-byte load
  static constexpr int TPR = D / VEC < 32 ? D / VEC : 32;      // lanes a row
  static constexpr int RPB = 256 / TPR;                        // rows a block
};

// acc + the dot product of two 16-byte chunks of T, in element order
template <typename T>
__device__ __forceinline__ float dot16(uint4 a, uint4 b, float acc) {
  if constexpr (sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(&a);
    const float4 y = *reinterpret_cast<const float4*>(&b);
    return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
  } else {
    const uint32_t xa[4] = {a.x, a.y, a.z, a.w}, xb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[i]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xb[i]));
      acc = fmaf(x.y, y.y, fmaf(x.x, y.x, acc));
    }
    return acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  using S = DeltaShape<T, D>;
  const int row = blockIdx.x * S::RPB + threadIdx.x / S::TPR;
  const int t = threadIdx.x % S::TPR;
  float acc = 0.f;
  if (row < rows) {
    const uint4* o = reinterpret_cast<const uint4*>(out + (size_t)row * D);
    const uint4* g = reinterpret_cast<const uint4*>(dout + (size_t)row * D);
#pragma unroll
    for (int c = t; c < D / S::VEC; c += S::TPR)
      acc = dot16<T>(__ldg(g + c), __ldg(o + c), acc);
  }
  // every lane of the warp takes part (a row's lanes lie in one warp)
#pragma unroll
  for (int s = S::TPR / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (t == 0 && row < rows) delta[row] = acc;
}

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int rows,
                         cudaStream_t s) {
  constexpr int RPB = DeltaShape<T, D>::RPB;
  if (rows > 0)
    flash_bwd_delta_kernel<T, D><<<(rows + RPB - 1) / RPB, 256, 0, s>>>(
        static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows);
  return cudaGetLastError();
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
  return (2 * BKV + 2 * MMA_BM) * (D + 8) * 2 + 2 * MMA_BM * 4;
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
  constexpr int BM = MMA_BM;
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
// bfloat16, D = 64, 128 and 256: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

namespace hb {

using namespace wg;

constexpr int PRODUCER_REGS = 24;        // the producer warpgroup after setmaxnreg

// Per head dim. A block is CONSUMERS consumer warpgroups and a producer
// warpgroup; after setmaxnreg a consumer thread holds CONSUMER_REGS
// registers (CONSUMERS x 128 x CONSUMER_REGS + 128 x PRODUCER_REGS <=
// 65,536). The dK/dV pass (64-row query tiles): keys a block (64 a
// consumer; or, with two consumers and 64 keys, both on the same keys, each
// accumulating half of the output columns), ring stages, and whether dV's
// product waits until dS is formed (DEFER_DV: P^T and dS^T packed and both
// products issued together, fewer registers live at once). The dQ pass (64
// query rows a consumer, 64-key tiles): ring depth, and whether the ring's
// slots hold a K or a V tile each (APART: the depth counts tiles) or a K
// and a V tile together (the depth counts stages).
// tools/flash_bwd_sweep.py builds its variants by replacing these lines.
template <int CONSUMERS_, int CONSUMER_REGS_, int KV_BN_, int KV_STAGES_, bool KV_DEFER_DV_,
          int Q_STAGES_, bool Q_APART_>
struct ShapeOf {
  static constexpr int CONSUMERS = CONSUMERS_, CONSUMER_REGS = CONSUMER_REGS_;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int KV_BN = KV_BN_, KV_STAGES = KV_STAGES_;
  static constexpr bool KV_DEFER_DV = KV_DEFER_DV_;
  static constexpr int Q_STAGES = Q_STAGES_;
  static constexpr bool Q_APART = Q_APART_;
  static_assert(CONSUMERS * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536,
                "the warpgroups' registers do not fit an SM");
};
template <int D> struct Shape;
template <> struct Shape<64> : ShapeOf<3, 160, 192, 3, true, 3, false> {};
template <> struct Shape<128> : ShapeOf<2, 240, 128, 2, false, 2, false> {};
template <> struct Shape<256> : ShapeOf<2, 240, 64, 2, false, 3, true> {};

// The dK/dV pass: a block's keys of one (batch row, kv head), K and V
// loaded once; a ring of STAGES query tiles of BM rows (Q, dO, and the
// rows' lse * log2(e) and delta); shared memory holds K, V, the stages' Q
// and dO tiles, the stages' rows, the barriers.
template <int D>
struct Dkdv {
  static constexpr int SLABS = D / 64;     // 64-column slabs of a tile row
  static constexpr int CONSUMERS = Shape<D>::CONSUMERS;
  static constexpr int BN = Shape<D>::KV_BN, BM = 64, STAGES = Shape<D>::KV_STAGES;
  // two consumers on one 64-key tile split its output columns
  static constexpr bool COL_SPLIT = BN == 64 && CONSUMERS == 2;
  static constexpr int OW = COL_SPLIT ? D / 2 : D;   // output columns a consumer accumulates
  static_assert((BN == 64 * CONSUMERS || COL_SPLIT) && (OW == 64 || OW == 128),
                "the dK/dV pass takes 64 keys a consumer, 64 or 128 output columns");
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

// The dQ pass: a block's BM query rows (64 a consumer warpgroup) of one
// (batch row, query head), Q and dO loaded once; a ring of key tiles of BN
// keys (K and V), STAGES stages of both or, APART, STAGES slots of one.
template <int D>
struct Dq {
  static constexpr int SLABS = D / 64;
  static constexpr int CONSUMERS = Shape<D>::CONSUMERS;
  static constexpr int BM = 64 * CONSUMERS, BN = 64, STAGES = Shape<D>::Q_STAGES;
  static constexpr bool APART = Shape<D>::Q_APART;
  // output columns a dQ product (m64n128k16, m64n64k16 at D = 64), and
  // products per 16 keys
  static constexpr int ON = D >= 128 ? 128 : 64;
  static constexpr int OH = D / ON;
  static constexpr int Q_SLAB = BM * SLAB_ROW;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int KV_SLAB = BN * SLAB_ROW;
  static constexpr int KV_BYTES = SLABS * KV_SLAB;
  static constexpr int TILES = 2 * Q_BYTES + (APART ? STAGES : 2 * STAGES) * KV_BYTES;
  static constexpr int BARRIERS = 1 + 2 * STAGES;      // q_full; full and empty per slot
  static constexpr int SMEM_BYTES = 1024 + TILES + 8 * BARRIERS;
  static_assert(SMEM_BYTES <= 232448, "the dQ pass's shared memory is past the limit");
  static_assert(!APART || STAGES >= 3, "K and V apart need a third slot to load ahead");

  uint32_t base;
  __device__ __forceinline__ uint32_t q() const { return base; }
  __device__ __forceinline__ uint32_t dout() const { return base + Q_BYTES; }
  __device__ __forceinline__ uint32_t tile(int i) const {
    return base + 2 * Q_BYTES + i * KV_BYTES;
  }
  __device__ __forceinline__ uint32_t k(int st) const { return tile(2 * st); }
  __device__ __forceinline__ uint32_t v(int st) const { return tile(2 * st + 1); }
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
template <int D, int N>
__device__ __forceinline__ void product_ss(float (&d)[N], uint32_t a, int a_slab, uint32_t b,
                                           int b_slab) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss(d, desc_k(a + (ks / 4) * a_slab + col), desc_k(b + (ks / 4) * b_slab + col), ks);
  }
}

// (d) += X (the A fragments of 16 KN rows' products, registers) . B (16 KN
// rows of b from its first slab on, 2 N columns, MN-major: the descriptor's
// transpose bit)
template <int N, int KN>
__device__ __forceinline__ void product_rs(float (&d)[N], const uint32_t (&x)[KN][4], uint32_t b,
                                           int b_slab) {
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) wgmma_rs(d, x[kk], desc(b + kk * 16 * SLAB_ROW, b_slab, 1024));
}

// P^T of the dK/dV pass in place of S^T (element 4 j + 2 i + c at key key0
// + 8 i, query q0 + 8 j + col0 + c): exp2(S^T * c - lse * log2(e)) from
// the tile's staged rows, masked before the exponential where MASKED
template <bool MASKED, int N>
__device__ __forceinline__ void p_transposed(float (&s)[N], const float* rows, const Mask& ok,
                                             int q0, int key0, int col0, float c) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + col0);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int e = 4 * j + 2 * i + cc;
        const float p = ex2_ftz(fmaf(s[e], c, -(cc ? l2.y : l2.x)));
        s[e] = !MASKED || ok(q0 + 8 * j + col0 + cc, key0 + 8 * i) ? p : 0.f;
      }
  }
}

// P of the dQ pass in place of S (element 4 j + 2 i + c at row row0 + 8 i,
// key k0 + 8 j + col0 + c), masked before the exponential where MASKED
template <bool MASKED, int N>
__device__ __forceinline__ void p_rows(float (&s)[N], const float (&lse2)[2], const Mask& ok,
                                       int row0, int k0, int col0, float c) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int e = 4 * j + 2 * i + cc;
        const float p = ex2_ftz(fmaf(s[e], c, -lse2[i]));
        s[e] = !MASKED || ok(row0 + 8 * i, k0 + 8 * j + col0 + cc) ? p : 0.f;
      }
}

// a consumer thread's 64 x (2 N) float32 accumulator rows (row0, row0 + 8)
// into rows of a (rows, D) matrix from its column 0 (bf16, or float32
// partials), those below n_rows
template <int D, int N, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[N], int row0, int col0,
                                           int n_rows) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r < n_rows) {
      T* row = dst + (size_t)r * D + col0;
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        else
          *reinterpret_cast<float2*>(row + 8 * j) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

}  // namespace hb

// The dK/dV pass. Block: keys [k0, k0 + BN) of (batch row, kv head) bkv and
// the query heads of its split (all g where splits = 1). Consumer
// warpgroup w takes keys k0 + 64 w .. + 63 and every output column or,
// with COL_SPLIT, keys k0 .. k0 + 63 and the output columns OW w .. + OW -
// 1. Thread (warp, lane) holds the keys key0 = kw0 + 16 warp + lane / 4
// and key0 + 8 of its warpgroup's first key kw0. Its S^T and dP^T
// accumulators (m64nBM) hold element 4 j + 2 i + c at (key key0 + 8 i,
// query q0 + 8 j + col0 + c); its dK and dV (m64nOW) at (key key0 + 8 i,
// column 8 j + col0 + c of its columns). With splits > 1 it writes float32
// partials, (2, splits, B*Hkv, Sk, D), which flash_bwd_sum_kernel adds in
// split order.
template <int D>
__global__ void __launch_bounds__(hb::Shape<D>::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,    // (D, Sq, B*Hq), BM rows
                            const __grid_constant__ CUtensorMap tm_do,   // (D, Sq, B*Hq), BM rows
                            const __grid_constant__ CUtensorMap tm_k,    // (D, Sk, B*Hkv), BN
                            const __grid_constant__ CUtensorMap tm_v,    // (D, Sk, B*Hkv), BN
                            const float* __restrict__ lse,     // (B, Hq, Sq)
                            const float* __restrict__ delta,   // (B, Hq, Sq)
                            bf16* __restrict__ dk, bf16* __restrict__ dv,   // (B, Hkv, Sk, D)
                            float* __restrict__ part, int splits, int hq, int hkv, int sq, int sk,
                            int causal, int window, int q_offset, float scale) {
  using namespace hb;
  using L = Dkdv<D>;
  using S = Shape<D>;
  constexpr int BM = L::BM, STAGES = L::STAGES, OW = L::OW;
  extern __shared__ __align__(1024) unsigned char smem_dkdv_wg[];
  const uint32_t raw = smem_addr(smem_dkdv_wg);
  const L sm{(raw + 1023u) & ~1023u};
  unsigned char* const gbase = smem_dkdv_wg + (sm.base - raw);   // the same bytes, generic

  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full(), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(sm.full(st), 1 + 32);        // the TMA's bytes and the producer warp's rows
      mbar_init(sm.empty(st), S::CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // under a causal or window mask, kv heads (and splits) vary fastest and
  // key tiles go in order, the first (which the most query rows see under
  // the causal mask) first; without one, key tiles vary fastest, so the
  // blocks resident at once read the Q and dO of few heads
  const bool by_head = causal || window > 0;
  const int unit = by_head ? blockIdx.x : blockIdx.y;      // bkv * splits + split
  const int k0 = (by_head ? blockIdx.y : blockIdx.x) * L::BN;
  const int bkv = unit / splits;
  const int split = unit - bkv * splits;
  const int b = bkv / hkv;
  const int hk = bkv - b * hkv;
  const int g = hq / hkv;
  const int h0 = split * g / splits;                       // this split's query heads
  const int nh = (split + 1) * g / splits - h0;
  int qb, qe;
  q_range(k0, L::BN, sq, sk, causal, window, q_offset, BM, qb, qe);
  const int n_q = qe > qb ? (qe - qb + BM - 1) / BM : 0;
  const int n_tiles = nh * n_q;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (role == S::CONSUMERS) {
    // ---- producer: one warp; lane 0 issues the TMA loads, every lane
    // stages rows' lse * log2(e) and delta ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x >= S::CONSUMERS * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(sm.kv_full(), 2 * L::KV_BYTES);
#pragma unroll
      for (int j = 0; j < L::SLABS; ++j) {
        tma_load(sm.k() + j * L::KV_SLAB, &tm_k, sm.kv_full(), 64 * j, k0, bkv);
        tma_load(sm.v() + j * L::KV_SLAB, &tm_v, sm.kv_full(), 64 * j, k0, bkv);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const uint32_t phase = ((it / STAGES) & 1) ^ 1;   // the first round finds them free
      const int h = h0 + it / n_q;
      const int q0 = qb + (it % n_q) * BM;
      const int bh = (b * hkv + hk) * g + h;
      mbar_wait(sm.empty(st), phase);
      if (lane == 0) {
        mbar_expect_tx(sm.full(st), 2 * L::Q_BYTES);
#pragma unroll
        for (int j = 0; j < L::SLABS; ++j) {
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

  // ---- consumer warpgroups: 64 keys each, OW output columns ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS) : "memory");
  const int lane = threadIdx.x % 32;
  const int kw0 = L::COL_SPLIT ? k0 : k0 + 64 * role;      // this warpgroup's keys
  const int cw0 = L::COL_SPLIT ? OW * role : 0;            // and its first output column
  const int key0 = kw0 + (threadIdx.x % 128 / 32) * 16 + lane / 4;   // and + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t k_w = sm.k() + (kw0 - k0) * SLAB_ROW;     // its 64 rows of each slab
  const uint32_t v_w = sm.v() + (kw0 - k0) * SLAB_ROW;
  const uint32_t c_q = (cw0 / 64) * L::Q_SLAB;             // its first column's slab
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};

  float dk_acc[OW / 2], dv_acc[OW / 2];
#pragma unroll
  for (int i = 0; i < OW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(sm.kv_full(), 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int q0 = qb + (it % n_q) * BM;
    mbar_wait(sm.full(st), (it / STAGES) & 1);
    if (meets(q0, min(q0 + BM, sq) - 1, kw0, min(kw0 + 64, sk) - 1, causal, window, q_offset)) {
      // S^T = K . Q^T and dP^T = V . dO^T, both over D from shared memory
      float s[BM / 2], dp[BM / 2];
      wgmma_fence();
      product_ss<D>(s, k_w, L::KV_SLAB, sm.q(st), L::Q_SLAB);
      wgmma_commit();
      product_ss<D>(dp, v_w, L::KV_SLAB, sm.dout(st), L::Q_SLAB);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // P^T = exp2(S^T * c - lse * log2(e)), masked before the exponential
      // only where the tile crosses a mask or a tail, while dP^T is in flight
      const float* rows = reinterpret_cast<const float*>(gbase + (sm.rows(st) - sm.base));
      if (inside(q0, BM, kw0, 64, sq, sk, causal, window, q_offset))
        p_transposed<false>(s, rows, ok, q0, key0, col0, c);
      else
        p_transposed<true>(s, rows, ok, q0, key0, col0, c);
      // dV += P^T . dO, P^T rounded to bf16 in registers, dO read through
      // the transpose bit (DEFER_DV: once dS^T is formed too); then dP^T
      // has landed
      uint32_t pa[BM / 16][4], da[BM / 16][4];
      if constexpr (!S::KV_DEFER_DV) {
        pack_p(pa, s);
        wgmma_fence();
        product_rs(dv_acc, pa, sm.dout(st) + c_q, L::Q_SLAB);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(dp);
      // dS^T = P^T * (dP^T - delta) * scale while dV's product runs; dK +=
      // dS^T . Q, likewise
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(rows + BM + 8 * j + col0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dp[4 * j + 2 * i] = s[4 * j + 2 * i] * (dp[4 * j + 2 * i] - dl.x) * scale;
          dp[4 * j + 2 * i + 1] = s[4 * j + 2 * i + 1] * (dp[4 * j + 2 * i + 1] - dl.y) * scale;
        }
      }
      if constexpr (S::KV_DEFER_DV) pack_p(pa, s);
      pack_p(da, dp);
      wgmma_fence();
      if constexpr (S::KV_DEFER_DV) product_rs(dv_acc, pa, sm.dout(st) + c_q, L::Q_SLAB);
      product_rs(dk_acc, da, sm.q(st) + c_q, L::Q_SLAB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
    }
    mbar_arrive(sm.empty(st));
  }
  if (splits == 1) {
    store_rows<D>(dk + (size_t)bkv * sk * D + cw0, dk_acc, key0, col0, sk);
    store_rows<D>(dv + (size_t)bkv * sk * D + cw0, dv_acc, key0, col0, sk);
  } else {
    const size_t plane = (size_t)((by_head ? gridDim.x : gridDim.y) / splits) * sk * D;
    float* pk = part + (size_t)split * plane + (size_t)bkv * sk * D + cw0;
    store_rows<D>(pk, dk_acc, key0, col0, sk);
    store_rows<D>(pk + (size_t)splits * plane, dv_acc, key0, col0, sk);
  }
}

// dK and dV from the dK/dV pass's float32 partials (2, splits, n): each
// element the sum over the splits in order, stored as T (rounded once to
// bf16, or float32 as it is); 4 elements a thread
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
                     size_t n4, int splits) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n4) return;
  const size_t which = i >= n4;
  const size_t e = i - which * n4;
  const float4* p = reinterpret_cast<const float4*>(part) + which * splits * n4 + e;
  float4 acc = p[0];
  for (int s = 1; s < splits; ++s) {
    const float4 x = p[(size_t)s * n4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  if constexpr (sizeof(T) == 2)
    *reinterpret_cast<uint2*>((which ? dv : dk) + 4 * e) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  else
    *reinterpret_cast<float4*>((which ? dv : dk) + 4 * e) = acc;
}

// The dQ pass. Block: query rows [q0, q0 + BM) of (batch row, query head)
// bh; consumer warpgroup w takes rows q0 + 64 w .. + 63, thread (warp,
// lane) of it the rows row0 = q0 + 64 w + 16 warp + lane / 4 and row0 + 8.
// Its S and dP accumulators (m64nBN) hold element 4 j + 2 i + c at (row
// row0 + 8 i, key k0 + 8 j + col0 + c); its dQ (OH accumulators of m64nON)
// at (row row0 + 8 i, column ON h + 8 j + col0 + c). dQ sums the key tiles
// in ascending order.
template <int D>
__global__ void __launch_bounds__(hb::Shape<D>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,    // (D, Sq, B*Hq), BM rows
                          const __grid_constant__ CUtensorMap tm_do,   // (D, Sq, B*Hq), BM rows
                          const __grid_constant__ CUtensorMap tm_k,    // (D, Sk, B*Hkv), BN
                          const __grid_constant__ CUtensorMap tm_v,    // (D, Sk, B*Hkv), BN
                          const float* __restrict__ lse,     // (B, Hq, Sq)
                          const float* __restrict__ delta,   // (B, Hq, Sq)
                          bf16* __restrict__ dq,             // (B, Hq, Sq, D)
                          int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                          float scale) {
  using namespace hb;
  using L = Dq<D>;
  using S = Shape<D>;
  constexpr int BN = L::BN, STAGES = L::STAGES, ON = L::ON, OH = L::OH;
  extern __shared__ __align__(1024) unsigned char smem_dq_wg[];
  const L sm{(smem_addr(smem_dq_wg) + 1023u) & ~1023u};

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), S::CONSUMERS * 128);
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

  if (role == S::CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x != S::CONSUMERS * 128) return;
    mbar_expect_tx(sm.q_full(), 2 * L::Q_BYTES);
#pragma unroll
    for (int j = 0; j < L::SLABS; ++j) {
      tma_load(sm.q() + j * L::Q_SLAB, &tm_q, sm.q_full(), 64 * j, q0, bh);
      tma_load(sm.dout() + j * L::Q_SLAB, &tm_do, sm.q_full(), 64 * j, q0, bh);
    }
    if constexpr (L::APART) {
      // K of tile it is load 2 it, V load 2 it + 1, each into the next slot
      for (int it = 0; it < n_tiles; ++it) {
        const int k0 = kb + it * BN;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const int ld = 2 * it + kv;
          const int st = ld % STAGES;
          mbar_wait(sm.empty(st), ((ld / STAGES) & 1) ^ 1);
          mbar_expect_tx(sm.full(st), L::KV_BYTES);
#pragma unroll
          for (int j = 0; j < L::SLABS; ++j)
            tma_load(sm.tile(st) + j * L::KV_SLAB, kv ? &tm_v : &tm_k, sm.full(st), 64 * j, k0,
                     kvh);
        }
      }
    } else {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const int k0 = kb + it * BN;
        mbar_wait(sm.empty(st), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(sm.full(st), 2 * L::KV_BYTES);
#pragma unroll
        for (int j = 0; j < L::SLABS; ++j) {
          tma_load(sm.k(st) + j * L::KV_SLAB, &tm_k, sm.full(st), 64 * j, k0, kvh);
          tma_load(sm.v(st) + j * L::KV_SLAB, &tm_v, sm.full(st), 64 * j, k0, kvh);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS) : "memory");
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

  float dq_acc[OH][ON / 2];
#pragma unroll
  for (int h = 0; h < OH; ++h)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) dq_acc[h][i] = 0.f;

  mbar_wait(sm.q_full(), 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kb + it * BN;
    // the slots of this tile's K and V, and the parities of their loads
    int st_k, st_v;
    uint32_t ph_k, ph_v;
    if constexpr (L::APART) {
      st_k = (2 * it) % STAGES;
      st_v = (2 * it + 1) % STAGES;
      ph_k = ((2 * it) / STAGES) & 1;
      ph_v = ((2 * it + 1) / STAGES) & 1;
    } else {
      st_k = st_v = it % STAGES;
      ph_k = ph_v = (it / STAGES) & 1;
    }
    const uint32_t kt = L::APART ? sm.tile(st_k) : sm.k(st_k);
    const uint32_t vt = L::APART ? sm.tile(st_v) : sm.v(st_v);
    mbar_wait(sm.full(st_k), ph_k);
    if (meets(r0, r_last, k0, min(k0 + BN, sk) - 1, causal, window, q_offset)) {
      // S = Q . K^T and dP = dO . V^T (APART: V waited on once S is issued)
      float s[BN / 2], dp[BN / 2];
      wgmma_fence();
      product_ss<D>(s, q_w, L::Q_SLAB, kt, L::KV_SLAB);
      wgmma_commit();
      if constexpr (L::APART) mbar_wait(sm.full(st_v), ph_v);
      product_ss<D>(dp, do_w, L::Q_SLAB, vt, L::KV_SLAB);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      // P while dP is in flight, masked only where the tile crosses a mask
      // or a tail; then dS = P * (dP - delta) * scale in dp's registers
      if (inside(r0, 64, k0, BN, sq, sk, causal, window, q_offset))
        p_rows<false>(s, lse2, ok, row0, k0, col0, c);
      else
        p_rows<true>(s, lse2, ok, row0, k0, col0, c);
      wgmma_wait<0>();
      fence_regs(dp);
      if constexpr (L::APART) mbar_arrive(sm.empty(st_v));   // V is read
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;
      // dQ += dS . K, dS rounded to bf16 in registers, K read through the
      // transpose bit
      uint32_t da[BN / 16][4];
      pack_p(da, dp);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < OH; ++h)
        product_rs(dq_acc[h], da, kt + h * (ON / 64) * L::KV_SLAB, L::KV_SLAB);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < OH; ++h) fence_regs(dq_acc[h]);
      fence_regs(da);
    } else if constexpr (L::APART) {
      mbar_wait(sm.full(st_v), ph_v);
      mbar_arrive(sm.empty(st_v));
    }
    mbar_arrive(sm.empty(st_k));
  }
#pragma unroll
  for (int h = 0; h < OH; ++h)
    store_rows<D>(dq + (size_t)bh * sq * D + h * ON, dq_acc[h], row0, col0, sq);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

namespace f3 {

constexpr int THREADS = 256;   // 8 warps a block

// Per head dim. The dK/dV pass: keys a block (KV_BN), query rows a tile
// (KV_BM), ring stages of the Q and dO tiles, and 16-key m-tiles a warp
// (KV_M). The dQ pass: query rows a block (Q_BM), keys a tile (Q_BN), ring
// stages of the K and V tiles, and 16-row m-tiles a warp (Q_M). The
// block's 8 warps are the key (row) groups of 16 M times the parts over
// which each group's S^T (S) piece divides the tile's query rows (keys)
// and its dK/dV (dQ) output columns; a warp with two m-tiles splits each B
// fragment once for both.
// tools/flash_bwd_sweep.py builds its variants by replacing these lines.
template <int KV_BN_, int KV_BM_, int KV_STAGES_, int KV_M_, int Q_BM_, int Q_BN_, int Q_STAGES_,
          int Q_M_>
struct ShapeOf {
  static constexpr int KV_BN = KV_BN_, KV_BM = KV_BM_, KV_STAGES = KV_STAGES_, KV_M = KV_M_;
  static constexpr int Q_BM = Q_BM_, Q_BN = Q_BN_, Q_STAGES = Q_STAGES_, Q_M = Q_M_;
};
template <int D> struct Shape;
template <> struct Shape<32> : ShapeOf<128, 64, 2, 1, 128, 64, 2, 1> {};
template <> struct Shape<64> : ShapeOf<128, 64, 2, 2, 128, 64, 2, 2> {};
template <> struct Shape<128> : ShapeOf<64, 64, 2, 2, 128, 64, 1, 1> {};
template <> struct Shape<256> : ShapeOf<32, 64, 1, 1, 32, 64, 1, 1> {};

using repro_tf32x3::at;
using repro_tf32x3::product_m;

template <int W, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n_rows) {
  repro_tf32x3::load_tile<W, R, THREADS>(dst, src, row0, n_rows);
}

template <int R>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int n_rows) {
  repro_tf32x3::load_vec<R, THREADS>(dst, src, row0, n_rows);
}

template <int D>
struct Dkdv {
  using S = Shape<D>;
  static constexpr int BN = S::KV_BN, BM = S::KV_BM, STAGES = S::KV_STAGES, M = S::KV_M;
  static constexpr int GROUPS = BN / (16 * M), PARTS = 8 / GROUPS;
  static constexpr int QW = BM / PARTS;    // query rows of a warp's S^T piece
  static constexpr int OW = D / PARTS;     // output columns a warp accumulates
  static constexpr int STAGE = 2 * BM * D + 2 * BM;   // Q, dO, lse, delta
  static constexpr int SMEM_BYTES = 4 * (2 * BN * D + STAGES * STAGE + 2 * BN * BM);
  static_assert(GROUPS * PARTS == 8 && QW % 8 == 0 && OW % 32 == 0 && BM % 32 == 0 &&
                    D % 32 == 0,
                "the dK/dV pass's warps: 16 M keys each, S^T pieces of 8 rows, 32-column chunks");
  static_assert(SMEM_BYTES <= 232448, "the dK/dV pass's shared memory is past the limit");
};

template <int D>
struct Dq {
  using S = Shape<D>;
  static constexpr int BM = S::Q_BM, BN = S::Q_BN, STAGES = S::Q_STAGES, M = S::Q_M;
  static constexpr int GROUPS = BM / (16 * M), PARTS = 8 / GROUPS;
  static constexpr int KW = BN / PARTS;    // keys of a warp's S piece
  static constexpr int OW = D / PARTS;     // output columns a warp accumulates
  static constexpr int SMEM_BYTES = 4 * (2 * BM * D + STAGES * 2 * BN * D + BM * BN);
  static_assert(GROUPS * PARTS == 8 && KW % 8 == 0 && OW % 32 == 0 && BN % 32 == 0,
                "the dQ pass's warps: 16 M rows each, S pieces of 8 keys, 32-column chunks");
  static_assert(SMEM_BYTES <= 232448, "the dQ pass's shared memory is past the limit");
};

// out[ch][n] += the 16 x 32 chunk c (a product's layout)
__device__ __forceinline__ void add_chunk(float (&out)[4][4], const float (&c)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] += c[n][e];
}

// a warp's 16 x (32 CH) accumulator rows (r0 + lane / 4, + 8) into rows of a
// (rows, D) float32 matrix from its column col0, those below n_rows
template <int D, int CH>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[CH][4][4], int r0,
                                          int col0, int n_rows, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    if (r < n_rows) {
      float* row = dst + (size_t)r * D + col0 + 2 * (lane % 4);
#pragma unroll
      for (int ch = 0; ch < CH; ++ch)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(row + 32 * ch + 8 * n) =
              make_float2(acc[ch][n][2 * i], acc[ch][n][2 * i + 1]);
    }
  }
}

}  // namespace f3

// The float32 dK/dV pass. Block: keys [k0, k0 + BN) of (batch row, kv head)
// bkv and the query heads of its split, K and V loaded once; Q and dO tiles
// of BM rows (with the rows' lse and delta) through a STAGES-deep cp.async
// ring. Warp w is key group w % GROUPS (16 M keys) and part w / GROUPS: per
// tile it computes S^T and dP^T for its keys and the part's QW query rows,
// forms P^T and dS^T and stores them in shared memory; then dV += P^T.dO and
// dK += dS^T.Q for its keys and the part's OW output columns, 32 at a time,
// each chunk's product added once a tile into the running float32 sums.
// With splits > 1 it writes float32 partials, (2, splits, B*Hkv, Sk, D).
template <int D>
__global__ void __launch_bounds__(f3::THREADS, 1)
flash_bwd_dkdv_tf32x3_kernel(const float* __restrict__ q,      // (B, Hq, Sq, D)
                             const float* __restrict__ k,      // (B, Hkv, Sk, D)
                             const float* __restrict__ v,      // (B, Hkv, Sk, D)
                             const float* __restrict__ dout,   // (B, Hq, Sq, D)
                             const float* __restrict__ lse,    // (B, Hq, Sq)
                             const float* __restrict__ delta,  // (B, Hq, Sq)
                             float* __restrict__ dk, float* __restrict__ dv,   // (B, Hkv, Sk, D)
                             float* __restrict__ part, int splits, int hq, int hkv, int sq, int sk,
                             int causal, int window, int q_offset, float scale) {
  using namespace f3;
  using L = Dkdv<D>;
  constexpr int BN = L::BN, BM = L::BM, M = L::M, QW = L::QW, OW = L::OW, CH = OW / 32;
  extern __shared__ __align__(16) float smem_f3_dkdv[];
  float* k_s = smem_f3_dkdv;                      // BN x D
  float* v_s = k_s + BN * D;
  float* ring = v_s + BN * D;                     // per stage: Q, dO (BM x D), lse, delta
  float* pt_s = ring + L::STAGES * L::STAGE;      // BN x BM: P^T
  float* ds_s = pt_s + BN * BM;                   // BN x BM: dS^T

  // under a causal or window mask, kv heads (and splits) vary fastest and
  // key tiles go in order, the first (which the most query rows see under
  // the causal mask) first; without one, key tiles vary fastest
  const bool by_head = causal || window > 0;
  const int unit = by_head ? blockIdx.x : blockIdx.y;   // bkv * splits + split
  const int k0 = (by_head ? blockIdx.y : blockIdx.x) * BN;
  const int bkv = unit / splits;
  const int split = unit - bkv * splits;
  const int b = bkv / hkv;
  const int hk = bkv - b * hkv;
  const int g = hq / hkv;
  const int h0 = split * g / splits;                    // this split's query heads
  const int nh = (split + 1) * g / splits - h0;
  int qb, qe;
  q_range(k0, BN, sq, sk, causal, window, q_offset, BM, qb, qe);
  const int n_q = qe > qb ? (qe - qb + BM - 1) / BM : 0;
  const int n_tiles = nh * n_q;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % L::GROUPS, prt = warp / L::GROUPS;
  const int kr0 = 16 * M * grp;                         // this warp's first key in the block
  const int kw0 = k0 + kr0;
  const int kw_last = min(kw0 + 16 * M, sk) - 1;
  const int col0 = 2 * (lane % 4);
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};

  // tile it: query head h0 + it / n_q, rows qb + (it % n_q) BM
  auto issue = [&](int it) {
    float* st = ring + (it % L::STAGES) * L::STAGE;
    const int q0 = qb + (it % n_q) * BM;
    const size_t bh = (size_t)(b * hkv + hk) * g + h0 + it / n_q;
    load_tile<D, BM>(st, q + bh * sq * D, q0, sq);
    load_tile<D, BM>(st + BM * D, dout + bh * sq * D, q0, sq);
    load_vec<BM>(st + 2 * BM * D, lse + bh * sq, q0, sq);
    load_vec<BM>(st + 2 * BM * D + BM, delta + bh * sq, q0, sq);
  };
  load_tile<D, BN>(k_s, k + (size_t)bkv * sk * D, k0, sk);
  load_tile<D, BN>(v_s, v + (size_t)bkv * sk * D, k0, sk);
  if (n_tiles > 0) issue(0);
  repro_tf32x3::cp_async_commit();

  float dk_acc[M][CH][4][4], dv_acc[M][CH][4][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[m][ch][n][e] = dv_acc[m][ch][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    repro_tf32x3::cp_async_wait<0>();
    __syncthreads();   // tile it has landed; every warp is done with tile it - 1
    if (L::STAGES > 1 && it + 1 < n_tiles) issue(it + 1);
    repro_tf32x3::cp_async_commit();
    const float* qt = ring + (it % L::STAGES) * L::STAGE;
    const float* dot = qt + BM * D;
    const float* lse_t = dot + BM * D;
    const float* dl_t = lse_t + BM;
    const int q0 = qb + (it % n_q) * BM;
    const int qw0 = q0 + prt * QW;   // the first query row of this warp's piece

    // S^T = K.Q^T and dP^T = V.dO^T for its keys and rows; P^T = exp2(S^T
    // c - lse log2(e)) masked, dS^T = P^T (dP^T - delta) scale, stored
    float s[M][QW / 8][4], dp[M][QW / 8][4];
    const bool live =
        hb::meets(qw0, min(qw0 + QW, sq) - 1, kw0, kw_last, causal, window, q_offset);
    if (live) {
      product_m<M, QW / 8, D, D, D, false>(s, k_s, kr0, qt, prt * QW, lane);
      product_m<M, QW / 8, D, D, D, false>(dp, v_s, kr0, dot, prt * QW, lane);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < QW / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kr = kr0 + 16 * m + lane / 4 + 8 * i;   // the key's row in the block
          const int qi = prt * QW + 8 * n + col0;           // and qi + 1
          float p[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
          if (live) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              if (ok(q0 + qi + cc, k0 + kr))
                p[cc] = exp2f(fmaf(s[m][n][2 * i + cc], c, -lse_t[qi + cc] * kLog2e));
              ds[cc] = p[cc] * (dp[m][n][2 * i + cc] - dl_t[qi + cc]) * scale;
            }
          }
          const int at_ = at<BM>(kr, qi);
          *reinterpret_cast<float2*>(pt_s + at_) = make_float2(p[0], p[1]);
          *reinterpret_cast<float2*>(ds_s + at_) = make_float2(ds[0], ds[1]);
        }
    __syncthreads();   // P^T and dS^T are whole

    // dV += P^T.dO and dK += dS^T.Q over the tile's rows, for its keys and
    // the part's output columns
    if (hb::meets(q0, min(q0 + BM, sq) - 1, kw0, kw_last, causal, window, q_offset)) {
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        float mm[M][4][4];
        product_m<M, 4, BM, BM, D, true>(mm, pt_s, kr0, dot, prt * OW + 32 * ch, lane);
#pragma unroll
        for (int m = 0; m < M; ++m) add_chunk(dv_acc[m][ch], mm[m]);
        product_m<M, 4, BM, BM, D, true>(mm, ds_s, kr0, qt, prt * OW + 32 * ch, lane);
#pragma unroll
        for (int m = 0; m < M; ++m) add_chunk(dk_acc[m][ch], mm[m]);
      }
    }
    if (L::STAGES == 1 && it + 1 < n_tiles) {
      __syncthreads();   // every warp is done with the stage
      issue(it + 1);
      repro_tf32x3::cp_async_commit();
    }
  }
  repro_tf32x3::cp_async_wait<0>();

  float* dk_out = dk + (size_t)bkv * sk * D;
  float* dv_out = dv + (size_t)bkv * sk * D;
  if (splits > 1) {
    const size_t plane = (size_t)((by_head ? gridDim.x : gridDim.y) / splits) * sk * D;
    dk_out = part + (size_t)split * plane + (size_t)bkv * sk * D;
    dv_out = dk_out + (size_t)splits * plane;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    store_acc<D, CH>(dk_out, dk_acc[m], kw0 + 16 * m, prt * OW, sk, lane);
    store_acc<D, CH>(dv_out, dv_acc[m], kw0 + 16 * m, prt * OW, sk, lane);
  }
}

// The float32 dQ pass. Block: query rows [q0, q0 + BM) of (batch row,
// query head) bh, Q and dO loaded once; K and V tiles of BN keys through a
// STAGES-deep cp.async ring. Warp w is row group w % GROUPS (16 M rows) and
// part w / GROUPS: per tile it computes S and dP for its rows and the
// part's KW keys, forms dS and stores it in shared memory; then dQ += dS.K
// for its rows and the part's OW output columns, 32 at a time, each chunk's
// product added once a tile into the running float32 sums. dQ sums the key
// tiles in ascending order.
template <int D>
__global__ void __launch_bounds__(f3::THREADS, 1)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,      // (B, Hq, Sq, D)
                           const float* __restrict__ k,      // (B, Hkv, Sk, D)
                           const float* __restrict__ v,      // (B, Hkv, Sk, D)
                           const float* __restrict__ dout,   // (B, Hq, Sq, D)
                           const float* __restrict__ lse,    // (B, Hq, Sq)
                           const float* __restrict__ delta,  // (B, Hq, Sq)
                           float* __restrict__ dq,           // (B, Hq, Sq, D)
                           int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                           float scale) {
  using namespace f3;
  using L = Dq<D>;
  constexpr int BM = L::BM, BN = L::BN, M = L::M, KW = L::KW, OW = L::OW, CH = OW / 32;
  extern __shared__ __align__(16) float smem_f3_dq[];
  float* q_s = smem_f3_dq;                     // BM x D
  float* do_s = q_s + BM * D;
  float* ring = do_s + BM * D;                 // per stage: K, V (BN x D)
  float* ds_s = ring + L::STAGES * 2 * BN * D; // BM x BN: dS

  // under a causal or window mask, heads vary fastest and query tiles go
  // longest first (the forward's order); without one, query tiles vary
  // fastest
  const bool by_head = causal || window > 0;
  const int bh = by_head ? blockIdx.x : blockIdx.y;
  const int tile = by_head ? blockIdx.y : blockIdx.x;
  const int q0 = (by_head ? gridDim.y - 1 - tile : tile) * BM;
  const int b = bh / hq;
  const size_t kvh = (size_t)b * hkv + (bh - b * hq) / (hq / hkv);
  int kb, ke;
  k_range(q0, min(q0 + BM, sq) - 1, sk, causal, window, q_offset, BN, kb, ke);
  const int n_tiles = ke > kb ? (ke - kb + BN - 1) / BN : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % L::GROUPS, prt = warp / L::GROUPS;
  const int rr0 = 16 * M * grp;                // this warp's first row in the block
  const int r0 = q0 + rr0;
  const int r_last = min(r0 + 16 * M, sq) - 1;
  const int col0 = 2 * (lane % 4);
  const float c = scale * kLog2e;
  const Mask ok{sq, sk, causal, window, q_offset};
  // this thread's rows r0 + 16 m + lane / 4 + 8 i: lse * log2(e), delta
  float lse2[M][2], dl[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * m + lane / 4 + 8 * i;
      lse2[m][i] = r < sq ? lse[(size_t)bh * sq + r] * kLog2e : 0.f;
      dl[m][i] = r < sq ? delta[(size_t)bh * sq + r] : 0.f;
    }

  auto issue = [&](int it) {
    float* st = ring + (it % L::STAGES) * 2 * BN * D;
    load_tile<D, BN>(st, k + kvh * sk * D, kb + it * BN, sk);
    load_tile<D, BN>(st + BN * D, v + kvh * sk * D, kb + it * BN, sk);
  };
  load_tile<D, BM>(q_s, q + (size_t)bh * sq * D, q0, sq);
  load_tile<D, BM>(do_s, dout + (size_t)bh * sq * D, q0, sq);
  if (n_tiles > 0) issue(0);
  repro_tf32x3::cp_async_commit();

  float dq_acc[M][CH][4][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[m][ch][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    repro_tf32x3::cp_async_wait<0>();
    __syncthreads();   // tile it has landed; every warp is done with tile it - 1
    if (L::STAGES > 1 && it + 1 < n_tiles) issue(it + 1);
    repro_tf32x3::cp_async_commit();
    const float* kt = ring + (it % L::STAGES) * 2 * BN * D;
    const float* vt = kt + BN * D;
    const int k0 = kb + it * BN;
    const int kw0 = k0 + prt * KW;   // the first key of this warp's piece

    // S = Q.K^T and dP = dO.V^T for its rows and keys; P = exp2(S c - lse
    // log2(e)) masked, dS = P (dP - delta) scale, stored
    float s[M][KW / 8][4], dp[M][KW / 8][4];
    const bool live =
        hb::meets(r0, r_last, kw0, min(kw0 + KW, sk) - 1, causal, window, q_offset);
    if (live) {
      product_m<M, KW / 8, D, D, D, false>(s, q_s, rr0, kt, prt * KW, lane);
      product_m<M, KW / 8, D, D, D, false>(dp, do_s, rr0, vt, prt * KW, lane);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < KW / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = rr0 + 16 * m + lane / 4 + 8 * i;   // the row in the block
          const int kj = prt * KW + 8 * n + col0;           // and kj + 1
          float ds[2] = {0.f, 0.f};
          if (live) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float p = ok(q0 + rr, k0 + kj + cc)
                                  ? exp2f(fmaf(s[m][n][2 * i + cc], c, -lse2[m][i]))
                                  : 0.f;
              ds[cc] = p * (dp[m][n][2 * i + cc] - dl[m][i]) * scale;
            }
          }
          *reinterpret_cast<float2*>(ds_s + at<BN>(rr, kj)) = make_float2(ds[0], ds[1]);
        }
    __syncthreads();   // dS is whole

    // dQ += dS.K over the tile's keys, for its rows and the part's columns
    if (hb::meets(r0, r_last, k0, min(k0 + BN, sk) - 1, causal, window, q_offset)) {
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        float mm[M][4][4];
        product_m<M, 4, BN, BN, D, true>(mm, ds_s, rr0, kt, prt * OW + 32 * ch, lane);
#pragma unroll
        for (int m = 0; m < M; ++m) add_chunk(dq_acc[m][ch], mm[m]);
      }
    }
    if (L::STAGES == 1 && it + 1 < n_tiles) {
      __syncthreads();   // every warp is done with the stage
      issue(it + 1);
      repro_tf32x3::cp_async_commit();
    }
  }
  repro_tf32x3::cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < M; ++m)
    store_acc<D, CH>(dq + (size_t)bh * sq * D, dq_acc[m], r0 + 16 * m, prt * OW, sq, lane);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// bfloat16 at D = 64, 128 and 256: the delta pass, then the TMA + wgmma
// dK/dV and dQ passes (with splits > 1, the dK/dV pass's partials summed
// into dk and dv in between). Each tensor is mapped in the boxes of the
// pass that reads it: Q and dO in the dK/dV pass's query tile and 128 rows
// (dQ), K and V in the dK/dV pass's key block and the dQ pass's key tile;
// rows past Sq or Sk load as zeros. With no query row or no key, no pair
// is seen: the gradients are zeros.
template <int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* out,
                             const float* lse, const void* dout, float* delta, void* dq,
                             void* dk, void* dv, float* part, int splits, int batch, int hq,
                             int hkv, int sq, int sk, int causal, int window, int q_offset,
                             float scale, cudaStream_t s) {
  using KV = hb::Dkdv<D>;
  using DQ = hb::Dq<D>;
  const size_t kv_bytes = (size_t)batch * hkv * sk * D * sizeof(bf16);
  if (splits < 1 || splits > hq / hkv || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (sq == 0 || sk == 0) {
    cudaError_t err = cudaMemsetAsync(dk, 0, kv_bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, kv_bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dq, 0, (size_t)batch * hq * sq * D * 2, s);
    return err;
  }
  cudaError_t err = launch_delta<bf16, D>(out, dout, delta, batch * hq * sq, s);
  if (err != cudaSuccess) return err;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq_kv, tdo_kv, tq_dq, tdo_dq, tk_kv, tv_kv, tk_dq, tv_dq;
  if (!make_map(enc, &tq_kv, q, D, sq, batch * hq, KV::BM) ||
      !make_map(enc, &tdo_kv, dout, D, sq, batch * hq, KV::BM) ||
      !make_map(enc, &tq_dq, q, D, sq, batch * hq, DQ::BM) ||
      !make_map(enc, &tdo_dq, dout, D, sq, batch * hq, DQ::BM) ||
      !make_map(enc, &tk_kv, k, D, sk, batch * hkv, KV::BN) ||
      !make_map(enc, &tv_kv, v, D, sk, batch * hkv, KV::BN) ||
      !make_map(enc, &tk_dq, k, D, sk, batch * hkv, DQ::BN) ||
      !make_map(enc, &tv_dq, v, D, sk, batch * hkv, DQ::BN))
    return cudaErrorInvalidValue;
  const bool by_head = causal || window > 0;
  const int k_tiles = (sk + KV::BN - 1) / KV::BN;
  const int units = batch * hkv * splits;
  const int q_tiles = (sq + DQ::BM - 1) / DQ::BM;
  if ((err = set_smem(flash_bwd_dkdv_wgmma_kernel<D>, KV::SMEM_BYTES)) != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D><<<by_head ? dim3(units, k_tiles) : dim3(k_tiles, units),
                                   hb::Shape<D>::THREADS, KV::SMEM_BYTES, s>>>(
      tq_kv, tdo_kv, tk_kv, tv_kv, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      part, splits, hq, hkv, sq, sk, causal, window, q_offset, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (splits > 1) {
    const size_t n4 = (size_t)batch * hkv * sk * D / 4;
    flash_bwd_sum_kernel<bf16><<<(unsigned)((2 * n4 + 255) / 256), 256, 0, s>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n4, splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = set_smem(flash_bwd_dq_wgmma_kernel<D>, DQ::SMEM_BYTES)) != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D><<<by_head ? dim3(batch * hq, q_tiles) : dim3(q_tiles, batch * hq),
                                 hb::Shape<D>::THREADS, DQ::SMEM_BYTES, s>>>(
      tq_dq, tdo_dq, tk_dq, tv_dq, lse, delta, static_cast<bf16*>(dq), hq, hkv, sq, sk, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

// float32 at every head dim: the delta pass, then the 3xTF32 dK/dV and dQ
// passes (with splits > 1, the dK/dV pass's partials summed into dk and dv
// in between). With no query row or no key, no pair is seen: the gradients
// are zeros.
template <int D>
cudaError_t launch_bwd_tf32x3(const void* q, const void* k, const void* v, const void* out,
                              const float* lse, const void* dout, float* delta, void* dq,
                              void* dk, void* dv, float* part, int splits, int batch, int hq,
                              int hkv, int sq, int sk, int causal, int window, int q_offset,
                              float scale, cudaStream_t s) {
  using KV = f3::Dkdv<D>;
  using DQ = f3::Dq<D>;
  if (splits < 1 || splits > hq / hkv || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (sq == 0 || sk == 0) {
    const size_t kv_bytes = (size_t)batch * hkv * sk * D * sizeof(float);
    cudaError_t err = cudaMemsetAsync(dk, 0, kv_bytes, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, kv_bytes, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dq, 0, (size_t)batch * hq * sq * D * sizeof(float), s);
    return err;
  }
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(dout);
  float *dkf = static_cast<float*>(dk), *dvf = static_cast<float*>(dv);
  cudaError_t err = launch_delta<float, D>(out, dout, delta, batch * hq * sq, s);
  if (err != cudaSuccess) return err;
  const bool by_head = causal || window > 0;
  const int k_tiles = (sk + KV::BN - 1) / KV::BN;
  const int units = batch * hkv * splits;
  const int q_tiles = (sq + DQ::BM - 1) / DQ::BM;
  if ((err = set_smem(flash_bwd_dkdv_tf32x3_kernel<D>, KV::SMEM_BYTES)) != cudaSuccess)
    return err;
  flash_bwd_dkdv_tf32x3_kernel<D><<<by_head ? dim3(units, k_tiles) : dim3(k_tiles, units),
                                    f3::THREADS, KV::SMEM_BYTES, s>>>(
      qf, kf, vf, of, lse, delta, dkf, dvf, part, splits, hq, hkv, sq, sk, causal, window,
      q_offset, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (splits > 1) {
    const size_t n4 = (size_t)batch * hkv * sk * D / 4;
    flash_bwd_sum_kernel<float><<<(unsigned)((2 * n4 + 255) / 256), 256, 0, s>>>(part, dkf, dvf,
                                                                                 n4, splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = set_smem(flash_bwd_dq_tf32x3_kernel<D>, DQ::SMEM_BYTES)) != cudaSuccess) return err;
  flash_bwd_dq_tf32x3_kernel<D><<<by_head ? dim3(batch * hq, q_tiles) : dim3(q_tiles, batch * hq),
                                  f3::THREADS, DQ::SMEM_BYTES, s>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dq), hq, hkv, sq, sk, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* out,
                       const float* lse, const void* dout, float* delta, void* dq, void* dk,
                       void* dv, float* part, int splits, int batch, int hq, int hkv, int sq,
                       int sk, int causal, int window, int q_offset, float scale,
                       cudaStream_t s) {
  // float32 at every head dim on the 3xTF32 passes
  if (dtype == 0)
    return launch_bwd_tf32x3<D>(q, k, v, out, lse, dout, delta, dq, dk, dv, part, splits, batch,
                                hq, hkv, sq, sk, causal, window, q_offset, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  // bfloat16 at D = 64, 128 and 256 on the TMA + wgmma passes
  if constexpr (D >= 64) {
    return launch_bwd_wgmma<D>(q, k, v, out, lse, dout, delta, dq, dk, dv, part, splits, batch,
                               hq, hkv, sq, sk, causal, window, q_offset, scale, s);
  } else {
    // bfloat16 at D = 32 on mma.sync: dk and dv written by the dK/dV pass
    // itself, one block a key tile
    if (splits != 1) return cudaErrorInvalidValue;
    constexpr int CHUNKS = D / CHUNK_COLS<D>;
    const dim3 grid_kv((sk + BKV - 1) / BKV, batch * hkv, CHUNKS);
    const dim3 grid_q((sq + BQ - 1) / BQ, batch * hq, CHUNKS);
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(dout);
    cudaError_t err = launch_delta<bf16, D>(out, dout, delta, batch * hq * sq, s);
    if (err != cudaSuccess) return err;
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
// q_offset >= 0 (the caller resolves -1 to sk - sq). splits: the blocks
// over which the dK/dV pass divides each kv head's query heads, 1 <= splits
// <= hq / hkv, above 1 in float32 or in bfloat16 at d >= 64, with part a float32
// scratch of 2 * splits * batch * hkv * sk * d (else unused). Three
// launches on `stream` (delta, dK/dV, dQ; a fourth, the partials' sum,
// with splits > 1); returns the first failing one's cudaError_t, else 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, void* part, int dtype, int batch, int hq,
                                   int hkv, int sq, int sk, int d, int splits, int causal,
                                   int window, int q_offset, float scale, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || sq < 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  cudaError_t err;
  switch (d) {
    case 32:
      err = launch_bwd<32>(dtype, q, k, v, out, l, dout, dl, dq, dk, dv, pt, splits, batch, hq,
                           hkv, sq, sk, causal, window, q_offset, scale, s);
      break;
    case 64:
      err = launch_bwd<64>(dtype, q, k, v, out, l, dout, dl, dq, dk, dv, pt, splits, batch, hq,
                           hkv, sq, sk, causal, window, q_offset, scale, s);
      break;
    case 128:
      err = launch_bwd<128>(dtype, q, k, v, out, l, dout, dl, dq, dk, dv, pt, splits, batch, hq,
                            hkv, sq, sk, causal, window, q_offset, scale, s);
      break;
    case 256:
      err = launch_bwd<256>(dtype, q, k, v, out, l, dout, dl, dq, dk, dv, pt, splits, batch, hq,
                            hkv, sq, sk, causal, window, q_offset, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
