// Flash attention forward for Hopper (sm_90a): GQA, causal and/or sliding
// window, q_offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel). Same function: for query row i of
// head hq (absolute position q_offset + i) and key j of kv head hq / g,
//   mask(i, j) = j < Sk && (!causal || j <= q_offset + i)
//                       && (window <= 0 || j > q_offset + i - window),
// scores q . k * D^-0.5 in float32 masked out, an online softmax in float32,
// P cast to V's dtype before the P.V product, and rows with no unmasked key
// giving zeros. Where the caller passes an lse buffer (B, Hq, Sq) in float32,
// each row's log-sum-exp of its scaled scores, m + log(l), lands there too
// (-1e30 for a row with no unmasked key): the training forward's residual,
// from which the backward recomputes each key chunk's probabilities
// (src/repro/models/attention.py, _blocked_fwd_impl and _blocked_bwd). The
// epilogue already holds each row's m and l, so it costs one float a row.
//
// What bounds it on an H100: operations. At prefill lengths each K/V tile
// is reused by a whole tile of queries, so the work per byte is far above
// the memory roofline, and only the tensor cores reach the card's rate —
// at full rate only through wgmma, with its operands fed by TMA.
//
// What the design does about it. Every path runs one block per (b * Hq,
// query tile), loops over key tiles of the kv head it reads (bh / g, so the
// GQA expansion is never materialized), skips kv tiles wholly outside the
// causal / window mask (they contribute exactly zero) and masks the ragged
// Sk tail in the kernel, with no padding copy.
// - bfloat16, D = 64 (Whisper's encoder, decoder and cross attention), 128
//   (Yi's serving shape) and 256 (recurrentgemma's local attention):
//   flash_wgmma_kernel<D>, two consumer warpgroups and a producer per
//   128-row query tile. The producer issues, from one thread, TMA loads of
//   Q (once) and of K and V tiles into a ring of shared memory, guarded by
//   full and empty mbarriers for K and V apart. Warpgroups 0 and 1 consume,
//   64 query rows each, each holding one tile's S, P and O. Every tile is
//   stored as 64-column slabs of 128-byte rows, the swizzle's width. S =
//   Q.K^T is D / 16 wgmma k-steps from shared memory, the descriptors
//   moving to the next slab every 4; the softmax runs in exp2 on scores
//   times scale * log2(e), with the per-element mask only on the tiles that
//   the diagonal, the window's lower edge or the Sk tail crosses; the score
//   accumulators are rounded to bf16 in place into the A operand of O +=
//   P.V, wgmma with V read through the descriptor's transpose bit (no copy
//   of V^T): m64n128k16 per 128 output columns and 16 keys, m64n64k16 at
//   D = 64. The tensor maps are 3-D, (D, S, heads), so rows past Sq or Sk
//   load as zeros and never reach into the next head; they are encoded on
//   the host through the driver entry point, with 128-byte swizzle to match
//   the wgmma shared-memory descriptors. Under a causal or window mask
//   query tiles are launched longest first across heads; without one a
//   head's tiles run together, so its K/V stay in L2.
//   The register budget sets the shapes (Shape<D>). At D = 128: 128-key
//   tiles (S m64n128k16, 64 registers a thread; O 64), a three-stage ring,
//   the producer a warpgroup that gives up registers (setmaxnreg.dec, 40)
//   to consumers at 232 (setmaxnreg.inc). At D = 256 a consumer's O is
//   64 x 256 float32, 128 registers a thread, so a 128-key tile's S (64)
//   and P (32) would pass the 240 that setmaxnreg can give: 64-key tiles
//   (S m64n64k16, 32 registers; P 16), two P.V products per 16 keys,
//   consumers at 240 and the producer at 24 (2 x 128 x 240 + 128 x 24 =
//   64,512 of the SM's 65,536). Q (128 x 256) takes 64 KB and a K or V
//   tile 32 KB, so two stages (197,704 bytes, one block an SM) fit where
//   three would not.
//   At D = 64 the special-function unit, not the tensor cores alone, sets
//   the pace: a key's exponential per query row costs as much SFU time (16
//   a clock an SM) as its 2 x 64 multiply-adds of tensor time, and with one
//   block an SM both consumers tend to wait on the same tile, their
//   softmaxes then leaving the tensor cores idle. So two blocks share an
//   SM, whose four consumers drift apart: 64-key tiles (S 32 registers, P
//   16, O 32), two stages, 50,248 bytes a block, and a one-warp producer
//   (288 threads; no setmaxnreg) so that launch_bounds(288, 2) leaves each
//   thread 112 registers. The softmax (FAST) takes 2^x from ex2.approx.ftz
//   (one SFU instruction, where exp2f adds a range check and two
//   scalings), moves a row's running max only when a tile's passes it by
//   more than kSlack = 8 (so most tiles leave O unscaled, a warp vote
//   skipping its multiplies; flash_attention_tiled models the same rule), and
//   sums a row's quad once, at the end. Dropped on the card
//   (tools/flash_d64_sweep.py; PERF.md): D = 128's shape, a third and a
//   fourth stage, two blocks with a warpgroup producer at 104 consumer
//   registers (as fast, fewer registers), and, in earlier builds, the next
//   tile's Q.K^T issued beside this tile's softmax (ptxas serialises the
//   wgmma, C7514: slower), the consumers taking turns at the tensor cores
//   (slower) and pairwise-tree reductions (slower). Not yet: persistent
//   blocks.
// - bfloat16, D = 32 (only smoke configurations have it; flash_mma_kernel):
//   mma.sync m16n8k16 on 64-row query tiles and 64-key tiles loaded
//   synchronously; each warp keeps its Q fragments in registers, K and V
//   reach the MMAs through ldmatrix (V transposed on the fly), and the
//   scores become the P operand in registers. Same exp2 softmax.
// - float32 (flash_tf32x3_kernel<D>): 3xTF32 on mma.sync m16n8k8 through
//   tf32x3_frag.cuh (each operand split into a TF32 hi and lo as its
//   fragment is read; lo.hi and hi.lo into a second accumulator, hi.hi into
//   the main one, summed at the end of each product), 8 warps a block,
//   64-key tiles through a cp.async ring of swizzled float32 tiles (ff::Shape<D>).
//   Up to D = 128: 128-row query tiles of 8 warps x 16 rows, two stages; a
//   warp's S = Q.K^T stays in registers for the exp2 online softmax
//   (softmax_row, exp2f), and P goes through its rows of a shared tile into
//   O += P.V, 32 output columns at a time, each chunk's product from zero
//   and added into O (scaled by alpha) in float32, so O's sum over the key
//   tiles never runs through the tensor cores' own accumulation. At D = 256
//   a warp's 16 x 256 output would take 128 registers a thread (it spilled):
//   64-row tiles, each row group's two warps computing S over half the keys
//   and O over half the columns, the pair exchanging each row's max and
//   sum through shared memory; one stage. The serving and the training op
//   run the same kernel, so their outputs are equal bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"
#include "tf32x3_frag.cuh"

namespace {

constexpr int BQ = 64;                 // query rows per block (bf16 mma.sync)
constexpr int BK = 64;                 // keys per kv tile (bf16 mma.sync)
constexpr int NT = 128;                // threads per block (bf16 mma.sync)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the first and last kv tile a query range [qlo, qhi] can see (absolute
// positions), tiles of bk keys; the range is empty when begin >= end
__device__ __forceinline__ void kv_range(int qlo, int qhi, int sk, int causal, int window,
                                         int bk, int& begin, int& end) {
  end = sk;
  if (causal) end = min(end, qhi + 1);
  begin = 0;
  if (window > 0) begin = max(0, qlo - window + 1);
  begin = (begin / bk) * bk;
}

// Key e of the scores a thread holds of one row: k0 + 8 (e / 2) + col0 +
// e % 2 (the accumulator layout of mma.sync and wgmma alike), against the
// row's query position; true where the key is seen.
struct KeyMask {
  int k0, col0, qpos, sk, causal, window;
  __device__ __forceinline__ bool operator()(int e) const {
    const int kpos = k0 + 8 * (e >> 1) + col0 + (e & 1);
    return kpos < sk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
  }
};

// One row's online-softmax step over the N scores this thread holds of it
// (the other three threads of its quad hold the rest of the row): masked
// scores (MASKED: where !ok) become kNegInf; the scaled running max ms
// becomes max(ms, max(s) * c); s becomes p = exp2(s * c - ms), 0 where
// masked; the row sum of p joins l; the factor alpha by which the row's
// output must be scaled is returned. FAST: 2^x by ex2_ftz; the running max
// moves only when the tile's passes it by more than kSlack (so p stays below
// 2^kSlack, and most tiles leave the row's output unscaled: alpha 1); and l
// holds this thread's share of the row sum only (the running max is the
// quad's, so the shares scale alike; the caller sums the quad once, at the
// end).
constexpr float kSlack = 8.f;

template <int N, bool MASKED, bool FAST = false>
__device__ __forceinline__ float softmax_row(float (&s)[N], float& ms, float& l, float c,
                                             const KeyMask& ok) {
  float mx = kNegInf;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (MASKED && !ok(e)) s[e] = kNegInf;
    mx = fmaxf(mx, s[e]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float ms_new = fmaxf(ms, mx * c);
  if (FAST && !(ms_new > ms + kSlack)) ms_new = ms;
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float x = fmaf(s[e], c, -ms_new);
    const float p = FAST ? ex2_ftz(x) : exp2f(x);
    s[e] = (!MASKED || ok(e)) ? p : 0.f;
    sum += s[e];
  }
  if (!FAST) {
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  }
  const float alpha = FAST ? ex2_ftz(ms - ms_new) : exp2f(ms - ms_new);
  l = alpha * l + sum;
  ms = ms_new;
  return alpha;
}

// A row's log-sum-exp of its scaled scores from the exp2 softmax's state:
// ms is the running max of the scores times scale * log2(e), so the max of
// the scaled scores is ms * ln(2), and l sums exp2(s * c - ms) = exp(s *
// scale - ms * ln(2)); -1e30 for a row with no unmasked key (l == 0).
__device__ __forceinline__ float row_lse(float ms, float l) {
  return l == 0.f ? kNegInf : ms * kLn2 + logf(l);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

namespace ff {

constexpr int THREADS = 256;   // 8 warps

// Per head dim: keys a tile, K/V ring stages, and the parts over which a
// row group's keys and output columns are divided. The block's 8 warps are
// 8 / PARTS row groups of 16 query rows times PARTS parts: with PARTS = 2
// (D = 256, where a warp's 16 x 256 output would take 128 registers a
// thread and spilled) each warp of a pair computes S for its half of the
// tile's keys and O for its half of the columns, the pair exchanging each
// row's max and sum through shared memory. Two parts at D = 64 and 128
// ran level and slower on the card.
template <int BN_, int STAGES_, int PARTS_>
struct ShapeOf {
  static constexpr int BN = BN_, STAGES = STAGES_, PARTS = PARTS_;
};
template <int D> struct Shape;
template <> struct Shape<32> : ShapeOf<64, 2, 1> {};
template <> struct Shape<64> : ShapeOf<64, 2, 1> {};
template <> struct Shape<128> : ShapeOf<64, 2, 1> {};
template <> struct Shape<256> : ShapeOf<64, 1, 2> {};

// shared memory: the Q tile, the ring's K and V tiles, P (each row group
// its 16 rows) and, with PARTS > 1, each part's row maxima and sums
template <int D>
struct Layout {
  using S = Shape<D>;
  static constexpr int BN = S::BN, STAGES = S::STAGES, PARTS = S::PARTS;
  static constexpr int CN = 32;           // output columns a P.V chunk
  static constexpr int GROUPS = 8 / PARTS, BM = 16 * GROUPS;
  static constexpr int KW = BN / PARTS;   // keys of a warp's S piece
  static constexpr int OW = D / PARTS;    // output columns a warp accumulates
  static constexpr int STATS = PARTS > 1 ? 2 * PARTS * BM : 0;
  static constexpr int SMEM_BYTES = 4 * (BM * D + STAGES * 2 * BN * D + BM * BN + STATS);
  static_assert(GROUPS * PARTS == 8 && D % 32 == 0 && BN % 32 == 0 && KW % 8 == 0 &&
                    OW % CN == 0 && CN % 8 == 0,
                "32-float rows, 32-deep product steps, chunks of 8-column n-tiles");
  static_assert(SMEM_BYTES <= 232448, "the float32 forward's shared memory is past the limit");
};

// the PARTS warps of row group grp meet (named barrier 1 + grp)
template <int PARTS>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (PARTS == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(32 * PARTS) : "memory");
}

}  // namespace ff

// Block: query rows [q0, q0 + BM) of (batch row, query head) bh, Q loaded
// once; K and V tiles of BN keys through a STAGES-deep cp.async ring. Warp
// w is row group w % GROUPS (16 rows) and part w / GROUPS: per tile S =
// Q.K^T (3xTF32) for its rows and the part's KW keys, the exp2 online
// softmax (softmax_row's steps, exp2f; with PARTS > 1 each row's max and
// sum summed over the parts in order, so every part holds the same
// running max and sum), P stored to its rows of a shared tile, then O =
// alpha O + P.V (3xTF32) for the part's OW columns, CN at a time, each
// chunk's product from zero, added into O scaled by alpha in float32. The
// output and lse are written as the other paths write them.
template <int D>
__global__ void __launch_bounds__(ff::THREADS, 1)
flash_tf32x3_kernel(const float* __restrict__ q,   // (B, Hq, Sq, D)
                    const float* __restrict__ k,   // (B, Hkv, Sk, D)
                    const float* __restrict__ v,   // (B, Hkv, Sk, D)
                    float* __restrict__ out,       // (B, Hq, Sq, D)
                    float* __restrict__ lse,       // (B, Hq, Sq) or null
                    int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                    float c) {                     // scale * log2(e)
  using L = ff::Layout<D>;
  using repro_tf32x3::at;
  constexpr int BM = L::BM, BN = L::BN, STAGES = L::STAGES, CN = L::CN, PARTS = L::PARTS;
  constexpr int KW = L::KW, OW = L::OW, CH = OW / CN;
  extern __shared__ __align__(16) float smem_ff[];
  float* q_s = smem_ff;                       // BM x D
  float* ring = q_s + BM * D;                 // per stage: K, V (BN x D)
  float* p_s = ring + STAGES * 2 * BN * D;    // BM x BN
  float* mx_s = p_s + BM * BN;                // PARTS x BM row maxima, then sums
  float* sum_s = mx_s + PARTS * BM;

  // under a causal or window mask, heads vary fastest and query tiles go
  // longest first; without one, a head's query tiles run together
  const bool by_head = causal || window > 0;
  const int bh = by_head ? blockIdx.x : blockIdx.y;
  const int tile = by_head ? blockIdx.y : blockIdx.x;
  const int q0 = (by_head ? gridDim.y - 1 - tile : tile) * BM;
  const int b = bh / hq;
  const size_t kvh = (size_t)b * hkv + (bh - b * hq) / (hq / hkv);
  int kv_begin, kv_end;
  kv_range(q_offset + q0, q_offset + min(q0 + BM, sq) - 1, sk, causal, window, BN, kv_begin,
           kv_end);
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % L::GROUPS, prt = warp / L::GROUPS;
  const int r0 = q0 + 16 * grp;               // this warp's rows
  const int row0 = r0 + lane / 4;             // this thread's: row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  // the keys rows r0 .. r_last see: [q_offset + r0 - window + 1, q_offset
  // + r_last] under the window and the causal mask
  const int r_last = min(r0 + 16, sq) - 1;
  const int see_lo = window > 0 ? q_offset + r0 - window + 1 : INT_MIN;
  const int see_hi = causal ? q_offset + r_last : INT_MAX;

  auto issue = [&](int it) {
    float* st = ring + (it % STAGES) * 2 * BN * D;
    const int k0 = kv_begin + it * BN;
    repro_tf32x3::load_tile<D, BN, ff::THREADS>(st, k + kvh * sk * D, k0, sk);
    repro_tf32x3::load_tile<D, BN, ff::THREADS>(st + BN * D, v + kvh * sk * D, k0, sk);
  };
  repro_tf32x3::load_tile<D, BM, ff::THREADS>(q_s, q + (size_t)bh * sq * D, q0, sq);
  if (n_tiles > 0) issue(0);
  repro_tf32x3::cp_async_commit();

  float o[CH][CN / 8][4];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int n = 0; n < CN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ch][n][e] = 0.f;
  float ms[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    repro_tf32x3::cp_async_wait<0>();
    __syncthreads();   // tile it has landed; every warp is done with tile it - 1
    if (STAGES > 1 && it + 1 < n_tiles) issue(it + 1);
    repro_tf32x3::cp_async_commit();
    const float* kt = ring + (it % STAGES) * 2 * BN * D;
    const float* vt = kt + BN * D;
    const int k0 = kv_begin + it * BN;
    const int kw0 = k0 + prt * KW;            // this warp's keys
    // the row group's parts take this branch together
    if (r0 <= r_last && k0 <= see_hi && min(k0 + BN, sk) - 1 >= see_lo) {
      float s[KW / 8][4];
      if (kw0 <= see_hi && min(kw0 + KW, sk) - 1 >= see_lo && kw0 < sk) {
        repro_tf32x3::product<KW / 8, D, D, D, false>(s, q_s, 16 * grp, kt, prt * KW, lane);
      } else {
#pragma unroll
        for (int n = 0; n < KW / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      }
      float alpha[2];
      float row[2][KW / 4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < KW / 8; ++n) {
          row[i][2 * n] = s[n][2 * i];
          row[i][2 * n + 1] = s[n][2 * i + 1];
        }
      if constexpr (PARTS == 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const KeyMask ok{kw0, col0, q_offset + row0 + 8 * i, sk, causal, window};
          alpha[i] = softmax_row<KW / 4, true>(row[i], ms[i], l[i], c, ok);
        }
      } else {
        // softmax_row's steps with each row's max and sum over the parts
        float mx[2], sum[2], ms_new[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const KeyMask ok{kw0, col0, q_offset + row0 + 8 * i, sk, causal, window};
          mx[i] = kNegInf;
#pragma unroll
          for (int e = 0; e < KW / 4; ++e) {
            if (!ok(e)) row[i][e] = kNegInf;
            mx[i] = fmaxf(mx[i], row[i][e]);
          }
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          if (lane % 4 == 0) mx_s[prt * BM + 16 * grp + lane / 4 + 8 * i] = mx[i];
        }
        ff::group_sync<PARTS>(grp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const KeyMask ok{kw0, col0, q_offset + row0 + 8 * i, sk, causal, window};
          float m_all = mx_s[16 * grp + lane / 4 + 8 * i];
#pragma unroll
          for (int pt = 1; pt < PARTS; ++pt)
            m_all = fmaxf(m_all, mx_s[pt * BM + 16 * grp + lane / 4 + 8 * i]);
          ms_new[i] = fmaxf(ms[i], m_all * c);
          sum[i] = 0.f;
#pragma unroll
          for (int e = 0; e < KW / 4; ++e) {
            const float p = exp2f(fmaf(row[i][e], c, -ms_new[i]));
            row[i][e] = ok(e) ? p : 0.f;
            sum[i] += row[i][e];
          }
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
          if (lane % 4 == 0) sum_s[prt * BM + 16 * grp + lane / 4 + 8 * i] = sum[i];
        }
        ff::group_sync<PARTS>(grp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float tot = sum_s[16 * grp + lane / 4 + 8 * i];
#pragma unroll
          for (int pt = 1; pt < PARTS; ++pt) tot += sum_s[pt * BM + 16 * grp + lane / 4 + 8 * i];
          alpha[i] = exp2f(ms[i] - ms_new[i]);
          l[i] = alpha[i] * l[i] + tot;
          ms[i] = ms_new[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < KW / 8; ++n)
          *reinterpret_cast<float2*>(
              p_s + at<BN>(16 * grp + lane / 4 + 8 * i, prt * KW + 8 * n + col0)) =
              make_float2(row[i][2 * n], row[i][2 * n + 1]);
      ff::group_sync<PARTS>(grp);   // the row group's P rows are whole
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        float m[CN / 8][4];
        repro_tf32x3::product<CN / 8, BN, BN, D, true>(m, p_s, 16 * grp, vt, prt * OW + CN * ch,
                                                       lane);
#pragma unroll
        for (int n = 0; n < CN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[ch][n][e] = fmaf(o[ch][n][e], alpha[e >> 1], m[n][e]);
      }
    }
    if (STAGES == 1 && it + 1 < n_tiles) {
      __syncthreads();   // every warp is done with the stage
      issue(it + 1);
      repro_tf32x3::cp_async_commit();
    }
  }
  repro_tf32x3::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r < sq) {
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      float* orow = out + ((size_t)bh * sq + r) * D + prt * OW + col0;
#pragma unroll
      for (int ch = 0; ch < CH; ++ch)
#pragma unroll
        for (int n = 0; n < CN / 8; ++n)
          *reinterpret_cast<float2*>(orow + CN * ch + 8 * n) =
              make_float2(o[ch][n][2 * i] * inv, o[ch][n][2 * i + 1] * inv);
      if (lse != nullptr && prt == 0 && lane % 4 == 0)
        lse[(size_t)bh * sq + r] = row_lse(ms[i], l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D = 32: mma.sync m16n8k16, float32 accumulate
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
                 float* __restrict__ lse,      // (B, Hq, Sq) or null
                 int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                 float c) {                    // scale * log2(e)
  static_assert(D <= 64, "flash_mma_kernel keeps a warp's Q fragments in registers");
  constexpr int LD = D + 8;            // padded row: ldmatrix rows hit distinct banks
  constexpr int KS = D / 16;           // k-steps over D
  constexpr int DN = D / 8;            // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);
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
  // this warp's 16 query rows as A fragments, held in registers for all of D
  const bf16* q_frag = q_s + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], q_frag + ks * 16);

  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float ms[2] = {kNegInf, kNegInf};    // rows lane/4 and lane/4 + 8 of the warp, scaled
  float l[2] = {0.f, 0.f};
  const int qpos0 = q_offset + q0 + warp * 16 + (lane >> 2);

  int kv_begin, kv_end;
  kv_range(q_offset + q0, q_offset + min(q0 + BQ, sq) - 1, sk, causal, window, BK, kv_begin,
           kv_end);

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
      const KeyMask ok{k0, (lane & 3) * 2, qpos0 + half * 8, sk, causal, window};
      float row[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) row[e] = s[e >> 1][half * 2 + (e & 1)];
      const float alpha = softmax_row<16, true>(row, ms[half], l[half], c, ok);
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e >> 1][half * 2 + (e & 1)] = row[e];
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
      if (lse != nullptr && (lane & 3) == 0)
        lse[(size_t)bh * sq + r] = row_lse(ms[half], l[half]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D = 64, 128 and 256: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;                     // query rows per block, 64 per consumer

// per head dim: keys per kv tile, K/V ring depth, the registers a consumer
// and a producer thread hold after setmaxnreg (BLOCKS x (2 x 128 x consumer
// + 128 x producer) <= 65,536), the blocks an SM holds, whether the
// producer is one warp instead of a warpgroup (SLIM: no setmaxnreg; every
// thread keeps what the launch bounds give it), and whether the softmax is
// softmax_row's FAST one
template <int BN_, int STAGES_, int CONSUMER_REGS_, int PRODUCER_REGS_, int BLOCKS_, bool SLIM_,
          bool FAST_>
struct ShapeOf {
  static constexpr int BN = BN_, STAGES = STAGES_, CONSUMER_REGS = CONSUMER_REGS_,
                       PRODUCER_REGS = PRODUCER_REGS_, BLOCKS = BLOCKS_;
  static constexpr bool SLIM = SLIM_, FAST = FAST_;
  static constexpr int THREADS = SLIM ? 256 + 32 : 384;
};
// tools/flash_d64_sweep.py builds the other D = 64 shapes it times by
// defining this macro (in a header it pre-includes); the port builds the
// default
#ifndef FLASH_D64_SHAPE
#define FLASH_D64_SHAPE 64, 2, 0, 0, 2, true, true
#endif
template <int D> struct Shape;
template <> struct Shape<64> : ShapeOf<FLASH_D64_SHAPE> {};
template <> struct Shape<128> : ShapeOf<128, 3, 232, 40, 1, false, false> {};
template <> struct Shape<256> : ShapeOf<64, 2, 240, 24, 1, false, false> {};

// output columns per P.V product (wgmma m64n128k16, or m64n64k16 at D = 64)
// and products per 16 keys
template <int D> constexpr int ON = D >= 128 ? 128 : 64;
template <int D> constexpr int OH = D / ON<D>;

// A tile of R rows x D columns is D / 64 slabs of R rows of 128 bytes, each
// slab 128-byte swizzled (one TMA box of 64 columns x R rows). Shared
// memory holds Q, then per stage K and V, then the barriers, aligned to
// 1024 bytes (the swizzle's period) from a base that may sit anywhere.
template <int D>
struct Layout {
  static constexpr int BN = Shape<D>::BN, STAGES = Shape<D>::STAGES;
  static constexpr int SLABS = D / 64;
  static constexpr int Q_SLAB = BM * SLAB_ROW;
  static constexpr int KV_SLAB = BN * SLAB_ROW;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int KV_BYTES = SLABS * KV_SLAB;
  static constexpr int BARRIERS = 1 + 4 * STAGES;   // q_full; full and empty, K and V, per stage
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory is past the opt-in limit");
  static_assert(Shape<D>::BLOCKS * (SMEM_BYTES + 1024) <= 233472,
                "Shape<D>::BLOCKS blocks do not fit an SM's shared memory");
  static_assert(Shape<D>::SLIM || Shape<D>::BLOCKS * (256 * Shape<D>::CONSUMER_REGS +
                                                      128 * Shape<D>::PRODUCER_REGS) <= 65536,
                "Shape<D>::BLOCKS blocks do not fit an SM's registers");
};


// a block's shared memory: Q, then per stage K and V, then the mbarriers
template <int D>
struct Smem {
  using L = Layout<D>;
  uint32_t base;
  __device__ __forceinline__ uint32_t q() const { return base; }
  __device__ __forceinline__ uint32_t k(int st) const {
    return base + L::Q_BYTES + 2 * st * L::KV_BYTES;
  }
  __device__ __forceinline__ uint32_t v(int st) const { return k(st) + L::KV_BYTES; }
  __device__ __forceinline__ uint32_t bar(int i) const {
    return base + L::Q_BYTES + 2 * L::STAGES * L::KV_BYTES + 8u * i;
  }
  __device__ __forceinline__ uint32_t q_full() const { return bar(0); }
  __device__ __forceinline__ uint32_t full_k(int st) const { return bar(1 + st); }
  __device__ __forceinline__ uint32_t full_v(int st) const { return bar(1 + L::STAGES + st); }
  __device__ __forceinline__ uint32_t empty_k(int st) const {
    return bar(1 + 2 * L::STAGES + st);
  }
  __device__ __forceinline__ uint32_t empty_v(int st) const {
    return bar(1 + 3 * L::STAGES + st);
  }
};

// S = Q K^T of the tile in stage st, issued once it has landed: D / 16
// k-steps of 16 columns, 4 in each 64-column slab of Q and K
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[Shape<D>::BN / 2], const Smem<D>& sm,
                                        uint32_t q_w, int st, uint32_t phase) {
  using L = Layout<D>;
  mbar_wait(sm.full_k(st), phase);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss(s, desc_k(q_w + (ks / 4) * L::Q_SLAB + col),
             desc_k(sm.k(st) + (ks / 4) * L::KV_SLAB + col), ks);
  }
  wgmma_commit();
}

// O += P V of the tile in stage st, issued once it has landed: per 16 keys
// (16 slab rows of 128 B) one product for each ON output columns, whose V
// is ON / 64 slabs, KV_SLAB apart (MN-major); its wgmma.fence orders the
// writes of o and pa before the products.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[OH<D>][ON<D> / 2],
                                         const uint32_t (&pa)[Shape<D>::BN / 16][4],
                                         const Smem<D>& sm, int st, uint32_t phase) {
  using L = Layout<D>;
  mbar_wait(sm.full_v(st), phase);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::BN / 16; ++kk)
#pragma unroll
    for (int h = 0; h < OH<D>; ++h)
      wgmma_rs(o[h], pa[kk],
               desc(sm.v(st) + h * (ON<D> / 64) * L::KV_SLAB + kk * 16 * SLAB_ROW,
                    L::KV_SLAB, 1024));
  wgmma_commit();
}

// one kv tile's softmax on a consumer thread's N score accumulators, in
// place (element 4 j + 2 i + c: row i, key k0 + 8 j + col0 + c); the rows'
// output scale factors go to alpha. Only tiles the mask crosses (masked)
// test each key.
template <bool FAST, int N>
__device__ __forceinline__ void tile_softmax(float (&s)[N], float (&ms)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked, int k0, int qpos0,
                                             int col0, int sk, int causal, int window,
                                             float c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const KeyMask ok{k0, col0, qpos0 + 8 * i, sk, causal, window};
    float row[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) row[e] = s[4 * (e >> 1) + 2 * i + (e & 1)];
    alpha[i] = masked ? softmax_row<N / 2, true, FAST>(row, ms[i], l[i], c, ok)
                      : softmax_row<N / 2, false, FAST>(row, ms[i], l[i], c, ok);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) s[4 * (e >> 1) + 2 * i + (e & 1)] = row[e];
  }
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::Shape<D>::THREADS, wg::Shape<D>::BLOCKS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,   // (D, Sq, B*Hq)
                   const __grid_constant__ CUtensorMap tm_k,   // (D, Sk, B*Hkv)
                   const __grid_constant__ CUtensorMap tm_v,   // (D, Sk, B*Hkv)
                   bf16* __restrict__ out,                     // (B, Hq, Sq, D)
                   float* __restrict__ lse,                    // (B, Hq, Sq) or null
                   int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                   float c) {                                  // scale * log2(e)
  using namespace wg;
  using L = Layout<D>;
  constexpr int BN = L::BN, STAGES = L::STAGES, NH = OH<D>, NO = ON<D>;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const Smem<D> sm{(smem_addr(smem_wg) + 1023u) & ~1023u};

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(sm.full_k(st), 1);
      mbar_init(sm.full_v(st), 1);
      mbar_init(sm.empty_k(st), 2 * 128);
      mbar_init(sm.empty_v(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // under a causal or window mask, heads vary fastest and query tiles go
  // longest first over the whole grid (the tiles' work differs); without
  // one, query tiles vary fastest, so the blocks resident at once read the
  // K/V of few heads and find them in L2 (by_head below, as launched)
  const bool by_head = causal || window > 0;
  const int bh = by_head ? blockIdx.x : blockIdx.y;
  const int tile = by_head ? blockIdx.y : blockIdx.x;
  const int q0 = ((by_head ? gridDim.y : gridDim.x) - 1 - tile) * BM;
  int kv_begin, kv_end;
  kv_range(q_offset + q0, q_offset + min(q0 + BM, sq) - 1, sk, causal, window, BN, kv_begin,
           kv_end);
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;
  // warpgroups 0 and 1 consume, 2 produces; warp-uniform by construction
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (role == 2) {
    // ---- producer (a warpgroup, one warp where SLIM): one thread keeps the ring full ----
    if constexpr (!Shape<D>::SLIM)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Shape<D>::PRODUCER_REGS)
                   : "memory");
    if (threadIdx.x == 256) {
      const int b = bh / hq;
      const int kvh = b * hkv + (bh - b * hq) / (hq / hkv);
      mbar_expect_tx(sm.q_full(), L::Q_BYTES);
#pragma unroll
      for (int j = 0; j < L::SLABS; ++j)
        tma_load(sm.q() + j * L::Q_SLAB, &tm_q, sm.q_full(), 64 * j, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const uint32_t phase = ((it / STAGES) & 1) ^ 1;   // the first round finds them free
        const int k0 = kv_begin + it * BN;
        mbar_wait(sm.empty_k(st), phase);
        mbar_expect_tx(sm.full_k(st), L::KV_BYTES);
#pragma unroll
        for (int j = 0; j < L::SLABS; ++j)
          tma_load(sm.k(st) + j * L::KV_SLAB, &tm_k, sm.full_k(st), 64 * j, k0, kvh);
        mbar_wait(sm.empty_v(st), phase);
        mbar_expect_tx(sm.full_v(st), L::KV_BYTES);
#pragma unroll
        for (int j = 0; j < L::SLABS; ++j)
          tma_load(sm.v(st) + j * L::KV_SLAB, &tm_v, sm.full_v(st), 64 * j, k0, kvh);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (!Shape<D>::SLIM)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Shape<D>::CONSUMER_REGS)
                   : "memory");
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + role * 64 + (threadIdx.x % 128 / 32) * 16 + lane / 4;   // and + 8
    const int qpos0 = q_offset + row0;
    const int col0 = 2 * (lane % 4);                        // + 8 j + {0, 1}
    const int qlo = q_offset + q0 + role * 64;              // this warpgroup's rows
    const int qhi = qlo + 63;
    const uint32_t q_w = sm.q() + role * 64 * SLAB_ROW;     // its 64 rows of each slab
    // the per-element mask is needed where the Sk tail, the diagonal or the
    // window's lower edge crosses the tile for these rows
    auto crossed = [=](int k0) {
      return (k0 + BN > sk) || (causal && k0 + BN - 1 > qlo) || (window > 0 && k0 <= qhi - window);
    };

    float o[NH][NO / 2], s[BN / 2], ms[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pa[BN / 16][4];            // P as the bf16 A fragments of P.V
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < NO / 2; ++i) o[h][i] = 0.f;

    mbar_wait(sm.q_full(), 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const uint32_t phase = (it / STAGES) & 1;
      const int k0 = kv_begin + it * BN;
      issue_s<D>(s, sm, q_w, st, phase);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(sm.empty_k(st));
      tile_softmax<Shape<D>::FAST>(s, ms, l, alpha, crossed(k0), k0, qpos0, col0, sk, causal,
                                 window, c);
      // FAST: most tiles leave every row of the warp unscaled
      if (!Shape<D>::FAST || __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int h = 0; h < NH; ++h) scale_rows(o[h], alpha);
      }
      pack_p(pa, s);
      issue_pv<D>(o, pa, sm, st, phase);
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_regs(o[h]);
      mbar_arrive(sm.empty_v(st));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (Shape<D>::FAST) {   // the quad's shares of the row sum
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
      const int r = row0 + 8 * i;
      if (r < sq) {
        const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
        bf16* orow = out + ((size_t)bh * sq + r) * D + col0;
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int j = 0; j < NO / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + NO * h + 8 * j) =
                __floats2bfloat162_rn(o[h][4 * j + 2 * i] * inv, o[h][4 * j + 2 * i + 1] * inv);
        if (lse != nullptr && lane % 4 == 0) lse[(size_t)bh * sq + r] = row_lse(ms[i], l[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// one query row a batch row: split keys over blocks, K/V in the model's
// (B, Sk, Hkv, D) layout (flash_decode)
//
// Replaces the TPU kernel above (flash_attention.py, flash_attention) where
// the reference calls it with one query row: a decode tick's cross
// attention (src/repro/models/blocks.py, attn_block_decode, through
// models/attention.py::attention). Same function at Sq = 1: the row at
// absolute position q_offset sees the keys [lo, hi) of the causal and
// window masks (a contiguous range), softmax in float32, zeros where it
// sees none.
//
// What bounds it on an H100: bytes. Each K and V element carries g
// multiply-adds (one at Whisper's g = 1), so the card reads K/V far slower
// than it could multiply them, and a tensor-core tile would be mostly
// padding. What the design does about it: no copy (the rows are read in
// place through their strides, Hkv * D apart, not transposed first), one
// block per (kv head, split of the keys, batch row) so that enough bytes
// are in flight to fill the card (the wrapper sizes the splits for about
// four blocks an SM), each block reading its split once for all g query
// heads of its kv head. The splits' partials are merged as
// csrc/paged_decode.cu's combine merges them, but in the same launch: the
// last split of a (row, kv head) to finish, found by an atomic count that
// it resets, merges all of them (a second kernel cost 2-5 us, up to a fifth
// of the read).
// ---------------------------------------------------------------------------

namespace dec {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;                   // cp.async ring stages

// A K or V row of D elements is read by LPK lanes, each holding E elements
// (CPL 16-byte chunks, LPK apart); RPW rows a warp, R rows (row slots) a
// block, U keys a row slot in each tile of TK keys.
template <typename T, int D, int G>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CHUNKS = D / VEC;
  static constexpr int LPK = CHUNKS < 32 ? CHUNKS : 32;
  static constexpr int CPL = CHUNKS / LPK;
  static constexpr int E = CPL * VEC;
  static constexpr int RPW = 32 / LPK;
  static constexpr int R = WARPS * RPW;
  static constexpr int U = G >= 8 ? 2 : 4;
  static constexpr int TK = R * U;
  static constexpr int RING = STAGES * 2 * TK * D * (int)sizeof(T);
  static constexpr int MERGE = WARPS * G * (D + 2) * 4;
  static constexpr int SMEM = G * D * 4 + (RING > MERGE ? RING : MERGE);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a 16-byte chunk of shared memory as floats
__device__ __forceinline__ void chunk_f32(const float* p, float* f) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
}
__device__ __forceinline__ void chunk_f32(const bf16* p, float* f) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ float elem_f32(float x) { return x; }
__device__ __forceinline__ float elem_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(bf16* p, float x) { *p = __float2bfloat16(x); }

// Block (kv head h, split, row b) reads keys [s0, s1) of the row's visible
// range [lo, hi), s0 = lo + split * split_keys, for the g <= G query heads
// h * g .. h * g + g - 1 together. Each lane copies its own chunks of its
// rows into the ring with cp.async (zero-filled past s1) and reads back only
// what it copied, so the walk needs no barrier: STAGES - 1 tiles are in
// flight while one is computed. A row slot keeps each head's running max
// (of scores times c, log2 units), denominator and E-element accumulator in
// float32; the slots are merged by shuffles within a warp and through
// shared memory across warps into the split's partial (m, l, acc).
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q,        // (B, Hkv * g, D)
                    const T* __restrict__ k,        // row j of kv head h: b sb + j ss + h sh
                    const T* __restrict__ v,
                    T* __restrict__ out,            // (B, Hkv * g, D)
                    float* __restrict__ part_acc,   // (B, Hkv, n_splits, g, D)
                    float* __restrict__ part_ml,    // (B, Hkv, n_splits, g, 2)
                    int* __restrict__ counters,     // (B, Hkv), zero; left zero
                    int hkv, int g, long long sb, long long ss, long long sh, int lo, int hi,
                    int split_keys, float c) {
  using C = Cfg<T, D, G>;
  constexpr int E = C::E, U = C::U, R = C::R, TK = C::TK, LPK = C::LPK, VEC = C::VEC;
  extern __shared__ __align__(16) unsigned char smem_dec[];
  float* q_s = reinterpret_cast<float*>(smem_dec);                  // G x D
  T* ring = reinterpret_cast<T*>(smem_dec + G * D * 4);             // [stage][K, V][TK][D]
  float* merge = reinterpret_cast<float*>(smem_dec + G * D * 4);    // after the walk

  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = warp * C::RPW + lane / LPK;   // this lane's row slot
  const int li = lane % LPK;                     // its place in the row
  const int s0 = lo + split * split_keys;
  const int n = max(0, min(hi, s0 + split_keys) - s0);
  const int n_tiles = (n + TK - 1) / TK;
  const T* kb = k + b * sb + h * sh + (long long)s0 * ss;
  const T* vb = v + b * sb + h * sh + (long long)s0 * ss;

  auto issue = [&](int t) {
    T* ks = ring + (t % STAGES) * 2 * TK * D;
    T* vs = ks + TK * D;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = u * R + slot;
      const int i = t * TK + row;
      const bool ok = i < n;
      const long long off = (long long)(ok ? i : 0) * ss;
#pragma unroll
      for (int j = 0; j < C::CPL; ++j) {
        const int col = (li + j * LPK) * VEC;
        cp_async16(ks + row * D + col, kb + off + col, ok);
        cp_async16(vs + row * D + col, vb + off + col, ok);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  const T* qb = q + ((size_t)b * hkv + h) * g * D;
  for (int e = tid; e < G * D; e += THREADS) q_s[e] = e < g * D ? elem_f32(qb[e]) : 0.f;
  __syncthreads();                                // q_s complete

  float acc[G][E], m[G], l[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();                  // this lane's copies of tile t landed
    if (t + STAGES - 1 < n_tiles) issue(t + STAGES - 1);
    cp_async_commit();
    const T* ks = ring + (t % STAGES) * 2 * TK * D;
    const T* vs = ks + TK * D;

    float s[U][G];
    {
      float kf[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < C::CPL; ++j)
          chunk_f32(ks + (u * R + slot) * D + (li + j * LPK) * VEC, &kf[u][j * VEC]);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float qf[E];
#pragma unroll
        for (int j = 0; j < C::CPL; ++j)
#pragma unroll
          for (int x = 0; x < VEC; x += 4)
            chunk_f32(q_s + r * D + (li + j * LPK) * VEC + x, &qf[j * VEC + x]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) a = fmaf(qf[e], kf[u][e], a);
          s[u][r] = a;
        }
      }
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < G; ++r) s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], o);

    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) ok[u] = t * TK + u * R + slot < n;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][r] * c);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][r] = ok[u] ? exp2f(fmaf(s[u][r], c, -m_new)) : 0.f;
        sum += s[u][r];
      }
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int j = 0; j < C::CPL; ++j)
        chunk_f32(vs + (u * R + slot) * D + (li + j * LPK) * VEC, &vf[j * VEC]);
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(s[u][r], vf[e], acc[r][e]);
    }
  }

  // merge the warp's row slots (lanes LPK, 2 LPK, ... apart hold the same
  // elements of other slots)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float a = exp2f(m[r] - mn), bo = exp2f(mo - mn);
      l[r] = a * l[r] + bo * lo_;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] = a * acc[r][e] + bo * __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  // ... and the warps' through shared memory, once the ring is idle
  cp_async_wait<0>();
  __syncthreads();
  float* ml_w = merge;                            // [WARPS][G][2]
  float* acc_w = merge + WARPS * G * 2;           // [WARPS][G][D]
  if (lane < LPK) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (li == 0) {
        ml_w[(warp * G + r) * 2] = m[r];
        ml_w[(warp * G + r) * 2 + 1] = l[r];
      }
#pragma unroll
      for (int j = 0; j < C::CPL; ++j)
#pragma unroll
        for (int x = 0; x < VEC; ++x)
          acc_w[(warp * G + r) * D + (li + j * LPK) * VEC + x] = acc[r][j * VEC + x];
    }
  }
  __syncthreads();
  const size_t part = ((size_t)b * hkv + h) * gridDim.y + split;
  for (int e = tid; e < g * D; e += THREADS) {
    const int r = e / D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, ml_w[(w * G + r) * 2]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(ml_w[(w * G + r) * 2] - mm);
      ll = fmaf(f, ml_w[(w * G + r) * 2 + 1], ll);
      aa = fmaf(f, acc_w[(w * G + r) * D + e - r * D], aa);
    }
    part_acc[part * g * D + e] = aa;
    if (e - r * D == 0) {
      part_ml[(part * g + r) * 2] = mm;
      part_ml[(part * g + r) * 2 + 1] = ll;
    }
  }

  // the last of the (row, kv head)'s splits to finish merges them all:
  // out[b, h g + r, :] = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp2(m_s -
  // max m); a row that sees no key (every l_s = 0) gives zeros
  __shared__ bool last;
  __threadfence();                                // this split's partial, device-wide
  __syncthreads();
  if (tid == 0) {
    int* count = counters + (size_t)b * hkv + h;
    last = atomicAdd(count, 1) == (int)gridDim.y - 1;
    if (last) *count = 0;                         // for the next launch on the stream
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_splits = gridDim.y;
  const size_t first = ((size_t)b * hkv + h) * n_splits;
  for (int e = tid; e < g * D; e += THREADS) {
    const int r = e / D;
    const float* ml = part_ml + (first * g + r) * 2;          // split s at ml[2 g s]
    const float* acc_s = part_acc + (first * g + r) * D + (e - r * D);   // at [g D s]
    float mm = kNegInf;
    for (int sp = 0; sp < n_splits; ++sp) mm = fmaxf(mm, __ldcg(ml + 2 * g * sp));
    float ll = 0.f, aa = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float f = exp2f(__ldcg(ml + 2 * g * sp) - mm);
      ll = fmaf(f, __ldcg(ml + 2 * g * sp + 1), ll);
      aa = fmaf(f, __ldcg(acc_s + (size_t)g * D * sp), aa);
    }
    store_elem(out + ((size_t)b * hkv + h) * g * D + e, aa / (ll == 0.f ? 1.f : ll));
  }
}

}  // namespace dec

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* out, float* lse,
                          int batch, int hq, int hkv, int sq, int sk, int causal, int window,
                          int q_offset, float scale, cudaStream_t stream) {
  using L = ff::Layout<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_tf32x3_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = (sq + L::BM - 1) / L::BM;
  const dim3 grid = causal || window > 0 ? dim3(batch * hq, tiles) : dim3(tiles, batch * hq);
  flash_tf32x3_kernel<D><<<grid, ff::THREADS, L::SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, hq, hkv, sq, sk, causal,
      window, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                       int batch, int hq, int hkv, int sq, int sk, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream) {
  const int bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, batch * hq);
  flash_mma_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, hq, hkv, sq, sk, causal, window, q_offset,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int batch, int hq, int hkv, int sq, int sk, int causal, int window,
                         int q_offset, float scale, cudaStream_t stream) {
  using L = wg::Layout<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, D, sq, batch * hq, wg::BM) ||
      !make_map(enc, &tk, k, D, sk, batch * hkv, L::BN) ||
      !make_map(enc, &tv, v, D, sk, batch * hkv, L::BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  // the largest shared-memory carveout, so that Shape<D>::BLOCKS blocks fit an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int tiles = (sq + wg::BM - 1) / wg::BM;
  const dim3 grid = causal || window > 0 ? dim3(batch * hq, tiles) : dim3(tiles, batch * hq);
  flash_wgmma_kernel<D><<<grid, wg::Shape<D>::THREADS, L::SMEM_BYTES, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, hq, hkv, sq, sk, causal, window, q_offset,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int hq, int hkv, int sq, int sk, int causal, int window,
                   int q_offset, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_tf32x3<D>(q, k, v, out, lse, batch, hq, hkv, sq, sk, causal, window,
                            q_offset, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (D >= 64)
    return launch_wgmma<D>(q, k, v, out, lse, batch, hq, hkv, sq, sk, causal, window, q_offset,
                           scale, s);
  else
    return launch_mma<D>(q, k, v, out, lse, batch, hq, hkv, sq, sk, causal, window, q_offset,
                         scale, s);
}

template <typename T, int D, int G>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* out,
                          float* part_acc, float* part_ml, int* counters, int batch, int hkv,
                          int g, long long sb, long long ss, long long sh, int lo, int hi,
                          int split_keys, int n_splits, float scale, cudaStream_t stream) {
  constexpr int bytes = dec::Cfg<T, D, G>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(dec::flash_decode_kernel<T, D, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dec::flash_decode_kernel<T, D, G><<<dim3(hkv, n_splits, batch), dec::THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), part_acc, part_ml, counters, hkv, g, sb, ss, sh, lo, hi,
      split_keys, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t decode_g(const void* q, const void* k, const void* v, void* out, float* pa,
                     float* pm, int* cnt, int batch, int hkv, int g, long long sb, long long ss,
                     long long sh, int lo, int hi, int split_keys, int n_splits, float scale,
                     cudaStream_t s) {
  // the instantiation whose G is the smallest of 1, 4, 16 >= g
  if (g == 1)
    return launch_decode<T, D, 1>(q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                                  split_keys, n_splits, scale, s);
  if (g <= 4)
    return launch_decode<T, D, 4>(q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                                  split_keys, n_splits, scale, s);
  return launch_decode<T, D, 16>(q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                                 split_keys, n_splits, scale, s);
}

template <typename T>
cudaError_t decode_d(int d, const void* q, const void* k, const void* v, void* out, float* pa,
                     float* pm, int* cnt, int batch, int hkv, int g, long long sb, long long ss,
                     long long sh, int lo, int hi, int split_keys, int n_splits, float scale,
                     cudaStream_t s) {
  switch (d) {
    case 32:
      return decode_g<T, 32>(q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                             split_keys, n_splits, scale, s);
    case 64:
      return decode_g<T, 64>(q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                             split_keys, n_splits, scale, s);
    case 128:
      return decode_g<T, 128>(q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                              split_keys, n_splits, scale, s);
    case 256:
      return decode_g<T, 256>(q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                              split_keys, n_splits, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One query row a batch row: q (batch, hkv * g, d), k and v rows of kv
// head h at b * sb + j * ss + h * sh elements (16-byte aligned), keys
// [lo, hi) seen, in n_splits splits of split_keys; out (batch, hkv * g, d)
// in q's dtype. part_acc / part_ml: float32 workspace of batch * hkv *
// n_splits * g * d and batch * hkv * n_splits * g * 2 elements; counters:
// batch * hkv int32, zero, which the launch leaves zero. dtype: 0 =
// float32, 1 = bfloat16; d in {32, 64, 128, 256}; 1 <= g <= 16. One launch
// of flash_decode_kernel; returns its cudaError_t.
extern "C" int flash_decode(const void* q, const void* k, const void* v, void* out,
                            void* part_acc, void* part_ml, void* counters, int dtype, int batch,
                            int hkv, int g, int d, long long sb, long long ss, long long sh,
                            int lo, int hi, int split_keys, int n_splits, float scale,
                            void* stream) {
  if (g < 1 || g > 16 || lo < 0 || hi < lo || split_keys < 1 || n_splits < 1 ||
      (long long)n_splits * split_keys < hi - lo)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  cudaError_t err;
  if (dtype == 0)
    err = decode_d<float>(d, q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                          split_keys, n_splits, scale, s);
  else if (dtype == 1)
    err = decode_d<bf16>(d, q, k, v, out, pa, pm, cnt, batch, hkv, g, sb, ss, sh, lo, hi,
                         split_keys, n_splits, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128, 256}; rows must be
// 16-byte aligned. bfloat16 at d = 64, 128 and 256 runs
// flash_wgmma_kernel<d>, at d = 32 flash_mma_kernel<32>; float32 runs
// flash_tf32x3_kernel<d>. lse: null, or (batch, hq, sq)
// float32 for each row's log-sum-exp. Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               void* lse_out, int dtype, int batch, int hq, int hkv, int sq,
                               int sk, int d, int causal, int window, int q_offset,
                               float scale, void* stream) {
  if (hkv < 1 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  cudaError_t err;
  switch (d) {
    case 32:
      err = launch<32>(dtype, q, k, v, out, lse, batch, hq, hkv, sq, sk, causal, window, q_offset,
                       scale, s);
      break;
    case 64:
      err = launch<64>(dtype, q, k, v, out, lse, batch, hq, hkv, sq, sk, causal, window, q_offset,
                       scale, s);
      break;
    case 128:
      err = launch<128>(dtype, q, k, v, out, lse, batch, hq, hkv, sq, sk, causal, window, q_offset,
                        scale, s);
      break;
    case 256:
      err = launch<256>(dtype, q, k, v, out, lse, batch, hq, hkv, sq, sk, causal, window, q_offset,
                        scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
