// Mamba-2 SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan, body
// _ssd_kernel). Same function, per (batch row b, head h), over chunks of
// `chunk` positions with a float32 (P, N) state that starts at zero:
//   cum    = inclusive prefix sum of dt * a within the chunk, total = cum[-1]
//   y      = (C B^T o L) (dt x) + exp(cum) C state^T + d x,
//            L[i, j] = exp(cum_i - cum_j) for i >= j, 0 above the diagonal
//            (masked before the exp: those entries are positive and overflow)
//   state  = exp(total) state + (dt x exp(total - cum))^T B
// x (B, S, H, P) and B, C (B, S, N) in float32 or bfloat16, dt (B, S, H),
// a (H,) and d (H,) in float32, y in x's dtype, rounded once. cum is kept in
// float64: under strong decay it reaches thousands, and a float32 difference
// of two such values carries an absolute error of ~5e-4 however small the
// difference is; each difference is rounded to float32 before its exp.
//
// What bounds it on an H100: bytes, at the serving shape (B 8, S 2048,
// H 64, P 64, N 128, bf16): ~281 MB moved, 0.084 ms at 3.35 TB/s, against
// 43 GFLOP of small products (0.26 ms as 3xTF32 at the TF32 peak). The
// first version of this kernel (one block per (row, head, 32-column P
// tile), every product as float32 FMAs on the CUDA cores, C B^T redone for
// each of those blocks, five block-wide barriers per chunk and loads that
// did not overlap the products) ran 36x above the byte bound.
//
// What this design does about it:
// - C B^T once per (row, chunk). C and B are shared by every head, so a
//   small first pass (ssd_scan_gram_kernel, one block per (chunk, row))
//   writes G = C B^T as (B, nc, 64, 64) float32 scratch (4.2 MB at the
//   serving shape, which the next pass reads from L2). With bfloat16 inputs
//   C and B are exact in TF32, so this is one TF32 product per k-step.
// - The three per-head products on the tensor cores, mma.sync m16n8k8 TF32
//   (the tiles are a 64-row chunk, a 32-column P tile and N = 128: too
//   small a block of work per product for wgmma's 64-row warpgroup tiles to
//   pay), each float32 operand split into a TF32 hi and lo part (3xTF32, as
//   tf32x3_tile.cuh does) so the result meets the float32 tolerance:
//     y_intra = W x,       W = (G o L) dt_j   (W split; x exact in bf16)
//     y_inter = C state^T                     (C exact in bf16; state split)
//     state  += (x sc)^T B, sc = dt exp(total - cum)   ((x sc) split; B exact)
//   An operand that is exact in TF32 (a bfloat16 input) is not split, so
//   with bfloat16 inputs each product costs two TF32 products, not three.
//   The lo terms go to their own accumulator, added once at the end. The
//   causal mask leaves W's upper k-steps zero; they are skipped.
// - The (P, N) state stays float32 in the update product's accumulator
//   registers across chunks; at each chunk's start it is written once to
//   shared memory, where the inter-chunk product reads it, each warp
//   splitting the values it reads. (Splitting it once there into TF32 hi
//   and lo arrays ran slower on the H100: the extra 33 KB of shared memory
//   and the two loads per value cost more than the split saved.)
// - The chunk walk is pipelined: chunk c + 1's G, x, C and B tiles arrive
//   by 16-byte cp.async in a 2-stage ring (rows past the chunk zero-filled)
//   while chunk c's products run; warp 0 forms chunk c + 1's float64
//   cumsum during chunk c from dt it read into registers a chunk earlier. Two
//   block-wide barriers per chunk remain: one for the landed stage, one
//   between forming (W, the shared state) and the products reading them.
// - Grid: one block per (P tile, head, row), one block per SM. The wrapper
//   takes the whole P of 64 in a block of 16 warps (bfloat16: ring, state
//   and cumsum ~156 KB) where that still gives every SM a block (the (4,
//   2048) and (8, 2048) buckets), so W, the cumsum and the G, C and B tiles
//   are formed and loaded once per head; else 32-column tiles in blocks of
//   8 warps (128 blocks at the (1, 1024) bucket for the 132 SMs; float32
//   always, as its full-P ring does not fit: ~207 KB at 32 columns). Each
//   warp holds the same tiles either way: 2 of y's and 4 of the state's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro_tf32x3::cp_async16;

constexpr int CH = 64;         // largest chunk; shorter chunks are zero-padded
constexpr int GRAM_NT = 128;   // threads of a Gram block: 4 warps x 16 rows
constexpr int STAGES = 2;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Exact {   // values of T are TF32 values already
  static constexpr bool value = false;
};
template <>
struct Exact<bf16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, float32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): a = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b = (k t, n g), (k t + 4, n g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// R values of one operand fragment as TF32 hi and lo parts; EXACT: the
// values are TF32 already, lo is zero and never formed
template <int R, bool EXACT>
struct Frag {
  uint32_t hi[R], lo[R];
  __device__ __forceinline__ void set(int i, float v) {
    if (EXACT)
      hi[i] = __float_as_uint(v);
    else
      repro_tf32x3::split_tf32(v, hi[i], lo[i]);
  }
};

// big += a_hi b_hi; small += a_hi b_lo + a_lo b_hi (the terms that are not zero)
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const Frag<4, AX>& a,
                                     const Frag<2, BX>& b) {
  mma_tf32(big, a.hi, b.hi[0], b.hi[1]);
  if (!BX) mma_tf32(small, a.hi, b.lo[0], b.lo[1]);
  if (!AX) mma_tf32(small, a.lo, b.hi[0], b.hi[1]);
}

// ---------------------------------------------------------------------------
// pass 1: G = C B^T per (row, chunk)
// ---------------------------------------------------------------------------

// shared C and B rows of a Gram block (T elements), padded by 16 bytes so
// a fragment read (8 rows x 4 columns) hits distinct banks
template <typename T, int N>
struct Gram {
  static constexpr int LD = N + 16 / static_cast<int>(sizeof(T));
  static constexpr int BYTES = 2 * CH * LD * static_cast<int>(sizeof(T));
};

// g[b, c] (CH x CH float32) = C[b, chunk c] . B[b, chunk c]^T, rows and
// columns at or past `chunk` zero. Block (c, b); warp w owns rows 16 w + 0..15.
template <typename T, int N>
__global__ void __launch_bounds__(GRAM_NT)
ssd_scan_gram_kernel(const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ g,
                     int seqlen, int chunk) {
  constexpr int LD = Gram<T, N>::LD;
  constexpr int V = 16 / static_cast<int>(sizeof(T));   // elements per 16-byte load
  constexpr bool EX = Exact<T>::value;
  extern __shared__ __align__(16) unsigned char smem_g[];
  T* cs = reinterpret_cast<T*>(smem_g);
  T* bs = cs + CH * LD;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * seqlen + static_cast<size_t>(c) * chunk;
  for (int e = threadIdx.x; e < CH * (N / V); e += GRAM_NT) {
    const int r = e / (N / V);
    const int q = (e % (N / V)) * V;
    uint4 cv = make_uint4(0, 0, 0, 0), bv = make_uint4(0, 0, 0, 0);
    if (r < chunk) {
      cv = __ldg(reinterpret_cast<const uint4*>(cm + (row0 + r) * N + q));
      bv = __ldg(reinterpret_cast<const uint4*>(bm + (row0 + r) * N + q));
    }
    *reinterpret_cast<uint4*>(cs + r * LD + q) = cv;
    *reinterpret_cast<uint4*>(bs + r * LD + q) = bv;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int i0 = (threadIdx.x / 32) * 16;
  float big[CH / 8][4], small[CH / 8][4];
#pragma unroll
  for (int j = 0; j < CH / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) big[j][v] = small[j][v] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < N; k0 += 8) {
    Frag<4, EX> af;
    af.set(0, to_f(cs[(i0 + gq) * LD + k0 + tq]));
    af.set(1, to_f(cs[(i0 + gq + 8) * LD + k0 + tq]));
    af.set(2, to_f(cs[(i0 + gq) * LD + k0 + tq + 4]));
    af.set(3, to_f(cs[(i0 + gq + 8) * LD + k0 + tq + 4]));
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      Frag<2, EX> bf;
      bf.set(0, to_f(bs[(8 * j + gq) * LD + k0 + tq]));
      bf.set(1, to_f(bs[(8 * j + gq) * LD + k0 + tq + 4]));
      mma3(big[j], small[j], af, bf);
    }
  }
  float* out = g + (static_cast<size_t>(b) * gridDim.x + c) * CH * CH;
#pragma unroll
  for (int j = 0; j < CH / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(out + (i0 + gq + 8 * h) * CH + 8 * j + 2 * tq, big[j][2 * h] + small[j][2 * h],
             big[j][2 * h + 1] + small[j][2 * h + 1]);
}

// ---------------------------------------------------------------------------
// pass 2: the chunk walk
// ---------------------------------------------------------------------------

// Shared memory of a walk block (bytes), mirrored by kernels/ssd_scan.py's
// smem_bytes: per-chunk vectors (two buffers), the shared state, then
// STAGES ring stages of G (W in place), x, C and B. Row paddings keep every
// fragment read on distinct banks: G, C and the state are read (8 rows x 4
// columns), x and B (4 rows x 8 columns).
template <typename T, int PT, int N>
struct Walk {
  static constexpr int SZ = static_cast<int>(sizeof(T));
  static constexpr int LDG = CH + 4;            // floats
  static constexpr int LDX = PT + 8;            // T
  static constexpr int LDC = N + 16 / SZ;       // T
  static constexpr int LDB = N + 8;             // T
  static constexpr int LDS = N + 4;             // floats
  static constexpr int G_BYTES = CH * LDG * 4;
  static constexpr int X_BYTES = CH * LDX * SZ;
  static constexpr int C_BYTES = CH * LDC * SZ;
  static constexpr int B_BYTES = CH * LDB * SZ;
  static constexpr int STAGE_BYTES = G_BYTES + X_BYTES + C_BYTES + B_BYTES;
  // cum (float64), dt, exp(cum), dt exp(total - cum), exp(total): two buffers
  static constexpr int VEC_BYTES = 2 * CH * 8 + 3 * 2 * CH * 4 + 16;
  static constexpr int S_BYTES = PT * LDS * 4;
  static constexpr int BYTES = VEC_BYTES + S_BYTES + STAGES * STAGE_BYTES;
  static_assert(G_BYTES % 16 == 0 && X_BYTES % 16 == 0 && C_BYTES % 16 == 0 &&
                    B_BYTES % 16 == 0 && S_BYTES % 16 == 0 && VEC_BYTES % 16 == 0,
                "16-byte aligned regions");
};

// Warp 0: the chunk's inclusive prefix sum of dt * a in float64 (two
// positions per lane), its exponentials, and dt, into buffer `buf`.
// Padded positions have dt = 0 and leave cum at its total.
__device__ __forceinline__ void chunk_scan(float dt0, float dt1, float ah, double* cum,
                                           float* dts, float* ec, float* sc, float* et) {
  const int lane = threadIdx.x;
  const double v0 = static_cast<double>(dt0 * ah);
  const double v1 = static_cast<double>(dt1 * ah);
  double s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += u;
  }
  const double total = __shfl_sync(kFull, s, 31);
  const double c0 = s - v1;
  const int i0 = 2 * lane;
  cum[i0] = c0;
  cum[i0 + 1] = s;
  dts[i0] = dt0;
  dts[i0 + 1] = dt1;
  ec[i0] = expf(static_cast<float>(c0));
  ec[i0 + 1] = expf(static_cast<float>(s));
  sc[i0] = dt0 * expf(static_cast<float>(total - c0));
  sc[i0 + 1] = dt1 * expf(static_cast<float>(total - s));
  if (lane == 0) *et = expf(static_cast<float>(total));
}

// Block (P tile, head h, row b) of NW warps walks the chunks; see the head
// of the file. STATES (the training forward): also write the state entering
// each chunk to `states`; the serving instantiation compiles without it.
template <typename T, int PT, int N, int NW, bool STATES>
__global__ void __launch_bounds__(32 * NW, 1)
ssd_scan_walk_kernel(const T* __restrict__ x,          // (B, S, H, P)
                     const float* __restrict__ dt,     // (B, S, H)
                     const float* __restrict__ a,      // (H,)
                     const T* __restrict__ bm,         // (B, S, N)
                     const T* __restrict__ cm,         // (B, S, N)
                     const float* __restrict__ dskip,  // (H,)
                     const float* __restrict__ g,      // (B, nc, CH, CH) from pass 1
                     T* __restrict__ y,                // (B, S, H, P)
                     float* __restrict__ states,       // (B, H, nc, P, N) if STATES
                     int seqlen, int heads, int p_total, int chunk) {
  using L = Walk<T, PT, N>;
  constexpr int NT = 32 * NW;
  constexpr bool EX = Exact<T>::value;
  constexpr int V = 16 / L::SZ;                // T elements per 16-byte copy
  // output tiles (16 x 8) of y (CH x PT) and of the state (PT x N); a warp
  // takes consecutive tiles of one row block, so its A fragments serve all
  constexpr int YT = (CH / 16) * (PT / 8), YPW = (YT + NW - 1) / NW;
  constexpr int UT = (PT / 16) * (N / 8), UPW = (UT + NW - 1) / NW;
  static_assert(PT % 16 == 0 && N % 8 == 0, "tile shapes");
  static_assert((PT / 8) % YPW == 0 && (N / 8) % UPW == 0, "a warp's tiles share rows");

  extern __shared__ __align__(16) unsigned char smem[];
  double* cum_s = reinterpret_cast<double*>(smem);   // [2][CH]
  float* dt_s = reinterpret_cast<float*>(cum_s + 2 * CH);
  float* ec_s = dt_s + 2 * CH;
  float* sc_s = ec_s + 2 * CH;
  float* et_s = sc_s + 2 * CH;                       // [2] (+ 2 padding)
  float* st_s = et_s + 4;                            // PT x LDS: the state
  unsigned char* ring = smem + L::VEC_BYTES + L::S_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float ah = a[h];
  const float dh = dskip[h];
  const size_t xrow = static_cast<size_t>(heads) * p_total;  // x / y row stride
  const int n_chunks = seqlen / chunk;
  const size_t brow = static_cast<size_t>(b) * seqlen;

  const int yt0 = warp * YPW;
  const bool y_on = yt0 < YT;
  const int yi0 = 16 * (yt0 / (PT / 8)), yp0 = 8 * (yt0 % (PT / 8));
  const int ut0 = warp * UPW;
  const bool u_on = ut0 < UT;
  const int up0 = 16 * (ut0 / (N / 8)), un0 = 8 * (ut0 % (N / 8));

  // issue chunk ci's tiles into its stage (one commit group)
  auto load_chunk = [&](int ci) {
    unsigned char* st = ring + (ci % STAGES) * L::STAGE_BYTES;
    float* gs = reinterpret_cast<float*>(st);
    T* xs = reinterpret_cast<T*>(st + L::G_BYTES);
    T* cs = reinterpret_cast<T*>(st + L::G_BYTES + L::X_BYTES);
    T* bs = reinterpret_cast<T*>(st + L::G_BYTES + L::X_BYTES + L::C_BYTES);
    const size_t row0 = brow + static_cast<size_t>(ci) * chunk;
    const float* gsrc = g + (static_cast<size_t>(b) * n_chunks + ci) * CH * CH;
    for (int e = tid; e < CH * CH / 4; e += NT)
      cp_async16(gs + (e / (CH / 4)) * L::LDG + (e % (CH / 4)) * 4, gsrc + e * 4, true);
    const T* xsrc = x + row0 * xrow + static_cast<size_t>(h) * p_total + p0;
    for (int e = tid; e < CH * (PT / V); e += NT) {
      const int r = e / (PT / V), q = (e % (PT / V)) * V;
      const bool in = r < chunk;
      cp_async16(reinterpret_cast<float*>(xs + r * L::LDX + q), in ? xsrc + r * xrow + q : xsrc,
                 in);
    }
    for (int e = tid; e < CH * (N / V); e += NT) {
      const int r = e / (N / V), q = (e % (N / V)) * V;
      const bool in = r < chunk;
      const size_t off = in ? (row0 + r) * N + q : 0;
      cp_async16(reinterpret_cast<float*>(cs + r * L::LDC + q), cm + off, in);
      cp_async16(reinterpret_cast<float*>(bs + r * L::LDB + q), bm + off, in);
    }
    repro_tf32x3::cp_async_commit();
  };
  // warp 0: dt of chunk ci, two positions per lane (0 past the chunk)
  auto load_dt = [&](int ci, float& d0, float& d1) {
    const size_t row0 = brow + static_cast<size_t>(ci) * chunk;
    const int i0 = 2 * lane;
    d0 = i0 < chunk ? __ldg(dt + (row0 + i0) * heads + h) : 0.f;
    d1 = i0 + 1 < chunk ? __ldg(dt + (row0 + i0 + 1) * heads + h) : 0.f;
  };

  float st[UPW][4];   // the state tiles this warp updates
#pragma unroll
  for (int j = 0; j < UPW; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;

  load_chunk(0);
  float dn0 = 0.f, dn1 = 0.f;   // warp 0: dt of the chunk after the current one
  if (warp == 0) {
    load_dt(0, dn0, dn1);
    chunk_scan(dn0, dn1, ah, cum_s, dt_s, ec_s, sc_s, et_s);
    if (n_chunks > 1) load_dt(1, dn0, dn1);
  }

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    unsigned char* stage = ring + (ci % STAGES) * L::STAGE_BYTES;
    float* ws = reinterpret_cast<float*>(stage);
    const T* xs = reinterpret_cast<const T*>(stage + L::G_BYTES);
    const T* cs = reinterpret_cast<const T*>(stage + L::G_BYTES + L::X_BYTES);
    const T* bs = reinterpret_cast<const T*>(stage + L::G_BYTES + L::X_BYTES + L::C_BYTES);
    repro_tf32x3::cp_async_wait<0>();
    __syncthreads();   // chunk ci has landed; chunk ci - 1 is done everywhere
    const bool more = ci + 1 < n_chunks;
    if (more) load_chunk(ci + 1);
    // warp 0: chunk ci + 1's cumsum into the other buffer (last read in
    // chunk ci - 1), then chunk ci + 2's dt. Warp 0 has the fewest masked
    // product k-steps, so the scan runs in the others' product time rather
    // than ahead of the next barrier.
    if (warp == 0 && more) {
      const int nb = buf ^ 1;
      chunk_scan(dn0, dn1, ah, cum_s + nb * CH, dt_s + nb * CH, ec_s + nb * CH, sc_s + nb * CH,
                 et_s + nb);
      if (ci + 2 < n_chunks) load_dt(ci + 2, dn0, dn1);
    }

    // the state entering this chunk, for the inter-chunk product (and,
    // training, for the backward: states[b, h, ci])
    if (u_on) {
#pragma unroll
      for (int j = 0; j < UPW; ++j) {
        float* row = st_s + (up0 + gq) * L::LDS + un0 + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(row) = make_float2(st[j][0], st[j][1]);
        *reinterpret_cast<float2*>(row + 8 * L::LDS) = make_float2(st[j][2], st[j][3]);
      }
      if (STATES) {
        float* out = states + ((static_cast<size_t>(b) * heads + h) * n_chunks + ci) *
                                  p_total * N + static_cast<size_t>(p0 + up0 + gq) * N;
#pragma unroll
        for (int j = 0; j < UPW; ++j) {
          float* o = out + un0 + 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(o) = make_float2(st[j][0], st[j][1]);
          *reinterpret_cast<float2*>(o + 8 * N) = make_float2(st[j][2], st[j][3]);
        }
      }
    }
    // W = (G o L) * dt_j in place of G, masked before the exp
    {
      const double* cum = cum_s + buf * CH;
      const float* dts = dt_s + buf * CH;
#pragma unroll 4
      for (int e = 0; e < CH * CH / NT; ++e) {
        const int idx = tid + e * NT;
        const int i = idx / CH, j = idx % CH;
        float* w = ws + i * L::LDG + j;
        *w = i >= j ? *w * expf(static_cast<float>(cum[i] - cum[j])) * dts[j] : 0.f;
      }
    }
    __syncthreads();

    const float* ec = ec_s + buf * CH;
    const float* sc = sc_s + buf * CH;
    if (y_on) {
      // y = W x + exp(cum) (C state^T) + d x over this warp's tiles
      float yi[YPW][4], yis[YPW][4], yo[YPW][4], yos[YPW][4];
#pragma unroll
      for (int j = 0; j < YPW; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) yi[j][v] = yis[j][v] = yo[j][v] = yos[j][v] = 0.f;
      // W's columns past the tile's last row are zero: k-steps below i0 + 16
      for (int k0 = 0; k0 < yi0 + 16; k0 += 8) {
        Frag<4, false> af;
        af.set(0, ws[(yi0 + gq) * L::LDG + k0 + tq]);
        af.set(1, ws[(yi0 + gq + 8) * L::LDG + k0 + tq]);
        af.set(2, ws[(yi0 + gq) * L::LDG + k0 + tq + 4]);
        af.set(3, ws[(yi0 + gq + 8) * L::LDG + k0 + tq + 4]);
#pragma unroll
        for (int j = 0; j < YPW; ++j) {
          const int p = yp0 + 8 * j + gq;
          Frag<2, EX> bf;
          bf.set(0, to_f(xs[(k0 + tq) * L::LDX + p]));
          bf.set(1, to_f(xs[(k0 + tq + 4) * L::LDX + p]));
          mma3(yi[j], yis[j], af, bf);
        }
      }
#pragma unroll 4
      for (int k0 = 0; k0 < N; k0 += 8) {
        Frag<4, EX> af;
        af.set(0, to_f(cs[(yi0 + gq) * L::LDC + k0 + tq]));
        af.set(1, to_f(cs[(yi0 + gq + 8) * L::LDC + k0 + tq]));
        af.set(2, to_f(cs[(yi0 + gq) * L::LDC + k0 + tq + 4]));
        af.set(3, to_f(cs[(yi0 + gq + 8) * L::LDC + k0 + tq + 4]));
#pragma unroll
        for (int j = 0; j < YPW; ++j) {
          const int p = yp0 + 8 * j + gq;
          Frag<2, false> bf;
          bf.set(0, st_s[p * L::LDS + k0 + tq]);
          bf.set(1, st_s[p * L::LDS + k0 + tq + 4]);
          mma3(yo[j], yos[j], af, bf);
        }
      }
      const size_t row0 = brow + static_cast<size_t>(ci) * chunk;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = yi0 + gq + 8 * hh;
        if (i >= chunk) continue;
        T* yrow = y + (row0 + i) * xrow + static_cast<size_t>(h) * p_total + p0;
        const float e = ec[i];
#pragma unroll
        for (int j = 0; j < YPW; ++j) {
          const int p = yp0 + 8 * j + 2 * tq;
          const float v0 = (yi[j][2 * hh] + yis[j][2 * hh]) +
                           e * (yo[j][2 * hh] + yos[j][2 * hh]) +
                           dh * to_f(xs[i * L::LDX + p]);
          const float v1 = (yi[j][2 * hh + 1] + yis[j][2 * hh + 1]) +
                           e * (yo[j][2 * hh + 1] + yos[j][2 * hh + 1]) +
                           dh * to_f(xs[i * L::LDX + p + 1]);
          store2(yrow + p, v0, v1);
        }
      }
    }
    if (u_on) {
      // state = exp(total) state + (x sc)^T B over this warp's tiles
      const float et = et_s[buf];
      float us[UPW][4];
#pragma unroll
      for (int j = 0; j < UPW; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          st[j][v] *= et;
          us[j][v] = 0.f;
        }
#pragma unroll
      for (int k0 = 0; k0 < CH; k0 += 8) {
        const float s0 = sc[k0 + tq], s1 = sc[k0 + tq + 4];
        Frag<4, false> af;
        af.set(0, to_f(xs[(k0 + tq) * L::LDX + up0 + gq]) * s0);
        af.set(1, to_f(xs[(k0 + tq) * L::LDX + up0 + gq + 8]) * s0);
        af.set(2, to_f(xs[(k0 + tq + 4) * L::LDX + up0 + gq]) * s1);
        af.set(3, to_f(xs[(k0 + tq + 4) * L::LDX + up0 + gq + 8]) * s1);
#pragma unroll
        for (int j = 0; j < UPW; ++j) {
          const int n = un0 + 8 * j + gq;
          Frag<2, EX> bf;
          bf.set(0, to_f(bs[(k0 + tq) * L::LDB + n]));
          bf.set(1, to_f(bs[(k0 + tq + 4) * L::LDB + n]));
          mma3(st[j], us[j], af, bf);
        }
      }
#pragma unroll
      for (int j = 0; j < UPW; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) st[j][v] += us[j][v];
    }
  }
}

template <typename T, int PT, int N, int NW>
cudaError_t launch_typed(const void* x, const void* dt, const void* a, const void* b,
                         const void* c, const void* d, void* g, void* y, float* states,
                         int batch, int seqlen, int heads, int p, int chunk,
                         cudaStream_t stream) {
  const int n_chunks = seqlen / chunk;
  constexpr int gram_bytes = Gram<T, N>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_gram_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, gram_bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_gram_kernel<T, N><<<dim3(n_chunks, batch), GRAM_NT, gram_bytes, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(g), seqlen, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int walk_bytes = Walk<T, PT, N>::BYTES;
  auto walk = states != nullptr ? ssd_scan_walk_kernel<T, PT, N, NW, true>
                                : ssd_scan_walk_kernel<T, PT, N, NW, false>;
  err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, walk_bytes);
  if (err != cudaSuccess) return err;
  walk<<<dim3(p / PT, heads, batch), 32 * NW, walk_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<const float*>(g), static_cast<T*>(y), states, seqlen, heads, p, chunk);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// pass 3: the backward (training)
// ---------------------------------------------------------------------------
//
// The gradient of the function above for an output gradient dy, from the
// state entering each chunk (written by the training forward's walk). Per
// (row, head) the state gradient dS is carried backward over the chunks,
// starting from zero past the last:
//   dS_in = exp(total) dS_out + sum_i exp(cum_i) dy_i C_i^T,
// and each chunk's local gradients are formed from its starting state S and
// the dS_out the chunks after it hand back (kernels/ssd_scan.py,
// ssd_scan_bwd_torch, states the formulas and is the plain version in this
// order). With G = C B^T (the Gram pass above), L masked before the exp,
// D = dy x^T, A1 = L o dt_j o D, M = G o L o dt_j and K = G o L o D:
//   dx_j  = sum_i M_ij dy_i + sc_j (dS_out B_j) + d dy_j
//   dB_j  = sum_i A1_ij C_i + sc_j dS_out^T x_j        (per head)
//   dC_i  = sum_j A1_ij B_j + exp(cum_i) S^T dy_i      (per head)
//   ddt_j = sum_i K_ij + exp(total - cum_j) x_j . (dS_out B_j) + a rc_j
// where rc is the reverse cumsum, in float64, of the gradient of each
// position's cum (the L, exp(cum), exp(total - cum) and exp(total) terms);
// da = sum dt_j rc_j and dd = sum x . dy.
//
// Design (simple and right first): one block of 256 threads per (head,
// row) walks the chunks from the last to the first. A chunk's x, dy, B and
// C, dS_out and the three c x c matrices sit in shared memory as float32
// (~190 KB at P 64, N 128); S is read from device memory where it is used.
// Every product is float32 FMAs on the CUDA cores, each thread owning a
// 4 x 4 or 4 x 8 tile of its output. B and C have no head axis, so their
// gradients are written per head into float32 scratch (B, H, S, N) and a
// last pass sums the heads in order; da and dd are written per (row, head)
// and summed over rows in order: no atomics, so two runs give the same
// bits. What bounds it on an H100: the CUDA cores' float32 rate (~7 MFLOP
// a (row, head, chunk) at P 64, N 128, where the byte bound is the chunk
// states' read); the tensor-core form, as the forward's walk, is for a
// later PR.

constexpr int BWD_NT = 256;   // threads of a backward block

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }

// Shared memory of a backward block in floats after four float64 vectors
// (CH each), mirrored by kernels/ssd_scan.py's bwd_smem_bytes. Rows are
// padded by one float.
template <int P, int N>
struct Bwd {
  static constexpr int LDP = P + 1, LDN = N + 1, LDQ = CH + 1;
  static constexpr int X = 0;                        // x (CH x LDP)
  static constexpr int DY = X + CH * LDP;            // dy
  static constexpr int BM = DY + CH * LDP;           // B (CH x LDN)
  static constexpr int CM = BM + CH * LDN;           // C
  static constexpr int R = CM + CH * LDN;            // dS_out (P x LDN)
  static constexpr int DK = R + P * LDN;             // D, then K (CH x LDQ)
  static constexpr int A1 = DK + CH * LDQ;           // A1
  static constexpr int M = A1 + CH * LDQ;            // M
  static constexpr int XRBP = M + CH * LDQ;          // x_j . (dS_out B_j) partials
  static constexpr int CIP = XRBP + CH * (P / 4);    // C_i . (S^T dy_i) partials
  static constexpr int VEC = CIP + CH * (N / 8);     // five per-position vectors
  static constexpr int RED = VEC + 5 * CH;           // one float a thread
  static constexpr int SCAL = RED + BWD_NT;          // exp(total)
  static constexpr int FLOATS = SCAL + 8;
  static constexpr int BYTES = 4 * FLOATS + 4 * 8 * CH;
  static_assert(P % 4 == 0 && N % 8 == 0, "tile shapes");
};

// Block (head h, row b); see above.
template <typename T, int P, int N>
__global__ void __launch_bounds__(BWD_NT, 1)
ssd_scan_bwd_kernel(const T* __restrict__ x,           // (B, S, H, P)
                    const float* __restrict__ dt,      // (B, S, H)
                    const float* __restrict__ a,       // (H,)
                    const T* __restrict__ bm,          // (B, S, N)
                    const T* __restrict__ cm,          // (B, S, N)
                    const float* __restrict__ dskip,   // (H,)
                    const float* __restrict__ states,  // (B, H, nc, P, N)
                    const T* __restrict__ dy,          // (B, S, H, P)
                    const float* __restrict__ g,       // (B, nc, CH, CH) from pass 1
                    float* __restrict__ db_h,          // (B, H, S, N)
                    float* __restrict__ dc_h,          // (B, H, S, N)
                    float* __restrict__ rows,          // (2, B, H): da, dd per row
                    T* __restrict__ dx,                // (B, S, H, P)
                    float* __restrict__ ddt,           // (B, S, H)
                    int seqlen, int heads, int chunk) {
  using L = Bwd<P, N>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  double* cum = reinterpret_cast<double*>(smem_b);
  double* rowt = cum + CH;     // sum_{j<i} dt_j K_ij
  double* colk = rowt + CH;    // sum_{i>j} K_ij
  double* dcum = colk + CH;    // the gradient of each position's cum
  float* f = reinterpret_cast<float*>(smem_b + 4 * 8 * CH);
  float* xs = f + L::X;
  float* dys = f + L::DY;
  float* bs = f + L::BM;
  float* cs = f + L::CM;
  float* rs = f + L::R;
  float* dk = f + L::DK;
  float* a1 = f + L::A1;
  float* mm = f + L::M;
  float* xrbp = f + L::XRBP;
  float* cip = f + L::CIP;
  float* dts = f + L::VEC;
  float* ec = dts + CH;        // exp(cum)
  float* dec = ec + CH;        // exp(total - cum)
  float* sc = dec + CH;        // dt exp(total - cum)
  float* xrb = sc + CH;        // x_j . (dS_out B_j)
  float* red = f + L::RED;
  float* scal = f + L::SCAL;

  const int tid = threadIdx.x, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const float ah = a[h], dh = dskip[h];
  const int n_chunks = seqlen / chunk;
  const size_t xrow = static_cast<size_t>(heads) * P;
  double da_acc = 0.0;   // thread 0: this row's da
  float dd_acc = 0.f;

  for (int e = tid; e < P * L::LDN; e += BWD_NT) rs[e] = 0.f;   // dS past the last chunk

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const size_t row0 = static_cast<size_t>(b) * seqlen + static_cast<size_t>(ci) * chunk;
    const float* sg = states + ((static_cast<size_t>(b) * heads + h) * n_chunks + ci) * P * N;
    const float* gg = g + (static_cast<size_t>(b) * n_chunks + ci) * CH * CH;
    // the chunk's rows (zero past the chunk), and warp 0's float64 cumsum
    for (int e = tid; e < CH * P; e += BWD_NT) {
      const int i = e / P, p = e % P;
      const bool in = i < chunk;
      const size_t off = (row0 + i) * xrow + static_cast<size_t>(h) * P + p;
      xs[i * L::LDP + p] = in ? to_f(x[off]) : 0.f;
      dys[i * L::LDP + p] = in ? to_f(dy[off]) : 0.f;
    }
    for (int e = tid; e < CH * N; e += BWD_NT) {
      const int i = e / N, n = e % N;
      const bool in = i < chunk;
      const size_t off = (row0 + i) * N + n;
      bs[i * L::LDN + n] = in ? to_f(bm[off]) : 0.f;
      cs[i * L::LDN + n] = in ? to_f(cm[off]) : 0.f;
    }
    if (tid < 32) {
      const int i0 = 2 * lane;
      const float d0 = i0 < chunk ? dt[(row0 + i0) * heads + h] : 0.f;
      const float d1 = i0 + 1 < chunk ? dt[(row0 + i0 + 1) * heads + h] : 0.f;
      const double v0 = static_cast<double>(d0 * ah);
      const double v1 = static_cast<double>(d1 * ah);
      double s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += u;
      }
      const double total = __shfl_sync(kFull, s, 31);
      const double c0 = s - v1;
      cum[i0] = c0;
      cum[i0 + 1] = s;
      dts[i0] = d0;
      dts[i0 + 1] = d1;
      ec[i0] = expf(static_cast<float>(c0));
      ec[i0 + 1] = expf(static_cast<float>(s));
      dec[i0] = expf(static_cast<float>(total - c0));
      dec[i0 + 1] = expf(static_cast<float>(total - s));
      sc[i0] = d0 * dec[i0];
      sc[i0 + 1] = d1 * dec[i0 + 1];
      if (lane == 0) scal[0] = expf(static_cast<float>(total));
    }
    __syncthreads();

    // D = dy x^T, tiles on or below the diagonal
    for (int t = tid; t < (CH / 4) * (CH / 4); t += BWD_NT) {
      const int i0 = (t / (CH / 4)) * 4, j0 = (t % (CH / 4)) * 4;
      if (i0 + 3 < j0) continue;
      float acc[4][4] = {};
      for (int p = 0; p < P; ++p) {
        float u[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = dys[(i0 + r) * L::LDP + p];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = xs[(j0 + c) * L::LDP + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += u[r] * v[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dk[(i0 + r) * L::LDQ + j0 + c] = acc[r][c];
    }
    __syncthreads();

    // A1, M and K (over D), masked before the exp
    for (int e = tid; e < CH * CH; e += BWD_NT) {
      const int i = e / CH, j = e % CH;
      float va = 0.f, vm = 0.f, vk = 0.f;
      if (i >= j && i < chunk) {
        const float l = expf(static_cast<float>(cum[i] - cum[j]));
        const float gij = gg[i * CH + j];
        const float dij = dk[i * L::LDQ + j];
        va = l * dts[j] * dij;
        vm = gij * l * dts[j];
        vk = gij * l * dij;
      }
      a1[i * L::LDQ + j] = va;
      mm[i * L::LDQ + j] = vm;
      dk[i * L::LDQ + j] = vk;
    }
    __syncthreads();

    // K's row sums (weighted by dt_j) and column sums, in float64 and
    // strictly below the diagonal, which cancels from cum's gradient
    // exactly (L_ii = 1): under strong decay the two sums cancel to a
    // float32 rounding error of theirs (~1e-3 of da)
    if (tid < CH) {
      double s = 0.0;
      for (int j = 0; j < tid; ++j)
        s += static_cast<double>(dts[j]) * static_cast<double>(dk[tid * L::LDQ + j]);
      rowt[tid] = s;
    } else if (tid < 2 * CH) {
      const int j = tid - CH;
      double s = 0.0;
      for (int i = j + 1; i < CH; ++i) s += static_cast<double>(dk[i * L::LDQ + j]);
      colk[j] = s;
    }
    // dx_j and x_j . (dS_out B_j), tiles of 4 positions x 4 columns
    for (int t = tid; t < (CH / 4) * (P / 4); t += BWD_NT) {
      const int j0 = (t / (P / 4)) * 4, p0 = (t % (P / 4)) * 4;
      float rb[4][4] = {}, acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float u[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = bs[(j0 + r) * L::LDN + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = rs[(p0 + c) * L::LDN + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) rb[r][c] += u[r] * v[c];
      }
      for (int i = j0; i < CH; ++i) {
        float u[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = mm[i * L::LDQ + j0 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = dys[i * L::LDP + p0 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += u[r] * v[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + r;
        float xr = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + c;
          if (j < chunk)
            store1(dx + (row0 + j) * xrow + static_cast<size_t>(h) * P + p,
                   acc[r][c] + sc[j] * rb[r][c] + dh * dys[j * L::LDP + p]);
          xr += xs[j * L::LDP + p] * rb[r][c];
        }
        xrbp[j * (P / 4) + p0 / 4] = xr;
      }
    }
    // dB_j per head, tiles of 4 positions x 8 state columns
    for (int t = tid; t < (CH / 4) * (N / 8); t += BWD_NT) {
      const int j0 = (t / (N / 8)) * 4, n0 = (t % (N / 8)) * 8;
      float t1[4][8] = {}, t2[4][8] = {};
      for (int i = j0; i < CH; ++i) {
        float u[4], v[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = a1[i * L::LDQ + j0 + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = cs[i * L::LDN + n0 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) t1[r][c] += u[r] * v[c];
      }
      for (int p = 0; p < P; ++p) {
        float u[4], v[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = xs[(j0 + r) * L::LDP + p];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = rs[p * L::LDN + n0 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) t2[r][c] += u[r] * v[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + r;
        if (j >= chunk) continue;
        float* o = db_h + ((static_cast<size_t>(b) * heads + h) * seqlen + ci * chunk + j) * N +
                   n0;
#pragma unroll
        for (int c = 0; c < 8; ++c) o[c] = t1[r][c] + sc[j] * t2[r][c];
      }
    }
    // dC_i per head and C_i . (S^T dy_i), tiles of 4 positions x 8 columns
    for (int t = tid; t < (CH / 4) * (N / 8); t += BWD_NT) {
      const int i0 = (t / (N / 8)) * 4, n0 = (t % (N / 8)) * 8;
      float t1[4][8] = {}, sdy[4][8] = {};
      for (int j = 0; j < i0 + 4; ++j) {
        float u[4], v[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = a1[(i0 + r) * L::LDQ + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = bs[j * L::LDN + n0 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) t1[r][c] += u[r] * v[c];
      }
      for (int p = 0; p < P; ++p) {
        float u[4], v[8];
        const float4 s0 = __ldg(reinterpret_cast<const float4*>(sg + p * N + n0));
        const float4 s1 = __ldg(reinterpret_cast<const float4*>(sg + p * N + n0 + 4));
        v[0] = s0.x, v[1] = s0.y, v[2] = s0.z, v[3] = s0.w;
        v[4] = s1.x, v[5] = s1.y, v[6] = s1.z, v[7] = s1.w;
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = dys[(i0 + r) * L::LDP + p];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) sdy[r][c] += u[r] * v[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        float cd = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) cd += cs[i * L::LDN + n0 + c] * sdy[r][c];
        cip[i * (N / 8) + n0 / 8] = cd;
        if (i >= chunk) continue;
        float* o = dc_h + ((static_cast<size_t>(b) * heads + h) * seqlen + ci * chunk + i) * N +
                   n0;
#pragma unroll
        for (int c = 0; c < 8; ++c) o[c] = t1[r][c] + ec[i] * sdy[r][c];
      }
    }
    // <dS_out, S> and x . dy, one partial a thread
    {
      float rsp = 0.f;
      for (int e = tid; e < P * N; e += BWD_NT) rsp += rs[(e / N) * L::LDN + e % N] * sg[e];
      red[tid] = rsp;
      for (int e = tid; e < CH * P; e += BWD_NT)
        dd_acc += xs[(e / P) * L::LDP + e % P] * dys[(e / P) * L::LDP + e % P];
    }
    __syncthreads();

    // each position's cum gradient but the chunk-end terms
    if (tid < chunk) {
      const int j = tid;
      float xr = 0.f, cd = 0.f;
      for (int q = 0; q < P / 4; ++q) xr += xrbp[j * (P / 4) + q];
      for (int q = 0; q < N / 8; ++q) cd += cip[j * (N / 8) + q];
      xrb[j] = xr;
      dcum[j] = rowt[j] - static_cast<double>(dts[j]) * colk[j] +
                static_cast<double>(ec[j] * cd) - static_cast<double>(sc[j] * xr);
    }
    // dS_in = exp(total) dS_out + sum_i exp(cum_i) dy_i C_i^T, in place
    const float et = scal[0];
    for (int t = tid; t < (P / 4) * (N / 8); t += BWD_NT) {
      const int p0 = (t / (N / 8)) * 4, n0 = (t % (N / 8)) * 8;
      float acc[4][8] = {};
      for (int i = 0; i < CH; ++i) {
        float u[4], v[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = ec[i] * dys[i * L::LDP + p0 + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = cs[i * L::LDN + n0 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] += u[r] * v[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float* o = rs + (p0 + r) * L::LDN + n0 + c;
          *o = et * *o + acc[r][c];
        }
    }
    __syncthreads();

    // thread 0: the chunk-end terms, the float64 reverse cumsum, ddt, da
    if (tid == 0) {
      float rsum = 0.f, usum = 0.f;
      for (int q = 0; q < BWD_NT; ++q) rsum += red[q];
      for (int j = 0; j < chunk; ++j) usum += sc[j] * xrb[j];
      double rc = 0.0;
      for (int k = chunk - 1; k >= 0; --k) {
        double v = dcum[k];
        if (k == chunk - 1) v += static_cast<double>(et * rsum + usum);
        rc += v;
        ddt[(row0 + k) * heads + h] =
            static_cast<float>(colk[k]) + dk[k * L::LDQ + k] + dec[k] * xrb[k] +
            ah * static_cast<float>(rc);
        da_acc += static_cast<double>(dts[k]) * rc;
      }
    }
    __syncthreads();
  }

  red[tid] = dd_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int q = 0; q < BWD_NT; ++q) s += red[q];
    const size_t bh = static_cast<size_t>(b) * heads + h;
    rows[bh] = static_cast<float>(da_acc);
    rows[static_cast<size_t>(gridDim.y) * heads + bh] = s;
  }
}

// dB and dC: the per-head partials summed over heads in order; da and dd
// (block 0): the per-row values summed over rows in order
template <typename T>
__global__ void ssd_scan_bwd_sum_kernel(const float* __restrict__ db_h,
                                        const float* __restrict__ dc_h,
                                        const float* __restrict__ rows, T* __restrict__ db,
                                        T* __restrict__ dc, float* __restrict__ da,
                                        float* __restrict__ dd, int batch, int seqlen,
                                        int heads, int n) {
  const size_t stride = static_cast<size_t>(seqlen) * n;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < static_cast<size_t>(batch) * stride) {
    const size_t b = e / stride, rest = e % stride;
    const float* pb = db_h + b * heads * stride + rest;
    const float* pc = dc_h + b * heads * stride + rest;
    float sb = 0.f, scc = 0.f;
    for (int h = 0; h < heads; ++h) {
      sb += pb[h * stride];
      scc += pc[h * stride];
    }
    store1(db + e, sb);
    store1(dc + e, scc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < heads; h += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int b = 0; b < batch; ++b) {
        sa += rows[static_cast<size_t>(b) * heads + h];
        sd += rows[static_cast<size_t>(batch + b) * heads + h];
      }
      da[h] = sa;
      dd[h] = sd;
    }
  }
}

template <typename T, int P, int N>
cudaError_t launch_bwd(const void* x, const void* dt, const void* a, const void* b,
                       const void* c, const void* d, const void* states, const void* dy,
                       void* g, void* db_h, void* dc_h, void* rows, void* dx, void* ddt,
                       void* da, void* db, void* dc, void* dd, int batch, int seqlen, int heads,
                       int chunk, cudaStream_t stream) {
  const int n_chunks = seqlen / chunk;
  constexpr int gram_bytes = Gram<T, N>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_gram_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, gram_bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_gram_kernel<T, N><<<dim3(n_chunks, batch), GRAM_NT, gram_bytes, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(g), seqlen, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int bwd_bytes = Bwd<P, N>::BYTES;
  auto bwd = ssd_scan_bwd_kernel<T, P, N>;
  err = cudaFuncSetAttribute(bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_bytes);
  if (err != cudaSuccess) return err;
  bwd<<<dim3(heads, batch), BWD_NT, bwd_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<const float*>(states), static_cast<const T*>(dy),
      static_cast<const float*>(g), static_cast<float*>(db_h), static_cast<float*>(dc_h),
      static_cast<float*>(rows), static_cast<T*>(dx), static_cast<float*>(ddt), seqlen, heads,
      chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(batch) * seqlen * N;
  const int blocks = static_cast<int>((total + 255) / 256);
  ssd_scan_bwd_sum_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(db_h), static_cast<const float*>(dc_h),
      static_cast<const float*>(rows), static_cast<T*>(db), static_cast<T*>(dc),
      static_cast<float*>(da), static_cast<float*>(dd), batch, seqlen, heads, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); (p, n, p_tile) in
// {(64, 128, 32), (64, 128, 64) bfloat16 only, (16, 16, 16)}; 1 <= chunk <=
// 64 and seqlen % chunk == 0; x, B and C rows 16-byte aligned; g: (batch,
// seqlen / chunk, 64, 64) float32 scratch for C B^T; states: null, or
// (batch, heads, seqlen / chunk, p, n) float32 for the state entering each
// chunk (the training forward). Two launches (the Gram pass, then the
// walk). Returns the first failing launch's cudaError_t.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a, const void* b,
                        const void* c, const void* d, void* g, void* y, void* states, int dtype,
                        int batch, int seqlen, int heads, int p, int n, int p_tile, int chunk,
                        void* stream) {
  if (chunk < 1 || chunk > CH || seqlen % chunk != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(states);
  cudaError_t err = cudaErrorInvalidValue;
  // a 32-column P tile: 8 warps; the whole P of 64 (bfloat16; the float32
  // ring does not fit beside a 64-row state): 16 warps, the same tiles per warp
  if (p == 64 && n == 128 && p_tile == 32)
    err = dtype == 0 ? launch_typed<float, 32, 128, 8>(x, dt, a, b, c, d, g, y, st, batch,
                                                       seqlen, heads, p, chunk, s)
                     : launch_typed<bf16, 32, 128, 8>(x, dt, a, b, c, d, g, y, st, batch,
                                                      seqlen, heads, p, chunk, s);
  else if (p == 64 && n == 128 && p_tile == 64 && dtype == 1)
    err = launch_typed<bf16, 64, 128, 16>(x, dt, a, b, c, d, g, y, st, batch, seqlen, heads, p,
                                          chunk, s);
  else if (p == 16 && n == 16 && p_tile == 16)
    err = dtype == 0 ? launch_typed<float, 16, 16, 8>(x, dt, a, b, c, d, g, y, st, batch,
                                                      seqlen, heads, p, chunk, s)
                     : launch_typed<bf16, 16, 16, 8>(x, dt, a, b, c, d, g, y, st, batch,
                                                     seqlen, heads, p, chunk, s);
  return static_cast<int>(err);
}

// The backward: dtype 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC);
// (p, n) in {(64, 128), (16, 16)}; 1 <= chunk <= 64, seqlen % chunk == 0;
// states (batch, heads, seqlen / chunk, p, n) float32 from the training
// forward; scratch g (batch, seqlen / chunk, 64, 64), db_h and dc_h
// (batch, heads, seqlen, n) and rows (2, batch, heads), all float32; ddt
// (batch, seqlen, heads), da and dd (heads,) float32. Three launches (the
// Gram pass, the backward walk, the sums). Returns the first failing
// launch's cudaError_t.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, const void* d, const void* states, const void* dy,
                            void* g, void* db_h, void* dc_h, void* rows, void* dx, void* ddt,
                            void* da, void* db, void* dc, void* dd, int dtype, int batch,
                            int seqlen, int heads, int p, int n, int chunk, void* stream) {
  if (chunk < 1 || chunk > CH || seqlen % chunk != 0 || batch < 1 || batch > 65535 ||
      heads < 1 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_BWD(T, P, N)                                                                \
  launch_bwd<T, P, N>(x, dt, a, b, c, d, states, dy, g, db_h, dc_h, rows, dx, ddt, da, db, dc, \
                      dd, batch, seqlen, heads, chunk, s)
  cudaError_t err = cudaErrorInvalidValue;
  if (p == 64 && n == 128 && dtype == 0)
    err = REPRO_SSD_BWD(float, 64, 128);
  else if (p == 64 && n == 128 && dtype == 1)
    err = REPRO_SSD_BWD(bf16, 64, 128);
  else if (p == 16 && n == 16 && dtype == 0)
    err = REPRO_SSD_BWD(float, 16, 16);
  else if (p == 16 && n == 16 && dtype == 1)
    err = REPRO_SSD_BWD(bf16, 16, 16);
#undef REPRO_SSD_BWD
  return static_cast<int>(err);
}
