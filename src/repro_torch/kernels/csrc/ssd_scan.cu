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
// state S entering each chunk (written by the training forward's walk).
// With G = C B^T (the Gram pass above), L masked before the exp, D = dy
// x^T, A1 = L o dt_j o D, M = G o L o dt_j, K = G o L o D, sc_j = dt_j
// exp(total - cum_j) and dS_out the gradient of the state a chunk hands on
// (kernels/ssd_scan.py, ssd_scan_bwd_torch, states the formulas and is the
// plain version in this order):
//   dS_out[last] = 0,  dS_out[c - 1] = exp(total_c) dS_out[c] + U_c,
//   U_c   = sum_i exp(cum_i) dy_i C_i^T                      (P x N)
//   dx_j  = sum_i M_ij dy_i + sc_j rb_j + d dy_j,   rb_j = dS_out B_j
//   dB_j  = sum_h [sum_i A1_ij C_i + sc_j dS_out^T x_j]
//   dC_i  = sum_h [sum_j A1_ij B_j + exp(cum_i) S^T dy_i]
//   ddt_j = sum_i K_ij + exp(total - cum_j) x_j . rb_j + a rc_j
// where rc is the reverse cumsum, in float64, of the gradient of each
// position's cum (the L, exp(cum), exp(total - cum) and exp(total) terms);
// da = sum dt_j rc_j and dd = sum x . dy.
//
// Design. The only serial dependency is dS_out itself, a float32 scaled add
// over the chunks; every other product reads one chunk's dS_out and S and
// nothing carried. So the backward is four launches:
// 1. the Gram pass above, G once per (row, chunk);
// 2. the dS walk (ssd_scan_bwd_state_kernel): one block of 8 warps per
//    (head, row) walks the chunks from the last to the first with dS in
//    the accumulator registers of U's product (mma.sync m16n8k8 TF32,
//    exp(cum) dy split hi/lo, C exact in bfloat16), the forward's state
//    passing mirrored: one product a chunk, dy and C tiles in a 2-stage
//    cp.async ring, warp 0 forming the next chunk's float64 cumsum. It
//    writes each chunk's dS_out to float32 scratch (B, H, nc, P, N);
// 3. the chunk pass (ssd_scan_bwd_chunk_kernel): one block per (chunk,
//    row, head group) of 16 warps (8 at the smoke width), ~8,000 (row,
//    head, chunk) units at the training shape. G, B and C are staged once
//    per block; per head x, dy, S and dS_out arrive by cp.async (S for the
//    next head while this one's dS products run; x, dy and dS_out while its
//    scalar tail runs). Every product is on the tensor cores in 3xTF32 as
//    the forward's walk (an operand exact in TF32, a bfloat16 input, is not
//    split): D, then dy S (dC's term), then rb, sum_i M_ij dy_i and x
//    dS_out (dB's term). Each warp owns 16 rows of every output, so A1's
//    tiles stay in registers and are summed over the group's heads there:
//    the A1 terms of dB and dC cost two products per group, not per head.
//    dB and dC accumulate over the group's heads in registers in head
//    order and are written once per group; a last pass sums the groups in
//    order. The masked upper k-steps of M and A1 are skipped;
// 4. the sum pass: dB, dC over the head groups in order, da and dd over
//    (row, chunk) in order: no atomics, so two calls give the same bits.
// The cumsum, K's strictly-below-diagonal row and column sums and the
// reverse cumsum of cum's gradient stay in float64. Shared memory of a
// chunk block is ~177 KB (bfloat16; float32 ~225 KB), one block an SM; a
// dS-walk block ~54 KB (bfloat16).
//
// What bounds it on an H100: ~60 GFLOP of products at the training shape
// (4, 2048, 64, 64, 128), two TF32 products each in bfloat16 (0.24 ms at
// the TF32 peak), against 482 MB the function must move (0.144 ms); the
// dS_out scratch adds 268 MB written and read again. The chunk pass takes
// most of the time and is latency-bound at one block of 16 warps an SM
// (128 registers): its loads and barriers wait little, every product
// phase issues well below the SM's rate. Double buffers for the next
// head's tiles and bfloat16 pair loads spilled registers and ran slower.

constexpr int BWD_STATE_NW = 8;   // warps of a dS-walk block

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }

template <int J>
__device__ __forceinline__ void zero(float (&t)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
}

// big, small += A (rows m0 .. m0 + 15) . B (J 8-column tiles from n0) over
// k in [kb, ke) (multiples of 8), in 3xTF32 as mma3; fa(row, k) and
// fb(k, col) read the operands. PERM pairs a thread's two k slots as (2t,
// 2t + 1) rather than (t, t + 4), in A and B alike, which keeps a
// (k row, column) read of 4 rows at a row stride of 4 banks on distinct
// banks.
template <int J, bool PERM, bool AX, bool BX, typename FA, typename FB>
__device__ __forceinline__ void tile_mma(float (&big)[J][4], float (&small)[J][4], int m0, int n0,
                                         int kb, int ke, FA fa, FB fb) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int ka = PERM ? 2 * tq : tq, kc = PERM ? 2 * tq + 1 : tq + 4;
#pragma unroll 2
  for (int k0 = kb; k0 < ke; k0 += 8) {
    Frag<4, AX> af;
    af.set(0, fa(m0 + gq, k0 + ka));
    af.set(1, fa(m0 + gq + 8, k0 + ka));
    af.set(2, fa(m0 + gq, k0 + kc));
    af.set(3, fa(m0 + gq + 8, k0 + kc));
#pragma unroll
    for (int j = 0; j < J; ++j) {
      Frag<2, BX> bf;
      bf.set(0, fb(k0 + ka, n0 + 8 * j + gq));
      bf.set(1, fb(k0 + kc, n0 + 8 * j + gq));
      mma3(big[j], small[j], af, bf);
    }
  }
}

// Warp 0: the chunk's float64 inclusive prefix sum of dt * a (two
// positions per lane; dt = 0 past the chunk), dt, exp(cum), exp(total -
// cum), dt exp(total - cum) and exp(total)
__device__ __forceinline__ void bwd_chunk_scan(float d0, float d1, float ah, double* cum,
                                               float* dts, float* ec, float* dec, float* sc,
                                               float* et) {
  const int lane = threadIdx.x % 32;
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
  const int i0 = 2 * lane;
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
  if (lane == 0) *et = expf(static_cast<float>(total));
}

// Shared memory of a dS-walk block (bytes): the per-chunk vectors (two
// buffers), then STAGES ring stages of the chunk's dy and C tiles, rows padded as the forward's x
// and B (a (k row, column) read of 4 rows x 8 columns on distinct banks).
template <typename T, int P, int N>
struct BwdState {
  static constexpr int SZ = static_cast<int>(sizeof(T));
  static constexpr int LDY = P + 8;   // T
  static constexpr int LDC = N + 8;   // T
  static constexpr int Y_BYTES = CH * LDY * SZ;
  static constexpr int C_BYTES = CH * LDC * SZ;
  static constexpr int STAGE_BYTES = Y_BYTES + C_BYTES;
  // cum (float64), dt, exp(cum), exp(total - cum), dt exp(total - cum),
  // exp(total): two buffers
  static constexpr int VEC_BYTES = 2 * CH * 8 + 4 * 2 * CH * 4 + 16;
  static constexpr int BYTES = VEC_BYTES + STAGES * STAGE_BYTES;
  static_assert(Y_BYTES % 16 == 0 && C_BYTES % 16 == 0 && VEC_BYTES % 16 == 0, "aligned");
};

// Block (head h, row b): dS from zero past the last chunk, each chunk's
// dS_out written to dso[b, h, c], then dS = exp(total) dS + U_c.
template <typename T, int P, int N>
__global__ void __launch_bounds__(32 * BWD_STATE_NW, 2)
ssd_scan_bwd_state_kernel(const T* __restrict__ dy,      // (B, S, H, P)
                          const float* __restrict__ dt,  // (B, S, H)
                          const float* __restrict__ a,   // (H,)
                          const T* __restrict__ cm,      // (B, S, N)
                          float* __restrict__ dso,       // (B, H, nc, P, N)
                          int seqlen, int heads, int chunk) {
  using L = BwdState<T, P, N>;
  constexpr int NW = BWD_STATE_NW, NT = 32 * NW;
  constexpr bool EX = Exact<T>::value;
  constexpr int V = 16 / L::SZ;
  // dS tiles (16 x 8); a warp takes consecutive tiles of one row block
  constexpr int UT = (P / 16) * (N / 8), UPW = (UT + NW - 1) / NW;
  static_assert(P % 16 == 0 && (N / 8) % UPW == 0, "a warp's tiles share rows");

  extern __shared__ __align__(16) unsigned char smem_s[];
  double* cum_s = reinterpret_cast<double*>(smem_s);   // [2][CH]
  float* dt_s = reinterpret_cast<float*>(cum_s + 2 * CH);
  float* ec_s = dt_s + 2 * CH;
  float* dec_s = ec_s + 2 * CH;
  float* sc_s = dec_s + 2 * CH;
  float* et_s = sc_s + 2 * CH;                          // [2] (+ 2 padding)
  unsigned char* ring = smem_s + L::VEC_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const float ah = a[h];
  const size_t xrow = static_cast<size_t>(heads) * P;
  const int n_chunks = seqlen / chunk;
  const size_t brow = static_cast<size_t>(b) * seqlen;
  const int kend = min(CH, (chunk + 7) / 8 * 8);
  const int ut0 = warp * UPW;
  const bool u_on = ut0 < UT;
  const int up0 = 16 * (ut0 / (N / 8)), un0 = 8 * (ut0 % (N / 8));

  // issue chunk ci's dy and C tiles into its stage (one commit group)
  auto load_chunk = [&](int ci) {
    unsigned char* st = ring + (ci & 1) * L::STAGE_BYTES;
    T* ys = reinterpret_cast<T*>(st);
    T* cs = reinterpret_cast<T*>(st + L::Y_BYTES);
    const size_t row0 = brow + static_cast<size_t>(ci) * chunk;
    const T* ysrc = dy + row0 * xrow + static_cast<size_t>(h) * P;
    for (int e = tid; e < CH * (P / V); e += NT) {
      const int r = e / (P / V), q = (e % (P / V)) * V;
      const bool in = r < chunk;
      cp_async16(reinterpret_cast<float*>(ys + r * L::LDY + q), in ? ysrc + r * xrow + q : ysrc,
                 in);
    }
    for (int e = tid; e < CH * (N / V); e += NT) {
      const int r = e / (N / V), q = (e % (N / V)) * V;
      const bool in = r < chunk;
      cp_async16(reinterpret_cast<float*>(cs + r * L::LDC + q), cm + (in ? (row0 + r) * N + q : 0),
                 in);
    }
    repro_tf32x3::cp_async_commit();
  };
  auto load_dt = [&](int ci, float& d0, float& d1) {
    const size_t row0 = brow + static_cast<size_t>(ci) * chunk;
    const int i0 = 2 * lane;
    d0 = i0 < chunk ? __ldg(dt + (row0 + i0) * heads + h) : 0.f;
    d1 = i0 + 1 < chunk ? __ldg(dt + (row0 + i0 + 1) * heads + h) : 0.f;
  };
  auto scan = [&](int ci, float d0, float d1) {
    const int o = (ci & 1) * CH;
    bwd_chunk_scan(d0, d1, ah, cum_s + o, dt_s + o, ec_s + o, dec_s + o, sc_s + o,
                   et_s + (ci & 1));
  };

  float ds[UPW][4];   // this warp's dS tiles
  zero(ds);
  const int last = n_chunks - 1;
  load_chunk(last);
  float dn0 = 0.f, dn1 = 0.f;   // warp 0: dt of the chunk before the next one
  if (warp == 0) {
    load_dt(last, dn0, dn1);
    scan(last, dn0, dn1);
    if (last > 0) load_dt(last - 1, dn0, dn1);
  }

  for (int ci = last; ci >= 0; --ci) {
    const unsigned char* stage = ring + (ci & 1) * L::STAGE_BYTES;
    const T* ys = reinterpret_cast<const T*>(stage);
    const T* cs = reinterpret_cast<const T*>(stage + L::Y_BYTES);
    repro_tf32x3::cp_async_wait<0>();
    __syncthreads();   // chunk ci has landed; chunk ci + 1 is done everywhere
    if (ci > 0) {
      load_chunk(ci - 1);
      if (warp == 0) {
        scan(ci - 1, dn0, dn1);
        if (ci > 1) load_dt(ci - 2, dn0, dn1);
      }
    }
    if (!u_on) continue;
    float* out = dso + ((static_cast<size_t>(b) * heads + h) * n_chunks + ci) * P * N +
                 static_cast<size_t>(up0 + gq) * N + un0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(ds[j][0], ds[j][1]);
      *reinterpret_cast<float2*>(out + 8 * j + 8 * N) = make_float2(ds[j][2], ds[j][3]);
    }
    if (ci == 0) break;   // the gradient of the zero initial state is not needed
    const float* ec = ec_s + (ci & 1) * CH;
    const float et = et_s[ci & 1];
    float us[UPW][4];
    zero(us);
#pragma unroll
    for (int j = 0; j < UPW; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) ds[j][v] *= et;
    tile_mma<UPW, false, false, EX>(
        ds, us, up0, un0, 0, kend,
        [&](int r, int k) { return to_f(ys[k * L::LDY + r]) * ec[k]; },
        [&](int k, int n) { return to_f(cs[k * L::LDC + n]); });
#pragma unroll
    for (int j = 0; j < UPW; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) ds[j][v] += us[j][v];
  }
}

// Shared memory of a chunk block (bytes), mirrored by kernels/ssd_scan.py's
// bwd_smem_bytes: three float64 vectors (cum, K's row and column sums),
// the float vectors and partials, G, M (A1 summed over the group at
// the end) and K (c x c float32), B and C (c x N), x and dy (c x P) in T,
// S and dS_out (P x N float32). Row paddings keep each product's fragment
// reads on distinct banks: x, dy, B, C read (8 rows x 4 columns) at a
// stride of 4 banks, M (4 rows x 8 columns) at 8, S and dS_out both ways at
// 4 (their (k row, column) reads pair k slots as (2t, 2t + 1)).
template <typename T, int P, int N, int NW>
struct BwdChunk {
  static constexpr int SZ = static_cast<int>(sizeof(T));
  static constexpr int CG = NW / 4;            // column groups of warps
  static constexpr int LDG = CH + 8;           // floats: G, M, K
  static constexpr int LDX = P + 16 / SZ;      // T: x, dy
  static constexpr int LDBC = N + 16 / SZ;     // T: B, C
  static constexpr int LDS = N + 4;            // floats: S, dS_out
  static constexpr int G_BYTES = CH * LDG * 4;
  static constexpr int X_BYTES = CH * LDX * SZ;
  static constexpr int BC_BYTES = CH * LDBC * SZ;
  static constexpr int S_BYTES = P * LDS * 4;
  static constexpr int DVEC_BYTES = 3 * CH * 8;
  // dt, exp(cum), exp(total - cum), dt exp(total - cum); the x . rb and
  // C . (S^T dy) row partials per column group; two per-warp partials;
  // exp(total)
  static constexpr int FVEC_BYTES = ((4 * CH + 2 * CH * CG + 2 * NW + 4) * 4 + 15) / 16 * 16;
  static constexpr int BYTES =
      DVEC_BYTES + FVEC_BYTES + 3 * G_BYTES + 2 * BC_BYTES + 2 * X_BYTES + 2 * S_BYTES;
  static_assert(X_BYTES % 16 == 0 && BC_BYTES % 16 == 0 && S_BYTES % 16 == 0, "aligned");
};

// Block (chunk ci, row b, head group): see above. Warp w owns rows 16 (w %
// 4) .. + 15 of every output and the (w / 4)-th column group.
template <typename T, int P, int N, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
ssd_scan_bwd_chunk_kernel(const T* __restrict__ x,           // (B, S, H, P)
                          const float* __restrict__ dt,      // (B, S, H)
                          const float* __restrict__ a,       // (H,)
                          const T* __restrict__ bm,          // (B, S, N)
                          const T* __restrict__ cm,          // (B, S, N)
                          const float* __restrict__ dskip,   // (H,)
                          const float* __restrict__ states,  // (B, H, nc, P, N)
                          const T* __restrict__ dy,          // (B, S, H, P)
                          const float* __restrict__ g,       // (B, nc, CH, CH) from pass 1
                          const float* __restrict__ dso,     // (B, H, nc, P, N) from the walk
                          float* __restrict__ dbp,           // (B, groups, S, N)
                          float* __restrict__ dcp,           // (B, groups, S, N)
                          double* __restrict__ dap,          // (B, nc, H)
                          float* __restrict__ ddp,           // (B, nc, H)
                          T* __restrict__ dx,                // (B, S, H, P)
                          float* __restrict__ ddt,           // (B, S, H)
                          int seqlen, int heads, int chunk, int hpb) {
  using L = BwdChunk<T, P, N, NW>;
  constexpr int NT = 32 * NW, CG = L::CG;
  constexpr int JC = CH / 8 / CG, JP = P / 8 / CG, JN = N / 8 / CG;
  static_assert(NW % 4 == 0 && (P / 8) % CG == 0 && (N / 8) % CG == 0 && JP >= 1, "tiles");
  constexpr bool EX = Exact<T>::value;
  constexpr int V = 16 / L::SZ;

  extern __shared__ __align__(16) unsigned char smem_c[];
  double* cum = reinterpret_cast<double*>(smem_c);
  double* rowt = cum + CH;    // sum_{j<i} dt_j K_ij
  double* colk = rowt + CH;   // sum_{i>j} K_ij
  float* dts = reinterpret_cast<float*>(smem_c + L::DVEC_BYTES);
  float* ec = dts + CH;       // exp(cum)
  float* dec = ec + CH;       // exp(total - cum)
  float* sc = dec + CH;       // dt exp(total - cum)
  float* xrbp = sc + CH;      // [CH][CG]: x_j . rb_j partials
  float* cidp = xrbp + CH * CG;   // [CH][CG]: C_i . (S^T dy_i) partials
  float* red = cidp + CH * CG;    // [2][NW]: <dS_out, S> and x . dy
  float* et = red + 2 * NW;       // exp(total)
  float* gs = reinterpret_cast<float*>(smem_c + L::DVEC_BYTES + L::FVEC_BYTES);
  float* ms = gs + CH * L::LDG;   // M; at the end A1 summed over the group
  float* ks = ms + CH * L::LDG;   // K
  T* bs = reinterpret_cast<T*>(ks + CH * L::LDG);
  T* cs = bs + CH * L::LDBC;
  T* xs = cs + CH * L::LDBC;
  T* dys = xs + CH * L::LDX;
  float* ss = reinterpret_cast<float*>(dys + CH * L::LDX);
  float* dss = ss + P * L::LDS;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ci = blockIdx.x, b = blockIdx.y, grp = blockIdx.z;
  const int h0 = grp * hpb, h1 = min(heads, h0 + hpb);
  const int n_chunks = seqlen / chunk;
  const size_t row0 = static_cast<size_t>(b) * seqlen + static_cast<size_t>(ci) * chunk;
  const size_t xrow = static_cast<size_t>(heads) * P;
  const int kend = min(CH, (chunk + 7) / 8 * 8);
  const int m0 = 16 * (warp % 4), cgw = warp / 4;
  const int c0 = cgw * 8 * JC, p0 = cgw * 8 * JP, n0 = cgw * 8 * JN;

  // G, B and C of this (row, chunk), shared by every head of the group
  {
    const float* gsrc = g + (static_cast<size_t>(b) * n_chunks + ci) * CH * CH;
    for (int e = tid; e < CH * CH / 4; e += NT)
      cp_async16(gs + (e / (CH / 4)) * L::LDG + (e % (CH / 4)) * 4, gsrc + e * 4, true);
    for (int e = tid; e < CH * (N / V); e += NT) {
      const int r = e / (N / V), q = (e % (N / V)) * V;
      const bool in = r < chunk;
      const size_t off = in ? (row0 + r) * N + q : 0;
      cp_async16(reinterpret_cast<float*>(bs + r * L::LDBC + q), bm + off, in);
      cp_async16(reinterpret_cast<float*>(cs + r * L::LDBC + q), cm + off, in);
    }
  }
  auto load_xdy = [&](int h) {
    const size_t hoff = row0 * xrow + static_cast<size_t>(h) * P;
    for (int e = tid; e < CH * (P / V); e += NT) {
      const int r = e / (P / V), q = (e % (P / V)) * V;
      const bool in = r < chunk;
      const size_t off = in ? hoff + r * xrow + q : 0;
      cp_async16(reinterpret_cast<float*>(xs + r * L::LDX + q), x + off, in);
      cp_async16(reinterpret_cast<float*>(dys + r * L::LDX + q), dy + off, in);
    }
  };
  auto load_pn = [&](float* dst, const float* src, int h) {   // S or dS_out of head h
    const float* s0 = src + ((static_cast<size_t>(b) * heads + h) * n_chunks + ci) * P * N;
    for (int e = tid; e < P * N / 4; e += NT)
      cp_async16(dst + (e / (N / 4)) * L::LDS + (e % (N / 4)) * 4, s0 + e * 4, true);
  };
  load_xdy(h0);
  load_pn(ss, states, h0);
  load_pn(dss, dso, h0);
  repro_tf32x3::cp_async_commit();

  float db[JN][4], dc[JN][4];   // dB and dC of this warp's tiles, over the group's heads
  float a1s[JC][4];             // A1 of this warp's D tiles, summed over the group's heads
  zero(db);
  zero(dc);
  zero(a1s);

  for (int h = h0; h < h1; ++h) {
    const float ah = a[h], dk = dskip[h];
    if (warp == 0) {
      const int i0 = 2 * lane;
      const float d0 = i0 < chunk ? __ldg(dt + (row0 + i0) * heads + h) : 0.f;
      const float d1 = i0 + 1 < chunk ? __ldg(dt + (row0 + i0 + 1) * heads + h) : 0.f;
      bwd_chunk_scan(d0, d1, ah, cum, dts, ec, dec, sc, et);
    }
    repro_tf32x3::cp_async_wait<0>();
    __syncthreads();   // head h's x, dy, S and dS_out have landed; its vectors are formed

    // 1. D = dy x^T over this warp's tiles; A1, M and K over it, masked
    //    before the exp (M and K to shared memory, A1 summed in registers)
    {
      float d_big[JC][4], d_small[JC][4];
      zero(d_big);
      zero(d_small);
      tile_mma<JC, false, EX, EX>(
          d_big, d_small, m0, c0, 0, P, [&](int r, int k) { return to_f(dys[r * L::LDX + k]); },
          [&](int k, int n) { return to_f(xs[n * L::LDX + k]); });
#pragma unroll
      for (int jj = 0; jj < JC; ++jj)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = m0 + gq + 8 * (v / 2), j = c0 + 8 * jj + 2 * tq + v % 2;
          const float dij = d_big[jj][v] + d_small[jj][v];
          float va = 0.f, vm = 0.f, vk = 0.f;
          if (i >= j && i < chunk) {
            const float l = expf(static_cast<float>(cum[i] - cum[j]));
            const float gij = gs[i * L::LDG + j];
            va = l * dts[j] * dij;
            vm = gij * l * dts[j];
            vk = gij * l * dij;
          }
          ms[i * L::LDG + j] = vm;
          ks[i * L::LDG + j] = vk;
          a1s[jj][v] += va;
        }
    }
    __syncthreads();

    // 2. K's row sums (weighted by dt_j) and column sums, in float64 and
    //    strictly below the diagonal, which cancels from cum's gradient
    //    exactly (L_ii = 1); dy S: dC += exp(cum_i) (S^T dy_i) and the
    //    partials of C_i . (S^T dy_i); <dS_out, S> and x . dy
    // (each row and column in 8 interleaved segments, one a thread, summed
    // over the 8 neighbouring lanes in a fixed order)
    for (int t = tid; t < 8 * CH; t += NT) {
      const int r = t / 8, seg = t % 8;
      double rs = 0.0, cs = 0.0;
#pragma unroll
      for (int q = seg; q < CH; q += 8) {
        if (q < r) rs += static_cast<double>(dts[q]) * static_cast<double>(ks[r * L::LDG + q]);
        if (q > r) cs += static_cast<double>(ks[q * L::LDG + r]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        rs += __shfl_xor_sync(kFull, rs, o);
        cs += __shfl_xor_sync(kFull, cs, o);
      }
      if (seg == 0) {
        rowt[r] = rs;
        colk[r] = cs;
      }
    }
    {
      float t_big[JN][4], t_small[JN][4];
      zero(t_big);
      zero(t_small);
      tile_mma<JN, true, EX, false>(
          t_big, t_small, m0, n0, 0, P, [&](int r, int k) { return to_f(dys[r * L::LDX + k]); },
          [&](int k, int n) { return ss[k * L::LDS + n]; });
      float cd[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < JN; ++jj)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = m0 + gq + 8 * (v / 2), n = n0 + 8 * jj + 2 * tq + v % 2;
          const float t = t_big[jj][v] + t_small[jj][v];
          dc[jj][v] += ec[i] * t;
          cd[v / 2] += to_f(cs[i * L::LDBC + n]) * t;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        cd[hh] += __shfl_xor_sync(kFull, cd[hh], 1);
        cd[hh] += __shfl_xor_sync(kFull, cd[hh], 2);
      }
      if (tq == 0) {
        cidp[(m0 + gq) * CG + cgw] = cd[0];
        cidp[(m0 + gq + 8) * CG + cgw] = cd[1];
      }
    }
    {
      float rs = 0.f, xd = 0.f;
      for (int e = tid; e < P * N; e += NT) {
        const int o = (e / N) * L::LDS + e % N;
        rs += dss[o] * ss[o];
      }
      for (int e = tid; e < CH * P; e += NT) {
        const int o = (e / P) * L::LDX + e % P;
        xd += to_f(xs[o]) * to_f(dys[o]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        rs += __shfl_xor_sync(kFull, rs, o);
        xd += __shfl_xor_sync(kFull, xd, o);
      }
      if (lane == 0) {
        red[warp] = rs;
        red[NW + warp] = xd;
      }
    }
    __syncthreads();
    if (h + 1 < h1) {   // S is free: the next head's
      load_pn(ss, states, h + 1);
      repro_tf32x3::cp_async_commit();
    }

    // 3. rb = B dS_out^T and sum_i M_ij dy_i: dx and the partials of
    //    x_j . rb_j; then x dS_out: dB += sc_j (dS_out^T x_j)
    {
      float r_big[JP][4], r_small[JP][4], m_big[JP][4], m_small[JP][4];
      zero(r_big);
      zero(r_small);
      zero(m_big);
      zero(m_small);
      tile_mma<JP, false, EX, false>(
          r_big, r_small, m0, p0, 0, N, [&](int r, int k) { return to_f(bs[r * L::LDBC + k]); },
          [&](int k, int n) { return dss[n * L::LDS + k]; });
      // M's columns j >= m0 are zero above row m0: k-steps from m0
      tile_mma<JP, false, false, EX>(
          m_big, m_small, m0, p0, m0, kend, [&](int r, int k) { return ms[k * L::LDG + r]; },
          [&](int k, int n) { return to_f(dys[k * L::LDX + n]); });
      float xr[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = m0 + gq + 8 * hh;
#pragma unroll
        for (int jj = 0; jj < JP; ++jj) {
          const int p = p0 + 8 * jj + 2 * tq;
          const float rb0 = r_big[jj][2 * hh] + r_small[jj][2 * hh];
          const float rb1 = r_big[jj][2 * hh + 1] + r_small[jj][2 * hh + 1];
          const float v0 = (m_big[jj][2 * hh] + m_small[jj][2 * hh]) + sc[j] * rb0 +
                           dk * to_f(dys[j * L::LDX + p]);
          const float v1 = (m_big[jj][2 * hh + 1] + m_small[jj][2 * hh + 1]) + sc[j] * rb1 +
                           dk * to_f(dys[j * L::LDX + p + 1]);
          if (j < chunk) store2(dx + (row0 + j) * xrow + static_cast<size_t>(h) * P + p, v0, v1);
          xr[hh] += to_f(xs[j * L::LDX + p]) * rb0 + to_f(xs[j * L::LDX + p + 1]) * rb1;
        }
        xr[hh] += __shfl_xor_sync(kFull, xr[hh], 1);
        xr[hh] += __shfl_xor_sync(kFull, xr[hh], 2);
      }
      if (tq == 0) {
        xrbp[(m0 + gq) * CG + cgw] = xr[0];
        xrbp[(m0 + gq + 8) * CG + cgw] = xr[1];
      }
    }
    {
      float t_big[JN][4], t_small[JN][4];
      zero(t_big);
      zero(t_small);
      tile_mma<JN, true, EX, false>(
          t_big, t_small, m0, n0, 0, P, [&](int r, int k) { return to_f(xs[r * L::LDX + k]); },
          [&](int k, int n) { return dss[k * L::LDS + n]; });
#pragma unroll
      for (int jj = 0; jj < JN; ++jj)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          db[jj][v] += sc[m0 + gq + 8 * (v / 2)] * (t_big[jj][v] + t_small[jj][v]);
    }
    __syncthreads();
    if (h + 1 < h1) {   // x, dy and dS_out are free: the next head's
      load_xdy(h + 1);
      load_pn(dss, dso, h + 1);
      repro_tf32x3::cp_async_commit();
    }

    // 4. warp 0: cum's gradient (two positions a lane), the chunk-end terms,
    //    its float64 reverse cumsum rc, ddt, and this head's da and dd
    if (warp == 0) {
      double dcv[2];
      float xrv[2];
      float u = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = 2 * lane + q;
        float xr = 0.f, cd = 0.f;
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          xr += xrbp[j * CG + c];
          cd += cidp[j * CG + c];
        }
        xrv[q] = xr;
        dcv[q] = 0.0;
        if (j < chunk) {
          dcv[q] = rowt[j] - static_cast<double>(dts[j]) * colk[j] +
                   static_cast<double>(ec[j] * cd) - static_cast<double>(sc[j] * xr);
          u += sc[j] * xr;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) u += __shfl_xor_sync(kFull, u, o);
      float rsum = 0.f, xdsum = 0.f;
      for (int w = 0; w < NW; ++w) {
        rsum += red[w];
        xdsum += red[NW + w];
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (2 * lane + q == chunk - 1) dcv[q] += static_cast<double>(et[0] * rsum + u);
      // suffix sums over the lanes' pairs, then within the pair
      double s = dcv[0] + dcv[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_down_sync(kFull, s, o);
        if (lane + o < 32) s += v;
      }
      double next = __shfl_down_sync(kFull, s, 1);
      if (lane == 31) next = 0.0;
      const double rc1 = dcv[1] + next;
      const double rc[2] = {dcv[0] + rc1, rc1};
      double da_acc = 0.0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = 2 * lane + q;
        if (j >= chunk) continue;
        ddt[(row0 + j) * heads + h] = static_cast<float>(colk[j]) + ks[j * L::LDG + j] +
                                      dec[j] * xrv[q] + ah * static_cast<float>(rc[q]);
        da_acc += static_cast<double>(dts[j]) * rc[q];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) da_acc += __shfl_xor_sync(kFull, da_acc, o);
      if (lane == 0) {
        const size_t r = (static_cast<size_t>(b) * n_chunks + ci) * heads + h;
        dap[r] = da_acc;
        ddp[r] = xdsum;
      }
    }
    __syncthreads();   // the next head rewrites the vectors and partials
  }

  // A1 summed over the group's heads: dB += (sum A1)^T C, dC += (sum A1) B
#pragma unroll
  for (int jj = 0; jj < JC; ++jj)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      ms[(m0 + gq + 8 * (v / 2)) * L::LDG + c0 + 8 * jj + 2 * tq + v % 2] = a1s[jj][v];
  __syncthreads();
  {
    float sm[JN][4];
    zero(sm);
    // (sum A1)_ij is zero for i < j: k-steps from m0
    tile_mma<JN, false, false, EX>(
        db, sm, m0, n0, m0, kend, [&](int r, int k) { return ms[k * L::LDG + r]; },
        [&](int k, int n) { return to_f(cs[k * L::LDBC + n]); });
#pragma unroll
    for (int jj = 0; jj < JN; ++jj)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        db[jj][v] += sm[jj][v];
        sm[jj][v] = 0.f;
      }
    // and for j > i: k-steps below m0 + 16
    tile_mma<JN, false, false, EX>(
        dc, sm, m0, n0, 0, min(kend, m0 + 16), [&](int r, int k) { return ms[r * L::LDG + k]; },
        [&](int k, int n) { return to_f(bs[k * L::LDBC + n]); });
#pragma unroll
    for (int jj = 0; jj < JN; ++jj)
#pragma unroll
      for (int v = 0; v < 4; ++v) dc[jj][v] += sm[jj][v];
  }
  // this group's dB and dC rows
  const size_t gbase = (static_cast<size_t>(b) * gridDim.z + grp) * seqlen +
                       static_cast<size_t>(ci) * chunk;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = m0 + gq + 8 * hh;
    if (j >= chunk) continue;
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) {
      const size_t o = (gbase + j) * N + n0 + 8 * jj + 2 * tq;
      *reinterpret_cast<float2*>(dbp + o) = make_float2(db[jj][2 * hh], db[jj][2 * hh + 1]);
      *reinterpret_cast<float2*>(dcp + o) = make_float2(dc[jj][2 * hh], dc[jj][2 * hh + 1]);
    }
  }
}

// dB and dC: the head groups' partials summed in order; da and dd (block
// 0): the (row, chunk) partials summed in order
template <typename T>
__global__ void ssd_scan_bwd_sum_kernel(const float* __restrict__ dbp,
                                        const float* __restrict__ dcp,
                                        const double* __restrict__ dap,
                                        const float* __restrict__ ddp, T* __restrict__ db,
                                        T* __restrict__ dc, float* __restrict__ da,
                                        float* __restrict__ dd, int batch, int seqlen, int heads,
                                        int n, int groups, int n_chunks) {
  const size_t stride = static_cast<size_t>(seqlen) * n;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < static_cast<size_t>(batch) * stride) {
    const size_t b = e / stride, rest = e % stride;
    const float* pb = dbp + b * groups * stride + rest;
    const float* pc = dcp + b * groups * stride + rest;
    float sb = 0.f, scc = 0.f;
    for (int q = 0; q < groups; ++q) {
      sb += pb[q * stride];
      scc += pc[q * stride];
    }
    store1(db + e, sb);
    store1(dc + e, scc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < heads; h += blockDim.x) {
      double sa = 0.0;
      float sd = 0.f;
      for (int r = 0; r < batch * n_chunks; ++r) {
        sa += dap[static_cast<size_t>(r) * heads + h];
        sd += ddp[static_cast<size_t>(r) * heads + h];
      }
      da[h] = static_cast<float>(sa);
      dd[h] = sd;
    }
  }
}

template <typename T, int P, int N, int NW>
cudaError_t launch_bwd(const void* x, const void* dt, const void* a, const void* b,
                       const void* c, const void* d, const void* states, const void* dy,
                       void* g, void* dso, void* dbp, void* dcp, void* dap, void* ddp, void* dx,
                       void* ddt, void* da, void* db, void* dc, void* dd, int batch, int seqlen,
                       int heads, int chunk, int hpb, cudaStream_t stream) {
  const int n_chunks = seqlen / chunk;
  const int groups = (heads + hpb - 1) / hpb;
  constexpr int gram_bytes = Gram<T, N>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_gram_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, gram_bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_gram_kernel<T, N><<<dim3(n_chunks, batch), GRAM_NT, gram_bytes, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(g), seqlen, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int state_bytes = BwdState<T, P, N>::BYTES;
  auto walk = ssd_scan_bwd_state_kernel<T, P, N>;
  err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
  if (err != cudaSuccess) return err;
  walk<<<dim3(heads, batch), 32 * BWD_STATE_NW, state_bytes, stream>>>(
      static_cast<const T*>(dy), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(c), static_cast<float*>(dso), seqlen, heads, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int chunk_bytes = BwdChunk<T, P, N, NW>::BYTES;
  auto grads = ssd_scan_bwd_chunk_kernel<T, P, N, NW>;
  err = cudaFuncSetAttribute(grads, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
  if (err != cudaSuccess) return err;
  grads<<<dim3(n_chunks, batch, groups), 32 * NW, chunk_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<const float*>(states), static_cast<const T*>(dy),
      static_cast<const float*>(g), static_cast<const float*>(dso), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<double*>(dap), static_cast<float*>(ddp),
      static_cast<T*>(dx), static_cast<float*>(ddt), seqlen, heads, chunk, hpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t total = static_cast<size_t>(batch) * seqlen * N;
  const int blocks = static_cast<int>((total + 255) / 256);
  ssd_scan_bwd_sum_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp),
      static_cast<const double*>(dap), static_cast<const float*>(ddp), static_cast<T*>(db),
      static_cast<T*>(dc), static_cast<float*>(da), static_cast<float*>(dd), batch, seqlen, heads,
      N, groups, n_chunks);
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
// forward; hpb heads per chunk block (1 <= hpb <= heads). Scratch: g
// (batch, seqlen / chunk, 64, 64) and dso (batch, heads, seqlen / chunk, p,
// n) float32; dbp and dcp (batch, ceil(heads / hpb), seqlen, n) float32;
// dap (batch, seqlen / chunk, heads) float64 and ddp float32. Outputs: ddt
// (batch, seqlen, heads), da and dd (heads,) float32. Four launches (the
// Gram pass, the dS walk, the chunk pass, the sums). Returns the first
// failing launch's cudaError_t.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, const void* d, const void* states, const void* dy,
                            void* g, void* dso, void* dbp, void* dcp, void* dap, void* ddp,
                            void* dx, void* ddt, void* da, void* db, void* dc, void* dd,
                            int dtype, int batch, int seqlen, int heads, int p, int n, int chunk,
                            int hpb, void* stream) {
  if (chunk < 1 || chunk > CH || seqlen % chunk != 0 || batch < 1 || batch > 65535 ||
      heads < 1 || heads > 65535 || hpb < 1 || hpb > heads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_BWD(T, P, N, NW)                                                             \
  launch_bwd<T, P, N, NW>(x, dt, a, b, c, d, states, dy, g, dso, dbp, dcp, dap, ddp, dx, ddt, \
                          da, db, dc, dd, batch, seqlen, heads, chunk, hpb, s)
  cudaError_t err = cudaErrorInvalidValue;
  if (p == 64 && n == 128 && dtype == 0)
    err = REPRO_SSD_BWD(float, 64, 128, 16);
  else if (p == 64 && n == 128 && dtype == 1)
    err = REPRO_SSD_BWD(bf16, 64, 128, 16);
  else if (p == 16 && n == 16 && dtype == 0)
    err = REPRO_SSD_BWD(float, 16, 16, 8);
  else if (p == 16 && n == 16 && dtype == 1)
    err = REPRO_SSD_BWD(bf16, 16, 16, 8);
#undef REPRO_SSD_BWD
  return static_cast<int>(err);
}
