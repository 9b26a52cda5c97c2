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
// a (H,) and d (H,) in float32, y in x's dtype. cum is kept in float64:
// under strong decay it reaches thousands, and a float32 difference of two
// such values carries an absolute error of ~5e-4 however small the
// difference is; each difference is rounded to float32 before its exp.
//
// What bounds it on an H100: bytes, at the serving shape (B 8, S 2048,
// H 64, P 64, N 128, bf16): ~281 MB moved against ~43-60 GFLOP of small
// products, 0.084 ms at 3.35 TB/s. This first version multiplies in
// float32 on the CUDA cores, so it sits on the float32 operation rate
// instead, well above that bound.
//
// What the design does about it. On the TPU the chunk axis is the grid's
// sequential minor axis and the state lives in VMEM between grid steps; on
// Hopper blocks run in no order, so one block owns one (b, h, P tile) and
// walks the chunks itself, carrying its state tile in shared memory.
// Output column p depends only on x[:, p] and state[p, :], so P splits over
// blocks with no communication: P = 64 runs as two tiles of 32 (128 blocks
// for one batch row instead of 64 on 132 SMs), at the price of computing
// C B^T once per tile. Per chunk the block loads x, dt, B and C with
// 16-byte loads (rows past the chunk zero-filled, so a chunk shorter than
// 64 runs the same code), warp 0 forms cum with a warp scan while the other
// threads form C B^T (4 x 4 register tiles fed by 16-byte shared loads
// from padded, conflict-free rows), then the block writes the masked score
// tile, forms y, and updates the state. 256 threads, ~110 KB of dynamic
// shared memory at (64, 128): two blocks per SM. mma.sync/wgmma, TMA and a
// chunk-parallel (state-passing) form are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;         // largest chunk; shorter chunks are zero-padded
constexpr int NT = 256;        // threads per block (8 warps)
constexpr int WLD = CH + 4;    // padded row of the score tile
constexpr unsigned kFull = 0xffffffffu;

template <int PT, int N>
constexpr int smem_floats() {
  // cum (CH doubles), C, B, x tile, score tile, state, dt/ec/sc, exp(total)
  return 2 * CH + 2 * CH * (N + 4) + CH * (PT + 4) + CH * WLD + PT * (N + 4) + 3 * CH + 4;
}

// 16-byte loads of V consecutive elements, widened to float32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static float store(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// CH rows of COLS elements (global row stride `gstride`) into float32 shared
// rows of stride `ld`; rows at or past `rows` are zero-filled.
template <typename T, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, size_t gstride,
                                          int rows) {
  constexpr int V = Vec<T>::n;
  constexpr int PER_ROW = COLS / V;
  static_assert(COLS % V == 0, "tile width must be a whole number of 16-byte loads");
  for (int e = threadIdx.x; e < CH * PER_ROW; e += NT) {
    const int r = e / PER_ROW;
    const int c0 = (e - r * PER_ROW) * V;
    float v[V];
    if (r < rows) {
      Vec<T>::load(src + r * gstride + c0, v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c0 + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int PT, int N>
__global__ void __launch_bounds__(NT, 2)
ssd_scan_kernel(const T* __restrict__ x,        // (B, S, H, P)
                const float* __restrict__ dt,   // (B, S, H)
                const float* __restrict__ a,    // (H,)
                const T* __restrict__ bm,       // (B, S, N)
                const T* __restrict__ cm,       // (B, S, N)
                const float* __restrict__ dskip,  // (H,)
                T* __restrict__ y,              // (B, S, H, P)
                int seqlen, int heads, int p_total, int chunk) {
  constexpr int NLD = N + 4;   // padded row of C, B and the state
  constexpr int XLD = PT + 4;  // padded row of the x tile
  constexpr int YS = PT / 16;  // output columns per thread
  constexpr int TN = N < 32 ? N : 32;  // state update: threads along N
  constexpr int TP = NT / TN;          //               threads along P
  constexpr int RP = PT / TP;
  constexpr int RN = N / TN;
  static_assert(PT % 16 == 0 && N % 4 == 0, "tile shapes");
  static_assert(RP >= 1 && PT % TP == 0 && N % TN == 0, "state update map");

  extern __shared__ __align__(16) float smem[];
  double* cum_s = reinterpret_cast<double*>(smem);  // CH   cum (float64)
  float* c_s = smem + 2 * CH;                       // CH x NLD   C rows
  float* b_s = c_s + CH * NLD;                      // CH x NLD   B rows
  float* x_s = b_s + CH * NLD;                      // CH x XLD   x, this P tile
  float* w_s = x_s + CH * XLD;                      // CH x WLD   (C B^T o L) * dt_j
  float* st_s = w_s + CH * WLD;                     // PT x NLD   state
  float* dt_s = st_s + PT * NLD;                    // CH   dt
  float* ec_s = dt_s + CH;                          // CH   exp(cum)
  float* sc_s = ec_s + CH;                          // CH   dt * exp(total - cum)
  float* et_s = sc_s + CH;                          // [0]  exp(total)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float ah = a[h];
  const float dh = dskip[h];
  const size_t xrow = static_cast<size_t>(heads) * p_total;  // x / y row stride
  const int ti = tid >> 4;  // C B^T and y: rows ti + 16 r
  const int tj = tid & 15;  //              cols tj + 16 s
  const int sp = tid / TN;  // state update: rows sp + TP r
  const int sn = tid % TN;  //               cols sn + TN q

  for (int e = tid; e < PT * NLD; e += NT) st_s[e] = 0.f;

  const int n_chunks = seqlen / chunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const size_t row0 = static_cast<size_t>(b) * seqlen + static_cast<size_t>(ci) * chunk;
    __syncthreads();  // the previous chunk is done with b_s, x_s and the state
    load_tile<T, N>(c_s, NLD, cm + row0 * N, N, chunk);
    load_tile<T, N>(b_s, NLD, bm + row0 * N, N, chunk);
    load_tile<T, PT>(x_s, XLD, x + row0 * xrow + static_cast<size_t>(h) * p_total + p0, xrow,
                     chunk);
    if (tid < CH) dt_s[tid] = tid < chunk ? dt[(row0 + tid) * heads + h] : 0.f;
    __syncthreads();

    if (tid < 32) {
      // inclusive prefix sum of dt * a, two positions per lane; padded
      // positions have dt = 0 and leave cum at its total
      const int i0 = 2 * tid;
      const double v0 = static_cast<double>(dt_s[i0] * ah);
      const double v1 = static_cast<double>(dt_s[i0 + 1] * ah);
      double s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kFull, s, o);
        if (tid >= o) s += u;
      }
      const double total = __shfl_sync(kFull, s, 31);
      const double c0 = s - v1;
      cum_s[i0] = c0;
      cum_s[i0 + 1] = s;
      ec_s[i0] = expf(static_cast<float>(c0));
      ec_s[i0 + 1] = expf(static_cast<float>(s));
      sc_s[i0] = dt_s[i0] * expf(static_cast<float>(total - c0));
      sc_s[i0 + 1] = dt_s[i0 + 1] * expf(static_cast<float>(total - s));
      if (tid == 0) et_s[0] = expf(static_cast<float>(total));
    }

    // G = C B^T, 4 x 4 per thread
    float g[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) g[r][q] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        cv[r] = *reinterpret_cast<const float4*>(c_s + (ti + 16 * r) * NLD + n);
        bv[r] = *reinterpret_cast<const float4*>(b_s + (tj + 16 * r) * NLD + n);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) g[r][q] = dot4(cv[r], bv[q], g[r][q]);
    }
    __syncthreads();  // cum, ec, sc and exp(total) are in shared memory

    // W = (G o L) * dt_j, masked before the exp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tj + 16 * q;
        w_s[i * WLD + j] =
            i >= j ? g[r][q] * expf(static_cast<float>(cum_s[i] - cum_s[j])) * dt_s[j] : 0.f;
      }
    }
    __syncthreads();

    // y = W x + exp(cum) C state^T + d x
    float yi[4][YS], yo[4][YS];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < YS; ++s) yi[r][s] = yo[r][s] = 0.f;
#pragma unroll 2
    for (int j = 0; j < CH; j += 4) {
      float4 wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[r] = *reinterpret_cast<const float4*>(w_s + (ti + 16 * r) * WLD + j);
#pragma unroll
      for (int s = 0; s < YS; ++s) {
        const int p = tj + 16 * s;
        const float4 xv = make_float4(x_s[j * XLD + p], x_s[(j + 1) * XLD + p],
                                      x_s[(j + 2) * XLD + p], x_s[(j + 3) * XLD + p]);
#pragma unroll
        for (int r = 0; r < 4; ++r) yi[r][s] = dot4(wv[r], xv, yi[r][s]);
      }
    }
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      float4 cv[4], sv[YS];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cv[r] = *reinterpret_cast<const float4*>(c_s + (ti + 16 * r) * NLD + n);
#pragma unroll
      for (int s = 0; s < YS; ++s)
        sv[s] = *reinterpret_cast<const float4*>(st_s + (tj + 16 * s) * NLD + n);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < YS; ++s) yo[r][s] = dot4(cv[r], sv[s], yo[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti + 16 * r;
      if (i < chunk) {
        T* yrow = y + (row0 + i) * xrow + static_cast<size_t>(h) * p_total + p0;
#pragma unroll
        for (int s = 0; s < YS; ++s) {
          const int p = tj + 16 * s;
          const float v = yi[r][s] + ec_s[i] * yo[r][s] + dh * x_s[i * XLD + p];
          yrow[p] = Vec<T>::store(v);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // state = exp(total) state + (x * dt * exp(total - cum))^T B
    float acc[RP][RN];
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) acc[r][q] = 0.f;
#pragma unroll 4
    for (int t = 0; t < CH; ++t) {
      const float st = sc_s[t];
      float xv[RP], bv[RN];
#pragma unroll
      for (int r = 0; r < RP; ++r) xv[r] = x_s[t * XLD + sp + TP * r] * st;
#pragma unroll
      for (int q = 0; q < RN; ++q) bv[q] = b_s[t * NLD + sn + TN * q];
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(xv[r], bv[q], acc[r][q]);
    }
    const float et = et_s[0];
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        float* cell = st_s + (sp + TP * r) * NLD + sn + TN * q;
        *cell = fmaf(et, *cell, acc[r][q]);
      }
  }
}

template <typename T, int PT, int N>
cudaError_t launch_typed(const void* x, const void* dt, const void* a, const void* b,
                         const void* c, const void* d, void* y, int batch, int seqlen,
                         int heads, int p, int chunk, cudaStream_t stream) {
  const int bytes = smem_floats<PT, N>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, PT, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p / PT, heads, batch);
  ssd_scan_kernel<T, PT, N><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<T*>(y), seqlen, heads, p, chunk);
  return cudaGetLastError();
}

template <int PT, int N>
cudaError_t launch(int dtype, const void* x, const void* dt, const void* a, const void* b,
                   const void* c, const void* d, void* y, int batch, int seqlen, int heads,
                   int p, int chunk, cudaStream_t s) {
  if (dtype == 0)
    return launch_typed<float, PT, N>(x, dt, a, b, c, d, y, batch, seqlen, heads, p, chunk,
                                      s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16, PT, N>(x, dt, a, b, c, d, y, batch, seqlen, heads, p,
                                              chunk, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); (p, n) in {(64, 128),
// (16, 16)}; 1 <= chunk <= 64 and seqlen % chunk == 0; x, B and C rows
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a, const void* b,
                        const void* c, const void* d, void* y, int dtype, int batch,
                        int seqlen, int heads, int p, int n, int chunk, void* stream) {
  if (chunk < 1 || chunk > CH || seqlen % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p == 64 && n == 128)
    err = launch<32, 128>(dtype, x, dt, a, b, c, d, y, batch, seqlen, heads, p, chunk, s);
  else if (p == 16 && n == 16)
    err = launch<16, 16>(dtype, x, dt, a, b, c, d, y, batch, seqlen, heads, p, chunk, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
