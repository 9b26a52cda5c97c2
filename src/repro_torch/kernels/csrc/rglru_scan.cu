// The RG-LRU recurrence of a recurrentgemma prompt pass for Hopper
// (sm_90a), with its gates and its output product fused.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as
// lax.associative_scan (src/repro/models/blocks.py:570, in
// rglru_block_apply), which XLA lowers to log2(S) passes over the whole
// (B, S, W) sequence. In plain PyTorch it is S dependent steps, S launches
// per layer. Same function, per row b, channel w and position t:
//   r   = sigmoid(float(r_pre)),  i = sigmoid(float(i_pre))
//   a   = exp(c[w] * r),          c = -8 softplus(a_log), from the caller
//   bt  = sqrt(max(1 - a * a, 1e-9)) * i * float(xb)
//   h_t = a * h_{t-1} + bt        (h_{-1} = 0), in float32
//   y   = T(h_t * gelu_tanh(float(y_pre)))
// and the state h at t = clamp(lengths[b] - 1, 0, S - 1) for the
// prefill -> decode handoff. Every rounding point is the reference's:
// the inputs arrive in the model dtype T (the projections' outputs, the
// gate biases already added), all arithmetic is float32, y is rounded to T
// once.
//
// What bounds it on an H100: bytes. Four T inputs read once and one T
// output written once, 10 bytes per element in bfloat16, a few dozen
// float32 operations per element: at (8, 2048, 2560) 0.42 GB, 0.13 ms at
// the memory rate. Instruction issue comes close behind: the gates are
// two sigmoids, an exp, a sqrt and the tanh gelu per element.
//
// What the design does about it: a chunked scan over t, so that a batch-1
// prompt runs on many more threads than its W channels, in one pass that
// reads each input once and computes each gate once. The recurrence
// h -> a h + bt composes as (a2 a1, a2 h1 + b2), the combine of the
// reference's associative scan; chunks of 8 positions apply it to whole
// chunks. A block owns 16 neighbouring channels of one row (32 bytes of
// bf16 a position, one memory sector) and P chunks (P from the caller:
// kernels/rglru_scan.py::chunk_plan), and walks t in tiles of P chunks. In
// a tile each thread owns one (channel, chunk): it loads the chunk's four
// inputs at once, keeps the chunk's a, bt and y_pre in registers, and puts
// the chunk's decay product A and its end state H from h = 0 into shared
// memory; then the state entering its chunk is the tile's carry composed
// with the A, H of the chunks before it (h = A h + H, in order); then it
// runs the chunk from that state, writing y and, where lengths - 1 falls
// in the chunk, the state there. The last chunk's thread hands the carry
// to the next tile. So the float32 association is that of chunks of 8
// positions composed in order, the same whatever P is (the plain version
// rglru_scan_chunked_torch at chunk 8); only it differs from the
// sequential loop, as the reference's tree does. Positions past S and
// channels past W are the identity (a = 1, bt = 0), and only a tile that
// holds them tests each element. Blocks of up to 512 threads are held to
// 64 registers (a few dozen bytes spill), two to an SM. A two-pass form
// (chunk products and end states in one kernel, then every chunk again
// from its carry) read 16 bytes an element, computed the gates twice and
// ran slower on the H100 at every shape tried. Not yet: blocks split
// over t (a carry across blocks), which would spread a batch-1 row's 160
// blocks more evenly over the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChannels = 16;     // channels per block
constexpr int kChunk = 8;         // positions per chunk: one thread's in a tile
constexpr int kMaxChunks = 32;    // chunks per block (a tile) at most: 512 threads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// The special functions are the hardware's (ex2.approx, rcp.approx,
// rsqrt.approx behind __expf, __fdividef and rsqrtf: a few float32 ulp
// each); the IEEE forms took a third of the kernel's instructions.
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// tanh-approximate gelu, PyTorch's formula (jax.nn.gelu's default):
// 0.5 x (1 + tanh(u)) = x sigmoid(2 u)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;     // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return __fdividef(x, 1.f + __expf(-2.f * inner));
}

// One thread's chunk of a tile, positions t0 .. t0 + kChunk - 1 of its
// row's channel (off: the element offset of t0). EDGE: the tile may hold
// positions past S or the block channels past W (those are the identity).
template <bool EDGE, typename T>
__device__ __forceinline__ void chunk_gates(const T* xb, const T* r_pre, const T* i_pre,
                                            const T* y_pre, size_t off, int w, bool live,
                                            int t0, int s, float cw, float (&a)[kChunk],
                                            float (&bt)[kChunk], float (&yv)[kChunk]) {
  float xv[kChunk], rv[kChunk], iv[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (!EDGE || (live && t0 + u < s)) {
      const size_t e = off + (size_t)u * w;
      xv[u] = to_f32(xb[e]);
      rv[u] = to_f32(r_pre[e]);
      iv[u] = to_f32(i_pre[e]);
      yv[u] = to_f32(y_pre[e]);
    }
  }
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (!EDGE || (live && t0 + u < s)) {
      a[u] = __expf(cw * sigmoid(rv[u]));
      const float d = fmaxf(1.f - a[u] * a[u], 1e-9f);
      bt[u] = d * rsqrtf(d) * sigmoid(iv[u]) * xv[u];
    } else {
      a[u] = 1.f;
      bt[u] = 0.f;
    }
  }
}

template <bool EDGE, typename T>
__device__ __forceinline__ void chunk_out(T* y, float* h_last_b, size_t off, int w, bool live,
                                          int t0, int s, int t_last, float h,
                                          const float (&a)[kChunk], const float (&bt)[kChunk],
                                          const float (&yv)[kChunk]) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (!EDGE || (live && t0 + u < s)) {
      h = a[u] * h + bt[u];
      if (t0 + u == t_last) *h_last_b = h;
      y[off + (size_t)u * w] = from_f32<T>(h * gelu_tanh(yv[u]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kChannels * kMaxChunks, 2)
rglru_scan_kernel(const T* __restrict__ xb,        // (B, S, W) conv output
                  const T* __restrict__ r_pre,     // (B, S, W) x W_r + b_r
                  const T* __restrict__ i_pre,     // (B, S, W) x W_i + b_i
                  const T* __restrict__ y_pre,     // (B, S, W) h W_y
                  const float* __restrict__ c,     // (W,) -8 softplus(a_log)
                  const int32_t* __restrict__ lengths,  // (B,)
                  T* __restrict__ y,               // (B, S, W)
                  float* __restrict__ h_last,      // (B, W)
                  float* __restrict__ h_chunks,    // (B, ceil(S / 8), W) or null
                  int s, int w) {
  __shared__ float chunk_a[kMaxChunks][kChannels];   // the tile's chunks' A
  __shared__ float chunk_h[kMaxChunks][kChannels];   // and H
  __shared__ float carry[kChannels];                 // the state entering the tile
  const int lane_ch = threadIdx.x % kChannels;
  const int k = threadIdx.x / kChannels;             // this thread's chunk in a tile
  const int n_chunks = blockDim.x / kChannels;
  const int tile_len = n_chunks * kChunk;
  const int ch = blockIdx.x * kChannels + lane_ch;
  const int b = blockIdx.y;
  const bool live = ch < w;                          // threads past W keep the barriers
  const bool block_live = (blockIdx.x + 1) * kChannels <= w;
  const int t_last = min(max(lengths[b] - 1, 0), s - 1);
  const float cw = live ? c[ch] : 0.f;
  const size_t row = (size_t)b * s * w + ch;
  float* h_last_b = h_last + (size_t)b * w + ch;
  if (k == 0) carry[lane_ch] = 0.f;

  for (int tile = 0; tile < s; tile += tile_len) {
    const int t0 = tile + k * kChunk;
    const size_t off = row + (size_t)t0 * w;
    const bool edge = !block_live || tile + tile_len > s;   // uniform over the block
    float a[kChunk], bt[kChunk], yv[kChunk];
    if (edge)
      chunk_gates<true>(xb, r_pre, i_pre, y_pre, off, w, live, t0, s, cw, a, bt, yv);
    else
      chunk_gates<false>(xb, r_pre, i_pre, y_pre, off, w, live, t0, s, cw, a, bt, yv);
    // the chunk's decay product and its end state from h = 0
    float prod = 1.f, end = 0.f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      prod *= a[u];
      end = a[u] * end + bt[u];
    }
    chunk_a[k][lane_ch] = prod;
    chunk_h[k][lane_ch] = end;
    __syncthreads();
    // the state entering this chunk: the carry, then the chunks before it
    float h = carry[lane_ch];
    for (int j = 0; j < k; ++j) h = chunk_a[j][lane_ch] * h + chunk_h[j][lane_ch];
    __syncthreads();                                 // every carry read before it moves on
    if (h_chunks != nullptr && live && t0 < s)       // training: the backward's carries
      h_chunks[(static_cast<size_t>(b) * ((s + kChunk - 1) / kChunk) + t0 / kChunk) * w + ch] = h;
    if (k == n_chunks - 1) carry[lane_ch] = prod * h + end;
    if (edge)
      chunk_out<true>(y, h_last_b, off, w, live, t0, s, t_last, h, a, bt, yv);
    else
      chunk_out<false>(y, h_last_b, off, w, live, t0, s, t_last, h, a, bt, yv);
  }
}

template <typename T>
cudaError_t launch(const void* xb, const void* r_pre, const void* i_pre, const void* y_pre,
                   const float* c, const int32_t* lengths, void* y, float* h_last,
                   float* h_chunks, int batch, int s, int w, int n_chunks, cudaStream_t stream) {
  dim3 grid((w + kChannels - 1) / kChannels, batch);
  rglru_scan_kernel<T><<<grid, kChannels * n_chunks, 0, stream>>>(
      static_cast<const T*>(xb), static_cast<const T*>(r_pre), static_cast<const T*>(i_pre),
      static_cast<const T*>(y_pre), c, lengths, static_cast<T*>(y), h_last, h_chunks, s, w);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the backward (training)
// ---------------------------------------------------------------------------
//
// The gradient of y above for an output gradient dy, from the state the
// training forward wrote at the start of each chunk of 8 positions
// (h_chunks): per element, with e_t = dy_t gelu_tanh(y_pre_t),
//   dh_t = e_t + a_{t+1} dh_{t+1}          (dh past S is 0)
//   dy_pre = dy h_t gelu_tanh'(y_pre),  dxb = dh beta i,
//   di_pre = dh xb beta i (1 - i),
//   da = dh h_{t-1} - [1 - a^2 > 1e-9] (dh xb i) a / beta
//        (JAX's maximum: half at a tie, which float32 cannot reach),
//   dr_pre = da a c r (1 - r),  dc = sum over (B, S) of da a r.
// The reverse recurrence composes like the forward's: a chunk maps the
// value q = a_{t+1} dh_{t+1} handed in from its right to a_{t0} dh_{t0} =
// A q + E, with the same decay product A.
//
// Design: the forward's layout (16 channels of one row, one thread per
// (channel, chunk)) walking tiles from the last to the first, one pass over
// the inputs. A thread loads its chunk's five inputs once, computes each
// gate, the gelu and its derivative once per element with the forward's
// special functions (so a and the states are the forward's), and runs the
// chunk's states forward from the carry the training forward saved (h_{t-1}
// costs 4 bytes per 8 positions, not a (B, S, W) float32 buffer), writing
// dy_pre as it goes. Every other gradient is linear in dh, so the thread
// keeps a and e in registers and four coefficients an element in shared
// memory: beta i (dxb), xb beta i (1 - i) (di_pre), and m r, m c r (1 - r)
// with m = (h_{t-1} - [..] xb i a / beta) a (dc, dr_pre). Then the chunk's
// (A, E) from q = 0, the q entering it (the tile's carry composed with the
// chunks after it), and the reverse pass over the coefficients. Blocks of up
// to 512 threads are held to 64 registers and 64 KB of coefficients, two an
// SM, as the forward. dc is summed per thread in order, over a block's
// chunks in order, then over rows in order by a second launch: no atomics.
// Bound: bytes, as the forward (five inputs read and four gradients written
// in T: 18 bytes an element in bfloat16).

constexpr int kCoefs = 4;   // reverse-pass coefficients an element

// the tanh gelu (x sigmoid(2 u), as gelu_tanh) and its derivative
// 0.5 (1 + tanh u) + 0.5 x (1 - tanh^2 u) u' = s + 2 x s (1 - s) u'
__device__ __forceinline__ void gelu_tanh_grad(float x, float& val, float& grad) {
  const float kBeta = 0.7978845608028654f;     // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float sg = sigmoid(2.f * (kBeta * (x + kKappa * (x * x * x))));
  val = x * sg;
  grad = sg + 2.f * x * sg * (1.f - sg) * kBeta * (1.f + 3.f * kKappa * x * x);
}

template <typename T>
__global__ void __launch_bounds__(kChannels * kMaxChunks, 2)
rglru_scan_bwd_kernel(const T* __restrict__ xb, const T* __restrict__ r_pre,
                      const T* __restrict__ i_pre, const T* __restrict__ y_pre,
                      const float* __restrict__ c, const float* __restrict__ h_chunks,
                      const T* __restrict__ dy, T* __restrict__ dxb, T* __restrict__ dr,
                      T* __restrict__ di, T* __restrict__ dyp,
                      float* __restrict__ dc_rows,   // (B, W)
                      int s, int w) {
  __shared__ float chunk_a[kMaxChunks][kChannels];   // the tile's chunks' A (at the end: dc)
  __shared__ float chunk_e[kMaxChunks][kChannels];   // and E
  __shared__ float carry[kChannels];                 // q entering the tile from its right
  extern __shared__ float coef[];                    // [kCoefs][kChunk][blockDim.x]
  const int nt = blockDim.x;
  const int lane_ch = threadIdx.x % kChannels;
  const int k = threadIdx.x / kChannels;
  const int n_chunks = nt / kChannels;
  const int tile_len = n_chunks * kChunk;
  const int ch = blockIdx.x * kChannels + lane_ch;
  const int b = blockIdx.y;
  const bool live = ch < w;
  const int nck = (s + kChunk - 1) / kChunk;
  const float cw = live ? c[ch] : 0.f;
  const size_t row = static_cast<size_t>(b) * s * w + ch;
  float* cf = coef + threadIdx.x;                    // coefficient (q, u) at cf[(q kChunk + u) nt]
  float dc_acc = 0.f;
  if (k == 0) carry[lane_ch] = 0.f;

  for (int tile = ((s - 1) / tile_len) * tile_len; tile >= 0; tile -= tile_len) {
    const int t0 = tile + k * kChunk;
    const size_t off = row + static_cast<size_t>(t0) * w;
    const bool on = live && t0 < s;
    float av[kChunk], ev[kChunk];
    float h = on ? h_chunks[(static_cast<size_t>(b) * nck + t0 / kChunk) * w + ch] : 0.f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      av[u] = 1.f;
      ev[u] = 0.f;
      if (on && t0 + u < s) {
        const size_t e = off + static_cast<size_t>(u) * w;
        const float x = to_f32(xb[e]);
        const float r = sigmoid(to_f32(r_pre[e]));
        const float i = sigmoid(to_f32(i_pre[e]));
        const float g = to_f32(dy[e]);
        float gl, gd;
        gelu_tanh_grad(to_f32(y_pre[e]), gl, gd);
        const float a = __expf(cw * r);
        const float one_m = 1.f - a * a;
        const float d = fmaxf(one_m, 1e-9f);
        const float rs = rsqrtf(d);                  // 1 / beta
        const float beta = d * rs;
        const float hprev = h;
        h = a * h + beta * i * x;
        dyp[e] = from_f32<T>(g * h * gd);
        av[u] = a;
        ev[u] = g * gl;
        const float wgt = one_m > 1e-9f ? 1.f : (one_m == 1e-9f ? 0.5f : 0.f);
        const float m = (hprev - wgt * x * i * a * rs) * a;
        cf[(0 * kChunk + u) * nt] = beta * i;
        cf[(1 * kChunk + u) * nt] = x * beta * i * (1.f - i);
        cf[(2 * kChunk + u) * nt] = m * r;
        cf[(3 * kChunk + u) * nt] = m * cw * r * (1.f - r);
      }
    }
    float prod = 1.f, end = 0.f;
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      end = av[u] * (ev[u] + end);
      prod *= av[u];
    }
    chunk_a[k][lane_ch] = prod;
    chunk_e[k][lane_ch] = end;
    __syncthreads();
    float q = carry[lane_ch];
    for (int j = n_chunks - 1; j > k; --j) q = chunk_a[j][lane_ch] * q + chunk_e[j][lane_ch];
    __syncthreads();                                 // every carry read before it moves on
    if (k == 0) carry[lane_ch] = prod * q + end;
    if (on) {
#pragma unroll
      for (int u = kChunk - 1; u >= 0; --u) {
        if (t0 + u >= s) continue;
        const size_t e = off + static_cast<size_t>(u) * w;
        const float dh = ev[u] + q;
        dxb[e] = from_f32<T>(dh * cf[(0 * kChunk + u) * nt]);
        di[e] = from_f32<T>(dh * cf[(1 * kChunk + u) * nt]);
        dc_acc += dh * cf[(2 * kChunk + u) * nt];
        dr[e] = from_f32<T>(dh * cf[(3 * kChunk + u) * nt]);
        q = av[u] * dh;
      }
    }
  }
  __syncthreads();                                   // the last tile's A read everywhere
  chunk_a[k][lane_ch] = dc_acc;
  __syncthreads();
  if (k == 0 && live) {
    float sum = 0.f;
    for (int j = 0; j < n_chunks; ++j) sum += chunk_a[j][lane_ch];
    dc_rows[static_cast<size_t>(b) * w + ch] = sum;
  }
}

// dc: the per-row partials summed over rows in order
__global__ void rglru_scan_dc_kernel(const float* __restrict__ dc_rows, float* __restrict__ dc,
                                     int batch, int w) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= w) return;
  float sum = 0.f;
  for (int b = 0; b < batch; ++b) sum += dc_rows[static_cast<size_t>(b) * w + ch];
  dc[ch] = sum;
}

template <typename T>
cudaError_t launch_bwd(const void* xb, const void* r_pre, const void* i_pre,
                       const void* y_pre, const float* c, const float* h_chunks,
                       const void* dy, void* dxb, void* dr, void* di, void* dyp,
                       float* dc_rows, float* dc, int batch, int s, int w, int n_chunks,
                       cudaStream_t stream) {
  const int nt = kChannels * n_chunks;
  const int coef_bytes = kCoefs * kChunk * nt * static_cast<int>(sizeof(float));
  auto kernel = rglru_scan_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, coef_bytes);
  if (err != cudaSuccess) return err;
  // the shared memory of two blocks an SM before L1
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((w + kChannels - 1) / kChannels, batch);
  kernel<<<grid, nt, coef_bytes, stream>>>(
      static_cast<const T*>(xb), static_cast<const T*>(r_pre), static_cast<const T*>(i_pre),
      static_cast<const T*>(y_pre), c, h_chunks, static_cast<const T*>(dy),
      static_cast<T*>(dxb), static_cast<T*>(dr), static_cast<T*>(di), static_cast<T*>(dyp),
      dc_rows, s, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_scan_dc_kernel<<<(w + 255) / 256, 256, 0, stream>>>(dc_rows, dc, batch, w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xb, r_pre, i_pre, y_pre and y); c and
// h_last float32, lengths int32; h_chunks null, or (batch, ceil(s / 8), w)
// float32 for the state entering each chunk (the training forward);
// chunks: chunks of 8 positions a block walks at a time, 1 to 32. Returns
// the launch's cudaError_t.
extern "C" int rglru_scan(const void* xb, const void* r_pre, const void* i_pre,
                          const void* y_pre, const void* c, const void* lengths, void* y,
                          void* h_last, void* h_chunks, int dtype, int batch, int s, int w,
                          int chunks, void* stream) {
  if (batch < 1 || s < 1 || w < 1 || batch > 65535 || chunks < 1 || chunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  float* hl = static_cast<float*>(h_last);
  float* hc = static_cast<float*>(h_chunks);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(xb, r_pre, i_pre, y_pre, cf, len, y, hl, hc, batch, s, w, chunks, st);
  else if (dtype == 1)
    err = launch<bf16>(xb, r_pre, i_pre, y_pre, cf, len, y, hl, hc, batch, s, w, chunks, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The backward: dtype as above for xb, r_pre, i_pre, y_pre, dy and the four
// gradients; c, h_chunks (batch, ceil(s / 8), w), dc_rows (batch, w)
// scratch and dc (w,) float32; chunks as above. Two launches (the reverse
// scan, the sum over rows). Returns the first failing launch's cudaError_t.
extern "C" int rglru_scan_bwd(const void* xb, const void* r_pre, const void* i_pre,
                              const void* y_pre, const void* c, const void* h_chunks,
                              const void* dy, void* dxb, void* dr, void* di, void* dyp,
                              void* dc_rows, void* dc, int dtype, int batch, int s, int w,
                              int chunks, void* stream) {
  if (batch < 1 || s < 1 || w < 1 || batch > 65535 || chunks < 1 || chunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  const float* hc = static_cast<const float*>(h_chunks);
  float* dcr = static_cast<float*>(dc_rows);
  float* dcf = static_cast<float*>(dc);
  cudaError_t err;
  if (dtype == 0)
    err = launch_bwd<float>(xb, r_pre, i_pre, y_pre, cf, hc, dy, dxb, dr, di, dyp, dcr, dcf,
                            batch, s, w, chunks, st);
  else if (dtype == 1)
    err = launch_bwd<bf16>(xb, r_pre, i_pre, y_pre, cf, hc, dy, dxb, dr, di, dyp, dcr, dcf,
                           batch, s, w, chunks, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
