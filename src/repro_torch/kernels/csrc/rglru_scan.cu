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
    if (k == n_chunks - 1) carry[lane_ch] = prod * h + end;
    if (edge)
      chunk_out<true>(y, h_last_b, off, w, live, t0, s, t_last, h, a, bt, yv);
    else
      chunk_out<false>(y, h_last_b, off, w, live, t0, s, t_last, h, a, bt, yv);
  }
}

template <typename T>
cudaError_t launch(const void* xb, const void* r_pre, const void* i_pre, const void* y_pre,
                   const float* c, const int32_t* lengths, void* y, float* h_last, int batch,
                   int s, int w, int n_chunks, cudaStream_t stream) {
  dim3 grid((w + kChannels - 1) / kChannels, batch);
  rglru_scan_kernel<T><<<grid, kChannels * n_chunks, 0, stream>>>(
      static_cast<const T*>(xb), static_cast<const T*>(r_pre), static_cast<const T*>(i_pre),
      static_cast<const T*>(y_pre), c, lengths, static_cast<T*>(y), h_last, s, w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xb, r_pre, i_pre, y_pre and y); c and
// h_last float32, lengths int32; chunks: chunks of 8 positions a block
// walks at a time, 1 to 32. Returns the launch's cudaError_t.
extern "C" int rglru_scan(const void* xb, const void* r_pre, const void* i_pre,
                          const void* y_pre, const void* c, const void* lengths, void* y,
                          void* h_last, int dtype, int batch, int s, int w, int chunks,
                          void* stream) {
  if (batch < 1 || s < 1 || w < 1 || batch > 65535 || chunks < 1 || chunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  float* hl = static_cast<float*>(h_last);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(xb, r_pre, i_pre, y_pre, cf, len, y, hl, batch, s, w, chunks, st);
  else if (dtype == 1)
    err = launch<bf16>(xb, r_pre, i_pre, y_pre, cf, len, y, hl, batch, s, w, chunks, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
