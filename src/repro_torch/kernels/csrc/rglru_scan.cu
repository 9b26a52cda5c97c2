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
// the memory rate.
//
// What the design does about it. One thread owns one (row, channel) and
// walks t in float32; neighbouring threads own neighbouring channels, so
// every load and store of a warp is one contiguous run of 32 elements.
// The recurrence is a chain of dependent multiply-adds, but its inputs are
// not: each thread loads the next UNROLL positions of its four inputs
// (4 x UNROLL independent loads in flight) before it runs their gates and
// the chain. 64-thread blocks spread a batch-1 prompt (W = 2560: 40 blocks)
// over more SMs than 128-thread blocks would. Not yet: a chunked two-pass
// scan over t (per-chunk products and local states, then the carries),
// which would give a batch-1 prompt more than W threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// tanh-approximate gelu, PyTorch's formula (jax.nn.gelu's default)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;     // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ xb,        // (B, S, W) conv output
                  const T* __restrict__ r_pre,     // (B, S, W) x W_r + b_r
                  const T* __restrict__ i_pre,     // (B, S, W) x W_i + b_i
                  const T* __restrict__ y_pre,     // (B, S, W) h W_y
                  const float* __restrict__ c,     // (W,) -8 softplus(a_log)
                  const int32_t* __restrict__ lengths,  // (B,)
                  T* __restrict__ y,               // (B, S, W)
                  float* __restrict__ h_last,      // (B, W)
                  int s, int w) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (ch >= w) return;
  const int t_last = min(max(lengths[b] - 1, 0), s - 1);
  const float cw = c[ch];
  const size_t row = (size_t)b * s * w + ch;
  float h = 0.f, h_keep = 0.f;
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    float xv[kUnroll], rv[kUnroll], iv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < s) {
        const size_t e = row + (size_t)(t0 + u) * w;
        xv[u] = to_f32(xb[e]);
        rv[u] = to_f32(r_pre[e]);
        iv[u] = to_f32(i_pre[e]);
        yv[u] = to_f32(y_pre[e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < s) {
        const float a = expf(cw * sigmoid(rv[u]));
        const float beta = sqrtf(fmaxf(1.f - a * a, 1e-9f));
        const float bt = beta * sigmoid(iv[u]) * xv[u];
        h = a * h + bt;
        if (t == t_last) h_keep = h;
        y[row + (size_t)t * w] = from_f32<T>(h * gelu_tanh(yv[u]));
      }
    }
  }
  h_last[(size_t)b * w + ch] = h_keep;
}

template <typename T>
cudaError_t launch(const void* xb, const void* r_pre, const void* i_pre, const void* y_pre,
                   const float* c, const int32_t* lengths, void* y, float* h_last, int batch,
                   int s, int w, cudaStream_t stream) {
  dim3 grid((w + kThreads - 1) / kThreads, batch);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xb), static_cast<const T*>(r_pre), static_cast<const T*>(i_pre),
      static_cast<const T*>(y_pre), c, lengths, static_cast<T*>(y), h_last, s, w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xb, r_pre, i_pre, y_pre and y); c and
// h_last float32, lengths int32. Returns the launch's cudaError_t.
extern "C" int rglru_scan(const void* xb, const void* r_pre, const void* i_pre,
                          const void* y_pre, const void* c, const void* lengths, void* y,
                          void* h_last, int dtype, int batch, int s, int w, void* stream) {
  if (batch < 1 || s < 1 || w < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  float* hl = static_cast<float*>(h_last);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(xb, r_pre, i_pre, y_pre, cf, len, y, hl, batch, s, w, st);
  else if (dtype == 1)
    err = launch<bf16>(xb, r_pre, i_pre, y_pre, cf, len, y, hl, batch, s, w, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
