// Conv-stack kernels for the streaming SoundStream / LyraGAN core on Hopper.
//
// Replaces the conv lowerings of the Pallas megakernel
// lyra_tpu/ops/fused_stack.py (FusedStackKernel._make_kernel: _conv,
// _depthwise, _tconv; pallas_call built in _build_call).  The Pallas kernel
// ran the whole multi-channel core of a graph for a block of 64 streams in
// VMEM; here each conv op of the core is one launch over channels-last
// [B, T, C] activations, and the elementwise / data-movement ops between
// them stay torch ops (ops/fused_stack.py drives them in graph order).
//
// Two element types share one source: float32 (conv1d_fwd, ...) and
// bfloat16 (conv1d_fwd_bf16, ...), the Pallas kernel's default mode.  In
// bf16, x, w and bias are __nv_bfloat16; every product is accumulated in
// f32 with fmaf, the bias is added in f32 from its bf16-rounded value (as
// `wv(bias).astype(f32)` in the Pallas kernel), and the result is rounded
// to bf16 once, on store (__float2bfloat16_rn).  The Pallas _depthwise
// sums its K taps in bf16 (fused_stack.py:742-745); this kernel sums them
// in f32, which is at least as exact.
//
// What bounds them on an H100: per 20 ms hop a stream's core is a few
// hundred thousand MACs over ~1 MB (f32, ~5 MB at full width; half that in
// bf16) of weights that every stream shares.  Weights stay resident in the
// 50 MB L2 across the batch; activations are read once per output.  These
// first versions compute one output element per thread with f32 FMAs:
// consecutive threads take consecutive output channels, so weight reads
// ([K, I, O] layout, O fastest) coalesce and the input row is a warp-wide
// broadcast.  Tensor cores (wgmma), shared-memory tiling, TMA and fusing
// the whole stack into one persistent kernel are later steps.
//
// Every launcher returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// CONV_2D over time (W = 1), VALID, any stride, grouped:
//   out[b, t, o] = bias[o] + sum_k sum_i x[b, t*stride + k, g*I_f + i] * w[k, i, o]
// with g = o / (O / groups).  w is [K, I_f, O]; x is [B, T_in, C_in].
template <typename T>
__device__ __forceinline__ void conv1d_body(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ out, int B, int T_in, int C_in, int T_out, int O, int K,
    int I_f, int stride, int o_per_group) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(B) * T_out * O;
  if (idx >= total) return;
  const int o = static_cast<int>(idx % O);
  const long long bt = idx / O;
  const int t = static_cast<int>(bt % T_out);
  const long long b = bt / T_out;
  const int g = o / o_per_group;
  const T* xb = x + (b * T_in + static_cast<long long>(t) * stride) * C_in
                + static_cast<long long>(g) * I_f;
  float acc = bias != nullptr ? to_f32(bias[o]) : 0.0f;
  for (int k = 0; k < K; ++k) {
    const T* xr = xb + static_cast<long long>(k) * C_in;
    const T* wr = w + static_cast<long long>(k) * I_f * O + o;
    for (int i = 0; i < I_f; ++i) {
      acc = fmaf(to_f32(xr[i]), to_f32(wr[static_cast<long long>(i) * O]), acc);
    }
  }
  out[idx] = from_f32<T>(acc);
}

// DEPTHWISE_CONV_2D over time, VALID, stride 1, dilation d:
//   out[b, t, c] = bias[c] + sum_k x[b, t + k*d, c] * w[k, c]
template <typename T>
__device__ __forceinline__ void depthwise_conv1d_body(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ out, int B, int T_in, int C, int T_out, int K,
    int dilation) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(B) * T_out * C;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % C);
  const long long bt = idx / C;
  const int t = static_cast<int>(bt % T_out);
  const long long b = bt / T_out;
  const T* xr = x + (b * T_in + t) * C + c;
  float acc = bias != nullptr ? to_f32(bias[c]) : 0.0f;
  for (int k = 0; k < K; ++k) {
    acc = fmaf(to_f32(xr[static_cast<long long>(k) * dilation * C]),
               to_f32(w[k * C + c]), acc);
  }
  out[idx] = from_f32<T>(acc);
}

// TRANSPOSE_CONV over time, VALID, stride s (any s; the graphs have s | K):
//   out[b, t, o] = bias[o] + sum over taps k with (t - k) % s == 0 and
//                  0 <= (t - k)/s < T_in of  sum_i x[b, (t-k)/s, i] * w[k, i, o]
// for t < T_out (the declared output, at most (T_in - 1)*s + K rows).
template <typename T>
__device__ __forceinline__ void transpose_conv1d_body(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ out, int B, int T_in, int I, int T_out, int O, int K,
    int stride) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(B) * T_out * O;
  if (idx >= total) return;
  const int o = static_cast<int>(idx % O);
  const long long bt = idx / O;
  const int t = static_cast<int>(bt % T_out);
  const long long b = bt / T_out;
  float acc = bias != nullptr ? to_f32(bias[o]) : 0.0f;
  for (int k = t % stride; k < K && k <= t; k += stride) {
    const int j = (t - k) / stride;
    if (j >= T_in) continue;
    const T* xr = x + (b * T_in + j) * I;
    const T* wr = w + static_cast<long long>(k) * I * O + o;
    for (int i = 0; i < I; ++i) {
      acc = fmaf(to_f32(xr[i]), to_f32(wr[static_cast<long long>(i) * O]), acc);
    }
  }
  out[idx] = from_f32<T>(acc);
}

// One named __global__ per element type, so that a profiler shows which ran.
#define LYRA_CONV_KERNELS(SUFFIX, T)                                           \
  __global__ void conv1d_fwd##SUFFIX(                                          \
      const T* __restrict__ x, const T* __restrict__ w,                        \
      const T* __restrict__ bias, T* __restrict__ out, int B, int T_in,        \
      int C_in, int T_out, int O, int K, int I_f, int stride,                  \
      int o_per_group) {                                                       \
    conv1d_body<T>(x, w, bias, out, B, T_in, C_in, T_out, O, K, I_f, stride,   \
                   o_per_group);                                               \
  }                                                                            \
  __global__ void depthwise_conv1d_fwd##SUFFIX(                                \
      const T* __restrict__ x, const T* __restrict__ w,                        \
      const T* __restrict__ bias, T* __restrict__ out, int B, int T_in, int C, \
      int T_out, int K, int dilation) {                                        \
    depthwise_conv1d_body<T>(x, w, bias, out, B, T_in, C, T_out, K,            \
                             dilation);                                        \
  }                                                                            \
  __global__ void transpose_conv1d_fwd##SUFFIX(                                \
      const T* __restrict__ x, const T* __restrict__ w,                        \
      const T* __restrict__ bias, T* __restrict__ out, int B, int T_in, int I, \
      int T_out, int O, int K, int stride) {                                   \
    transpose_conv1d_body<T>(x, w, bias, out, B, T_in, I, T_out, O, K,         \
                             stride);                                          \
  }

LYRA_CONV_KERNELS(, float)
LYRA_CONV_KERNELS(_bf16, __nv_bfloat16)

#undef LYRA_CONV_KERNELS

}  // namespace

// C launchers, lyra_<kernel>: pointers to the element type of the kernel.
#define LYRA_CONV_LAUNCHERS(SUFFIX, T)                                         \
  int lyra_conv1d_fwd##SUFFIX(const T* x, const T* w, const T* bias, T* out,   \
                              int B, int T_in, int C_in, int T_out, int O,     \
                              int K, int I_f, int stride, int groups,          \
                              void* stream) {                                  \
    long long total = static_cast<long long>(B) * T_out * O;                   \
    if (total > 0) {                                                           \
      conv1d_fwd##SUFFIX<<<blocks_for(total), kThreads, 0,                     \
                           static_cast<cudaStream_t>(stream)>>>(               \
          x, w, bias, out, B, T_in, C_in, T_out, O, K, I_f, stride,            \
          O / groups);                                                         \
    }                                                                          \
    return static_cast<int>(cudaGetLastError());                               \
  }                                                                            \
  int lyra_depthwise_conv1d_fwd##SUFFIX(const T* x, const T* w, const T* bias, \
                                        T* out, int B, int T_in, int C,        \
                                        int T_out, int K, int dilation,        \
                                        void* stream) {                        \
    long long total = static_cast<long long>(B) * T_out * C;                   \
    if (total > 0) {                                                           \
      depthwise_conv1d_fwd##SUFFIX<<<blocks_for(total), kThreads, 0,           \
                                     static_cast<cudaStream_t>(stream)>>>(     \
          x, w, bias, out, B, T_in, C, T_out, K, dilation);                    \
    }                                                                          \
    return static_cast<int>(cudaGetLastError());                               \
  }                                                                            \
  int lyra_transpose_conv1d_fwd##SUFFIX(const T* x, const T* w, const T* bias, \
                                        T* out, int B, int T_in, int I,        \
                                        int T_out, int O, int K, int stride,   \
                                        void* stream) {                        \
    long long total = static_cast<long long>(B) * T_out * O;                   \
    if (total > 0) {                                                           \
      transpose_conv1d_fwd##SUFFIX<<<blocks_for(total), kThreads, 0,           \
                                     static_cast<cudaStream_t>(stream)>>>(     \
          x, w, bias, out, B, T_in, I, T_out, O, K, stride);                   \
    }                                                                          \
    return static_cast<int>(cudaGetLastError());                               \
  }

extern "C" {

LYRA_CONV_LAUNCHERS(, float)
LYRA_CONV_LAUNCHERS(_bf16, __nv_bfloat16)

}  // extern "C"

#undef LYRA_CONV_LAUNCHERS
