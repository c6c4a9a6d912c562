// Conv-stack kernels for the streaming SoundStream / LyraGAN core on Hopper.
//
// Replaces the conv lowerings of the Pallas megakernel
// lyra_tpu/ops/fused_stack.py (FusedStackKernel._make_kernel: _conv,
// _depthwise, _tconv; pallas_call built in _build_call).  The Pallas kernel
// ran the whole multi-channel core of a graph for a block of 64 streams in
// VMEM; here each conv op of the core is one launch over channels-last
// [B, T, C] float32 activations, and the elementwise / data-movement ops
// between them stay torch ops (ops/fused_stack.py drives them in graph
// order).
//
// What bounds them on an H100: per 20 ms hop a stream's core is a few
// hundred thousand MACs over ~1 MB (f32, ~5 MB at full width) of weights
// that every stream shares.  Weights stay resident in the 50 MB L2 across
// the batch; activations are read once per output.  These first versions
// compute one output element per thread with f32 FMAs: consecutive
// threads take consecutive output channels, so weight reads ([K, I, O]
// layout, O fastest) coalesce and the input row is a warp-wide broadcast.
// Tensor cores (wgmma), shared-memory tiling, TMA and fusing the whole
// stack into one persistent kernel are later steps.
//
// Every launcher returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

// CONV_2D over time (W = 1), VALID, any stride, grouped:
//   out[b, t, o] = bias[o] + sum_k sum_i x[b, t*stride + k, g*I_f + i] * w[k, i, o]
// with g = o / (O / groups).  w is [K, I_f, O]; x is [B, T_in, C_in].
__global__ void conv1d_fwd(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int B, int T_in,
                           int C_in, int T_out, int O, int K, int I_f,
                           int stride, int o_per_group) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(B) * T_out * O;
  if (idx >= total) return;
  const int o = static_cast<int>(idx % O);
  const long long bt = idx / O;
  const int t = static_cast<int>(bt % T_out);
  const long long b = bt / T_out;
  const int g = o / o_per_group;
  const float* xb = x + (b * T_in + static_cast<long long>(t) * stride) * C_in
                    + static_cast<long long>(g) * I_f;
  float acc = bias != nullptr ? bias[o] : 0.0f;
  for (int k = 0; k < K; ++k) {
    const float* xr = xb + static_cast<long long>(k) * C_in;
    const float* wr = w + static_cast<long long>(k) * I_f * O + o;
    for (int i = 0; i < I_f; ++i) {
      acc = fmaf(xr[i], wr[static_cast<long long>(i) * O], acc);
    }
  }
  out[idx] = acc;
}

// DEPTHWISE_CONV_2D over time, VALID, stride 1, dilation d:
//   out[b, t, c] = bias[c] + sum_k x[b, t + k*d, c] * w[k, c]
__global__ void depthwise_conv1d_fwd(const float* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int B,
                                     int T_in, int C, int T_out, int K,
                                     int dilation) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(B) * T_out * C;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % C);
  const long long bt = idx / C;
  const int t = static_cast<int>(bt % T_out);
  const long long b = bt / T_out;
  const float* xr = x + (b * T_in + t) * C + c;
  float acc = bias != nullptr ? bias[c] : 0.0f;
  for (int k = 0; k < K; ++k) {
    acc = fmaf(xr[static_cast<long long>(k) * dilation * C], w[k * C + c], acc);
  }
  out[idx] = acc;
}

// TRANSPOSE_CONV over time, VALID, stride s (any s; the graphs have s | K):
//   out[b, t, o] = bias[o] + sum over taps k with (t - k) % s == 0 and
//                  0 <= (t - k)/s < T_in of  sum_i x[b, (t-k)/s, i] * w[k, i, o]
// for t < T_out (the declared output, at most (T_in - 1)*s + K rows).
__global__ void transpose_conv1d_fwd(const float* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int B,
                                     int T_in, int I, int T_out, int O,
                                     int K, int stride) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(B) * T_out * O;
  if (idx >= total) return;
  const int o = static_cast<int>(idx % O);
  const long long bt = idx / O;
  const int t = static_cast<int>(bt % T_out);
  const long long b = bt / T_out;
  float acc = bias != nullptr ? bias[o] : 0.0f;
  for (int k = t % stride; k < K && k <= t; k += stride) {
    const int j = (t - k) / stride;
    if (j >= T_in) continue;
    const float* xr = x + (b * T_in + j) * I;
    const float* wr = w + static_cast<long long>(k) * I * O + o;
    for (int i = 0; i < I; ++i) {
      acc = fmaf(xr[i], wr[static_cast<long long>(i) * O], acc);
    }
  }
  out[idx] = acc;
}

}  // namespace

extern "C" {

int lyra_conv1d_fwd(const float* x, const float* w, const float* bias,
                    float* out, int B, int T_in, int C_in, int T_out, int O,
                    int K, int I_f, int stride, int groups, void* stream) {
  long long total = static_cast<long long>(B) * T_out * O;
  if (total > 0) {
    conv1d_fwd<<<blocks_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        x, w, bias, out, B, T_in, C_in, T_out, O, K, I_f, stride, O / groups);
  }
  return static_cast<int>(cudaGetLastError());
}

int lyra_depthwise_conv1d_fwd(const float* x, const float* w,
                              const float* bias, float* out, int B, int T_in,
                              int C, int T_out, int K, int dilation,
                              void* stream) {
  long long total = static_cast<long long>(B) * T_out * C;
  if (total > 0) {
    depthwise_conv1d_fwd<<<blocks_for(total), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        x, w, bias, out, B, T_in, C, T_out, K, dilation);
  }
  return static_cast<int>(cudaGetLastError());
}

int lyra_transpose_conv1d_fwd(const float* x, const float* w,
                              const float* bias, float* out, int B, int T_in,
                              int I, int T_out, int O, int K, int stride,
                              void* stream) {
  long long total = static_cast<long long>(B) * T_out * O;
  if (total > 0) {
    transpose_conv1d_fwd<<<blocks_for(total), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        x, w, bias, out, B, T_in, I, T_out, O, K, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
