// RVQ encode search on Hopper: the residual vector quantizer's sequential
// stages for one stream per warp.
//
// Replaces the Pallas kernel lyra_tpu/ops/rvq_kernel.py
// (RvqEncodeKernel._build, inner `kernel`), which ran all 46 stages for a
// block of 4,096 streams with the codebooks held in VMEM.  Same math as
// ResidualVectorQuantizer.quantize(method="fast"): per stage,
//   idx = argmin_k ||c_k||^2 - 2 r.c_k   (lowest k on ties, as jnp.argmin)
//   r  -= c_idx
//
// What bounds it on an H100: a stream is a 46-deep chain of tiny dependent
// steps (16 dot products of 64 floats, an argmin, a subtract), so it is
// latency-bound per stream and needs many streams in flight.  One warp per
// stream keeps the 64-float residual in registers (two floats per lane);
// each of the 16 dots is a warp-shuffle butterfly, whose xor pattern leaves
// the identical sum in every lane, so the argmin is warp-uniform without a
// broadcast.  The codebooks (46x16x64 f32 = 188,416 B) and ||c||^2 are read
// through L1/L2, where every warp of the batch reuses them; staging them in
// shared memory would need the full 227 KB opt-in and allow one block per
// SM.  Only `run_stages` stages run (the Pallas kernel always ran all 46).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFeatures = 64;
constexpr int kCodes = 16;
constexpr int kThreads = 256;  // 8 streams per block

__global__ void rvq_encode(const float* __restrict__ feats,
                           const float* __restrict__ cb,
                           const float* __restrict__ c2,
                           int* __restrict__ out, int B, int run_stages) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= B) return;  // whole warps exit together
  float r0 = feats[warp * kFeatures + lane];
  float r1 = feats[warp * kFeatures + 32 + lane];
  for (int s = 0; s < run_stages; ++s) {
    const float* cbs = cb + static_cast<long long>(s) * kCodes * kFeatures;
    float best = INFINITY;
    int best_k = 0;
    for (int k = 0; k < kCodes; ++k) {
      float d = r0 * cbs[k * kFeatures + lane]
                + r1 * cbs[k * kFeatures + 32 + lane];
      for (int off = 16; off > 0; off >>= 1) {
        d += __shfl_xor_sync(0xffffffffu, d, off);
      }
      const float score = c2[s * kCodes + k] - 2.0f * d;
      if (score < best) {
        best = score;
        best_k = k;
      }
    }
    r0 -= cbs[best_k * kFeatures + lane];
    r1 -= cbs[best_k * kFeatures + 32 + lane];
    if (lane == 0) out[warp * run_stages + s] = best_k;
  }
}

}  // namespace

extern "C" int lyra_rvq_encode(const float* feats, const float* cb,
                               const float* c2, int* out, int B,
                               int run_stages, void* stream) {
  if (B > 0 && run_stages > 0) {
    const long long threads = static_cast<long long>(B) * 32;
    const unsigned int blocks =
        static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
    rvq_encode<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        feats, cb, c2, out, B, run_stages);
  }
  return static_cast<int>(cudaGetLastError());
}
