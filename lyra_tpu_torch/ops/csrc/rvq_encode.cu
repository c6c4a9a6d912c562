// RVQ encode search (kernel K2) on Hopper: the residual vector quantizer's
// sequential stages, one warp per stream, its lanes over (codeword, half of
// the features).
//
// Replaces the Pallas kernel lyra_tpu/ops/rvq_kernel.py
// (RvqEncodeKernel._build, inner `kernel`), which ran all 46 stages for a
// block of 4,096 streams with the codebooks held in VMEM.  Same math as
// ResidualVectorQuantizer.quantize(method="fast"): per stage,
//   idx = argmin_k ||c_k||^2 - 2 r.c_k   (lowest k on ties, as torch.argmin)
//   r  -= c_idx
//
// What bounds it on an H100: not its operations (1.5 µs of FP32 at B=1024)
// but the stage chain (stage s+1 needs stage s's argmin): a warp issues in
// order, so each stage costs the latency of its dot, join, warp reduction,
// ballot and dependent shared-memory reads in turn.  At B=1024 each SM
// runs 8 such warps, which also contend for issue slots and shared-memory
// bandwidth.  The design:
//
// * Lane map.  Lane 2k + h owns codeword k and feature half h: it keeps its
//   half of the stream's residual in registers (the 16 lanes of a half hold
//   the same copy) and forms the 32-term partial dot with codeword k's
//   half; one __shfl_xor_sync(1) joins the halves (a + b = b + a, so both
//   lanes of a code hold the same dot).  Chosen over a thread per (stream,
//   code) with the residual in shared memory: here the residual never
//   leaves registers and a stage's warp-level work is one shuffle, one
//   reduction and one ballot (the PR 1 kernel did 16 five-step butterflies).
// * Argmin.  score = c2[k] − 2·d (one fmaf; 2·d is exact, so the same bits
//   as c2 − 2·d).  The score + 0.0f (−0 → +0) maps to an unsigned key in
//   the floats' order; __reduce_min_sync takes the least key of the warp
//   and the lowest set bit of __ballot_sync(key == least) among the even
//   lanes is the lowest k with the least score: torch.argmin's tie rule.
//   (NaN scores are not ordered as torch orders them: finite inputs only.)
// * Codebooks in shared memory, loaded together.  One thread issues a bulk
//   copy (TMA, cp.async.bulk) of each stage's 4 KB slice and one of all the
//   ||c||^2 rows, all at the start, each counted on its stage's mbarrier;
//   a warp waits only for the stage it is about to run, so the copies run
//   under the compute, and the kernel takes the same time whether or not
//   the codebooks are in L2.  Copies issued by the compute threads
//   themselves (16-byte cp.async) held those threads back until most had
//   been issued, and bulk copies of single 128-byte rows were slower
//   still: both measured.  One block per SM (46 stages = 191,728 B with c2
//   and the barriers).
// * Conflict-free reads of the natural layout.  Row 2k + h of a slice is
//   codeword k's half h, 128 bytes, its 16-byte chunk c in bank group c.
//   Register slot t of a lane holds chunk t ^ m, m = lane & 7, of its row
//   (and of the residual), so the 8 lanes of a quarter-warp read 8 bank
//   groups, in the dot and in the update (rows 2·idx and 2·idx + 1).  The
//   32 products (__fmul_rn, never merged into an fma) are summed per float
//   of a chunk by a balanced tree over slots (0,1), (2,3), ..., which under
//   t ^ m pairs the same chunks in every lane: with commutative adds every
//   lane's dot has the same bits, so equal codewords tie exactly.  The next
//   stage's row is loaded before the residual update, ahead of its dot.
// * Filling the card.  A block holds W = ceil(B / SMs) warps, at most 16,
//   and the grid min(ceil(B / W), SMs) blocks; warp w of block g takes
//   streams g·W + w, + G·W, ... (rvq_plan below, exported as
//   lyra_rvq_plan; ops/rvq_kernel.py:rvq_plan is the same rule).  At
//   B=1024 on 132 SMs that is 128 blocks of 8 warps; a larger batch loops
//   in each warp, so there is no grid limit and each SM loads the codebooks
//   once per call: at most 132 × 188 KB of L2 reads however large B is
//   (more streams per block bound that traffic here, not a cluster
//   multicast).
// * Exactness.  f32 throughout, no tensor cores; the residual update is the
//   plain version's f32 subtraction, so only the dot's summation order
//   differs from it and a row can differ only at a near-tie.  Stages are
//   computed alike whatever run_stages is, and two launches give the same
//   bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeatures = 64;
constexpr int kCodes = 16;
constexpr int kHalf = kFeatures / 2;              // features per lane
constexpr int kChunks = kHalf / 4;                // 16-byte chunks per lane
constexpr int kSliceBytes = kCodes * kFeatures * 4;  // a stage's codewords
constexpr int kStageBytes = kSliceBytes + kCodes * 4 + 8;  // + c2, mbarrier
constexpr int kMaxWarps = 16;
constexpr int kMaxStages = 232448 / kStageBytes;  // 55: the opt-in limit

struct Plan {
  int warps, blocks, smem;
};

Plan rvq_plan(int B, int run_stages, int sms) {
  Plan p;
  p.warps = (B + sms - 1) / sms;
  p.warps = p.warps < 1 ? 1 : (p.warps > kMaxWarps ? kMaxWarps : p.warps);
  p.blocks = (B + p.warps - 1) / p.warps;
  p.blocks = p.blocks < sms ? p.blocks : sms;
  p.smem = run_stages * kStageBytes;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits until the barrier's first phase (parity 0) has completed.
__device__ __forceinline__ void wait_stage(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(0u)
        : "memory");
  } while (!done);
}

// One bulk copy (TMA) of `bytes` from global to shared memory, counted on
// the barrier `bar` when it lands.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Unsigned key in the order of the floats (after −0 → +0).
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Slot t of a lane's row: chunk t ^ m of the 128-byte row at `row`.
__device__ __forceinline__ void load_row(float4 (&c)[kChunks],
                                         const float* row, int m) {
  const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int t = 0; t < kChunks; ++t) c[t] = v[t ^ m];
}

// Sum of 8 slots as a balanced tree over slot pairs (0,1), (2,3), ...
// then quads: with slot t holding chunk t ^ m the tree pairs the same
// chunks for every m, so the sum (commutative at each node) has the same
// bits in every lane.
__device__ __forceinline__ float tree8(const float (&v)[kChunks]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    rvq_encode(const float* __restrict__ feats, const float* __restrict__ cb,
               const float* __restrict__ c2, int* __restrict__ out, int B,
               int run_stages) {
  extern __shared__ __align__(128) char smem[];
  // [S] codeword slices as in global memory, [S][16] c2, [S] mbarriers.
  const float* slices = reinterpret_cast<const float*>(smem);
  const float* c2s = slices + run_stages * (kSliceBytes / 4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + run_stages * (kSliceBytes + kCodes * 4));
  const int tid = threadIdx.x;
  if (tid == 0) {  // one thread arms every stage and issues its copies
    for (int s = 0; s < run_stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_addr(bars + s)),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int s = 0; s < run_stages; ++s) {
      const uint32_t bar = smem_addr(bars + s);
      const uint32_t c2_bytes = s == 0 ? run_stages * kCodes * 4 : 0;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              bar),
          "r"(kSliceBytes + c2_bytes)
          : "memory");
      if (s == 0) {
        bulk_copy(smem + run_stages * kSliceBytes, c2, c2_bytes, bar);
      }
      bulk_copy(smem + s * kSliceBytes, cb + s * (kSliceBytes / 4),
                kSliceBytes, bar);
    }
  }
  __syncthreads();

  // Lane 2k + h: code k, feature half h; row 2k + h of a slice is
  // codeword k's half h.  Slot t holds chunk t ^ m, m = lane & 7, so the
  // eight lanes of a quarter-warp read eight bank groups.
  const int lane = tid & 31, k = lane >> 1, h = lane & 1, m = lane & 7;
  const int warps = blockDim.x >> 5;
  for (long long b = static_cast<long long>(blockIdx.x) * warps + (tid >> 5);
       b < B; b += static_cast<long long>(gridDim.x) * warps) {
    float4 r[kChunks];  // slot t: chunk t ^ m of the residual's half h
    const float* x = feats + b * kFeatures + h * kHalf;
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      const float* v = x + 4 * (t ^ m);
      r[t] = make_float4(__ldg(v), __ldg(v + 1), __ldg(v + 2), __ldg(v + 3));
    }
    float4 cw[kChunks];  // this stage's slots of row (k, h)
    wait_stage(smem_addr(bars));  // at once after the warp's first stream
    load_row(cw, slices + lane * kHalf, m);
    for (int s = 0; s < run_stages; ++s) {
      const float* slice = slices + s * (kSliceBytes / 4);
      float px[kChunks], py[kChunks], pz[kChunks], pw[kChunks];
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        // __fmul_rn: never merged into an fma with the tree's adds
        px[t] = __fmul_rn(r[t].x, cw[t].x);
        py[t] = __fmul_rn(r[t].y, cw[t].y);
        pz[t] = __fmul_rn(r[t].z, cw[t].z);
        pw[t] = __fmul_rn(r[t].w, cw[t].w);
      }
      float d = (tree8(px) + tree8(py)) + (tree8(pz) + tree8(pw));
      d += __shfl_xor_sync(0xffffffffu, d, 1);  // + the other half
      const uint32_t key = order_key(fmaf(-2.0f, d, c2s[s * kCodes + k]));
      const uint32_t least = __reduce_min_sync(0xffffffffu, key);
      const int idx =
          (__ffs(__ballot_sync(0xffffffffu, key == least) & 0x55555555u) -
           1) >> 1;
      if (lane == 0) out[b * run_stages + s] = idx;
      float4 chosen[kChunks];
      load_row(chosen, slice + (2 * idx + h) * kHalf, m);
      if (s + 1 < run_stages) {  // the next stage's row, ahead of its dot
        wait_stage(smem_addr(bars + s + 1));
        load_row(cw, slice + kSliceBytes / 4 + lane * kHalf, m);
      }
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        r[t].x -= chosen[t].x;
        r[t].y -= chosen[t].y;
        r[t].z -= chosen[t].z;
        r[t].w -= chosen[t].w;
      }
    }
  }
}

}  // namespace

// The launch plan for B streams and run_stages stages on `sms` SMs:
// plan[0] warps per block, plan[1] blocks, plan[2] dynamic shared bytes.
extern "C" void lyra_rvq_plan(int B, int run_stages, int sms, int* plan) {
  const Plan p = rvq_plan(B, run_stages, sms);
  plan[0] = p.warps;
  plan[1] = p.blocks;
  plan[2] = p.smem;
}

// features [B, 64], codebooks [S, 16, 64] and c2 [S, 16] f32, contiguous,
// 16-byte aligned codebooks and c2; out [B, run_stages] int32.
extern "C" int lyra_rvq_encode(const float* feats, const float* cb,
                               const float* c2, int* out, int B,
                               int run_stages, void* stream) {
  if (run_stages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && run_stages > 0) {
    // Per device, once: its SM count, and the shared-memory opt-in.
    static int sms_of[64];
    int dev = 0;
    cudaGetDevice(&dev);
    int sms = dev < 64 ? sms_of[dev] : 0;
    if (sms == 0) {
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaFuncSetAttribute(rvq_encode,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxStages * kStageBytes);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess || sms < 1) {
        return static_cast<int>(err != cudaSuccess ? err
                                                   : cudaErrorInvalidDevice);
      }
      if (dev < 64) sms_of[dev] = sms;
    }
    const Plan p = rvq_plan(B, run_stages, sms);
    rvq_encode<<<p.blocks, p.warps * 32, p.smem,
                 static_cast<cudaStream_t>(stream)>>>(feats, cb, c2, out, B,
                                                      run_stages);
  }
  return static_cast<int>(cudaGetLastError());
}
