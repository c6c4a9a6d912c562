// Conv-stack kernels for the streaming SoundStream / LyraGAN core on Hopper.
//
// Replaces the conv lowerings of the Pallas megakernel
// lyra_tpu/ops/fused_stack.py (FusedStackKernel._make_kernel: _conv,
// _depthwise, _tconv; pallas_call built in _build_call, fused_stack.py:488).
// The Pallas kernel ran the whole multi-channel core of a graph for a block
// of 64 streams in VMEM; here each conv op of the core is one launch over
// channels-last [B, T, C] activations, and the elementwise / data-movement
// ops between them stay torch ops (ops/fused_stack.py drives them in graph
// order).
//
// Two element types: float32 (conv1d_fwd, depthwise_conv1d_fwd,
// transpose_conv1d_fwd) and bfloat16 (the *_bf16 kernels), the Pallas
// kernel's default mode.  In bf16, x, w and bias are __nv_bfloat16; every
// product is accumulated in f32, the bias is added in f32 from its
// bf16-rounded value (as `wv(bias).astype(f32)` in the Pallas kernel), and
// the result is rounded to bf16 once, on store (__float2bfloat16_rn).  The
// Pallas _depthwise sums its K taps in bf16 (fused_stack.py:742-745); this
// depthwise kernel sums them in f32, which is at least as exact.
//
// f32 kernels and the depthwise kernels: one output element per thread with
// f32 FMAs; consecutive threads take consecutive output channels, so weight
// reads ([K, I, O] layout, O fastest) coalesce and the input row is a
// warp-wide broadcast.  Weights stay resident in the 50 MB L2 across the
// batch.
//
// bf16 conv1d and transpose conv: tensor-core implicit GEMMs.  The scalar
// design above ran them bound by instruction throughput, not by bytes or FLOPs:
// every FMA cost two 2-byte loads and two bf16→f32 conversions plus index
// arithmetic, and nothing was reused (each of the B·T_out·O threads re-read
// its whole K·I_f weight column and input window).  Per hop of the
// full-width fixture at B=1024, the 43 conv1d calls are 13.65 GFLOP and
// 178 MB of activations in + out, the 7 transpose convs 3.04 GFLOP and
// 33 MB; the scalar kernels took 2.653 and 0.638 ms on an NVIDIA H100 80GB
// HBM3 at 700 W (cuDNN's bf16 path: 2.074 and 0.327 ms).
//   * conv1d, per group g (grid z):  out[m, n] = Σ_r A[m, r] · W[r, n] with
//     m = (b, t), n < O/groups, r = (k, i) < K·I_f,
//     A[m, r] = x[b, t·s + k, g·I_f + i] (for groups = 1 row m is the
//     contiguous span of K·C_in elements at x + (b·T_in + t·s)·C_in; no
//     im2col buffer), W[r, n] = w[k, i, g·O_g + n] (the [K, I_f, O] layout
//     is already [R, O] row-major).
//   * transpose conv, per output phase p = blockIdx.z < s (the Pallas _tconv
//     per-phase matmuls, fused_stack.py:764-781, as a gather: no atomics):
//     output rows t = j·s + p < t_out, taps a < q_p = ceil((K − p)/s),
//     A[(b, j), (a, i)] = x[b, j − a, i] (zero outside [0, T_in)),
//     W[(a, i), n] = w[p + a·s, i, n].  q_p also covers s ∤ K.
//   * Main loop: a 3-stage ring of A (BM × 32) and B (32 × BN) tiles in
//     shared memory filled by cp.async (16 B, .cg; rows and reduction
//     columns out of range are zero-filled through the src-size operand),
//     ldmatrix for A and ldmatrix.trans for the row-major B tile, and
//     mma.sync m16n8k16 bf16 → f32 on 4 warps.  Rows are padded by 16 B so
//     the 8 row addresses of an ldmatrix hit distinct banks.  Where C_in,
//     I_f or O/groups is not a multiple of 8 (the small fixture's grouped
//     pointwise convs, I_f = 2) the same tiles are filled with predicated
//     scalar loads instead; the reduction is padded to 32 with zeros.
//   * Epilogue: f32 accumulator + f32(bias), one rounding to bf16, staged
//     through shared memory and written as 16-byte row chunks (scalar,
//     predicated stores where O/groups is not a multiple of 8).
//   * Tile: chosen per call on the host (lyra_conv_gemm_tile; mirrored by
//     conv_stack.py:gemm_tile, which the tests pin) from five instantiations:
//     the widest of BM × BN ∈ {128×64, 64×64, 32×32} (O/groups > 32),
//     {64×32, 32×32} (> 16) or {64×16} that still fills one wave, 132
//     blocks (one per SM of an H100 SXM), else the smallest.  Smaller tiles
//     past one wave only re-read A and B: a sweep of all five tiles over
//     the full fixture's calls at B=1024 (NVIDIA H100 80GB HBM3, 700 W)
//     took 485 µs of device time per hop with a two-wave target where the
//     fastest tile of each call sums to 434 µs; this rule picks a tile
//     within 0.3 µs of the fastest for every call but one transpose conv
//     (1.5 µs).  The small-M calls at B=1024 (M = 1024 rows for LyraGAN's T_out = 1
//     convs) take 32×32 tiles: 32 row tiles × 8 column tiles = 256 blocks
//     for O = 256.  All tiles stay under 48 KB of static shared memory
//     (44,544 B at 128×64).
//     No split-K: each output is one block's sum in a fixed order, so the
//     result is bitwise the same from run to run.
//   With the instruction bound gone, the floor per hop is bytes (53 + 10 µs
//   at 3.35 TB/s) and the launch latency of 50 calls; the tensor-core work
//   is about 14 + 3 µs at the bf16 peak.  mma.sync rather than wgmma + TMA:
//   the rate of the tensor cores is not the bound at these shapes, its
//   operand layouts are simpler, and TMA's tiled mode does not express the
//   overlapping strided windows of the implicit GEMM; wgmma, TMA and a
//   persistent grid belong to the whole-stack kernel.
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

// One named __global__ per kernel and element type, so that a profiler
// shows which ran.
__global__ void conv1d_fwd(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int B, int T_in, int C_in,
                           int T_out, int O, int K, int I_f, int stride,
                           int o_per_group) {
  conv1d_body<float>(x, w, bias, out, B, T_in, C_in, T_out, O, K, I_f, stride,
                     o_per_group);
}

__global__ void transpose_conv1d_fwd(const float* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int B, int T_in,
                                     int I, int T_out, int O, int K,
                                     int stride) {
  transpose_conv1d_body<float>(x, w, bias, out, B, T_in, I, T_out, O, K,
                               stride);
}

#define LYRA_DEPTHWISE_KERNEL(SUFFIX, T)                                       \
  __global__ void depthwise_conv1d_fwd##SUFFIX(                                \
      const T* __restrict__ x, const T* __restrict__ w,                        \
      const T* __restrict__ bias, T* __restrict__ out, int B, int T_in, int C, \
      int T_out, int K, int dilation) {                                        \
    depthwise_conv1d_body<T>(x, w, bias, out, B, T_in, C, T_out, K,            \
                             dilation);                                        \
  }

LYRA_DEPTHWISE_KERNEL(, float)
LYRA_DEPTHWISE_KERNEL(_bf16, __nv_bfloat16)

#undef LYRA_DEPTHWISE_KERNEL

// -- bf16 implicit GEMM (conv1d_fwd_bf16, transpose_conv1d_fwd_bf16) ---------

using bf16 = __nv_bfloat16;

constexpr int kGemmThreads = 128;  // 4 warps
constexpr int kBK = 32;            // reduction tile: two m16n8k16 steps
constexpr int kStages = 3;
constexpr int kPad = 8;            // 16 B of row padding against bank conflicts
constexpr int kTargetBlocks = 132;  // one wave on an H100 SXM

// One launch's operands.  For the transpose conv, I_f is its I and N is O.
struct GemmArgs {
  const bf16* x;
  const bf16* w;
  const bf16* bias;
  bf16* out;
  int B, T_in, C_in, T_out, O, K, I_f, stride;
  int N;    // GEMM columns: output channels per group (conv1d) or O
  int vec;  // 16-byte cp.async and stores (C_in, I_f, N multiples of 8)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two n8 B fragments (k 0-15) from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&b0)[2],
                                                  unsigned (&b1)[2],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The implicit GEMM of one (BM × BN) output tile; blockIdx.z is the group
// (conv1d) or the output phase (transpose conv).  WM × WN warps, each on a
// (BM/WM) × (BN/WN) sub-tile.
template <int BM, int BN, int WM, int WN, bool TCONV>
__device__ __forceinline__ void gemm_body(const GemmArgs& a) {
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  constexpr int LDA = kBK + kPad, LDB = BN + kPad, LDC = BN + kPad;
  constexpr int A_STAGE = BM * LDA, B_STAGE = kBK * LDB;
  constexpr int A_CHUNKS = BM * kBK / 8 / kGemmThreads;  // per thread
  constexpr int B_ALL = kBK * BN / 8;                    // per tile
  static_assert(WM * WN * 32 == kGemmThreads, "4 warps");
  static_assert(MI >= 1 && NI % 2 == 0 && A_CHUNKS >= 1, "tile shape");
  static_assert(BM * LDC <= kStages * A_STAGE, "C tile fits the A ring");
  __shared__ __align__(16) bf16 smem[kStages * (A_STAGE + B_STAGE)];
  bf16* const As = smem;
  bf16* const Bs = smem + kStages * A_STAGE;

  const int z = blockIdx.z, s = a.stride, N = a.N;
  int M, R, J = 0;
  if (TCONV) {
    J = a.T_out > z ? (a.T_out - z + s - 1) / s : 0;  // rows t = j·s + z
    const int q = a.K > z ? (a.K - z + s - 1) / s : 0;  // taps k = z + a·s
    M = a.B * J;
    R = q * a.I_f;
  } else {
    M = a.B * a.T_out;
    R = a.K * a.I_f;
  }
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (m0 >= M) return;  // a phase with fewer rows than phase 0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;

  // This thread's A rows (fixed over the reduction) and its 8 columns.
  const int a_col = (tid & 3) * 8;
  long long a_base[A_CHUNKS];
  int a_j[A_CHUNKS];  // transpose conv: the row's j; -1 marks m >= M
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int m = m0 + (tid >> 2) + c * (kGemmThreads / 4);
    a_base[c] = 0;
    a_j[c] = -1;
    if (m >= M) continue;
    if (TCONV) {
      const int b = m / J, j = m - b * J;
      a_base[c] = (static_cast<long long>(b) * a.T_in + j) * a.I_f;
      a_j[c] = j;
    } else {
      const int b = m / a.T_out, t = m - b * a.T_out;
      a_base[c] = (static_cast<long long>(b) * a.T_in +
                   static_cast<long long>(t) * s) * a.C_in +
                  static_cast<long long>(z) * a.I_f;
      a_j[c] = 0;
    }
  }
  // Address of A[row of chunk c, r], or nullptr where it is zero.
  auto a_src = [&](int c, int r) -> const bf16* {
    if (a_j[c] < 0 || r >= R) return nullptr;
    const int k = r / a.I_f, i = r - k * a.I_f;
    if (TCONV) {
      const int t_in = a_j[c] - k;
      if (t_in < 0 || t_in >= a.T_in) return nullptr;
      return a.x + a_base[c] - static_cast<long long>(k) * a.I_f + i;
    }
    return a.x + a_base[c] + static_cast<long long>(k) * a.C_in + i;
  };
  // Address of W[r, n0 + n], or nullptr where it is zero.
  auto b_src = [&](int r, int n) -> const bf16* {
    if (r >= R || n >= N) return nullptr;
    if (TCONV) {
      const int tap = r / a.I_f, i = r - tap * a.I_f;
      return a.w + (static_cast<long long>(z + tap * s) * a.I_f + i) * a.O + n;
    }
    return a.w + static_cast<long long>(r) * a.O +
           static_cast<long long>(z) * N + n;
  };
  const bf16 zero = __ushort_as_bfloat16(0);
  auto load_tile = [&](int kt, int stage) {
    const int r0 = kt * kBK;
    bf16* const as = As + stage * A_STAGE;
    bf16* const bs = Bs + stage * B_STAGE;
    for (int c = 0; c < A_CHUNKS; ++c) {
      bf16* dst = as + ((tid >> 2) + c * (kGemmThreads / 4)) * LDA + a_col;
      if (a.vec) {
        const bf16* src = a_src(c, r0 + a_col);
        cp_async16(dst, src != nullptr ? src : a.x, src != nullptr);
      } else {
        for (int e = 0; e < 8; ++e) {
          const bf16* src = a_src(c, r0 + a_col + e);
          dst[e] = src != nullptr ? *src : zero;
        }
      }
    }
    for (int idx = tid; idx < B_ALL; idx += kGemmThreads) {
      const int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
      bf16* dst = bs + row * LDB + col;
      if (a.vec) {
        const bf16* src = b_src(r0 + row, n0 + col);
        cp_async16(dst, src != nullptr ? src : a.w, src != nullptr);
      } else {
        for (int e = 0; e < 8; ++e) {
          const bf16* src = b_src(r0 + row, n0 + col + e);
          dst[e] = src != nullptr ? *src : zero;
        }
      }
    }
  };

  float acc[MI][NI][4];
  for (int mi = 0; mi < MI; ++mi)
    for (int ni = 0; ni < NI; ++ni)
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const int KT = (R + kBK - 1) / kBK;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_tile(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... and tile kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < KT) load_tile(next, next % kStages);
    cp_async_commit();
    const bf16* as = As + (kt % kStages) * A_STAGE;
    const bf16* bs = Bs + (kt % kStages) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[MI][4], bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], as + (wm * WTM + mi * 16 + (lane & 15)) * LDA +
                                kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj)
        ldmatrix_x4_trans(bfr[2 * nj], bfr[2 * nj + 1],
                          bs + (kk + (lane & 15)) * LDB + wn * WTN + nj * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }

  // Epilogue: + f32(bias), one rounding, staged in shared memory as rows.
  cp_async_wait<0>();
  __syncthreads();
  bf16* const cs = smem;
  const int bias_off = TCONV ? 0 : z * N;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = wn * WTN + ni * 8 + (lane & 3) * 2;
    const int n = n0 + col;
    float b0 = 0.0f, b1 = 0.0f;
    if (a.bias != nullptr) {
      if (n < N) b0 = __bfloat162float(a.bias[bias_off + n]);
      if (n + 1 < N) b1 = __bfloat162float(a.bias[bias_off + n + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int row = wm * WTM + mi * 16 + (lane >> 2);
      *reinterpret_cast<__nv_bfloat162*>(cs + row * LDC + col) =
          __floats2bfloat162_rn(acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(cs + (row + 8) * LDC + col) =
          __floats2bfloat162_rn(acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * BN / 8; idx += kGemmThreads) {
    const int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
    const int m = m0 + row, n = n0 + col;
    if (m >= M || n >= N) continue;
    bf16* dst;
    if (TCONV) {
      const int b = m / J, j = m - b * J;
      dst = a.out + (static_cast<long long>(b) * a.T_out + j * s + z) * a.O + n;
    } else {
      dst = a.out + static_cast<long long>(m) * a.O + bias_off + n;
    }
    const bf16* src = cs + row * LDC + col;
    if (a.vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(kGemmThreads)
    conv1d_fwd_bf16(const GemmArgs a) {
  gemm_body<BM, BN, WM, WN, false>(a);
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(kGemmThreads)
    transpose_conv1d_fwd_bf16(const GemmArgs a) {
  gemm_body<BM, BN, WM, WN, true>(a);
}

// The instantiated tiles, (BM, BN), in conv_stack.py:GEMM_TILES's order.
constexpr int kTileBM[] = {128, 64, 64, 32, 64};
constexpr int kTileBN[] = {64, 64, 32, 32, 16};

template <int BM, int BN, int WM, int WN, bool TCONV>
int launch_gemm(const GemmArgs& a, int M, int z, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (a.N + BN - 1) / BN, z);
  if (TCONV) {
    transpose_conv1d_fwd_bf16<BM, BN, WM, WN>
        <<<grid, kGemmThreads, 0, stream>>>(a);
  } else {
    conv1d_fwd_bf16<BM, BN, WM, WN><<<grid, kGemmThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Index into kTileBM/kTileBN of the tile for a GEMM of M rows, N columns
// and z groups or phases (conv_stack.py:gemm_tile is the same rule).
int gemm_tile(int M, int N, int z) {
  static const int wide[] = {0, 1, 3}, mid[] = {2, 3}, narrow[] = {4};
  const int* cand = N > 32 ? wide : N > 16 ? mid : narrow;
  const int n_cand = N > 32 ? 3 : N > 16 ? 2 : 1;
  for (int c = 0; c < n_cand; ++c) {
    const int bm = kTileBM[cand[c]], bn = kTileBN[cand[c]];
    const long long blocks = static_cast<long long>((M + bm - 1) / bm) *
                             ((N + bn - 1) / bn) * z;
    if (blocks >= kTargetBlocks) return cand[c];
  }
  return cand[n_cand - 1];
}

template <bool TCONV>
int launch_gemm_tiled(const GemmArgs& a, int M, int z, void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gemm_tile(M, a.N, z)) {
    case 0: return launch_gemm<128, 64, 2, 2, TCONV>(a, M, z, st);
    case 1: return launch_gemm<64, 64, 2, 2, TCONV>(a, M, z, st);
    case 2: return launch_gemm<64, 32, 2, 2, TCONV>(a, M, z, st);
    case 3: return launch_gemm<32, 32, 2, 2, TCONV>(a, M, z, st);
    default: return launch_gemm<64, 16, 4, 1, TCONV>(a, M, z, st);
  }
}

}  // namespace

// C launchers, lyra_<kernel>: pointers to the element type of the kernel.
extern "C" {

int lyra_conv_gemm_tile(int M, int N, int z) { return gemm_tile(M, N, z); }

int lyra_conv1d_fwd(const float* x, const float* w, const float* bias,
                    float* out, int B, int T_in, int C_in, int T_out, int O,
                    int K, int I_f, int stride, int groups, void* stream) {
  long long total = static_cast<long long>(B) * T_out * O;
  if (total > 0) {
    conv1d_fwd<<<blocks_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        x, w, bias, out, B, T_in, C_in, T_out, O, K, I_f, stride,
        O / groups);
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

#define LYRA_DEPTHWISE_LAUNCHER(SUFFIX, T)                                     \
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
  }

LYRA_DEPTHWISE_LAUNCHER(, float)
LYRA_DEPTHWISE_LAUNCHER(_bf16, __nv_bfloat16)

#undef LYRA_DEPTHWISE_LAUNCHER

int lyra_conv1d_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                         const __nv_bfloat16* bias, __nv_bfloat16* out, int B,
                         int T_in, int C_in, int T_out, int O, int K, int I_f,
                         int stride, int groups, void* stream) {
  const int N = O / groups;
  const int vec = I_f % 8 == 0 && N % 8 == 0 && aligned16(x) &&
                  aligned16(w) && aligned16(out);
  const GemmArgs a{x, w, bias, out, B, T_in, C_in, T_out, O, K, I_f, stride,
                   N, vec};
  return launch_gemm_tiled<false>(a, B * T_out, groups, stream);
}

int lyra_transpose_conv1d_fwd_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* w,
                                   const __nv_bfloat16* bias,
                                   __nv_bfloat16* out, int B, int T_in, int I,
                                   int T_out, int O, int K, int stride,
                                   void* stream) {
  const int vec = I % 8 == 0 && O % 8 == 0 && aligned16(x) && aligned16(w) &&
                  aligned16(out);
  const GemmArgs a{x, w, bias, out, B, T_in, I, T_out, O, K, I, stride, O,
                   vec};
  // Phase 0 has the most output rows: ceil(T_out / stride) per stream.
  return launch_gemm_tiled<true>(a, B * ((T_out + stride - 1) / stride),
                                 stride, stream);
}

}  // extern "C"
