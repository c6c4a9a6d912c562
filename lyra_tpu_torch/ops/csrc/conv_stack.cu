// Conv-stack kernels for the streaming SoundStream / LyraGAN core on Hopper.
//
// Replace the Pallas megakernel lyra_tpu/ops/fused_stack.py
// (FusedStackKernel._make_kernel, pallas_call built in _build_call,
// fused_stack.py:488), which ran the whole multi-channel core of a graph for
// a block of 64 streams in VMEM.  Here each conv op of the core is one
// launch over channels-last [B, T, C] activations, and the launch absorbs
// the graph ops around it (ops/fused_stack.py plans them from the graph's
// dataflow; see "fused operands" below): the state CONCATENATION ahead of
// its input, read from two pointers, a SPLIT's channel offset, LEAKY_RELU
// on load, and on its output the residual ADD/SUB, a transpose conv's
// STRIDED_SLICE crop and LEAKY_RELU; the new state (STRIDED_SLICE →
// ASSIGN_VARIABLE) is a side store of the same launch.  So no other kernel
// runs between the core's first conv and its last.  Each kernel family has
// a template flag FUSED; the FUSED=false instances are the plain convs.  In
// f32 the fused ops apply to the finished sum in the graph's order (with
// __fmul_rn / __fadd_rn, never contracted into an FMA), so a fused launch
// gives the bits of the plain kernel followed by the graph's torch ops.
// One persistent kernel for the whole stack (the Pallas design) is the
// next step.
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
// Depthwise kernels (depthwise_body, one template for both element types):
// a depthwise conv has no reduction across channels, so there is nothing
// for the tensor cores; each output is K = 3 FMAs.  The first design (one
// output per thread, four 64-bit divisions to find it, 3 + 3 scalar loads)
// was bound by instruction issue: the bf16 kernel, half the bytes, took
// the time of the f32 one.  Now a thread owns 16 bytes of channels (4
// floats or 8 bf16; one channel where C or a pointer does not allow it)
// of one phase p < d and computes a run of J outputs t = p + j·d, so a
// window of 3 rows in registers hands each row it loads to all 3 taps;
// the weights and bias stay in registers, and the thread's one division
// splits its x index into phase and channel vector.  Per hop of the
// full-width fixture at B=1024 the 18 calls need 184 MB in f32 (92 in
// bf16: where T_out < d a call reads 3·T_out of its T_in rows).  Timed as
// CUDA-graph replays on an NVIDIA H100 80GB HBM3 at 700 W, LyraGAN's nine
// calls take 3-4 µs each in either element type, a per-call floor: the
// hop is bound by the count of launches more than by its bytes (PERF.md
// §6).
//
// conv1d and transpose conv, both element types: implicit GEMMs.  The
// first design (one output per thread, two global loads per FMA, nothing
// reused) ran them bound by load and instruction issue, not by bytes or
// FLOPs.  Per hop of the full-width fixture at B=1024, the 43 conv1d calls
// are 13.65 GFLOP and the 7 transpose convs 3.04 GFLOP; their activations
// in + out are 357 + 67 MB in f32 (178 + 33 MB in bf16).  On an NVIDIA
// H100 80GB HBM3 at 700 W:
//   * f32: bound by the FP32 pipes (67 TFLOP/s outside the tensor cores):
//     0.204 + 0.045 ms of FFMA per hop, against 0.107 + 0.020 ms of bytes
//     at 3.35 TB/s.  The one-output-per-thread kernels took 2.456 + 0.546
//     ms of device time per tick.  The f32 mode is the port's exactness
//     mode, so the GEMM stays on FFMA (no TF32, no 3xTF32) and keeps the
//     old kernels' order of summation.
//   * bf16: tensor cores (989 TFLOP/s) make the FLOPs cheap (14 + 3 µs);
//     the floor is bytes (53 + 10 µs) and the launch latency of 50 calls.
//     The scalar bf16 kernels took 2.653 + 0.638 ms (cuDNN's bf16 path:
//     2.074 + 0.327 ms).
// The GEMMs:
//   * conv1d, per group g (grid z):  out[m, n] = bias[n] + Σ_r A[m, r] ·
//     W[r, n] with m = (b, t), n < O/groups, r = (k, i) < K·I_f,
//     A[m, r] = x[b, t·s + k, g·I_f + i] (for groups = 1 row m is the
//     contiguous span of K·C_in elements at x + (b·T_in + t·s)·C_in; no
//     im2col buffer), W[r, n] = w[k, i, g·O_g + n] (the [K, I_f, O] layout
//     is already [R, O] row-major).
//   * transpose conv, per output phase p = blockIdx.z < s (the Pallas _tconv
//     per-phase matmuls, fused_stack.py:764-781, as a gather: no atomics):
//     output rows t = j·s + p < t_out, taps a < q_p = ceil((K − p)/s),
//     A[(b, j), (a, i)] = x[b, j − a, i] (zero outside [0, T_in)),
//     W[(a, i), n] = w[p + a·s, i, n].  q_p also covers s ∤ K.
//   * Frame (gemm_body, shared by both element types): a 3-stage ring of
//     A (BM × BK, row-major) and B (BK × BN) tiles in shared memory filled
//     by 16-byte cp.async (.cg; rows and reduction columns out of range are
//     zero-filled through the src-size operand).  Rows are padded by 16 B.
//     Where a 16-byte chunk would straddle a tap or a group (I_f or
//     O/groups not a multiple of 8 bf16 / 4 floats; the small fixture's
//     grouped pointwise convs, I_f = 2) the same tiles are filled with
//     predicated scalar loads instead; the reduction is padded to BK with
//     zeros, which add nothing.
//   * Math policy, a template parameter of the frame:
//       - MmaBf16: BK = 32, 4 warps, ldmatrix for A and ldmatrix.trans for
//         the row-major B tile, mma.sync m16n8k16 bf16 → f32; epilogue
//         + f32(bias), one rounding, staged through shared memory and
//         written as 16-byte row chunks (FUSED: staged unrounded in f32,
//         the output ops applied as the chunks are written, the residual
//         read in 16-byte chunks ahead of the stores, one rounding).
//       - FfmaF32: BK = 16, one thread per TM × TN micro-tile of
//         accumulators in registers: 8 × 4 at 128×64 and 4 × 4 at 64×64
//         (256 threads), 4 × 2 at 64×32 (256) and 32×32 (128), 4 × 1 at
//         64×16 (256).  Per 4 reduction steps a thread reads TM float4 of
//         A (4 consecutive r of each of its rows) and 4 rows of TN floats
//         of B, then issues 4·TM·TN FFMAs: 12 shared-memory loads per 128
//         FFMAs at 8 × 4, against 2 global loads per FFMA before.  At
//         least 3 blocks per SM (launch bound).  Each accumulator starts
//         at f32(bias) and takes r = (k, i) in ascending order with fmaf
//         in one thread — the old kernels' order, so results stay within
//         rounding of them and two launches are bitwise equal.  Outputs go
//         straight from registers to global memory as float4 / float2
//         pieces, a grid row of threads writing consecutive floats (FUSED:
//         through the output ops, the micro-tile's residual loaded first).
//     Per hop it stays well below the FP32 peak (PERF.md §6): most
//     calls are 1-4 k-tiles deep or have few blocks, where the fixed cost
//     of a launch and one block's load latency dominate.  Shared-memory
//     bank conflicts are not what bounds it: layouts without them (A rows
//     of a warp 20 floats apart) ran no faster.
//   * Tile: chosen per call on the host (lyra_conv_gemm_tile, the same rule
//     for both element types; mirrored by conv_stack.py:gemm_tile, which
//     the tests pin) from five instantiations: the widest of BM × BN ∈
//     {128×64, 64×64, 32×32} (O/groups > 32), {64×32, 32×32} (> 16) or
//     {64×16} that still fills one wave, 132 blocks (one per SM of an H100
//     SXM), else the smallest.  Smaller tiles past one wave only re-read A
//     and B: a sweep of all five bf16 tiles over the full fixture's calls at
//     B=1024 (NVIDIA H100 80GB HBM3, 700 W) found this rule within 0.3 µs
//     of the fastest tile for every call but one transpose conv (1.5 µs).
//     The small-M calls at B=1024 (M = 1024 rows for LyraGAN's T_out = 1
//     convs) take 32×32 tiles: 32 row tiles × 8 column tiles = 256 blocks
//     for O = 256.  All tiles stay under 48 KB of static shared memory
//     (44,544 B bf16 and 43,776 B f32 at 128×64).
//     No split-K: each output is one thread's sum in a fixed order, so the
//     result is bitwise the same from run to run.
//   mma.sync rather than wgmma + TMA for bf16: the rate of the tensor cores
//   is not the bound at these shapes, its operand layouts are simpler, and
//   TMA's tiled mode does not express the overlapping strided windows of
//   the implicit GEMM; wgmma, TMA and a persistent grid belong to the
//   whole-stack kernel.
//
// Every launcher returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The fused operands of one launch (see "fused operands" below), the C
// struct every launcher takes; null → the plain kernel.
// ops/conv_stack.py:_FusedOps has the same layout.
struct FusedOps {
  const void* state;
  const void* res;
  void* side;
  int T_s, ld, c_off;
  int res_mode;  // 1 out + res, 2 out − res, 3 res − out
  int crop0;
  int side_begin, side_rows;
  int leaky_in, leaky_res, leaky_out;
  float alpha_in, alpha_res, alpha_out;
};

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// N consecutive floats from / to an address aligned to min(N, 4) floats.
template <int N>
__device__ __forceinline__ void load_floats(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z,
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = p[e];
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = v[e];
  }
}

// N floats to p as bf16, each rounded once: 16-byte stores where N is a
// multiple of 8 (p then 16-byte aligned).
template <int N>
__device__ __forceinline__ void store_floats(bf16* p, const float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      uint4 t;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(v[8 * q + 2 * e], v[8 * q + 2 * e + 1]);
      reinterpret_cast<uint4*>(p)[q] = t;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

// V consecutive elements at p as floats, through the read-only data path:
// one 16-byte load where V elements are 16 bytes (p then 16-byte aligned).
template <int V>
__device__ __forceinline__ void ldg_vec(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __ldg(p + e);
  }
}

template <int V>
__device__ __forceinline__ void ldg_vec(float (&v)[V], const bf16* p) {
  if constexpr (V == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x, v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __bfloat162float(__ldg(p + e));
  }
}

// -- fused operands -------------------------------------------------------------
// The graph ops a conv launch absorbs (ops/fused_stack.py builds the plan):
//   input side   x's rows follow T_s rows of state (CONCATENATION of a
//                READ_VARIABLE with x, read from two pointers of row width
//                ld), the conv reads channels c_off.. of them (SPLIT), and
//                x's rows may pass a LEAKY_RELU on load;
//   output side  on the finished f32 sum (bias included), in this order:
//                the residual (ADD, or SUB either way round, of a tensor in
//                the output's layout, itself through a LEAKY_RELU on load
//                where asked), then a LEAKY_RELU; one rounding after them;
//                a transpose conv writes only the rows [crop0, crop0 +
//                T_out) of its result (STRIDED_SLICE);
//   side store   the new state, rows [side_begin, side_begin + side_rows)
//                of the input (state rows then x rows, x's through the load
//                LEAKY_RELU), STRIDED_SLICE → ASSIGN_VARIABLE.
// The threads of a launch (of a depthwise launch, those of one stream's
// blocks) share the side store before their own work; the new state is a
// buffer of its own, so no thread reads what another writes.

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

// LEAKY_RELU as the executor computes it (x >= 0 ? x : x · alpha) on a
// value held in element type T: the product rounded once to T.
template <typename T>
__device__ __forceinline__ float leaky_stored(float v, float alpha) {
  return v >= 0.0f ? v : to_f32<T>(from_f32<T>(__fmul_rn(v, alpha)));
}

// On an f32 sum before its one rounding.  __fmul_rn / __fadd_rn keep nvcc
// from contracting these into an FMA: the unfused path rounds each op.
__device__ __forceinline__ float leaky_f32(float v, float alpha) {
  return v >= 0.0f ? v : __fmul_rn(v, alpha);
}

// The fused operands in a kernel's element type.
template <typename T>
struct Fused {
  const T* state;
  const T* res;
  T* side;
  int T_s, ld, c_off, res_mode, crop0, side_begin, side_rows, side_vec;
  int leaky_in, leaky_res, leaky_out;
  float alpha_in, alpha_res, alpha_out;

  // A value of an input row as loaded: x's rows (x_row) through the load
  // LEAKY_RELU where asked, state rows as they are.
  __device__ __forceinline__ float in(float v, bool x_row) const {
    return leaky_in && x_row ? leaky_stored<T>(v, alpha_in) : v;
  }

  // The output ops on the finished sum v, r the element of the residual
  // at the same place (if any) as loaded.
  __device__ __forceinline__ float out(float v, float r) const {
    if (res != nullptr) {
      if (leaky_res) r = leaky_stored<T>(r, alpha_res);
      v = res_mode == 1   ? __fadd_rn(v, r)
          : res_mode == 2 ? __fsub_rn(v, r)
                          : __fsub_rn(r, v);
    }
    return leaky_out ? leaky_f32(v, alpha_out) : v;
  }
};

bool aligned16_or_null(const void* p) {
  return p == nullptr || aligned16(p);
}

// Host: the fused operands of a launch in element type T (x: the launch's
// x, whose alignment the side store's 16-byte path needs).
template <typename T>
Fused<T> fused_from(const FusedOps& f, const void* x) {
  constexpr int ch = 16 / sizeof(T);
  Fused<T> u;
  u.state = static_cast<const T*>(f.state);
  u.res = static_cast<const T*>(f.res);
  u.side = static_cast<T*>(f.side);
  u.T_s = f.state != nullptr ? f.T_s : 0;
  u.ld = f.ld;
  u.c_off = f.c_off;
  u.res_mode = f.res_mode;
  u.crop0 = f.crop0;
  u.side_begin = f.side_begin;
  u.side_rows = f.side != nullptr ? f.side_rows : 0;
  u.side_vec = f.ld % ch == 0 && aligned16(x) && aligned16_or_null(f.state) &&
               aligned16_or_null(f.side);
  u.leaky_in = f.leaky_in;
  u.leaky_res = f.leaky_res;
  u.leaky_out = f.leaky_out;
  u.alpha_in = f.alpha_in;
  u.alpha_res = f.alpha_res;
  u.alpha_out = f.alpha_out;
  return u;
}

// The side store: dst[b, r, :] = input row side_begin + r of stream b
// (state rows, then x's through the load LEAKY_RELU), in 16-byte pieces
// where ld and the pointers allow.  The items (row, piece) of rows
// (b − b0)·side_rows + r < n_rows go to the launch's threads in turn:
// thread `tid` of `nthreads` takes items tid, tid + nthreads, ..., found
// by steps (one division per item, for its stream; none with ONE_STREAM:
// the rows of stream b0 alone, n_rows = side_rows), U of them loaded
// before any is stored.  The launchers keep the item count below 2^31.
template <typename T, bool ONE_STREAM>
__device__ void side_store(const Fused<T>& f, const T* x, int T_x, int b0,
                           int n_rows, int tid, int nthreads) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int U = 16 / CH;  // 16 floats in registers
  const int per_row = f.side_vec ? f.ld / CH : f.ld;
  const int drow = nthreads / per_row, dpiece = nthreads - drow * per_row;
  int row = tid / per_row, piece = tid - row * per_row;
  while (row < n_rows) {
    const T* src[U];
    T* dst[U];
    bool x_row[U];
    int n = 0;
    for (; n < U && row < n_rows; ++n) {
      const int b = ONE_STREAM ? b0 : b0 + row / f.side_rows;
      const int r = ONE_STREAM ? row : row - (b - b0) * f.side_rows;
      const int u = f.side_begin + r;
      const int e0 = f.side_vec ? piece * CH : piece;
      x_row[n] = u >= f.T_s;
      src[n] = (x_row[n] ? x + (static_cast<long long>(b) * T_x + u - f.T_s) *
                                   f.ld
                         : f.state + (static_cast<long long>(b) * f.T_s + u) *
                                         f.ld) + e0;
      dst[n] = f.side + (static_cast<long long>(b) * f.side_rows + r) * f.ld +
               e0;
      row += drow;
      piece += dpiece;
      if (piece >= per_row) {
        piece -= per_row;
        ++row;
      }
    }
    float v[U][CH];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (k >= n) break;
      if (f.side_vec) {
        ldg_vec<CH>(v[k], src[k]);
      } else {
        v[k][0] = to_f32<T>(*src[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (k >= n) break;
#pragma unroll
      for (int e = 0; e < CH; ++e) v[k][e] = f.in(v[k][e], x_row[k]);
      if (f.side_vec) {
        store_floats<CH>(dst[k], v[k]);
      } else {
        *dst[k] = from_f32<T>(v[k][0]);
      }
    }
  }
}

// -- depthwise (depthwise_conv1d_fwd*) ----------------------------------------

constexpr int kDwThreads = 256;  // most threads per block
constexpr int kDwTaps = 3;       // the taps of every Lyra depthwise conv
// J, the outputs per thread for K = kDwTaps (other K run J = 1): of the
// constant runs 1, 2, 4 and 8, 2 took the least time over a hop of the
// full-width fixture at B=1024 in both element types (PERF.md §6).
constexpr int kDwRun = 2;
constexpr int kMaxGridYZ = 65535;

// One launch's operands; phases = min(dilation, T_out).  T_in counts the
// state rows of a fused launch too (x holds T_in − T_s rows).
template <typename T>
struct DwArgs {
  const T* x;
  const T* w;
  const T* bias;
  T* out;
  int T_in, C, T_out, K, dilation, phases;
  Fused<T> f;  // read only by the FUSED kernels
};

// DEPTHWISE_CONV_2D over time, VALID, stride 1, dilation d:
//   out[b, t, c] = bias[c] + Σ_k x[b, t + k·d, c] · w[k, c]
// Thread (f, r) of grid layer b = blockIdx.z (the stream), f along x and r
// along y, owns phase p = f / (C/V) < phases and the V channels c = (f mod
// C/V)·V, and computes the run of outputs t = p + (r·J + j)·d < T_out,
// j < J.  Output
// t + d needs rows t + d .. t + K·d, so a window of K rows slides by one
// row per output: a run of n outputs loads n + K − 1 rows, each once.
// Each accumulator starts at f32(bias) and takes k = 0 .. K−1 in order
// with fmaf.  KT is K at compile time; KT = 0 takes K at run time (J = 1,
// weights read per tap).  FUSED: input row u is state row u (u < T_s) or
// x row u − T_s, the latter through the load LEAKY_RELU; each output
// passes the output ops before its store; all threads share the side
// store first (the C = ld channels of a row: a depthwise conv has no
// SPLIT).
template <typename T, int V, int J, int KT, bool FUSED>
__device__ __forceinline__ void depthwise_body(const DwArgs<T>& a) {
  const long long bz = blockIdx.z;
  if constexpr (FUSED) {
    if (a.f.side != nullptr) {  // stream bz's rows, by its blocks' threads
      const int per_block = blockDim.x * blockDim.y;
      side_store<T, true>(
          a.f, a.x, a.T_in - a.f.T_s, blockIdx.z, a.f.side_rows,
          (blockIdx.y * gridDim.x + blockIdx.x) * per_block +
              threadIdx.y * blockDim.x + threadIdx.x,
          gridDim.x * gridDim.y * per_block);
    }
  }
  const int nv = a.C / V;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (f >= a.phases * nv) return;
  const int p = f / nv;  // the thread's one division
  const int c = (f - p * nv) * V;
  const int t = p + r * J * a.dilation;
  if (t >= a.T_out) return;  // also every r past the last run
  const int step = a.dilation * a.C;  // one tap, or one output, further
  const T* x = a.x + bz * a.T_in * a.C + t * a.C + c;
  T* out = a.out + bz * a.T_out * a.C + t * a.C + c;
  // FUSED: offsets of input row 0's channel c in x and in the state, as
  // if row 0 lay in each.
  const long long x0 = (bz * (a.T_in - a.f.T_s) - a.f.T_s) * a.C + c;
  const long long s0 = bz * a.f.T_s * a.C + c;
  // Input row t + m·d (m taps or outputs further) into v.
  auto load = [&](float (&v)[V], int m) {
    if constexpr (FUSED) {
      const int u = t + m * a.dilation;
      const bool x_row = u >= a.f.T_s;
      ldg_vec<V>(v, x_row ? a.x + (x0 + u * a.C) : a.f.state + (s0 + u * a.C));
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = a.f.in(v[e], x_row);
    } else {
      ldg_vec<V>(v, x + m * step);
    }
  };
  // Output t + j·d from its finished sums.
  auto store = [&](float (&acc)[V], int j) {
    if constexpr (FUSED) {
      float rv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) rv[e] = 0.0f;
      if (a.f.res != nullptr) ldg_vec<V>(rv, a.f.res + (out - a.out) + j * step);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = a.f.out(acc[e], rv[e]);
    }
    store_floats<V>(out + j * step, acc);
  };
  float bias[V];
#pragma unroll
  for (int e = 0; e < V; ++e) bias[e] = 0.0f;
  if (a.bias != nullptr) ldg_vec<V>(bias, a.bias + c);

  if constexpr (KT == 0) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = bias[e];
    for (int k = 0; k < a.K; ++k) {
      float xv[V], wv[V];
      load(xv, k);
      ldg_vec<V>(wv, a.w + k * a.C + c);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(xv[e], wv[e], acc[e]);
    }
    store(acc, 0);
  } else {
    int n = 0;  // outputs in this run
#pragma unroll
    for (int j = 0; j < J; ++j) n += t + j * a.dilation < a.T_out;
    float w[KT][V], win[KT][V];
#pragma unroll
    for (int k = 0; k < KT; ++k) ldg_vec<V>(w[k], a.w + k * a.C + c);
#pragma unroll
    for (int k = 0; k + 1 < KT; ++k) load(win[k], k);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < n) load(win[KT - 1], j + KT - 1);
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[e] = bias[e];
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[e] = fmaf(win[k][e], w[k][e], acc[e]);
      }
      if (j < n) store(acc, j);
#pragma unroll
      for (int k = 0; k + 1 < KT; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) win[k][e] = win[k + 1][e];
    }
  }
}

// V channels per thread (16 bytes, or 1), J outputs per run, KT taps;
// FUSED: with the fused operands of DwArgs::f.
template <int V, int J, int KT, bool FUSED>
__global__ void __launch_bounds__(kDwThreads)
    depthwise_conv1d_fwd(const DwArgs<float> a) {
  depthwise_body<float, V, J, KT, FUSED>(a);
}

template <int V, int J, int KT, bool FUSED>
__global__ void __launch_bounds__(kDwThreads)
    depthwise_conv1d_fwd_bf16(const DwArgs<bf16> a) {
  depthwise_body<bf16, V, J, KT, FUSED>(a);
}

template <int V, int J, int KT, bool FUSED>
void launch_dw(const DwArgs<float>& a, dim3 grid, dim3 block,
               cudaStream_t st) {
  depthwise_conv1d_fwd<V, J, KT, FUSED><<<grid, block, 0, st>>>(a);
}

template <int V, int J, int KT, bool FUSED>
void launch_dw(const DwArgs<bf16>& a, dim3 grid, dim3 block,
               cudaStream_t st) {
  depthwise_conv1d_fwd_bf16<V, J, KT, FUSED><<<grid, block, 0, st>>>(a);
}

struct DwPlan {
  int elems;     // V, channels per thread
  int runs;      // J, outputs per thread
  int block[2];  // (phase × channel-vector lanes, runs)
  int grid[3];   // (lane blocks, run blocks, streams)
};

// The launch of a depthwise call of elem_bytes-byte elements
// (conv_stack.py:depthwise_plan is the same rule).  V is 16 bytes of
// channels where C allows it and every operand (x, w, bias, out, and of a
// fused launch its state and residual) is 16-byte aligned, else 1.
// Lanes = (phase, channel vector) pairs; a block takes up to kDwThreads of
// them along x and fills the rest of its kDwThreads with runs along y, so
// a stream with few lanes still makes full blocks, and a warp reads whole
// rows.
DwPlan depthwise_plan(int elem_bytes, int B, int T_out, int C, int K,
                      int dilation, bool aligned) {
  const int ch = 16 / elem_bytes;
  DwPlan plan;
  plan.elems = C % ch == 0 && aligned ? ch : 1;
  plan.runs = K == kDwTaps ? kDwRun : 1;
  const int phases = dilation < T_out ? dilation : T_out;
  const int lanes = phases * (C / plan.elems);
  const int per_phase = (T_out + dilation - 1) / dilation;  // phase 0's
  const int n_runs = (per_phase + plan.runs - 1) / plan.runs;
  plan.block[0] = lanes < kDwThreads ? lanes : kDwThreads;
  plan.block[1] = kDwThreads / plan.block[0];
  if (plan.block[1] > n_runs) plan.block[1] = n_runs;
  plan.grid[0] = (lanes + plan.block[0] - 1) / plan.block[0];
  plan.grid[1] = (n_runs + plan.block[1] - 1) / plan.block[1];
  plan.grid[2] = B;
  return plan;
}

template <typename T, int V, bool FUSED>
int launch_depthwise_v(DwArgs<T> a, const DwPlan& plan, int B,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Streams beyond the grid's z limit go in further launches.
  const int T_x = a.T_in - a.f.T_s;  // x's rows (T_s = 0 unfused)
  for (int b0 = 0; b0 < B; b0 += kMaxGridYZ) {
    const int nb = B - b0 < kMaxGridYZ ? B - b0 : kMaxGridYZ;
    const dim3 grid(plan.grid[0], plan.grid[1], nb);
    const dim3 block(plan.block[0], plan.block[1]);
    if (a.K == kDwTaps)
      launch_dw<V, kDwRun, kDwTaps, FUSED>(a, grid, block, st);
    else
      launch_dw<V, 1, 0, FUSED>(a, grid, block, st);
    a.x += static_cast<long long>(nb) * T_x * a.C;
    a.out += static_cast<long long>(nb) * a.T_out * a.C;
    if (FUSED) {
      if (a.f.state) a.f.state += static_cast<long long>(nb) * a.f.T_s * a.C;
      if (a.f.res) a.f.res += static_cast<long long>(nb) * a.T_out * a.C;
      if (a.f.side) a.f.side += static_cast<long long>(nb) * a.f.side_rows * a.C;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FUSED>
int launch_depthwise_f(const DwArgs<T>& a, const DwPlan& plan, int B,
                       void* stream) {
  constexpr int ch = 16 / sizeof(T);
  if (plan.elems == ch)
    return launch_depthwise_v<T, ch, FUSED>(a, plan, B, stream);
  return launch_depthwise_v<T, 1, FUSED>(a, plan, B, stream);
}

// x holds T_in − T_s rows of a fused launch's input; its depthwise conv
// reads all C = ld channels (no SPLIT) and crops nothing.
template <typename T>
int launch_depthwise(const T* x, const T* w, const T* bias, T* out, int B,
                     int T_in, int C, int T_out, int K, int dilation,
                     const FusedOps* fused, void* stream) {
  if (B <= 0 || T_out <= 0 || C <= 0)
    return static_cast<int>(cudaGetLastError());
  // Offsets inside one stream are 32-bit; so are the run's row offsets.
  if (static_cast<long long>(T_in) * C > 0x7fffffffLL ||
      (T_out + dilation - 1) / dilation > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fused != nullptr &&
      (fused->ld != C || fused->c_off != 0 || fused->crop0 != 0 ||
       (fused->state != nullptr && fused->T_s > T_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int phases = dilation < T_out ? dilation : T_out;
  DwArgs<T> a{x, w, bias, out, T_in, C, T_out, K, dilation, phases, {}};
  bool aligned = aligned16(x) && aligned16(w) && aligned16(out) &&
                 aligned16_or_null(bias);
  if (fused != nullptr) {
    a.f = fused_from<T>(*fused, x);
    aligned = aligned && aligned16_or_null(fused->state) &&
              aligned16_or_null(fused->res);
  }
  const DwPlan plan = depthwise_plan(sizeof(T), B, T_out, C, K, dilation,
                                     aligned);
  if (fused != nullptr) return launch_depthwise_f<T, true>(a, plan, B, stream);
  return launch_depthwise_f<T, false>(a, plan, B, stream);
}

// -- implicit GEMM (conv1d_fwd*, transpose_conv1d_fwd*) -----------------------

constexpr int kStages = 3;
constexpr int kTargetBlocks = 132;  // one wave on an H100 SXM
constexpr int kMmaThreads = 128;    // bf16: 4 warps

// One launch's operands.  For the transpose conv, I_f is its I and N is O.
// A fused launch's T_in counts its state rows too (x holds T_in − T_s),
// and a cropped transpose conv's T_out is the rows it keeps.
template <typename T>
struct GemmArgs {
  const T* x;
  const T* w;
  const T* bias;
  T* out;
  int B, T_in, C_in, T_out, O, K, I_f, stride;
  int N;    // GEMM columns: output channels per group (conv1d) or O
  int vec;  // 16-byte cp.async and stores (I_f, N multiples of 16 B)
  Fused<T> f;  // read only by the FUSED kernels
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

// Eight bf16 of the residual at p (16-byte aligned) as floats.  A plain
// asm load without side effects: the residual is read-only for the whole
// launch, so the compiler may issue it ahead of the tile's stores, which
// it could not prove apart from it.
__device__ __forceinline__ void ld_res_chunk(float (&v)[8], const bf16* p) {
  uint4 u;
  asm("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = __bfloat1622float2(h[q]);
    v[2 * q] = t.x, v[2 * q + 1] = t.y;
  }
}

// Math policy of the bf16 kernels: mma.sync on 4 warps, WM × WN warps each
// on a (BM/WM) × (BN/WN) sub-tile.
template <int BM_, int BN_, int WM, int WN>
struct MmaBf16 {
  using T = bf16;
  static constexpr int BM = BM_, BN = BN_, kThreads = kMmaThreads, BK = 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WM * WN * 32 == kThreads, "4 warps");
  static_assert(MI >= 1 && NI % 2 == 0, "tile shape");

  float acc[MI][NI][4];
  int lane, wm, wn;

  __device__ __forceinline__ void init(const T* /*bias*/, int /*n0*/,
                                       int /*N*/) {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    wm = warp / WN;
    wn = warp % WN;
    for (int mi = 0; mi < MI; ++mi)
      for (int ni = 0; ni < NI; ++ni)
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  }

  // One BK-deep step over the A [BM][LDA] and B [BK][LDB] tiles.
  template <int LDA, int LDB>
  __device__ __forceinline__ void step(const T* as, const T* bs) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
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

  // + f32(bias), one rounding, staged in shared memory (the A ring, free
  // now) as rows, written as 16-byte row chunks at out + row_off(m).
  // FUSED: staged unrounded, in f32, in all of shared memory (SMEM
  // elements); the copy-out applies the output ops, each thread's residual
  // chunks read (16 bytes, coalesced) before its stores, then rounds once.
  template <int A_RING, int SMEM, bool FUSED, class RowOff>
  __device__ __forceinline__ void store(T* cs, const T* bias, int m0, int n0,
                                        int M, int N, bool vec, T* out,
                                        const Fused<T>& f, RowOff row_off) {
    constexpr int LDC = BN + 8;
    static_assert(BM * LDC <= A_RING, "C tile fits the A ring");
    if constexpr (FUSED) {
      this->template store_fused<SMEM>(reinterpret_cast<float*>(cs), bias, m0,
                                       n0, M, N, vec, out, f, row_off);
      return;
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = wn * WTN + ni * 8 + (lane & 3) * 2;
      const int n = n0 + col;
      float b0 = 0.0f, b1 = 0.0f;
      if (bias != nullptr) {
        if (n < N) b0 = __bfloat162float(bias[n]);
        if (n + 1 < N) b1 = __bfloat162float(bias[n + 1]);
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
    for (int idx = threadIdx.x; idx < BM * BN / 8; idx += kThreads) {
      const int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
      const int m = m0 + row, n = n0 + col;
      if (m >= M || n >= N) continue;
      T* dst = out + row_off(m) + n;
      const T* src = cs + row * LDC + col;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
      }
    }
  }

  template <int SMEM, class RowOff>
  __device__ __forceinline__ void store_fused(float* cf, const T* bias, int m0,
                                              int n0, int M, int N, bool vec,
                                              T* out, const Fused<T>& f,
                                              RowOff row_off) {
    constexpr int LDF = BN + 4;                  // floats per staged row
    constexpr int ITER = BM * BN / 8 / kThreads;  // 8-column chunks per thread
    static_assert(BM * LDF * sizeof(float) <= SMEM * sizeof(T) &&
                      ITER * kThreads * 8 == BM * BN,
                  "f32 C tile fits shared memory");
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = wn * WTN + ni * 8 + (lane & 3) * 2;
      const int n = n0 + col;
      float b0 = 0.0f, b1 = 0.0f;
      if (bias != nullptr) {
        if (n < N) b0 = __bfloat162float(bias[n]);
        if (n + 1 < N) b1 = __bfloat162float(bias[n + 1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = wm * WTM + mi * 16 + (lane >> 2);
        *reinterpret_cast<float2*>(cf + row * LDF + col) =
            make_float2(acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
        *reinterpret_cast<float2*>(cf + (row + 8) * LDF + col) =
            make_float2(acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
      }
    }
    __syncthreads();
    float r[ITER][8];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
      const int m = m0 + row, n = n0 + col;
#pragma unroll
      for (int e = 0; e < 8; ++e) r[it][e] = 0.0f;
      if (f.res == nullptr || m >= M || n >= N) continue;
      const T* rp = f.res + row_off(m) + n;
      if (vec) {
        ld_res_chunk(r[it], rp);
      } else {
        for (int e = 0; e < 8 && n + e < N; ++e) r[it][e] = to_f32<T>(rp[e]);
      }
    }
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
      const int m = m0 + row, n = n0 + col;
      if (m >= M || n >= N) continue;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = f.out(cf[row * LDF + col + e], r[it][e]);
      T* dst = out + row_off(m) + n;
      if (vec) {
        store_floats<8>(dst, v);
      } else {
        for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = __float2bfloat16_rn(v[e]);
      }
    }
  }
};

// Math policy of the f32 kernels: FFMA on a GY × GX = (BM/TM) × (BN/TN)
// thread grid (thread ty·GX + tx), each thread a TM × TN micro-tile of
// accumulators in registers: rows ty·TM + i, columns tx·TN + j.
template <int BM_, int BN_, int TM_, int TN_>
struct FfmaF32 {
  using T = float;
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = 16;
  static constexpr int GY = BM / TM, GX = BN / TN, kThreads = GY * GX;
  static_assert(GY * TM == BM && GX * TN == BN && kThreads % 32 == 0 &&
                    (TN <= 2 || TN % 4 == 0),
                "tile shape");

  float acc[TM][TN];
  int ty, tx;

  // Every accumulator starts at f32(bias), as the scalar kernels did.
  __device__ __forceinline__ void init(const T* bias, int n0, int N) {
    ty = threadIdx.x / GX;
    tx = threadIdx.x % GX;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      const float b = bias != nullptr && n < N ? bias[n] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][j] = b;
    }
  }

  // BK reduction steps in ascending r: per 4 steps TM float4 of A (4
  // consecutive r of each of the thread's rows), then per step one row of
  // TN floats of B and TM·TN fmaf.
  template <int LDA, int LDB>
  __device__ __forceinline__ void step(const T* as, const T* bs) {
    const float* ar = as + ty * TM * LDA;
    const float* br = bs + tx * TN;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float av[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) load_floats<4>(av[i], ar + i * LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
        load_floats<TN>(bv, br + (k4 + kk) * LDB);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
      }
    }
  }

  // Straight from registers, in pieces of up to 4 floats: the GX threads
  // of a grid row write GX·TN consecutive floats of each output row at
  // out + row_off(m); FUSED: each through the output ops first (the
  // residual read in the same pieces).  With vec, N is a multiple of 4, so
  // a piece is wholly inside N or outside.
  template <int A_RING, int SMEM, bool FUSED, class RowOff>
  __device__ __forceinline__ void store(T* /*smem*/, const T* /*bias*/,
                                        int m0, int n0, int M, int N,
                                        bool vec, T* out, const Fused<T>& f,
                                        RowOff row_off) {
    constexpr int P = TN < 4 ? TN : 4;
    const int n = n0 + tx * TN;
    if (n >= N) return;
    if constexpr (FUSED) {
      // The output ops, the micro-tile's residual loaded first: a load
      // after a store to `out` would wait for it.
      if (f.res != nullptr) {
        float r[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = m0 + ty * TM + i;
#pragma unroll
          for (int j = 0; j < TN; ++j) r[i][j] = 0.0f;
          if (m >= M) continue;
          const float* rp = f.res + row_off(m) + n;
          if (vec) {
#pragma unroll
            for (int q = 0; q < TN; q += P)
              if (n + q < N) {
                float t[P];
                ldg_vec<P>(t, rp + q);
#pragma unroll
                for (int e = 0; e < P; ++e) r[i][q + e] = t[e];
              }
          } else {
            for (int j = 0; j < TN && n + j < N; ++j) r[i][j] = __ldg(rp + j);
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = f.out(acc[i][j], r[i][j]);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = f.out(acc[i][j], 0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) return;
      T* dst = out + row_off(m) + n;
      if (vec) {
#pragma unroll
        for (int q = 0; q < TN; q += P) {
          if (n + q >= N) break;
          float piece[P];
#pragma unroll
          for (int e = 0; e < P; ++e) piece[e] = acc[i][q + e];
          store_floats<P>(dst + q, piece);
        }
      } else {
        for (int j = 0; j < TN && n + j < N; ++j) dst[j] = acc[i][j];
      }
    }
  }
};

// The implicit GEMM of one (BM × BN) output tile under math policy P;
// blockIdx.z is the group (conv1d) or the output phase (transpose conv).
// FUSED: A's row u is state row u (u < T_s) or x row u − T_s, both ld
// wide from channel c_off, x's through the load LEAKY_RELU (scalar fills
// only: cp.async cannot transform, so the launcher turns vec off for it);
// the stores apply the output ops; a transpose conv keeps output rows
// crop0 + u, u < T_out, so its phase z owns the kept rows u = j·s + z
// (the result's rows t = crop0 + u, of tap phase (crop0 + z) mod s); all
// threads share the side store first.
template <class P, bool TCONV, bool FUSED>
__device__ __forceinline__ void gemm_body(const GemmArgs<typename P::T>& a) {
  using T = typename P::T;
  constexpr int BM = P::BM, BN = P::BN, BK = P::BK, NT = P::kThreads;
  constexpr int CH = 16 / sizeof(T);            // elements per 16-byte chunk
  constexpr int LDA = BK + CH, LDB = BN + CH;   // rows padded by 16 B
  constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;
  constexpr int ROW_CH = BK / CH;               // chunks per A row
  constexpr int A_ROWS = NT / ROW_CH;           // A rows per pass
  constexpr int A_CHUNKS = (BM + A_ROWS - 1) / A_ROWS;  // passes per thread
  constexpr int B_ALL = BK * BN / CH;           // chunks per B tile
  static_assert(NT % ROW_CH == 0 && BN % CH == 0, "tile shape");
  __shared__ __align__(16) T smem[kStages * (A_STAGE + B_STAGE)];
  T* const As = smem;
  T* const Bs = smem + kStages * A_STAGE;

  if constexpr (FUSED) {
    if (a.f.side != nullptr) {  // all streams' rows, by all threads
      const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                        blockIdx.x;
      side_store<T, false>(a.f, a.x, a.T_in - a.f.T_s, 0,
                           a.B * a.f.side_rows, block * NT + threadIdx.x,
                           gridDim.x * gridDim.y * gridDim.z * NT);
    }
  }
  const int z = blockIdx.z, s = a.stride, N = a.N;
  // Transpose conv: tap phase p of the block's rows, and j0, the result
  // row t = j·s + p of its first kept row, over s.
  const int p = FUSED && TCONV ? (a.f.crop0 + z) % s : z;
  const int j0 = FUSED && TCONV ? (a.f.crop0 + z) / s : 0;
  int M, R, J = 0;
  if (TCONV) {
    J = a.T_out > z ? (a.T_out - z + s - 1) / s : 0;  // rows u = j·s + z
    const int q = a.K > p ? (a.K - p + s - 1) / s : 0;  // taps k = p + a·s
    M = a.B * J;
    R = q * a.I_f;
  } else {
    M = a.B * a.T_out;
    R = a.K * a.I_f;
  }
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (m0 >= M) return;  // a phase with fewer rows than phase 0
  const int tid = threadIdx.x;

  // This thread's A rows (fixed over the reduction) and its CH columns.
  // FUSED: a_j is the input row u0 of tap 0 (u = u0 ± k), a_base and
  // a_sbase the offsets of row u0's first column read in x and in the
  // state (as if u0 lay in each).
  const int a_col = (tid % ROW_CH) * CH, a_row = tid / ROW_CH;
  long long a_base[A_CHUNKS], a_sbase[FUSED ? A_CHUNKS : 1];
  int a_j[A_CHUNKS];  // transpose conv: the row's j; -1 marks no row
#pragma unroll
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int row = a_row + c * A_ROWS, m = m0 + row;
    a_base[c] = 0;
    a_j[c] = -1;
    if (row >= BM || m >= M) continue;
    int b, u0;
    if (TCONV) {
      b = m / J;
      const int j = m - b * J;
      u0 = j0 + j;
      if (!FUSED) {
        a_base[c] = (static_cast<long long>(b) * a.T_in + j) * a.I_f;
        a_j[c] = j;
      }
    } else {
      b = m / a.T_out;
      const int t = m - b * a.T_out;
      u0 = t * s;
      if (!FUSED) {
        a_base[c] = (static_cast<long long>(b) * a.T_in +
                     static_cast<long long>(t) * s) * a.C_in +
                    static_cast<long long>(z) * a.I_f;
        a_j[c] = 0;
      }
    }
    if constexpr (FUSED) {
      const int col0 = a.f.c_off + (TCONV ? 0 : z * a.I_f);
      a_j[c] = u0;
      a_base[c] = (static_cast<long long>(b) * (a.T_in - a.f.T_s) + u0 -
                   a.f.T_s) * a.f.ld + col0;
      a_sbase[c] = (static_cast<long long>(b) * a.f.T_s + u0) * a.f.ld + col0;
    }
  }
  // Address of A[row of chunk c, r], or nullptr where it is zero; x_row:
  // whether it lies in x (not in the state).
  auto a_src = [&](int c, int r, bool& x_row) -> const T* {
    x_row = true;
    if (a_j[c] < 0 || r >= R) return nullptr;
    const int k = r / a.I_f, i = r - k * a.I_f;
    if constexpr (FUSED) {
      const int dk = TCONV ? -k : k;  // input rows past row u0
      const int u = a_j[c] + dk;
      if (u < 0 || u >= a.T_in) return nullptr;
      x_row = u >= a.f.T_s;
      const long long off = static_cast<long long>(dk) * a.f.ld + i;
      return x_row ? a.x + (a_base[c] + off) : a.f.state + (a_sbase[c] + off);
    }
    if (TCONV) {
      const int t_in = a_j[c] - k;
      if (t_in < 0 || t_in >= a.T_in) return nullptr;
      return a.x + a_base[c] - static_cast<long long>(k) * a.I_f + i;
    }
    return a.x + a_base[c] + static_cast<long long>(k) * a.C_in + i;
  };
  // Address of W[r, n0 + n], or nullptr where it is zero.
  auto b_src = [&](int r, int n) -> const T* {
    if (r >= R || n >= N) return nullptr;
    if (TCONV) {
      const int tap = r / a.I_f, i = r - tap * a.I_f;
      return a.w + (static_cast<long long>(p + tap * s) * a.I_f + i) * a.O + n;
    }
    return a.w + static_cast<long long>(r) * a.O +
           static_cast<long long>(z) * N + n;
  };
  const T zero = from_f32<T>(0.0f);
  auto load_tile = [&](int kt, int stage) {
    const int r0 = kt * BK;
    T* const as = As + stage * A_STAGE;
    T* const bs = Bs + stage * B_STAGE;
    bool x_row;
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int row = a_row + c * A_ROWS;
      if (row >= BM) break;
      T* dst = as + row * LDA + a_col;
      if (a.vec) {
        const T* src = a_src(c, r0 + a_col, x_row);
        cp_async16(dst, src != nullptr ? src : a.x, src != nullptr);
      } else {
        for (int e = 0; e < CH; ++e) {
          const T* src = a_src(c, r0 + a_col + e, x_row);
          if constexpr (FUSED) {
            dst[e] = src != nullptr
                         ? from_f32<T>(a.f.in(to_f32<T>(*src), x_row))
                         : zero;
          } else {
            dst[e] = src != nullptr ? *src : zero;
          }
        }
      }
    }
    for (int idx = tid; idx < B_ALL; idx += NT) {
      const int row = idx / (BN / CH), col = (idx % (BN / CH)) * CH;
      T* dst = bs + row * LDB + col;
      if (a.vec) {
        const T* src = b_src(r0 + row, n0 + col);
        cp_async16(dst, src != nullptr ? src : a.w, src != nullptr);
      } else {
        for (int e = 0; e < CH; ++e) {
          const T* src = b_src(r0 + row, n0 + col + e);
          dst[e] = src != nullptr ? *src : zero;
        }
      }
    }
  };

  const int bias_off = TCONV ? 0 : z * N;
  const T* const bias = a.bias != nullptr ? a.bias + bias_off : nullptr;
  P math;
  math.init(bias, n0, N);

  const int KT = (R + BK - 1) / BK;
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
    math.template step<LDA, LDB>(As + (kt % kStages) * A_STAGE,
                                 Bs + (kt % kStages) * B_STAGE);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Offset of GEMM row m's output row in out, at the group's first column.
  auto row_off = [&](int m) -> long long {
    if (TCONV) {
      const int b = m / J, j = m - b * J;
      return (static_cast<long long>(b) * a.T_out + j * s + z) * a.O;
    }
    return static_cast<long long>(m) * a.O + bias_off;
  };
  math.template store<kStages * A_STAGE, kStages * (A_STAGE + B_STAGE),
                      FUSED>(smem, bias, m0, n0, M, N, a.vec, a.out, a.f,
                             row_off);
}

// f32: at least 3 blocks per SM (≤ 85 registers at 256 threads), so that
// ptxas schedules the FFMA loop for that occupancy; on the card this ran
// faster than without the hint.  FUSED: with GemmArgs::f's operands.
template <int BM, int BN, int TM, int TN, bool FUSED>
__global__ void __launch_bounds__(BM / TM * (BN / TN), 3)
    conv1d_fwd(const GemmArgs<float> a) {
  gemm_body<FfmaF32<BM, BN, TM, TN>, false, FUSED>(a);
}

template <int BM, int BN, int TM, int TN, bool FUSED>
__global__ void __launch_bounds__(BM / TM * (BN / TN), 3)
    transpose_conv1d_fwd(const GemmArgs<float> a) {
  gemm_body<FfmaF32<BM, BN, TM, TN>, true, FUSED>(a);
}

template <int BM, int BN, int WM, int WN, bool FUSED>
__global__ void __launch_bounds__(kMmaThreads)
    conv1d_fwd_bf16(const GemmArgs<bf16> a) {
  gemm_body<MmaBf16<BM, BN, WM, WN>, false, FUSED>(a);
}

template <int BM, int BN, int WM, int WN, bool FUSED>
__global__ void __launch_bounds__(kMmaThreads)
    transpose_conv1d_fwd_bf16(const GemmArgs<bf16> a) {
  gemm_body<MmaBf16<BM, BN, WM, WN>, true, FUSED>(a);
}

// The instantiated tiles, (BM, BN), in conv_stack.py:GEMM_TILES's order,
// and the f32 micro-tile (TM, TN) of each.
constexpr int kTileBM[] = {128, 64, 64, 32, 64};
constexpr int kTileBN[] = {64, 64, 32, 32, 16};
constexpr int kF32TM[] = {8, 4, 4, 4, 4};
constexpr int kF32TN[] = {4, 4, 2, 2, 1};

template <int TILE, bool TCONV, bool FUSED>
int launch_gemm(const GemmArgs<float>& a, dim3 grid, cudaStream_t stream) {
  constexpr int BM = kTileBM[TILE], BN = kTileBN[TILE];
  constexpr int TM = kF32TM[TILE], TN = kF32TN[TILE];
  constexpr int nt = FfmaF32<BM, BN, TM, TN>::kThreads;
  if (TCONV) {
    transpose_conv1d_fwd<BM, BN, TM, TN, FUSED><<<grid, nt, 0, stream>>>(a);
  } else {
    conv1d_fwd<BM, BN, TM, TN, FUSED><<<grid, nt, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int TILE, bool TCONV, bool FUSED>
int launch_gemm(const GemmArgs<bf16>& a, dim3 grid, cudaStream_t stream) {
  constexpr int BM = kTileBM[TILE], BN = kTileBN[TILE];
  constexpr int WM = BN == 16 ? 4 : 2, WN = BN == 16 ? 1 : 2;
  if (TCONV) {
    transpose_conv1d_fwd_bf16<BM, BN, WM, WN, FUSED>
        <<<grid, kMmaThreads, 0, stream>>>(a);
  } else {
    conv1d_fwd_bf16<BM, BN, WM, WN, FUSED>
        <<<grid, kMmaThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
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

template <bool TCONV, bool FUSED, typename T>
int launch_gemm_tiled(const GemmArgs<T>& a, int M, int z, void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = gemm_tile(M, a.N, z);
  const dim3 grid((M + kTileBM[tile] - 1) / kTileBM[tile],
                  (a.N + kTileBN[tile] - 1) / kTileBN[tile], z);
  switch (tile) {
    case 0: return launch_gemm<0, TCONV, FUSED>(a, grid, st);
    case 1: return launch_gemm<1, TCONV, FUSED>(a, grid, st);
    case 2: return launch_gemm<2, TCONV, FUSED>(a, grid, st);
    case 3: return launch_gemm<3, TCONV, FUSED>(a, grid, st);
    default: return launch_gemm<4, TCONV, FUSED>(a, grid, st);
  }
}

// Both GEMM launchers: the fused operands into `a` (the 16-byte path also
// needs ld and c_off whole chunks, state and residual aligned and no load
// LEAKY_RELU), then the launch of the plain or the FUSED kernels.
template <bool TCONV, typename T>
int launch_gemm_fused(GemmArgs<T> a, int M, int z, const FusedOps* fused,
                      void* stream) {
  if (fused == nullptr) return launch_gemm_tiled<TCONV, false>(a, M, z, stream);
  constexpr int ch = 16 / sizeof(T);
  if (fused->ld < fused->c_off + a.C_in ||
      (fused->state != nullptr && fused->T_s > a.T_in) ||
      (!TCONV && fused->crop0 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fused->side != nullptr &&
      static_cast<long long>(a.B) * fused->side_rows * fused->ld > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.f = fused_from<T>(*fused, a.x);
  a.vec = a.vec && fused->ld % ch == 0 && fused->c_off % ch == 0 &&
          aligned16_or_null(fused->state) && aligned16_or_null(fused->res) &&
          !fused->leaky_in;
  return launch_gemm_tiled<TCONV, true>(a, M, z, stream);
}

template <typename T>
int launch_conv1d(const T* x, const T* w, const T* bias, T* out, int B,
                  int T_in, int C_in, int T_out, int O, int K, int I_f,
                  int stride, int groups, const FusedOps* fused,
                  void* stream) {
  constexpr int ch = 16 / sizeof(T);
  const int N = O / groups;
  const int vec = I_f % ch == 0 && N % ch == 0 && aligned16(x) &&
                  aligned16(w) && aligned16(out);
  const GemmArgs<T> a{x, w, bias, out, B, T_in, C_in, T_out, O, K, I_f,
                      stride, N, vec, {}};
  return launch_gemm_fused<false>(a, B * T_out, groups, fused, stream);
}

template <typename T>
int launch_transpose_conv1d(const T* x, const T* w, const T* bias, T* out,
                            int B, int T_in, int I, int T_out, int O, int K,
                            int stride, const FusedOps* fused, void* stream) {
  constexpr int ch = 16 / sizeof(T);
  const int vec = I % ch == 0 && O % ch == 0 && aligned16(x) &&
                  aligned16(w) && aligned16(out);
  const GemmArgs<T> a{x, w, bias, out, B, T_in, I, T_out, O, K, I, stride, O,
                      vec, {}};
  // Phase 0 has the most output rows: ceil(T_out / stride) per stream.
  return launch_gemm_fused<true>(a, B * ((T_out + stride - 1) / stride),
                                 stride, fused, stream);
}

}  // namespace

// C launchers, lyra_<kernel>: pointers to the element type of the kernel.
extern "C" {

int lyra_conv_gemm_tile(int M, int N, int z) { return gemm_tile(M, N, z); }

// The plan the depthwise launcher takes for these operands: writes V, J,
// the block and the grid to plan[0..6].  (A fused launch also needs its
// state and residual aligned for V > 1.)
void lyra_depthwise_plan(int elem_bytes, int B, int T_out, int C, int K,
                         int dilation, const void* x, const void* w,
                         const void* bias, const void* out, int* plan) {
  const DwPlan p = depthwise_plan(
      elem_bytes, B, T_out, C, K, dilation,
      aligned16(x) && aligned16(w) && aligned16(out) &&
          aligned16_or_null(bias));
  const int v[7] = {p.elems,    p.runs,     p.block[0], p.block[1],
                    p.grid[0],  p.grid[1],  p.grid[2]};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
}

// `fused`: the launch's fused operands (struct FusedOps), or null.
#define LYRA_GEMM_LAUNCHERS(SUFFIX, T)                                         \
  int lyra_conv1d_fwd##SUFFIX(const T* x, const T* w, const T* bias, T* out,  \
                              int B, int T_in, int C_in, int T_out, int O,    \
                              int K, int I_f, int stride, int groups,         \
                              const FusedOps* fused, void* stream) {          \
    return launch_conv1d<T>(x, w, bias, out, B, T_in, C_in, T_out, O, K, I_f, \
                            stride, groups, fused, stream);                   \
  }                                                                           \
  int lyra_transpose_conv1d_fwd##SUFFIX(const T* x, const T* w, const T* bias, \
                                        T* out, int B, int T_in, int I,       \
                                        int T_out, int O, int K, int stride,  \
                                        const FusedOps* fused,                \
                                        void* stream) {                       \
    return launch_transpose_conv1d<T>(x, w, bias, out, B, T_in, I, T_out, O,  \
                                      K, stride, fused, stream);              \
  }

LYRA_GEMM_LAUNCHERS(, float)
LYRA_GEMM_LAUNCHERS(_bf16, __nv_bfloat16)

#undef LYRA_GEMM_LAUNCHERS

#define LYRA_DEPTHWISE_LAUNCHER(SUFFIX, T)                                     \
  int lyra_depthwise_conv1d_fwd##SUFFIX(const T* x, const T* w, const T* bias, \
                                        T* out, int B, int T_in, int C,        \
                                        int T_out, int K, int dilation,        \
                                        const FusedOps* fused, void* stream) { \
    return launch_depthwise<T>(x, w, bias, out, B, T_in, C, T_out, K,          \
                               dilation, fused, stream);                       \
  }

LYRA_DEPTHWISE_LAUNCHER(, float)
LYRA_DEPTHWISE_LAUNCHER(_bf16, __nv_bfloat16)

#undef LYRA_DEPTHWISE_LAUNCHER

}  // extern "C"
