// LyraGAN's audio output edge on Hopper, in one launch per hop.
//
// The edge is the graph's last TRANSPOSE_CONV (C channels → 1, kernel K,
// stride S, a bias) and the overlap-add tail after it: the first L samples
// of its N-sample result plus the L-sample state (READ_VARIABLE, ADD), the
// last L samples as the new state (ASSIGN_VARIABLE), and the head and the
// middle samples L .. N − L as the hop's PCM (CONCATENATION, RESHAPE).
// ops/fused_stack.py matches that pattern in the graph; ops/out_edge.py is
// the wrapper.  Per stream and hop the kernel reads x [T, C] where the
// conv-stack core left it and its L-sample state, and writes the PCM
// [N − L] in float32 and the new state [L]; nothing else touches device
// memory.  Without a state (L = 0) it writes the conv's N samples alone
// (FusedStack.unfused).
//
// It replaces no Pallas kernel: the JAX package runs the channel-1 edges
// as XLA ops outside its megakernel (lyra_tpu/ops/fused_stack.py,
// `_edge_fn`), and the port ran them op by op through the executor, the
// conv on cuDNN's deterministic backward-data algorithms (pinned so that
// replays give the same bits), which took 10-30 times this work's bound.
//
// The bound.  With Y[t, k] = Σ_c x[t, c] · w[k, c], the conv is out[u] =
// bias + Σ_{S·t + k = u} Y[t, k]: per output phase p < S and row j, u =
// S·j + p sums Y[j − a, p + S·a] over its Q = ⌈K/S⌉ taps a.  Lyra's
// edge (T = 80, C = 64, K = 52, S = 4, N = 368, L = 48) is 80 · 52 · 64 =
// 266,240 MACs a stream: at B = 4096, 2.18 GFLOP, 32.6 µs at the 67
// TFLOP/s FP32 peak.  The bytes are 84 MB of f32 x (27 µs at 3.35 TB/s with the
// PCM and states) or 42 MB of bf16 x plus 5.2 MB of PCM and 1 MB of states
// (14.3 µs).  So f32 is bound by its FFMAs and bf16 by its bytes.
//
// The design, both element types:
//   * Persistent blocks of 4 warps, as many as fit on the device, each
//     taking tiles of 2 streams in turn through 2 stages of shared memory:
//     the next tile lands while the block computes this one.
//   * x comes by TMA: per stream one tensor copy of T rows of each 128 bytes
//     of channels, issued by one thread, counted on the stage's mbarrier,
//     with the 128-byte swizzle (16-byte unit i of row r at unit i ^ (r mod
//     8)), so that both kernels' reads below hit distinct bank groups.
//     Rows past the batch and channels past C land as zeros.  (The first
//     design issued 16-byte cp.async copies from every thread: their issue
//     stalled the math, 16-22 % of the time; a bulk copy per 256-byte row
//     was slower still.)  The weights (once) and the states come by cp.async.
//   * Y is a plain GEMM [T, C] × [C, S·Q], each element one sum over the
//     channels in ascending order, staged in f32 in shared memory; one
//     common epilogue then sums each output's Q taps in ascending order
//     (4 consecutive outputs, one row j's phases, are one float4 of Y a
//     tap), adds the bias, rounds once to the element type, adds the state
//     to the head as the graph's ADD does (f32 sum, one rounding) and
//     writes PCM and state as 16- or 8-byte runs.  No output needs another
//     block or an atomic, so the result is bitwise the same from run to run
//     and between an eager launch and a CUDA-graph replay.  (A first
//     design computed each output phase as its own GEMM over (tap, channel):
//     it read x again for every tap and computed 20 % of zero rows.)
//   * f32 (gan_out_edge): FFMA, never TF32.  Warp w takes Y's columns
//     Q·w .. Q·w + Q − 1, so every lane reads the same weights (a
//     broadcast); a lane takes 5 rows of one stream and keeps 5 × Q
//     accumulators.  Per 4 channels it loads 5 + Q 16-byte vectors for
//     20·Q FFMAs.
//   * bf16 (gan_out_edge_bf16): mma.sync m16n8k16 with f32 accumulation;
//     two warps a stream, each all of its m16 row tiles and half of the 7
//     n8 column tiles, the weights as the B operand resident in shared
//     memory.
//
// The launchers refuse (cudaErrorInvalidValue) what the instances do not
// cover: stride ≠ kStride, K > kStride·kTaps, T not a multiple of 16 or
// above kMaxT, C not a power of two in 8 .. kMaxChannels, N not a multiple
// of 4 or above (T − 1)·S + K, L not a multiple of 8, or 2L ≥ N.
// ops/out_edge.py:supported is the same rule (tests/test_torch_cuda.py
// holds the two equal); change both together.
//
// Every launcher returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // cuda.h's CUtensorMap, PFN_cuTensorMapEncodeTiled

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStride = 4;  // S of the instances
constexpr int kTaps = 13;   // Q: taps per output phase, K ≤ S·Q
constexpr int kCols = kStride * kTaps;  // Y's columns, the taps k < S·Q
constexpr int kMaxT = 80;               // x rows a stream
constexpr int kMaxChannels = 64;
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr int kTile = 2;          // streams a block takes at a time
constexpr int kStages = 2;        // tiles in shared memory: one loading
constexpr int kThreads = 128;     // 4 warps
constexpr int kBox = 128;         // bytes of a row of a TMA box (swizzled)
// f32: warp w takes Y's columns Q·w .. Q·w + Q − 1; a lane takes 5 rows t
// of one stream, 16 lanes a stream's 80.
constexpr int kF32Rows = 5;
// bf16: m16 tiles of rows t, n8 tiles of columns k.
constexpr int kMaxMTiles = kMaxT / 16;
constexpr int kNTiles = (kCols + 7) / 8;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) {
  return cdiv(a, b) * b;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory layout (host and device), from a 1024-byte aligned base.
// A stage holds a tile's x, as kTile × boxes TMA boxes of T rows of 128
// bytes (channels c of box c·sizeof(T)/128), then its L-sample states.
// Y [kTile][T][kCols] in f32 goes where the x was (f32), or to a region
// of its own (bf16); then the weights and the stages' barriers.
template <typename T>
__host__ __device__ int boxes(int C) {
  return cdiv(C * static_cast<int>(sizeof(T)), kBox);
}
template <typename T>
__host__ __device__ int x_bytes(int T_in, int C) {  // a stage's x (or Y)
  const int x = kTile * boxes<T>(C) * T_in * kBox;
  return round_up(sizeof(T) == 4 ? imax(x, kTile * T_in * kCols * 4) : x,
                  1024);
}
template <typename T>
__host__ __device__ int stage_bytes(int T_in, int C, int L) {
  return round_up(x_bytes<T>(T_in, C) + kTile * L * sizeof(T), 1024);
}
// The bf16 weights' rows: channels padded to k16 steps and 8 more, so that
// rows lie an odd number of 16-byte units apart (ldmatrix: no conflicts).
__host__ __device__ int bf16_wld(int C) { return round_up(C, 16) + 8; }
template <typename T>
__host__ __device__ int w_bytes(int C) {
  return sizeof(T) == 4 ? kCols * C * 4 : 8 * kNTiles * bf16_wld(C) * 2;
}
template <typename T>
__host__ __device__ int smem_bytes(int T_in, int C, int L) {
  return 1024 + kStages * stage_bytes<T>(T_in, C, L) +
         (sizeof(T) == 4 ? 0 : kTile * T_in * kCols * 4) + w_bytes<T>(C) +
         8 * kStages;
}

bool supported(int T, int C, int K, int stride, int N, int L) {
  return stride == kStride && K >= 1 && K <= kCols && T >= 16 &&
         T <= kMaxT && T % 16 == 0 && C >= 8 && C <= kMaxChannels &&
         (C & (C - 1)) == 0 && N >= 4 && N % 4 == 0 &&
         N <= (T - 1) * stride + K && L >= 0 && L % 8 == 0 && 2 * L < N;
}

template <typename T>
struct EdgeArgs {
  const T* x;      // [B, T, C], the core's output
  const T* w;      // [K, C]
  const T* bias;   // [1]
  const T* state;  // [B, L] (L > 0)
  float* pcm;      // [B, N − L] (L > 0)
  T* state_out;    // [B, L] (L > 0)
  T* y;            // [B, N] (L = 0: the conv alone)
  int B, T_in, C, K, N, L;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The thread's writes to shared memory, ordered before later TMA writes.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One TMA box (kBox-byte rows, 128-byte swizzle) of the tensor map at
// (c0, r0) into shared memory, counted on the barrier when it lands; rows
// past the tensor land as zeros.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_addr(bar))
      : "memory");
}

// The 16-byte unit `chunk` of row r of a swizzled box: where the TMA put it.
__device__ __forceinline__ int swz(int r, int chunk) {
  return r * kBox + ((chunk ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// w rows k < rows, ld elements apart: its C channels, then zeros up to
// `padded` 16-byte units; rows k ≥ K zero.
template <typename T>
__device__ __forceinline__ void load_w(const EdgeArgs<T>& a, T* dst,
                                       int rows, int ld, int padded) {
  constexpr int kVec = 16 / sizeof(T);
  const int units = a.C / kVec;
  for (int i = threadIdx.x; i < rows * padded; i += blockDim.x) {
    const int k = i / padded, g = i % padded;
    const bool ok = k < a.K && g < units;
    cp_async16(dst + k * ld + g * kVec,
               ok ? a.w + static_cast<size_t>(k) * a.C + g * kVec : a.w, ok);
  }
}

// Both kernels are persistent: block g takes the tiles of kTile streams
// g, g + gridDim.x, ... in turn.  A tile's x comes by TMA, one box per
// stream and 128 bytes of channels, issued by one thread for the next tile
// while the block computes this one; its states by cp.async.
template <typename T>
struct Tiles {
  const EdgeArgs<T>& a;
  const CUtensorMap* map;
  unsigned char* base;  // stage 0
  uint64_t* bars;
  int steps, stage;

  __device__ int b0(int it) const {
    return (blockIdx.x + it * gridDim.x) * kTile;
  }
  __device__ unsigned char* x(int it) const {
    return base + (it % kStages) * stage;
  }
  __device__ T* states(int it) const {
    return reinterpret_cast<T*>(x(it) + x_bytes<T>(a.T_in, a.C));
  }
  __device__ void issue(int it) const {
    if (it >= steps) return;
    const int nb = boxes<T>(a.C), b = b0(it);
    if (threadIdx.x == 0) {
      uint64_t* bar = bars + it % kStages;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem_addr(bar)),
          "r"(kTile * nb * a.T_in * kBox)
          : "memory");
      for (int s = 0; s < kTile; ++s)
        for (int h = 0; h < nb; ++h)
          tma_box(x(it) + (s * nb + h) * a.T_in * kBox, map,
                  h * kBox / static_cast<int>(sizeof(T)), (b + s) * a.T_in,
                  bar);
    }
    constexpr int kVec = 16 / sizeof(T);
    const int per = a.L / kVec;  // a state's 16-byte units
    for (int i = threadIdx.x; i < kTile * per; i += blockDim.x) {
      const bool ok = b + i / per < a.B;
      cp_async16(states(it) + i * kVec,
                 ok ? a.state + static_cast<size_t>(b) * a.L + i * kVec
                    : a.state,
                 ok);
    }
    cp_async_commit();
  }
  // Tile `it` has landed; the previous tile's stage is free for `it + 1`.
  __device__ void next(int it) const {
    cp_async_wait_all();
    fence_async();  // this thread's writes to the stage `it + 1` takes
    __syncthreads();
    issue(it + 1);
    mbar_wait(bars + it % kStages, (it / kStages) & 1);
  }
};

__device__ int tiles_of_block(int B) {  // this block's tiles
  const int tiles = cdiv(B, kTile), g = blockIdx.x;
  return tiles > g ? cdiv(tiles - g, gridDim.x) : 0;
}

// The 1024-byte aligned base of dynamic shared memory, for the swizzle.
__device__ __forceinline__ unsigned char* aligned_base(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// The common epilogue, 4 outputs at a time, the S = 4 phases of one row j:
// out[S·j + p] = bias + Σ_a Y[j − a][p + S·a] over the taps a < Q, a
// ascending (one float4 of Y a tap; zero where row j − a is not x's), in
// f32; `ys` the tile's Y, `st` its states in shared memory.  Then one
// rounding to T (the conv's), and for the head the graph's ADD of the
// state in T.  L > 0: PCM [B, N − L] and the new state [B, L]; L = 0:
// y [B, N].
template <typename T>
__device__ __forceinline__ void store_edge(const EdgeArgs<T>& a, int b0,
                                           float bias, const float* ys,
                                           const T* st) {
  static_assert(kStride == 4, "a row j's phases are one float4");
  const int L = a.L, P = a.N - L;
  for (int s = 0; s < kTile && b0 + s < a.B; ++s) {
    const size_t b = b0 + s;
    for (int u = 4 * threadIdx.x; u < a.N; u += 4 * blockDim.x) {
      const int j = u / kStride;
      float4 v[kTaps];
#pragma unroll
      for (int q = 0; q < kTaps; ++q)
        v[q] = j - q >= 0 && j - q < a.T_in
                   ? *reinterpret_cast<const float4*>(
                         ys + (s * a.T_in + j - q) * kCols + kStride * q)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      float y[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
      for (int q = 1; q < kTaps; ++q) {
        y[0] = __fadd_rn(y[0], v[q].x);
        y[1] = __fadd_rn(y[1], v[q].y);
        y[2] = __fadd_rn(y[2], v[q].z);
        y[3] = __fadd_rn(y[3], v[q].w);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = to_f(from_f<T>(__fadd_rn(y[e], bias)));
      if (L == 0) {
        store4(a.y + b * a.N + u, y);
      } else if (u >= P) {
        store4(a.state_out + b * L + u - P, y);
      } else {
        if (u < L) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[e] = to_f(from_f<T>(__fadd_rn(y[e], to_f(st[s * L + u + e]))));
        }
        store4(a.pcm + b * P + u, y);
      }
    }
  }
}

// -- f32 ----------------------------------------------------------------------

template <int S, int Q>
__global__ void __launch_bounds__(kThreads, 2)
    gan_out_edge(const __grid_constant__ CUtensorMap map,
                 const EdgeArgs<float> a) {
  extern __shared__ __align__(16) unsigned char smraw[];
  constexpr int TR = kF32Rows;
  static_assert(S * Q == kCols && kThreads == 32 * S, "a warp a phase");
  unsigned char* base = aligned_base(smraw);
  const int stage = stage_bytes<float>(a.T_in, a.C, a.L);
  float* ws = reinterpret_cast<float*>(base + kStages * stage);  // [S·Q][C]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + kCols * a.C);
  const Tiles<float> tiles{a, &map, base, bars, tiles_of_block(a.B), stage};
  const float bias = a.bias[0];
  load_w(a, ws, kCols, a.C, a.C / 4);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  tiles.issue(0);

  // Warp w: columns k0 .. k0 + Q − 1, so every lane of a warp reads the
  // same weights (a broadcast).  Lane: stream s = lane / 16, rows t0 ..
  // t0 + 4; rows 5 apart differ in (row mod 8), so the 8 lanes of a
  // quarter warp read 8 different 16-byte units of their swizzled rows.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = Q * warp, s = lane >> 4, t0 = TR * (lane & 15);
  const int nb = boxes<float>(a.C);
  unsigned live = 0;  // the rows that hold x
#pragma unroll
  for (int i = 0; i < TR; ++i)
    live |= static_cast<unsigned>(t0 + i < a.T_in) << i;

  for (int it = 0; it < tiles.steps; ++it) {
    tiles.next(it);
    unsigned char* xt = tiles.x(it);
    const unsigned char* xs = xt + s * nb * a.T_in * kBox;
    const float* wk = ws + k0 * a.C;
    // Y[t0 + i][k0 + k] over the channels in ascending order, one sum each.
    float acc[TR][Q];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int k = 0; k < Q; ++k) acc[i][k] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < a.C; c += 4) {
      const unsigned char* box = xs + (c >> 5) * a.T_in * kBox;
      float4 xv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        xv[i] = live >> i & 1 ? *reinterpret_cast<const float4*>(
                                    box + swz(t0 + i, (c & 31) >> 2))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(wk + k * a.C + c);
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][k] = fmaf(xv[i].x, wv.x, acc[i][k]);
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][k] = fmaf(xv[i].y, wv.y, acc[i][k]);
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][k] = fmaf(xv[i].z, wv.z, acc[i][k]);
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][k] = fmaf(xv[i].w, wv.w, acc[i][k]);
      }
    }
    __syncthreads();  // every warp is done with x: Y goes there
    float* ys = reinterpret_cast<float*>(xt);
#pragma unroll
    for (int i = 0; i < TR; ++i)
      if (live >> i & 1)
#pragma unroll
        for (int k = 0; k < Q; ++k)
          ys[(s * a.T_in + t0 + i) * kCols + k0 + k] = acc[i][k];
    __syncthreads();
    store_edge(a, tiles.b0(it), bias, ys, tiles.states(it));
  }
}

// -- bf16 ---------------------------------------------------------------------

template <int S, int Q>
__global__ void __launch_bounds__(kThreads, 2)
    gan_out_edge_bf16(const __grid_constant__ CUtensorMap map,
                      const EdgeArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char smraw[];
  constexpr int NH = (kNTiles + 1) / 2;  // n8 tiles a warp
  unsigned char* base = aligned_base(smraw);
  const int stage = stage_bytes<bf16>(a.T_in, a.C, a.L);
  float* ys = reinterpret_cast<float*>(base + kStages * stage);  // the Y
  const int wld = bf16_wld(a.C), cp = round_up(a.C, 16);
  bf16* wb = reinterpret_cast<bf16*>(ys + kTile * a.T_in * kCols);
  uint64_t* bars = reinterpret_cast<uint64_t*>(wb + 8 * kNTiles * wld);
  const Tiles<bf16> tiles{a, &map, base, bars, tiles_of_block(a.B), stage};
  const float bias = __bfloat162float(a.bias[0]);
  load_w(a, wb, 8 * kNTiles, wld, cp / 8);  // B operand: w [8·kNTiles][wld]
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  tiles.issue(0);

  // Warp w: stream w / 2, n8 tiles NH·(w % 2) .. of every m16 tile.  A
  // lane's ldmatrix row is 16·m + (lane mod 16), its 16-byte unit
  // kk / 8 + lane / 16, swizzled as the TMA stored it.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = warp >> 1, n0 = NH * (warp & 1), mtiles = a.T_in / 16;
  const bf16* wl = wb + (lane & 7) * wld + ((lane >> 3) & 1) * 8;
  for (int it = 0; it < tiles.steps; ++it) {
    tiles.next(it);
    const unsigned char* xs = tiles.x(it) + s * a.T_in * kBox;
    float acc[kMaxMTiles][NH][4];
#pragma unroll
    for (int m = 0; m < kMaxMTiles; ++m)
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
    for (int kk = 0; kk < cp; kk += 16) {
      unsigned bfr[NH][2];
#pragma unroll
      for (int n = 0; n < NH; ++n)
        if (n0 + n < kNTiles) ldmatrix_x2(bfr[n], wl + 8 * (n0 + n) * wld + kk);
#pragma unroll
      for (int m = 0; m < kMaxMTiles; ++m) {
        if (m < mtiles) {
          unsigned af[4];
          ldmatrix_x4(af, xs + swz(16 * m + (lane & 15),
                                   (kk >> 3) + (lane >> 4)));
#pragma unroll
          for (int n = 0; n < NH; ++n)
            if (n0 + n < kNTiles) mma_bf16(acc[m][n], af, bfr[n]);
        }
      }
    }
    // Y rows t < T, columns k < S·Q, from the fragments: c0, c1 at row
    // 16·m + lane / 4, columns 8n + 2·(lane % 4) + {0, 1}; c2, c3 8 rows on.
#pragma unroll
    for (int m = 0; m < kMaxMTiles; ++m) {
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int col = 8 * (n0 + n) + 2 * (lane & 3);
        if (m < mtiles && col < kCols) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = 16 * m + (lane >> 2) + 8 * h;
            *reinterpret_cast<float2*>(ys + (s * a.T_in + t) * kCols + col) =
                make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();
    store_edge(a, tiles.b0(it), bias, ys, tiles.states(it));
  }
}

// -- launchers ----------------------------------------------------------------

// As many blocks as fit on the device at once (the kernel's occupancy
// times the SMs), each walking its tiles; per kernel, device and shared
// memory size, once, with the opt-in to more than 48 KB of it.
template <class K>
cudaError_t resident_blocks(K kernel, int smem, int* blocks) {
  static int dev_of[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
  static int smem_of[8], blocks_of[8];
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < 8; ++i) {
    if (dev_of[i] == dev && smem_of[i] == smem) {
      *blocks = blocks_of[i];
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  for (int i = 0; i < 8; ++i) {
    if (dev_of[i] < 0) {
      dev_of[i] = dev, smem_of[i] = smem, blocks_of[i] = *blocks;
      break;
    }
  }
  return cudaSuccess;
}

// x [B·T, C] as a tensor map of boxes of T rows and 128 bytes of channels,
// 128-byte swizzle, zeros past its rows and channels.
template <typename T>
cudaError_t x_map(CUtensorMap* map, const EdgeArgs<T>& a) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.C),
                              static_cast<cuuint64_t>(a.B) * a.T_in};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.C) * sizeof(T)};
  const cuuint32_t box[2] = {kBox / sizeof(T),
                             static_cast<cuuint32_t>(a.T_in)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<T*>(a.x), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class K, typename T>
int launch(K kernel, const EdgeArgs<T>& a, int stride, void* stream) {
  if (a.B < 0 || !supported(a.T_in, a.C, a.K, stride, a.N, a.L))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B > 0) {
    const int smem = smem_bytes<T>(a.T_in, a.C, a.L);
    int blocks = 0;
    CUtensorMap map;
    cudaError_t err = resident_blocks(kernel, smem, &blocks);
    if (err == cudaSuccess) err = x_map(&map, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<imin(cdiv(a.B, kTile), blocks), kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(map, a);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_edge(const EdgeArgs<float>& a, int stride, void* stream) {
  return launch(gan_out_edge<kStride, kTaps>, a, stride, stream);
}

int launch_edge(const EdgeArgs<bf16>& a, int stride, void* stream) {
  return launch(gan_out_edge_bf16<kStride, kTaps>, a, stride, stream);
}

}  // namespace

// C launchers, lyra_<kernel>: x, w, bias, state and state_out (or y) in the
// kernel's element type, pcm in float32, all contiguous; x, w and the state
// 16-byte aligned.
extern "C" {

int lyra_gan_out_edge_supported(int T, int C, int K, int stride, int N,
                                int L) {
  return supported(T, C, K, stride, N, L) ? 1 : 0;
}

#define LYRA_EDGE_LAUNCHER(SUFFIX, T)                                          \
  int lyra_gan_out_edge##SUFFIX(const T* x, const T* w, const T* bias,         \
                                const T* state, float* pcm, T* state_out,      \
                                T* y, int B, int T_in, int C, int K,           \
                                int stride, int N, int L, void* stream) {      \
    const EdgeArgs<T> a{x, w, bias, state, pcm, state_out, y,                  \
                        B, T_in, C, K, N, L};                                  \
    return launch_edge(a, stride, stream);                                     \
  }

LYRA_EDGE_LAUNCHER(, float)
LYRA_EDGE_LAUNCHER(_bf16, __nv_bfloat16)

#undef LYRA_EDGE_LAUNCHER

}  // extern "C"
