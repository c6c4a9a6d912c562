// The conv-stack core's ops that no conv launch absorbs, on Hopper.
//
// Part of the port of the Pallas megakernel lyra_tpu/ops/fused_stack.py
// (FusedStackKernel._make_kernel, pallas_call at fused_stack.py:488), whose
// op loop computes, besides the convs, ADD/SUB/MUL/DIV of two tensors or of
// a tensor and a [1, C] weight (fused_stack.py:624-632), any
// CONCATENATION (:599-603) and any STRIDED_SLICE (:605-609, :660-680).
// ops/fused_stack.py absorbs what it can into the conv launches of
// conv_stack.cu (a residual, a MUL or DIV by a per-channel constant, a
// channel slice as a channel offset, the state concatenation); the rest
// runs here, inside the core, so no torch kernel runs between the core's
// first launch and its last:
//
//   core_eltwise   out = a op b over [B, T, C], op ADD, SUB, MUL or DIV,
//                  each operand a tensor of the output's shape, a constant
//                  per channel [C] or one constant;
//   core_gather    out [B, T, C] = the concatenation along time or channels
//                  of up to kMaxParts parts, each a strided window (rows
//                  row0 + t·rstride, channels col0 + c·cstride) of a tensor
//                  [B, T_p, C_p] or of a constant [T_p, C_p] shared by all
//                  streams: a CONCATENATION, a STRIDED_SLICE, or a
//                  CONCATENATION of STRIDED_SLICEs in one launch.
//
// Both in float32 and bfloat16 (the *_bf16 kernels): each element is
// loaded as a float, the op computed in f32 (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn: IEEE, never contracted) and rounded once on store,
// which is what torch's own ops do, so in f32 they give the bits of
// torch.add / sub / mul / div, and a copy is exact.  A simple design: one
// grid-stride loop over 32-bit indices (the launchers refuse 2^31
// elements), 16 bytes of elements per thread and step (one load per
// operand, one store) where the channels and pointers allow, else one
// element; 256 threads per block, at most kMaxBlocks blocks.  These ops
// move a few MB per hop at B=1024 and do next to no arithmetic, so they
// are bound by bytes; the graph of a Lyra model holds none of them
// (PERF.md §6).
//
// Every launcher returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxParts = 8;

// One part of a gather, the C struct the launcher takes;
// ops/conv_stack.py:_GatherPart has the same layout.
struct GatherPart {
  const void* src;
  long long b_stride;  // elements from one stream's tensor to the next; 0
                       // for a constant
  int ld;              // elements per row of src
  int row0, rstride;   // the part's row t is src row row0 + t·rstride
  int col0, cstride;   // its channel c is src channel col0 + c·cstride
  int extent;          // rows (axis 1) or channels (axis 2) of the output
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100 SXM

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Operand layouts of core_eltwise.
constexpr int kFull = 0, kPerChannel = 1, kScalar = 2;

// V consecutive elements at p as floats: one 16-byte load where V
// elements are 16 bytes (p then 16-byte aligned).
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __ldg(p + e);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const bf16* p) {
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

// V floats to p, each rounded once to T: one 16-byte store where V
// elements are 16 bytes.
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = v[e];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

template <typename T>
struct EltwiseArgs {
  const T* a;
  const T* b;
  T* out;
  unsigned n;  // B·T·C < 2^31
  int C;
  int a_layout, b_layout;  // kFull, kPerChannel or kScalar
  int op;                  // 1 ADD, 2 SUB, 3 MUL, 4 DIV
};

// Elements i0 .. i0 + V − 1 of an operand (a per-channel one: C a
// multiple of V, so they are channels i0 mod C onwards of one row).
template <int V, typename T>
__device__ __forceinline__ void operand(float (&v)[V], const T* p,
                                        int layout, unsigned i0, int C) {
  if (layout == kFull) {
    load_vec<V>(v, p + i0);
  } else if (layout == kPerChannel) {
    load_vec<V>(v, p + i0 % C);
  } else {
    const float s = to_f32<T>(p[0]);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = s;
  }
}

// Thread step i: elements i·V .. i·V + V − 1, V = 16 bytes of them where
// the launcher allows it, else 1.
template <typename T, int V>
__device__ __forceinline__ void eltwise_body(const EltwiseArgs<T>& e) {
  const unsigned steps = e.n / V, stride = gridDim.x * kThreads;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < steps;
       i += stride) {
    float a[V], b[V], v[V];
    operand<V>(a, e.a, e.a_layout, i * V, e.C);
    operand<V>(b, e.b, e.b_layout, i * V, e.C);
#pragma unroll
    for (int k = 0; k < V; ++k)
      v[k] = e.op == 1   ? __fadd_rn(a[k], b[k])
             : e.op == 2 ? __fsub_rn(a[k], b[k])
             : e.op == 3 ? __fmul_rn(a[k], b[k])
                         : __fdiv_rn(a[k], b[k]);
    store_vec<V>(e.out + i * V, v);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    core_eltwise(const EltwiseArgs<float> e) {
  eltwise_body<float, V>(e);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    core_eltwise_bf16(const EltwiseArgs<bf16> e) {
  eltwise_body<bf16, V>(e);
}

template <typename T>
struct GatherArgs {
  GatherPart parts[kMaxParts];
  T* out;
  unsigned units;  // B·T·C / V < 2^31
  int T_out, C, axis, n_parts;
};

// Thread step i: V output elements of one row (b, t), channels c .. c + V
// − 1 (V > 1: 16 bytes, every part's channels contiguous and 16-byte
// aligned, so the V lie in one part and are one 16-byte load); the part
// that holds t (axis 1) or c (axis 2) found by walking the parts' extents.
template <typename T, int V>
__device__ __forceinline__ void gather_body(const GatherArgs<T>& g) {
  const int per_row = g.C / V;
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < g.units;
       i += stride) {
    const unsigned row = i / per_row;
    const int b = row / g.T_out;
    int t = row - b * g.T_out, c = (i - row * per_row) * V;
    int k = 0;
    int& pos = g.axis == 1 ? t : c;
    while (k + 1 < g.n_parts && pos >= g.parts[k].extent) {
      pos -= g.parts[k].extent;
      ++k;
    }
    const GatherPart& p = g.parts[k];
    const T* src = static_cast<const T*>(p.src) + b * p.b_stride +
                   static_cast<long long>(p.row0 + t * p.rstride) * p.ld +
                   p.col0 + c * p.cstride;
    T* dst = g.out + static_cast<long long>(i) * V;
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      *dst = *src;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    core_gather(const GatherArgs<float> g) {
  gather_body<float, V>(g);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    core_gather_bf16(const GatherArgs<bf16> g) {
  gather_body<bf16, V>(g);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

int blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
int launch_eltwise(const T* a, const T* b, T* out, long long n, int C,
                   int a_layout, int b_layout, int op, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (C <= 0 || n % C || n > 0x7fffffffLL || op < 1 || op > 4 ||
      a_layout < kFull || a_layout > kScalar || b_layout < kFull ||
      b_layout > kScalar)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int ch = 16 / sizeof(T);
  const bool vec = C % ch == 0 && aligned16(out) &&
                   (a_layout == kScalar || aligned16(a)) &&
                   (b_layout == kScalar || aligned16(b));
  const EltwiseArgs<T> e{a, b, out, static_cast<unsigned>(n), C, a_layout,
                         b_layout, op};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = blocks(vec ? n / ch : n);
  if constexpr (sizeof(T) == 4) {
    if (vec) core_eltwise<ch><<<grid, kThreads, 0, st>>>(e);
    else core_eltwise<1><<<grid, kThreads, 0, st>>>(e);
  } else {
    if (vec) core_eltwise_bf16<ch><<<grid, kThreads, 0, st>>>(e);
    else core_eltwise_bf16<1><<<grid, kThreads, 0, st>>>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const GatherPart* parts, int n_parts, int axis, T* out,
                  int B, int T_out, int C, void* stream) {
  const long long n = static_cast<long long>(B) * T_out * C;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n_parts < 1 || n_parts > kMaxParts || (axis != 1 && axis != 2) ||
      n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int ch = 16 / sizeof(T);
  GatherArgs<T> g;
  int total = 0;
  bool vec = C % ch == 0 && aligned16(out);
  for (int k = 0; k < n_parts; ++k) {
    const GatherPart& p = parts[k];
    g.parts[k] = p;
    total += p.extent;
    vec = vec && p.cstride == 1 && p.ld % ch == 0 && p.col0 % ch == 0 &&
          (axis == 1 || p.extent % ch == 0) && aligned16(p.src);
  }
  if (total != (axis == 1 ? T_out : C))
    return static_cast<int>(cudaErrorInvalidValue);
  g.out = out;
  g.units = static_cast<unsigned>(vec ? n / ch : n);
  g.T_out = T_out;
  g.C = C;
  g.axis = axis;
  g.n_parts = n_parts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = blocks(g.units);
  if constexpr (sizeof(T) == 4) {
    if (vec) core_gather<ch><<<grid, kThreads, 0, st>>>(g);
    else core_gather<1><<<grid, kThreads, 0, st>>>(g);
  } else {
    if (vec) core_gather_bf16<ch><<<grid, kThreads, 0, st>>>(g);
    else core_gather_bf16<1><<<grid, kThreads, 0, st>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C launchers, lyra_<kernel>: pointers to the element type of the kernel.
extern "C" {

#define LYRA_CORE_LAUNCHERS(SUFFIX, T)                                        \
  int lyra_core_eltwise##SUFFIX(const T* a, const T* b, T* out, long long n, \
                                int C, int a_layout, int b_layout, int op,   \
                                void* stream) {                              \
    return launch_eltwise<T>(a, b, out, n, C, a_layout, b_layout, op,        \
                             stream);                                        \
  }                                                                          \
  int lyra_core_gather##SUFFIX(const GatherPart* parts, int n_parts,         \
                               int axis, T* out, int B, int T_out, int C,    \
                               void* stream) {                               \
    return launch_gather<T>(parts, n_parts, axis, out, B, T_out, C, stream); \
  }

LYRA_CORE_LAUNCHERS(, float)
LYRA_CORE_LAUNCHERS(_bf16, __nv_bfloat16)

#undef LYRA_CORE_LAUNCHERS

}  // extern "C"
