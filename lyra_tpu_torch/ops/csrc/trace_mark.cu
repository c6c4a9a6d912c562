// Device markers of the tracer (lyra_tpu_torch/utils/trace.py).
//
// A host annotation (torch.profiler.record_function) does not survive
// CUDA-graph capture: a replayed graph's kernels reach the profiler with
// their own names and nothing of the Python code that captured them.  A
// marker is a kernel, so it is captured like any other and replayed in
// stream order: `lyra_trace_mark<ID>` is a one-thread kernel that does
// nothing, and ID, part of its name in the profiler's records, is the index
// of a segment name in trace.SEGMENTS.  A reader of a profile assigns each
// kernel to the segment of the last marker before it on the stream.
//
// The tracer launches markers only while tracing is on, so a graph captured
// with tracing off holds none; an untraced process never builds this file.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegments = 64;  // trace.py holds SEGMENTS to this many

template <int ID>
__global__ void lyra_trace_mark() {}

template <int ID>
cudaError_t launch(int id, cudaStream_t stream) {
  if (id == ID) {
    lyra_trace_mark<ID><<<1, 1, 0, stream>>>();
    return cudaGetLastError();
  }
  if constexpr (ID + 1 < kMaxSegments) {
    return launch<ID + 1>(id, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int lyra_trace_max_segments() { return kMaxSegments; }

// Launches segment `id`'s marker on `stream`; → cudaGetLastError() after it.
extern "C" int lyra_trace_mark_launch(int id, void* stream) {
  if (id < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<0>(id, static_cast<cudaStream_t>(stream)));
}
