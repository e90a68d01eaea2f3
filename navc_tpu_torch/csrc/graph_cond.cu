// A CUDA graph IF node, added to a capture in progress: the port's form of
// the predicates navc_tpu's compiled decodes test on the device (l2r's
// lax.cond around each reveal round, ef's lax.while_loop condition), used by
// runtime/graphs.py ``when``. PyTorch 2.11's CUDAGraph has no conditional
// node of its own, so the node is made here from the runtime API (CUDA 12.4
// or later).
//
// navc_stream_create(out): a non-blocking stream of the caller's own for the
// bodies to capture on. PyTorch hands out the streams of its pool round
// robin, 32 of them, so a stream taken from the pool is now and then the
// very stream the graph is capturing on, and beginning the body's capture
// there fails (cudaErrorIllegalState).
//
// navc_cond_begin(pred, capture, body): `capture` is a stream capturing a
// graph. It queues on `capture` a one-thread kernel that sets a new
// conditional handle from the bool at `pred`, adds an IF node after that
// kernel, makes the node the stream's only dependency (so the stream's
// later work follows the node), and starts capturing the idle stream `body`
// into the node's body graph. navc_cond_end(body) ends that capture. A
// replay then runs the body's work only when *pred is true at that point of
// the graph, and skips it, kernels and all, when it is false.
//
// It replaces no TPU kernel: the set kernel is the control flow that XLA
// compiles into navc_tpu's program.

#include "common.cuh"

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle, const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The capture's graph and its current dependencies (CUDA 13 adds the edge
// data to the query; the default edges are all this file uses).
cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, ndeps);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, ndeps);
#endif
  if (e == cudaSuccess && status != cudaStreamCaptureStatusActive) e = cudaErrorIllegalState;
  return e;
}

}  // namespace

NAVC_EXPORT int navc_cond_begin(const void* pred, cudaStream_t capture, cudaStream_t body) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e = capture_info(capture, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_cond_kernel<<<1, 1, 0, capture>>>(handle, static_cast<const unsigned char*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = capture_info(capture, &graph, &deps, &ndeps);  // now ending at the set kernel
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(capture, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(capture, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                       nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

NAVC_EXPORT int navc_stream_create(cudaStream_t* out) {
  return cudaStreamCreateWithFlags(out, cudaStreamNonBlocking);
}

NAVC_EXPORT int navc_cond_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}
