// Conditional nodes for the solve loop's CUDA graph.
//
// The plan captures a solver's loop once and replays it: a WHILE node
// whose body is a round of steps, each step in an IF node with an ELSE
// body.  A one-thread kernel sets a node's handle from a bool on the card:
// just before the node, and for the WHILE node also at the end of its
// body, from the loop's condition on the state the round left.  The card
// runs the loop to its end with no read from the host.
//
// The bodies are captured from the stream PyTorch captures into:
// repro_graph_cond reads that stream's capture state, adds the set kernel
// and the conditional node to the graph being captured, makes the node the
// stream's capture dependency and hands back the body graphs and the
// handle; repro_graph_body_begin / _end capture one body graph from a
// second stream (cudaStreamBeginCaptureToGraph), on which the caller then
// issues the body's work, and repro_graph_set the kernel that sets the
// handle again.  Needs CUDA 12.3 (IF, WHILE), 12.8 (IF with an ELSE
// body).
//
// Not a port of a TPU kernel: the JAX package's lax.while_loop is XLA's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The capture state of `s` (CUDA 13 added the edge data to the call).
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         unsigned long long* id, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, id, graph, deps, nullptr, ndeps);
#else
  return cudaStreamGetCaptureInfo(s, status, id, graph, deps, ndeps);
#endif
}

}  // namespace

// Adds to the graph that `stream` is capturing: a kernel that sets a new
// conditional handle from *pred, then a conditional node on it: for `kind`
// 0 an IF node with `n_bodies` bodies (1: IF, 2: IF and ELSE), for kind 1
// a WHILE node (one body, which must set the handle again).  The node
// becomes the stream's only capture dependency; its body graphs go to
// bodies[0..n) and the handle to *handle_out.
extern "C" int repro_graph_cond(void* stream, const void* pred, int32_t kind,
                                int32_t n_bodies, void** bodies,
                                uint64_t* handle_out) {
  if (kind < 0 || kind > 1 || n_bodies < 1 || n_bodies > 2 - kind)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(s, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_cond_kernel<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(s, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = (unsigned)n_bodies;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n_bodies; ++i)
    bodies[i] = (void*)params.conditional.phGraph_out[i];
  *handle_out = (uint64_t)handle;
  return 0;
}

// Sets conditional `handle` from *pred: a kernel on `stream`, which is
// capturing the body of that handle's WHILE node.
extern "C" int repro_graph_set(void* stream, uint64_t handle,
                               const void* pred) {
  set_cond_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (cudaGraphConditionalHandle)handle, (const bool*)pred);
  return (int)cudaGetLastError();
}

// Starts capturing `body` (a body graph from repro_graph_cond) from
// `stream`, which must not be capturing.
extern "C" int repro_graph_body_begin(void* stream, void* body) {
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)stream, (cudaGraph_t)body, nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal);
}

extern "C" int repro_graph_body_end(void* stream) {
  cudaGraph_t graph = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)stream, &graph);
}

// The number of nodes of `graph` (a body graph right after its capture):
// the launches and copies one pass of it makes, a conditional node
// counting as one.
extern "C" int repro_graph_nodes(void* graph, int64_t* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *count = (int64_t)n;
  return (int)err;
}
