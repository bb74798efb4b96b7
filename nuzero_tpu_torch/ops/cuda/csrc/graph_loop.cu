// Conditional while-nodes for CUDA graphs that PyTorch captures.
//
// `graph_while_begin` is called while `stream` captures a graph.  It
// appends to that graph a one-thread kernel that copies the device flag
// `*pred` into a new conditional handle, then a while-node on the handle
// that depends on the kernel, makes the while-node the stream's only
// capture dependency, and starts capturing `body` into the node's body
// graph.  `graph_while_end(body, handle, pred)` appends to the body the same
// kernel on `*pred`, which the body has recomputed, and ends the body's
// capture.  At replay the device then runs the body while `*pred` holds,
// with no host in the loop.  (Later PyTorch releases capture if-nodes
// through `torch.cuda.CUDAGraph.begin_capture_to_if_node`; PyTorch 2.11
// has no conditional node.)
//
// Both return a cudaError_t (0 on success); `graph_while_begin` returns -1
// when `stream` is not capturing.

#include <cuda_runtime.h>

__global__ void graph_cond_set_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int graph_while_begin(cudaStream_t stream, const void* pred, cudaStream_t body,
                                 unsigned long long* handle_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, nullptr, nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  graph_cond_set_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &num_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  *handle_out = handle;
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed));
}

extern "C" int graph_while_end(cudaStream_t body, unsigned long long handle, const void* pred) {
  graph_cond_set_kernel<<<1, 1, 0, body>>>(handle, static_cast<const bool*>(pred));
  cudaError_t e = cudaGetLastError();
  cudaGraph_t graph;
  cudaError_t end = cudaStreamEndCapture(body, &graph);
  return static_cast<int>(e != cudaSuccess ? e : end);
}
