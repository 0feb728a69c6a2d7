// Conditional nodes of a CUDA graph, bound to Python with ctypes.
//
// The JAX frame is one XLA program whose Hough loop is a lax.while_loop and
// whose update is a lax.switch: the device decides which rounds and which
// branches run.  The port captures the frame into one CUDA graph
// (pipeline.FrameStep) and gives each round and each branch an IF node
// (ops/hough.py run_if): a node whose body graph runs only when a one-byte
// flag on the card reads nonzero at the node's turn in the replay.
//
// pcs_if_begin adds, to the graph that `stream` is capturing:
//   * a one-thread kernel that reads the flag and sets the node's condition
//     (cudaGraphSetConditional), so the flag is read at replay, not at
//     capture;
//   * the IF node after it, on which the stream's later work depends;
// and starts capturing `body_stream` into the node's body graph.  Work
// queued on `body_stream` until pcs_if_end is the body.  Nodes nest: a body
// stream that is capturing may itself be the `stream` of an inner node.
//
// The caller keeps every result a body makes in tensors allocated before
// the node (a body that does not run leaves them as they were), and
// allocates the body's own tensors from the capturing graph's memory pool.
// A body stream must never be the stream that captures the graph, nor an
// outer body's: pcs_stream_create makes streams of the process's own for
// bodies (PyTorch's torch.cuda.Stream() hands out a fixed pool of streams
// round-robin, so one of those would in time be a frame step's).
//
// pcs_capture_nodes counts the nodes of the graph a stream is capturing so
// far (an IF node counts one; its body is counted when its own capture
// ends), so a capture can report how many nodes its graph holds.
//
// CUDA 12.4 or later: conditional handles, cudaGraphAddNode with conditional
// parameters and cudaStreamBeginCaptureToGraph.  Each entry returns a CUDA
// error code (0 on success), or kNotCapturing.

#include <cuda_runtime.h>

namespace {

constexpr int kNotCapturing = -1;

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* flag) {
  cudaGraphSetConditional(handle, flag[0] != 0 ? 1u : 0u);
}

}  // namespace

extern "C" int pcs_if_begin(void* stream, const void* flag, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return kNotCapturing;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const unsigned char*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the node depends on what the stream's capture depends on now: the
  // kernel just captured
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  // relaxed: the outer capture's mode still rules what the thread may call
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeRelaxed));
}

extern "C" int pcs_stream_create(void** stream) {
  return static_cast<int>(
      cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(stream), cudaStreamNonBlocking));
}

extern "C" int pcs_if_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}

extern "C" int pcs_capture_nodes(void* stream, unsigned long long* n) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return kNotCapturing;
  size_t count = 0;
  err = cudaGraphGetNodes(graph, nullptr, &count);
  *n = count;
  return static_cast<int>(err);
}
