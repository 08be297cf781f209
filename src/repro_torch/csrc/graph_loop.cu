// Device loops for CUDA graphs: CUDA conditional WHILE and IF nodes (CUDA
// 12.4+) built around graphs that PyTorch captured.
//
// The JAX package runs every loop of a solve as a lax.while_loop inside one
// compiled program.  Here a loop's step (plain PyTorch ops and the frontier
// kernels on static buffers) is captured once by torch.cuda.CUDAGraph, and
// this library builds the loop around it, entirely on the device:
//
//   set(h, live) -> WHILE h { child(step graph) -> set(h, live) }
//
// set_condition is a one-thread kernel that reads an int32 flag in device
// memory (the loop's `live` scalar) and sets the conditional handle from
// it, so the host launches the whole loop once and reads nothing until it
// ends.  An IF node (`set(h, flag)` or its negation, then IF h { ... })
// picks a branch on the device, so only the taken branch runs.  Bodies may
// nest.  The child graph node is a copy of the captured graph: the captured
// graph's memory (PyTorch's graph pool) must outlive the loop's graph.
//
// A runaway guard bounds every WHILE loop: the set kernel counts the loop's
// iterations in `iters` (reset by the set before the loop), and once they
// reach `limit` it ends the loop and writes 1 to `runaway`, which the host
// reads with the next values it reads.  A loop of the solver ends long
// before its limit; the guard keeps a fault from hanging the card.
//
// A loop may also be added to a graph that a stream is capturing (a loop
// inside a step that PyTorch captures): lg_capture_tail gives the graph
// and the node the stream's next work depends on, the loop is built after
// it, and lg_capture_continue makes the stream go on from the loop.
//
// Every function returns the CUDA error (0 = success).  Handles go to and
// from Python as opaque pointers and unsigned 64-bit integers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const int* flag, int negate, int* iters,
                              int limit, int* runaway, int reset) {
  bool on = (*flag != 0) != (negate != 0);
  if (iters != nullptr) {
    const int n = reset ? 0 : *iters + 1;
    *iters = n;
    if (on && n >= limit) {
      on = false;
      *runaway = 1;
    }
  }
  cudaGraphSetConditional(handle, on ? 1u : 0u);
}

cudaGraphNode_t* deps(void** dep) {
  return *dep == nullptr ? nullptr : reinterpret_cast<cudaGraphNode_t*>(dep);
}

}  // namespace

extern "C" int lg_graph_create(void** out) {
  cudaGraph_t g = nullptr;
  const cudaError_t err = cudaGraphCreate(&g, 0);
  *out = g;
  return (int)err;
}

extern "C" int lg_graph_destroy(void* graph) {
  return (int)cudaGraphDestroy((cudaGraph_t)graph);
}

extern "C" int lg_handle_create(void* graph, unsigned long long* out) {
  cudaGraphConditionalHandle h = 0;
  const cudaError_t err =
      cudaGraphConditionalHandleCreate(&h, (cudaGraph_t)graph, 0, 0);
  *out = (unsigned long long)h;
  return (int)err;
}

// child: a copy of `child` (a captured graph) after node `dep` (may be null)
extern "C" int lg_add_child(void* graph, void* dep, void* child, void** out) {
  cudaGraphNode_t node = nullptr;
  const cudaError_t err = cudaGraphAddChildGraphNode(
      &node, (cudaGraph_t)graph, deps(&dep), dep == nullptr ? 0 : 1,
      (cudaGraph_t)child);
  *out = node;
  return (int)err;
}

// the set kernel: handle <- (*flag != 0) xor negate, through the runaway
// guard when iters is not null
extern "C" int lg_add_set(void* graph, void* dep, unsigned long long handle,
                          const int* flag, int negate, int* iters, int limit,
                          int* runaway, int reset, void** out) {
  cudaGraphConditionalHandle h = (cudaGraphConditionalHandle)handle;
  void* args[] = {&h, &flag, &negate, &iters, &limit, &runaway, &reset};
  cudaKernelNodeParams p = {};
  p.func = (void*)set_condition;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  cudaGraphNode_t node = nullptr;
  const cudaError_t err = cudaGraphAddKernelNode(
      &node, (cudaGraph_t)graph, deps(&dep), dep == nullptr ? 0 : 1, &p);
  *out = node;
  return (int)err;
}

// a conditional node on `handle` (is_while: WHILE, else IF) after `dep`;
// `body` receives the graph its body is built in
extern "C" int lg_add_cond(void* graph, void* dep, unsigned long long handle,
                           int is_while, void** body, void** out) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
  const cudaError_t err = cudaGraphAddNode(
      &node, (cudaGraph_t)graph, deps(&dep), dep == nullptr ? 0 : 1, &p);
  *out = node;
  *body = err == cudaSuccess ? p.conditional.phGraph_out[0] : nullptr;
  return (int)err;
}

extern "C" int lg_instantiate(void* graph, void** exec) {
  cudaGraphExec_t e = nullptr;
  const cudaError_t err = cudaGraphInstantiate(&e, (cudaGraph_t)graph, 0);
  *exec = e;
  return (int)err;
}

extern "C" int lg_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int lg_exec_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

// the graph `stream` is capturing, and the one node its next work depends
// on (null if none; several are joined by an empty node)
extern "C" int lg_capture_tail(void* stream, void** graph, void** dep) {
  cudaStreamCaptureStatus status;
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t* d = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                             nullptr, &g, &d, nullptr, &n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                             nullptr, &g, &d, &n);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  *graph = g;
  *dep = n == 0 ? nullptr : d[0];
  if (n > 1) {
    cudaGraphNode_t join = nullptr;
    err = cudaGraphAddEmptyNode(&join, g, d, n);
    *dep = join;
  }
  return (int)err;
}

// the stream's next captured work depends on `node` alone
extern "C" int lg_capture_continue(void* stream, void* node) {
  cudaGraphNode_t n = (cudaGraphNode_t)node;
#if CUDART_VERSION >= 13000
  return (int)cudaStreamUpdateCaptureDependencies(
      (cudaStream_t)stream, &n, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return (int)cudaStreamUpdateCaptureDependencies(
      (cudaStream_t)stream, &n, 1, cudaStreamSetCaptureDependencies);
#endif
}
