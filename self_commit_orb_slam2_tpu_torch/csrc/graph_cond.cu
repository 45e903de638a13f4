// Conditional IF nodes in a CUDA graph under stream capture: the device
// side of lax.cond for the port's captured programs
// (models/program_graphs.py cond, models/step_graph.py's chunk graph).
//
// Replaces no TPU kernel.  The JAX package's chunk program branches with
// lax.cond inside one XLA program; a CUDA graph branches with a conditional
// node whose condition a kernel sets from device memory just before it, so
// the host reads nothing.  PyTorch's CUDAGraph has no binding for these
// nodes on every version, so the capture is driven here against the CUDA
// runtime:
//
//   cond_begin(parent, child, pred): on the stream `parent`, which is
//     capturing, a one-thread kernel sets a new conditional handle from the
//     0-d bool `pred`; an IF node on that handle joins the capture after
//     it; then `child` (idle) begins capturing into the node's body graph.
//   cond_end(child, &nodes): ends the body's capture; `nodes` is the number
//     of nodes in the body (a nested IF node counts once, its body apart).
//   capture_nodes(stream, &nodes): the node count of the graph `stream`
//     is capturing into.
//   body_stream(&stream): a new non-blocking stream for the bodies (one of
//     its own: a stream of PyTorch's pool may be the capturing one).
//
// Each returns a cudaError_t (0 on success).  Bound by nothing measurable:
// the kernel reads one byte; what it saves is the host read and the graph
// launch per branch.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_graph(cudaStream_t stream, cudaGraph_t* graph,
                          const cudaGraphNode_t** deps, size_t* n_deps) {
    cudaStreamCaptureStatus status;
    unsigned long long id = 0;
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, n_deps);
    if (err != cudaSuccess) return err;
    return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                   : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int cond_begin(void* parent_ptr, void* child_ptr, const void* pred) {
    cudaStream_t parent = static_cast<cudaStream_t>(parent_ptr);
    cudaStream_t child = static_cast<cudaStream_t>(child_ptr);
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    cudaError_t err = capture_graph(parent, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    set_condition<<<1, 1, 0, parent>>>(handle, static_cast<const bool*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = capture_graph(parent, &graph, &deps, &n_deps);   // the kernel's node now
    if (err != cudaSuccess) return err;

    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                              cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
    return cudaStreamBeginCaptureToGraph(child, params.conditional.phGraph_out[0], nullptr,
                                         nullptr, 0, cudaStreamCaptureModeGlobal);
}

extern "C" int cond_end(void* child_ptr, size_t* nodes) {
    cudaStream_t child = static_cast<cudaStream_t>(child_ptr);
    cudaGraph_t graph;
    cudaError_t err = capture_graph(child, &graph, nullptr, nullptr);
    if (err != cudaSuccess) return err;
    err = cudaGraphGetNodes(graph, nullptr, nodes);
    if (err != cudaSuccess) return err;
    cudaGraph_t body;
    return cudaStreamEndCapture(child, &body);   // the node owns the body graph
}

extern "C" int capture_nodes(void* stream_ptr, size_t* nodes) {
    cudaGraph_t graph;
    cudaError_t err = capture_graph(static_cast<cudaStream_t>(stream_ptr), &graph, nullptr,
                                    nullptr);
    if (err != cudaSuccess) return err;
    return cudaGraphGetNodes(graph, nullptr, nodes);
}

extern "C" int body_stream(void** stream) {
    cudaStream_t s = nullptr;
    cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    *stream = s;
    return err;
}
