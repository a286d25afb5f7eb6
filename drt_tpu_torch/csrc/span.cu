// Device span markers of the train step, bound through ctypes
// (drt_tpu_torch/spans.py).
//
// A CUDA graph's replay runs no Python, so a host range (record_function,
// NVTX) placed in the step's code exists only while the step is captured.
// What survives a replay is an operation captured into the graph: one
// empty kernel of one thread on the step's stream, which the profiler's
// device trace shows between the operations it brackets, on their clock.
// Each span name has a marker kernel of its own, so the trace's event name
// alone says which span opens there (`span_<name>_kernel`); one
// `span_end_kernel` closes the innermost open span. The markers are plain
// definitions, one a name, so a reader of the sources finds each by its
// `__global__ void` line.
//
// `span_mark_launch` launches one marker on a given stream and, while that
// stream is being captured, gives back the graph node it added (the
// stream's one capture dependency after the launch), so the owner of the
// graph can switch the markers on and off in the instantiated graph with
// `span_nodes_set_enabled` (cudaGraphNodeSetEnabled: a disabled kernel
// node is an empty node and launches nothing) without capturing again.

#include <cuda_runtime.h>

__global__ void span_step_kernel() {}
__global__ void span_normals_kernel() {}
__global__ void span_ray_kernel() {}
__global__ void span_silhouette_kernel() {}
__global__ void span_smooth_kernel() {}
__global__ void span_backward_kernel() {}
__global__ void span_update_kernel() {}
__global__ void span_solve_kernel() {}
__global__ void span_end_kernel() {}

namespace {

typedef void (*Marker)();
// In the order of span_kinds_signature().
const Marker MARKERS[] = {span_step_kernel, span_normals_kernel,
                          span_ray_kernel, span_silhouette_kernel,
                          span_smooth_kernel, span_backward_kernel,
                          span_update_kernel, span_solve_kernel,
                          span_end_kernel};
const int N_MARKERS = sizeof(MARKERS) / sizeof(MARKERS[0]);

}  // namespace

extern "C" const char* span_signature() { return "kind stream node"; }

extern "C" const char* span_kinds_signature() {
    return "step normals ray silhouette smooth backward update solve end";
}

// Launch marker `kind` on `stream`. `*node` is the graph node the launch
// added while the stream is being captured, else null.
extern "C" int span_mark_launch(int kind, void* stream, void** node) {
    *node = nullptr;
    if (kind < 0 || kind >= N_MARKERS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    MARKERS[kind]<<<1, 1, 0, s>>>();
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cudaStreamCaptureStatus status;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
#if CUDART_VERSION >= 13000
    err = cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr, &deps,
                                   nullptr, &n_deps);
#else
    err = cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr, &deps,
                                   &n_deps);
#endif
    if (err != cudaSuccess) return (int)err;
    if (status == cudaStreamCaptureStatusActive) {
        // a launch leaves the capturing stream depending on its node alone
        if (n_deps != 1) return (int)cudaErrorStreamCaptureInvalidated;
        *node = (void*)deps[0];
    }
    return (int)cudaSuccess;
}

// Enable (enabled != 0) or disable the `n` marker nodes `nodes` of the
// graph that `exec` was instantiated from, for its next launches.
extern "C" int span_nodes_set_enabled(void* exec, void** nodes, int n,
                                      int enabled) {
    for (int i = 0; i < n; ++i) {
        cudaError_t err = cudaGraphNodeSetEnabled(
            (cudaGraphExec_t)exec, (cudaGraphNode_t)nodes[i],
            enabled ? 1u : 0u);
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}
