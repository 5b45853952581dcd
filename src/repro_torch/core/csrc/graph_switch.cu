// A switch node in the CUDA graph a stream is capturing: the branch a
// captured step runs is picked on the card, at every replay, by a device
// int.  The counterpart of `lax.switch` inside the reference's jitted
// in-graph step (src/repro/collectives/ingraph.py, `all_reduce`); no TPU
// kernel is replaced.  Built and bound by core/graphs.py.
//
// bpf_switch_begin, on the capturing stream:
//   1. a conditional handle on the graph being captured;
//   2. bpf_switch_set <<<1,1>>>, captured: at each replay it reads
//      `*index` and sets the handle (an index outside [0, n) selects no
//      body, so the node runs nothing);
//   3. one conditional node of type switch with n bodies, after the
//      stream's current capture dependencies; the stream's dependencies
//      become that node, so what the stream captures next runs after
//      the chosen body.
//   The n body graphs are returned; each is captured by
//   bpf_body_begin / bpf_body_end on a second stream.
//
// cudaGraphCondTypeSwitch needs CUDA 12.8.  Every call returns its CUDA
// error (0 on success); -1 means the stream is not capturing and -2 that
// a body capture ended into another graph.

#include <cuda_runtime.h>

__global__ void bpf_switch_set(cudaGraphConditionalHandle h,
                               const int *index, unsigned int n) {
    int i = *index;
    cudaGraphSetConditional(h, (i >= 0 && (unsigned int)i < n)
                                   ? (unsigned int)i : n);
}

extern "C" int bpf_switch_begin(void *stream, const void *index,
                                unsigned int n, void **bodies) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t *deps;
    size_t ndeps;
    cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &ndeps);
    if (e != cudaSuccess) return (int)e;
    if (status != cudaStreamCaptureStatusActive) return -1;
    cudaGraphConditionalHandle h;
    e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
    if (e != cudaSuccess) return (int)e;
    bpf_switch_set<<<1, 1, 0, s>>>(h, (const int *)index, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // the set kernel is now the stream's dependency
    e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
    if (e != cudaSuccess) return (int)e;
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = h;
    p.conditional.type = cudaGraphCondTypeSwitch;
    p.conditional.size = n;
    cudaGraphNode_t node;
    e = cudaGraphAddNode(&node, graph, deps, ndeps, &p);
    if (e != cudaSuccess) return (int)e;
    for (unsigned int i = 0; i < n; ++i)
        bodies[i] = (void *)p.conditional.phGraph_out[i];
    return (int)cudaStreamUpdateCaptureDependencies(
        s, &node, 1, cudaStreamSetCaptureDependencies);
}

extern "C" int bpf_body_begin(void *stream, void *body) {
    return (int)cudaStreamBeginCaptureToGraph(
        (cudaStream_t)stream, (cudaGraph_t)body, nullptr, nullptr, 0,
        cudaStreamCaptureModeRelaxed);
}

extern "C" const char *bpf_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

extern "C" int bpf_body_end(void *stream, void *body) {
    cudaGraph_t g = nullptr;
    cudaError_t e = cudaStreamEndCapture((cudaStream_t)stream, &g);
    if (e != cudaSuccess) return (int)e;
    return g == (cudaGraph_t)body ? 0 : -2;
}
