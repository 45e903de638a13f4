// A time stamp taken on the card, where the work it marks runs: the pass
// timer inside the port's CUDA graphs (utils/profiling.py stamp).
//
// Replaces no TPU kernel.  A host timer cannot see a stage that a CUDA
// graph replays, and one that synchronizes cannot run inside a stream of
// graphs; a stamp is one more node of the graph, so it times the stage
// where it runs and the host reads nothing until the trace closes.
//
//   stamp(ring, head, n, stream): one thread on `stream` writes
//     %globaltimer (ns) into ring[head[0] % n] and adds one to head[0].
//
// Returns a cudaError_t (0 on success).  Bound by its launch: it writes
// two int64.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* ring, long long* head, long long n) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const long long i = head[0];
    ring[i % n] = static_cast<long long>(t);
    head[0] = i + 1;
}

}  // namespace

extern "C" int stamp(void* ring, void* head, long long n, void* stream) {
    stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(ring), static_cast<long long*>(head), n);
    return cudaGetLastError();
}
