// DES segment-min over CSR segments, float64.
//
//   out[s] = min(values[starts[s] : starts[s] + counts[s]]),  +inf if empty
//
// A transfer's bottleneck bandwidth is the min of its route edges' fair
// shares; route lists are short (a handful of edges), so one thread per
// segment walks its own slice.  The CSR layout is consumed as it lies on
// the device: nothing is densified or padded.  Each value is read once
// and one double per segment is written: bound by bytes moved, and at
// the sizes a flush produces by launch latency.  A NaN value propagates
// (as the plain version's amin does).
#include <cuda_runtime.h>
#include <math_constants.h>

__global__ void segment_min_kernel(const double* __restrict__ values,
                                   const long long* __restrict__ starts,
                                   const long long* __restrict__ counts,
                                   double* __restrict__ out, long long S) {
    long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    const long long lo = starts[s];
    const long long hi = lo + counts[s];
    double m = CUDART_INF;
    for (long long k = lo; k < hi; ++k) {
        const double v = values[k];
        if (v < m || v != v) m = v;
        if (m != m) break;
    }
    out[s] = m;
}

extern "C" int heye_segment_min(const void* values, const void* starts,
                                const void* counts, void* out, long long S,
                                void* stream) {
    if (S <= 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((S + threads - 1) / threads);
    segment_min_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const double*)values, (const long long*)starts,
        (const long long*)counts, (double*)out, S);
    return (int)cudaGetLastError();
}
