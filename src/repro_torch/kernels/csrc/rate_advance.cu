// DES rate-advance (settle + completion projection), float64.
//
//   W'  = max(0, W - rate * (now - t_last)),  a NaN residue (inf * 0) -> 0
//   eta = now + W' / rate   where rate > 0, else +inf
//
// One thread per element.  `now` is a run-time double argument, so one
// compiled kernel serves every timestamp.  `with_eta == 0` selects the
// settle-only form (compute jobs: rates are finite-positive and the
// caller projects eta itself); `eta` may then be null.  Three doubles in,
// one or two out per element: bound by bytes moved, and at the sizes a
// flush produces (hundreds of jobs) by launch latency.
#include <cuda_runtime.h>
#include <math_constants.h>

__global__ void rate_advance_kernel(const double* __restrict__ W,
                                    const double* __restrict__ rate,
                                    const double* __restrict__ t_last,
                                    double* __restrict__ W2,
                                    double* __restrict__ eta,
                                    long long n, double now, int with_eta) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const double r = rate[i];
    // no fused multiply-add: the plain version rounds the product first
    const double raw = __dsub_rn(W[i], __dmul_rn(r, __dsub_rn(now, t_last[i])));
    double w = (raw > 0.0) ? raw : 0.0;      // NaN compares false -> 0
    W2[i] = w;
    if (with_eta) {
        eta[i] = (r > 0.0) ? __dadd_rn(now, __ddiv_rn(w, r)) : CUDART_INF;
    }
}

extern "C" int heye_rate_advance(const void* W, const void* rate,
                                 const void* t_last, void* W2, void* eta,
                                 long long n, double now, int with_eta,
                                 void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    rate_advance_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const double*)W, (const double*)rate, (const double*)t_last,
        (double*)W2, (double*)eta, n, now, with_eta);
    return (int)cudaGetLastError();
}
