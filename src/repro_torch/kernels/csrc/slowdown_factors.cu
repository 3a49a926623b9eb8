// Batched slowdown factor aggregation (H-EYE section 3.4), float64.
//
//   f[i] = max(1, (1 + mt[i]) * prod_r(1 + term(beta[r], x[i,r]) * mem[i]))
//   term(b, x) = b * x * (1 + kappa * x)   where x > 0 and b > 0, else 0
//
// One thread per row; the product runs over r = 0..R-1 in ascending
// order, the order a row-wise product over the last axis takes, so the
// kernel and its plain PyTorch version agree to the bit.  R is a run-time
// argument (6 resource classes on the edge/server testbed); rows are
// read once and one double per row is written, so the kernel is bound by
// bytes moved and, at the pool sizes the scheduler produces (tens to a
// few thousand rows), by launch latency.
#include <cuda_runtime.h>

__global__ void slowdown_factors_kernel(const double* __restrict__ x,
                                        const double* __restrict__ beta,
                                        const double* __restrict__ mem,
                                        const double* __restrict__ mt,
                                        double* __restrict__ out,
                                        long long n, int R, double kappa) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const double m = mem[i];
    const double* row = x + i * (long long)R;
    double prod = 1.0;
    for (int r = 0; r < R; ++r) {
        const double xv = row[r];
        const double b = beta[r];
        double term = 0.0;
        if (xv > 0.0 && b > 0.0) {
            // (b * x) * (1 + kappa * x), no fused contraction: the plain
            // version rounds every product and sum separately
            term = __dmul_rn(__dmul_rn(b, xv),
                             __dadd_rn(1.0, __dmul_rn(kappa, xv)));
        }
        prod = __dmul_rn(prod, __dadd_rn(1.0, __dmul_rn(term, m)));
    }
    const double f = __dmul_rn(__dadd_rn(1.0, mt[i]), prod);
    // fmax would drop a NaN; the plain version's maximum propagates it
    out[i] = (f != f) ? f : (f > 1.0 ? f : 1.0);
}

extern "C" int heye_slowdown_factors(const void* x, const void* beta,
                                     const void* mem, const void* mt,
                                     void* out, long long n, int R,
                                     double kappa, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    slowdown_factors_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const double*)x, (const double*)beta, (const double*)mem,
        (const double*)mt, (double*)out, n, R, kappa);
    return (int)cudaGetLastError();
}
