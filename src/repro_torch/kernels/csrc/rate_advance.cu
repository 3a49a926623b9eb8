// DES rate-advance (settle + completion projection), float64, in three
// forms.  The settle of one job is
//
//   W'  = max(0, W - rate * (now - t_last)),  a NaN residue (inf * 0) -> 0
//
// * rate_advance (transfers): gathered columns in, W' and
//   eta = now + W'/rate (where rate > 0, else +inf) out;
// * settle_reprice (a flush's dirty compute pools), in place on the job
//   columns: for i with m = members[i]
//     cstamp[m] = stamp0 + i;  W[m] = W';  t_last[m] = now;
//     rate[m] = 1 / factors[i];  eta[m] = now + W[m] / rate[m]
// * settle_complete (a timestamp's finished compute jobs, in stamp order),
//   in place: W[m] = W', t_last[m] = now, eta[m] = +inf where W' <= tol
//   (finished) else now + W'/rate[m] (a float residue keeps running), and
//   pairs[i] = m, pairs[n + i] = (W' <= tol), read by the host in one copy.
//
// One thread per element; `now` is a run-time argument, so one compiled
// kernel serves every timestamp.  The two in-place forms replace the
// gathers, the settle launch and the scatters around it (a dozen ops at
// each site) with one launch; `members` / `done` hold distinct slots (the
// callers' pools are sets), so no two threads write one slot.  Every
// product, difference and quotient is rounded on its own (no fused
// multiply-add) and `rate` is 1/factor before eta divides by it, the
// order of the unfused sequence, so all three forms are bit-equal to
// their plain versions.  A few doubles per element: bound by bytes
// moved, and at the sizes a flush produces (a handful of jobs) by launch
// latency.  Replaces repro/kernels/timeline_kernel.py rate_advance_pallas
// (:59) and the settle form at repro/core/timeline.py:194 _settle_pos.
#include <cuda_runtime.h>
#include <math_constants.h>

#define RA_THREADS 128

__device__ __forceinline__ double settle_one(double W, double r,
                                             double t_last, double now) {
    const double raw = __dsub_rn(W, __dmul_rn(r, __dsub_rn(now, t_last)));
    return (raw > 0.0) ? raw : 0.0;          // NaN compares false -> 0
}

__global__ void rate_advance_kernel(const double* __restrict__ W,
                                    const double* __restrict__ rate,
                                    const double* __restrict__ t_last,
                                    double* __restrict__ W2,
                                    double* __restrict__ eta,
                                    long long n, double now) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const double r = rate[i];
    const double w = settle_one(W[i], r, t_last[i], now);
    W2[i] = w;
    eta[i] = (r > 0.0) ? __dadd_rn(now, __ddiv_rn(w, r)) : CUDART_INF;
}

__global__ void settle_reprice_kernel(double* __restrict__ W,
                                      double* __restrict__ rate,
                                      double* __restrict__ t_last,
                                      double* __restrict__ eta,
                                      long long* __restrict__ cstamp,
                                      const long long* __restrict__ members,
                                      const double* __restrict__ factors,
                                      long long n, double now,
                                      long long stamp0) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long m = members[i];
    const double w = settle_one(W[m], rate[m], t_last[m], now);
    const double r = __ddiv_rn(1.0, factors[i]);
    cstamp[m] = stamp0 + i;
    W[m] = w;
    t_last[m] = now;
    rate[m] = r;
    eta[m] = __dadd_rn(now, __ddiv_rn(w, r));
}

__global__ void settle_complete_kernel(double* __restrict__ W,
                                       const double* __restrict__ rate,
                                       double* __restrict__ t_last,
                                       double* __restrict__ eta,
                                       const long long* __restrict__ done,
                                       long long* __restrict__ pairs,
                                       long long n, double now, double tol) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long m = done[i];
    const double r = rate[m];
    const double w = settle_one(W[m], r, t_last[m], now);
    const bool fin = w <= tol;
    W[m] = w;
    t_last[m] = now;
    eta[m] = fin ? CUDART_INF : __dadd_rn(now, __ddiv_rn(w, r));
    pairs[i] = m;
    pairs[n + i] = fin ? 1 : 0;
}

static unsigned blocks_for(long long n) {
    return (unsigned)((n + RA_THREADS - 1) / RA_THREADS);
}

extern "C" int heye_rate_advance(const void* W, const void* rate,
                                 const void* t_last, void* W2, void* eta,
                                 long long n, double now, void* stream) {
    if (n <= 0) return 0;
    rate_advance_kernel<<<blocks_for(n), RA_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const double*)W, (const double*)rate, (const double*)t_last,
        (double*)W2, (double*)eta, n, now);
    return (int)cudaGetLastError();
}

extern "C" int heye_settle_reprice(void* W, void* rate, void* t_last,
                                   void* eta, void* cstamp,
                                   const void* members, const void* factors,
                                   long long n, double now, long long stamp0,
                                   void* stream) {
    if (n <= 0) return 0;
    settle_reprice_kernel<<<blocks_for(n), RA_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (double*)W, (double*)rate, (double*)t_last, (double*)eta,
        (long long*)cstamp, (const long long*)members,
        (const double*)factors, n, now, stamp0);
    return (int)cudaGetLastError();
}

extern "C" int heye_settle_complete(void* W, const void* rate, void* t_last,
                                    void* eta, const void* done, void* pairs,
                                    long long n, double now, double tol,
                                    void* stream) {
    if (n <= 0) return 0;
    settle_complete_kernel<<<blocks_for(n), RA_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (double*)W, (const double*)rate, (double*)t_last, (double*)eta,
        (const long long*)done, (long long*)pairs, n, now, tol);
    return (int)cudaGetLastError();
}
