// The DES transfer path, float64, in two fused in-place forms.
//
// * transfer_reprice (a flush's affected transfers, in ascending slot
//   order): for i with k = ks[i]
//     xstamp[k] = stamp0 + i
//     bw        = min over the route edges e of transfer k (its CSR row
//                 xe_flat[xe_start[k] : xe_start[k] + xe_cnt[k]]) of
//                 edge_bw[e] / max(1, edge_mem[e])   (+inf with no edge;
//                 a NaN share propagates)
//     xW[k]     = max(0, xW[k] - xrate[k] * (now - xt_last[k]))  (NaN -> 0)
//     xt_last[k] = now;  xrate[k] = bw
//     xeta[k]   = now + (bw > 0 ? xW[k] / bw : +inf)
//   The flush's changed per-edge member counts come packed with it
//   (upd_e ascending, upd_c): they land in the device column edge_mem in
//   the same launch.  A thread reads an edge's count from the packed list
//   when the edge is there (a binary search where the list lies) and from
//   the column otherwise, and the launch writes the column only at the
//   packed edges, so no thread reads a count another thread writes.
// * transfer_complete (a timestamp's finished transfers, in reprice-stamp
//   order): for i with k = done[i]
//     xW[k] = the settle above;  xt_last[k] = now
//     xeta[k] = +inf where xW[k] <= tol (finished), else
//               now + xW[k] / xrate[k] where xrate[k] > 0, else +inf
//     pairs[i] = k, pairs[n + i] = finished   (one host read)
//
// One thread per transfer; `now` is a run-time argument.  Each form
// replaces the op sequence of the port's first transfer path (index
// gathers, cumsum, repeat_interleave, the CSR gather, the share division,
// the segment-min and rate-advance launches, indexed stores and a
// where; ~15 device ops and host rounds a flush) with one launch, and is
// bit-equal to that sequence: every product, difference and quotient is
// rounded on its own (no fused multiply-add), the shares are divided
// before the min is taken.  `ks` / `done` hold distinct slots.  Routes
// are a handful of edges, so a thread walks its own CSR row; a few
// doubles per transfer and edge: bound by bytes moved, and at the sizes
// a flush produces (one to a few thousand transfers) by launch latency.
// Replaces repro/kernels/timeline_kernel.py segment_min_pallas (:109)
// and rate_advance_pallas (:59) at their transfer sites,
// repro/core/timeline.py _flush's link branch and _complete_transfers.
#include <cuda_runtime.h>
#include <math_constants.h>

#define XT_THREADS 128

__device__ __forceinline__ double x_settle(double W, double r, double t_last,
                                           double now) {
    const double raw = __dsub_rn(W, __dmul_rn(r, __dsub_rn(now, t_last)));
    return (raw > 0.0) ? raw : 0.0;          // NaN compares false -> 0
}

// the member count of edge e: the packed update when e has one, else the
// column's
__device__ __forceinline__ long long edge_count(
    long long e, const long long* upd_e, const long long* upd_c, long long u,
    const long long* __restrict__ edge_mem) {
    long long lo = 0, hi = u;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (upd_e[mid] < e) lo = mid + 1; else hi = mid;
    }
    return (lo < u && upd_e[lo] == e) ? upd_c[lo] : edge_mem[e];
}

__global__ void __launch_bounds__(XT_THREADS)
transfer_reprice_kernel(double* __restrict__ xW, double* __restrict__ xrate,
                        double* __restrict__ xt_last,
                        double* __restrict__ xeta,
                        long long* __restrict__ xstamp,
                        const long long* __restrict__ xe_flat,
                        const long long* __restrict__ xe_start,
                        const long long* __restrict__ xe_cnt,
                        const double* __restrict__ edge_bw,
                        long long* __restrict__ edge_mem,
                        const long long* __restrict__ ks, long long n,
                        const long long* __restrict__ upd_e,
                        const long long* __restrict__ upd_c, long long u,
                        double now, long long stamp0) {
    const long long i = (long long)blockIdx.x * XT_THREADS + threadIdx.x;
    if (i < u) edge_mem[upd_e[i]] = upd_c[i];
    if (i >= n) return;
    const long long k = ks[i];
    const long long lo = xe_start[k];
    const long long hi = lo + xe_cnt[k];
    const double w = x_settle(xW[k], xrate[k], xt_last[k], now);
    // the route's bottleneck share; a NaN share sticks, as the min's NaN
    // propagates
    double bw = CUDART_INF;
    for (long long j = lo; j < hi; ++j) {
        const long long e = xe_flat[j];
        const long long c = edge_count(e, upd_e, upd_c, u, edge_mem);
        const double share = __ddiv_rn(edge_bw[e], (double)(c > 1 ? c : 1));
        if (share < bw || share != share) bw = share;
    }
    xstamp[k] = stamp0 + i;
    xW[k] = w;
    xt_last[k] = now;
    xrate[k] = bw;
    xeta[k] = __dadd_rn(now, bw > 0.0 ? __ddiv_rn(w, bw) : CUDART_INF);
}

__global__ void __launch_bounds__(XT_THREADS)
transfer_complete_kernel(double* __restrict__ xW,
                         const double* __restrict__ xrate,
                         double* __restrict__ xt_last,
                         double* __restrict__ xeta,
                         const long long* __restrict__ done,
                         long long* __restrict__ pairs, long long n,
                         double now, double tol) {
    const long long i = (long long)blockIdx.x * XT_THREADS + threadIdx.x;
    if (i >= n) return;
    const long long k = done[i];
    const double r = xrate[k];
    const double w = x_settle(xW[k], r, xt_last[k], now);
    const bool fin = w <= tol;
    xW[k] = w;
    xt_last[k] = now;
    xeta[k] = fin ? CUDART_INF
                  : (r > 0.0 ? __dadd_rn(now, __ddiv_rn(w, r)) : CUDART_INF);
    pairs[i] = k;
    pairs[n + i] = fin ? 1 : 0;
}

static unsigned xt_blocks(long long n) {
    return (unsigned)((n + XT_THREADS - 1) / XT_THREADS);
}

extern "C" int heye_transfer_reprice(
        void* xW, void* xrate, void* xt_last, void* xeta, void* xstamp,
        const void* xe_flat, const void* xe_start, const void* xe_cnt,
        const void* edge_bw, void* edge_mem, const void* ks, long long n,
        const void* upd_e, const void* upd_c, long long u, double now,
        long long stamp0, void* stream) {
    const long long m = n > u ? n : u;
    if (m <= 0) return 0;
    transfer_reprice_kernel<<<xt_blocks(m), XT_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (double*)xW, (double*)xrate, (double*)xt_last, (double*)xeta,
        (long long*)xstamp, (const long long*)xe_flat,
        (const long long*)xe_start, (const long long*)xe_cnt,
        (const double*)edge_bw, (long long*)edge_mem, (const long long*)ks,
        n, (const long long*)upd_e, (const long long*)upd_c, u, now, stamp0);
    return (int)cudaGetLastError();
}

extern "C" int heye_transfer_complete(void* xW, const void* xrate,
                                      void* xt_last, void* xeta,
                                      const void* done, void* pairs,
                                      long long n, double now, double tol,
                                      void* stream) {
    if (n <= 0) return 0;
    transfer_complete_kernel<<<xt_blocks(n), XT_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (double*)xW, (const double*)xrate, (double*)xt_last, (double*)xeta,
        (const long long*)done, (long long*)pairs, n, now, tol);
    return (int)cudaGetLastError();
}
