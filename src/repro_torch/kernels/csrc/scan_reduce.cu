// Alg. 1 subtree-scan accounting reduce, float64 / int64.
//
//   feas[n]  = any(ok[pu_lo[n] : pu_hi[n]])
//   winner   = first feasible position attaining the minimum key
//              (still a feasible position when every key is +inf;
//              -1 when the scan root, node 0, is infeasible)
//   queries  = sum(leafcnt[feas]);  hops = sum(nchild[feas])
//   overhead = sum((hopsum + lqc * leafcnt * (depth + 1))[feas])
//
// One block per scan.  Feasibility comes from a block prefix sum of `ok`
// (chunked per thread, written to an int32 scratch the wrapper
// allocates), so every node's range test is two loads.  The argmin
// orders candidates by (key, index), so ties resolve to the lowest index
// whatever the thread layout; the integer sums are exact in int64; the
// overhead is summed in a fixed order (strided per-thread partials, then
// a fixed binary tree), so it is reproducible from run to run.  The four
// results go into one 4-double output so the host needs one copy.
// Every input is read once: bound by bytes moved, and at device-scan
// sizes (6 PUs) by launch latency.
#include <cuda_runtime.h>
#include <math_constants.h>

#define SCAN_THREADS 1024

__device__ __forceinline__ bool better(double k, long long i,
                                       double bk, long long bi) {
    return (k < bk) || (k == bk && i < bi);
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_reduce_kernel(const unsigned char* __restrict__ ok,
                   const double* __restrict__ key,
                   const long long* __restrict__ pu_lo,
                   const long long* __restrict__ pu_hi,
                   const long long* __restrict__ leafcnt,
                   const long long* __restrict__ nchild,
                   const double* __restrict__ hopsum,
                   const double* __restrict__ depth,
                   int* __restrict__ cs, double* __restrict__ out,
                   long long P, long long Nn, double lqc) {
    __shared__ double sK[SCAN_THREADS];
    __shared__ long long sI[SCAN_THREADS];
    __shared__ long long sQ[SCAN_THREADS];
    const int t = threadIdx.x;
    const int T = blockDim.x;

    // ---- pass 1: per-thread chunk count + chunk-local argmin ------------
    const long long chunk = (P + T - 1) / T;
    const long long lo = (long long)t * chunk;
    const long long hi = (lo + chunk < P) ? lo + chunk : P;
    long long cnt = 0;
    double bk = CUDART_INF;
    long long bi = 0x7fffffffffffffffLL;
    for (long long i = lo; i < hi; ++i) {
        if (ok[i]) {
            ++cnt;
            const double k = key[i];
            if (better(k, i, bk, bi)) { bk = k; bi = i; }
        }
    }
    sQ[t] = cnt;
    sK[t] = bk;
    sI[t] = bi;
    __syncthreads();

    // ---- exclusive scan of the chunk counts (T entries, one thread) -----
    if (t == 0) {
        long long run = 0;
        for (int j = 0; j < T; ++j) {
            const long long c = sQ[j];
            sQ[j] = run;
            run += c;
        }
        cs[0] = 0;
    }
    __syncthreads();
    {
        long long run = sQ[t];
        for (long long i = lo; i < hi; ++i) {
            run += ok[i] ? 1 : 0;
            cs[i + 1] = (int)run;
        }
    }
    // ---- block argmin with (key, index) ordering -------------------------
    for (int s = T / 2; s > 0; s >>= 1) {
        __syncthreads();
        if (t < s) {
            const double k2 = sK[t + s];
            const long long i2 = sI[t + s];
            if (better(k2, i2, sK[t], sI[t])) { sK[t] = k2; sI[t] = i2; }
        }
    }
    __syncthreads();                 // also publishes cs[] to the block
    const long long winner = sI[0];
    const bool root_ok = (Nn > 0) && (cs[pu_hi[0]] > cs[pu_lo[0]]);
    __syncthreads();

    // ---- pass 2: per-node feasibility + accounting sums ------------------
    long long q = 0, h = 0;
    double ov = 0.0;
    for (long long n = t; n < Nn; n += T) {
        if (cs[pu_hi[n]] > cs[pu_lo[n]]) {
            const long long lc = leafcnt[n];
            q += lc;
            h += nchild[n];
            const double term = __dadd_rn(
                hopsum[n],
                __dmul_rn(__dmul_rn(lqc, (double)lc),
                          __dadd_rn(depth[n], 1.0)));
            ov = __dadd_rn(ov, term);
        }
    }
    sK[t] = ov;
    sI[t] = q;
    sQ[t] = h;
    for (int s = T / 2; s > 0; s >>= 1) {
        __syncthreads();
        if (t < s) {
            sK[t] = __dadd_rn(sK[t], sK[t + s]);
            sI[t] += sI[t + s];
            sQ[t] += sQ[t + s];
        }
    }
    __syncthreads();
    if (t == 0) {
        if (!root_ok) {
            out[0] = -1.0; out[1] = 0.0; out[2] = 0.0; out[3] = 0.0;
        } else {
            out[0] = (double)winner;
            out[1] = (double)sI[0];
            out[2] = (double)sQ[0];
            out[3] = sK[0];
        }
    }
}

extern "C" int heye_scan_reduce(const void* ok, const void* key,
                                const void* pu_lo, const void* pu_hi,
                                const void* leafcnt, const void* nchild,
                                const void* hopsum, const void* depth,
                                void* cs, void* out, long long P,
                                long long Nn, double lqc, void* stream) {
    scan_reduce_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)ok, (const double*)key,
        (const long long*)pu_lo, (const long long*)pu_hi,
        (const long long*)leafcnt, (const long long*)nchild,
        (const double*)hopsum, (const double*)depth, (int*)cs, (double*)out,
        P, Nn, lqc);
    return (int)cudaGetLastError();
}
