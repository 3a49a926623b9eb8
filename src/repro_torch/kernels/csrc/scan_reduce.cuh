// The device code of the Alg. 1 subtree-scan accounting reduce that more
// than one kernel runs: one scan of at most 32 PUs on one warp
// (warp_scan), one of up to SR_MAX_WORDS * 32 PUs on one block of
// SR_THREADS threads (block_scan), each writing the scan's seven values.
// scan_reduce.cu launches them over a ragged stack of scans, rewalk.cu
// over the one scan of a re-walk's entry plan.  See scan_reduce.cu for
// the layout and the order of the sums.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define SR_THREADS 256
#define SR_WARPS (SR_THREADS / 32)
#define SR_WARP_MAX_P 32
#define SR_MAX_WORDS 4096                 // a block's scan: <= 131072 PUs
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ bool better(double k, long long i,
                                       double bk, long long bi) {
    return (k < bk) || (k == bk && i < bi);
}

// bits [0, x) of a 32-bit word, x in [0, 32]
__device__ __forceinline__ unsigned below(long long x) {
    return x >= 32 ? FULL_MASK : ((1u << (unsigned)x) - 1u);
}

__device__ __forceinline__ double node_term(double hopsum, double lqc,
                                            long long lc, double depth) {
    // no fused multiply-add: the plain version rounds each product
    return __dadd_rn(hopsum, __dmul_rn(__dmul_rn(lqc, (double)lc),
                                       __dadd_rn(depth, 1.0)));
}

struct ScanArgs {
    const unsigned char* ok;
    const double* key;
    const double* sa;
    const double* f;
    const double* cm;
    const long long* pu_lo;
    const long long* pu_hi;
    const long long* leafcnt;
    const long long* nchild;
    const double* hopsum;
    const double* depth;
    // per scan [ok_off, P, node_off, Nn] (S rows), then perm (S entries);
    // null for a stack of one, whose P / Nn come as scalars
    const long long* meta;
    long long S, n_small, P0, Nn0;
    double lqc;
    double* out;
};

__device__ __forceinline__ void scan_of(const ScanArgs& a, long long k,
                                        long long& s, long long& ok_off,
                                        long long& P, long long& node_off,
                                        long long& Nn) {
    if (a.meta == nullptr) {
        s = 0; ok_off = 0; P = a.P0; node_off = 0; Nn = a.Nn0;
        return;
    }
    s = a.meta[4 * a.S + k];
    ok_off = a.meta[4 * s];
    P = a.meta[4 * s + 1];
    node_off = a.meta[4 * s + 2];
    Nn = a.meta[4 * s + 3];
}

__device__ __forceinline__ void write_row(const ScanArgs& a, long long s,
                                          bool root_ok, long long ok_off,
                                          long long w, long long q,
                                          long long h, double ov) {
    double* o = a.out + 7 * s;
    if (!root_ok) {
        o[0] = -1.0;
        for (int j = 1; j < 7; ++j) o[j] = 0.0;
        return;
    }
    o[0] = (double)w;
    o[1] = (double)q;
    o[2] = (double)h;
    o[3] = ov;
    o[4] = a.sa[ok_off + w];
    o[5] = a.f[ok_off + w];
    o[6] = a.cm[ok_off + w];
}

// one warp, one scan of at most 32 PUs
static __device__ void warp_scan(const ScanArgs& a, long long k, int lane) {
    long long s, ok_off, P, node_off, Nn;
    scan_of(a, k, s, ok_off, P, node_off, Nn);
    const bool o = lane < P && a.ok[ok_off + lane];
    double bk = o ? a.key[ok_off + lane] : CUDART_INF;
    long long bi = o ? (long long)lane : 0x7fffffffffffffffLL;
    for (int d = 16; d > 0; d >>= 1) {
        const double k2 = __shfl_xor_sync(FULL_MASK, bk, d);
        const long long i2 = __shfl_xor_sync(FULL_MASK, bi, d);
        if (better(k2, i2, bk, bi)) { bk = k2; bi = i2; }
    }
    const unsigned okbits = __ballot_sync(FULL_MASK, o);
    const long long* lo = a.pu_lo + node_off;
    const long long* hi = a.pu_hi + node_off;
    long long q = 0, h = 0;
    double ov = 0.0;
    for (long long n = lane; n < Nn; n += 32) {
        if (okbits & below(hi[n]) & ~below(lo[n])) {
            const long long lc = a.leafcnt[node_off + n];
            q += lc;
            h += a.nchild[node_off + n];
            ov = __dadd_rn(ov, node_term(a.hopsum[node_off + n], a.lqc, lc,
                                         a.depth[node_off + n]));
        }
    }
    for (int d = 16; d > 0; d >>= 1) {
        ov = __dadd_rn(ov, __shfl_xor_sync(FULL_MASK, ov, d));
        q += __shfl_xor_sync(FULL_MASK, q, d);
        h += __shfl_xor_sync(FULL_MASK, h, d);
    }
    if (lane == 0) {
        const bool root_ok = Nn > 0 && (okbits & below(hi[0]) & ~below(lo[0]));
        write_row(a, s, root_ok, ok_off, bi, q, h, ov);
    }
}

// one block, one scan of up to SR_MAX_P PUs
static __device__ void block_scan(const ScanArgs& a, long long k) {
    __shared__ unsigned sW[SR_MAX_WORDS + 1];   // ok bits, 32 PUs a word
    __shared__ int sC[SR_MAX_WORDS + 1];        // set bits before word w
    __shared__ int sT[SR_WARPS];
    __shared__ double sK[SR_WARPS];
    __shared__ long long sI[SR_WARPS];
    __shared__ long long sQ[SR_WARPS];
    __shared__ long long sH[SR_WARPS];
    __shared__ double sO[SR_WARPS];
    __shared__ unsigned char sRoot;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int wid = t >> 5;
    long long s, ok_off, P, node_off, Nn;
    scan_of(a, k, s, ok_off, P, node_off, Nn);
    const unsigned char* ok = a.ok + ok_off;
    const int nW = (int)((P + 31) / 32);

    // 1. one ballot per 32 PUs (coalesced byte loads) and the (key,
    //    index) argmin over the feasible ones
    double bk = CUDART_INF;
    long long bi = 0x7fffffffffffffffLL;
    for (int w = wid; w < nW; w += SR_WARPS) {
        const long long i = 32LL * w + lane;
        const bool o = i < P && ok[i];
        const unsigned word = __ballot_sync(FULL_MASK, o);
        if (o) {
            const double kv = a.key[ok_off + i];
            if (better(kv, i, bk, bi)) { bk = kv; bi = i; }
        }
        if (lane == 0) sW[w] = word;
    }
    if (t == 0) sW[nW] = 0u;
    for (int d = 16; d > 0; d >>= 1) {
        const double k2 = __shfl_xor_sync(FULL_MASK, bk, d);
        const long long i2 = __shfl_xor_sync(FULL_MASK, bi, d);
        if (better(k2, i2, bk, bi)) { bk = k2; bi = i2; }
    }
    __syncthreads();

    // 2. exclusive prefix of the words' popcounts: a contiguous chunk of
    //    words per thread, the chunk totals scanned across the block
    const int chunk = (nW + SR_THREADS - 1) / SR_THREADS;
    const int w0 = t * chunk < nW ? t * chunk : nW;
    const int w1 = w0 + chunk < nW ? w0 + chunk : nW;
    int tot = 0;
    for (int w = w0; w < w1; ++w) tot += __popc(sW[w]);
    int incl = tot;
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) sT[wid] = incl;
    __syncthreads();
    if (t == 0) {
        int run = 0;
        for (int j = 0; j < SR_WARPS; ++j) {
            const int v = sT[j];
            sT[j] = run;
            run += v;
        }
        sC[nW] = run;                            // every set bit
    }
    __syncthreads();
    int run = sT[wid] + incl - tot;
    for (int w = w0; w < w1; ++w) {
        sC[w] = run;
        run += __popc(sW[w]);
    }
    __syncthreads();

    // 3. one thread per plan node: feasible when [lo, hi) holds a set bit,
    //    i.e. cs(hi) > cs(lo) with cs(x) = ok bits before position x
    long long q = 0, h = 0;
    double ov = 0.0;
    for (long long n = t; n < Nn; n += SR_THREADS) {
        long long lo = a.pu_lo[node_off + n];
        long long hi = a.pu_hi[node_off + n];
        lo = lo < P ? lo : P;
        hi = hi < P ? hi : P;
        const int cl = sC[lo >> 5] + __popc(sW[lo >> 5] & below(lo & 31));
        const int ch = sC[hi >> 5] + __popc(sW[hi >> 5] & below(hi & 31));
        const bool feas = ch > cl;
        if (n == 0) sRoot = feas ? 1 : 0;
        if (feas) {
            const long long lc = a.leafcnt[node_off + n];
            q += lc;
            h += a.nchild[node_off + n];
            ov = __dadd_rn(ov, node_term(a.hopsum[node_off + n], a.lqc, lc,
                                         a.depth[node_off + n]));
        }
    }
    for (int d = 16; d > 0; d >>= 1) {
        ov = __dadd_rn(ov, __shfl_xor_sync(FULL_MASK, ov, d));
        q += __shfl_xor_sync(FULL_MASK, q, d);
        h += __shfl_xor_sync(FULL_MASK, h, d);
    }
    if (lane == 0) {
        sK[wid] = bk;
        sI[wid] = bi;
        sQ[wid] = q;
        sH[wid] = h;
        sO[wid] = ov;
    }
    __syncthreads();
    if (t == 0) {
        double kk = sK[0], oo = sO[0];
        long long ii = sI[0], qq = sQ[0], hh = sH[0];
        for (int j = 1; j < SR_WARPS; ++j) {
            if (better(sK[j], sI[j], kk, ii)) { kk = sK[j]; ii = sI[j]; }
            qq += sQ[j];
            hh += sH[j];
            oo = __dadd_rn(oo, sO[j]);
        }
        write_row(a, s, Nn > 0 && sRoot, ok_off, ii, qq, hh, oo);
    }
}
