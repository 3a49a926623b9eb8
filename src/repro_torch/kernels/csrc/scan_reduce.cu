// Alg. 1 subtree-scan accounting reduce over a ragged stack of scans,
// float64 / int64.  For every scan s (its PUs at ok[ok_off : ok_off + P],
// its plan nodes at [node_off, node_off + Nn) of the concatenated plan
// arrays, node ranges relative to the scan's own PU order):
//
//   feas[n]  = any(ok[pu_lo[n] : pu_hi[n]])
//   winner   = first feasible position attaining the minimum key
//              (still a feasible position when every key is +inf;
//              -1 when the scan root, node 0, is infeasible)
//   queries  = sum(leafcnt[feas]);  hops = sum(nchild[feas])
//   overhead = sum((hopsum + lqc * leafcnt * (depth + 1))[feas])
//
// and out[7 s : 7 s + 7] = [winner, queries, hops, overhead, sa[w], f[w],
// cm[w]] (the winner's prediction columns gathered here, so the caller
// needs no further op), or [-1, 0, 0, 0, 0, 0, 0] when the root is
// infeasible.
//
// Work per scan is tiny (the walk's device scans have 6 PUs and one node)
// and scans arrive a thousand at a time, so the layout follows the scan:
//
// * a scan of at most 32 PUs gets ONE WARP: lane i holds PU i, a ballot of
//   `ok` is the whole prefix (a node is feasible when the ballot has a bit
//   in [pu_lo, pu_hi)), the (key, index) argmin and the sums are butterfly
//   shuffles, so there is no shared memory, no block barrier and no global
//   scratch; eight scans share a block;
// * a larger scan (a group- or root-level scan, 8448 PUs at mult=128) gets
//   a BLOCK: one ballot per 32 PUs packs `ok` into bit words in shared
//   memory (the argmin rides along), a block scan of the words' popcounts
//   makes the prefix, and then one THREAD per plan node tests its range in
//   O(1) (two popcounts), so the nodes' loads are independent and
//   coalesced; partials are combined in lane, then warp order.  The words
//   take 32 KB of shared memory: up to 131072 PUs per scan;
// * a scan of more PUs (a root scan past mult ~1985 of the mining fleet)
//   takes the GRID, in four launches of its own (heye_scan_reduce_big):
//   the word pass packs `ok` into bit words in a global scratch, 256
//   words a block, with each word's popcount prefix within its block,
//   the block's total and its (key, index) argmin; one thread turns the
//   block totals into block prefixes and picks the winner; the node pass
//   tests each node's range in O(1) as above, from the global words, and
//   leaves per-block partials; one thread sums them in block order and
//   writes the row.
//
// The first two kinds go in one launch: blocks [0, n_warp_blocks) take
// the warp scans, the next n_large blocks one large scan each (`perm`
// lists the warp scans first, then the large ones, then any scan that
// takes the grid form).
// The argmin orders candidates by (key, index), so ties resolve to the
// lowest position whatever the thread layout; the integer sums are exact
// in int64; the overhead is summed in a fixed order (lane / warp order, a
// fixed butterfly), so it is reproducible from run to run.  Every input
// is read at most once per enclosing plan node: bound by bytes moved, and
// at the walk's sizes by launch latency, which is why a whole wave of
// entry scans is one launch.  Replaces repro/kernels/walk_kernel.py
// scan_reduce (:150) and scan_reduce_batch (:168, a jit(vmap) of it).
// warp_scan and block_scan, which the walk's fused re-walk (rewalk.cu)
// runs too, are in scan_reduce.cuh.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_reduce.cuh"

__global__ void __launch_bounds__(SR_THREADS)
scan_reduce_batch_kernel(ScanArgs a, long long n_warp_blocks) {
    if ((long long)blockIdx.x < n_warp_blocks) {
        const long long k = (long long)blockIdx.x * SR_WARPS
                            + (threadIdx.x >> 5);
        if (k < a.n_small) warp_scan(a, k, threadIdx.x & 31);
    } else {
        block_scan(a, a.n_small + (long long)blockIdx.x - n_warp_blocks);
    }
}

extern "C" int heye_scan_reduce_batch(
        const void* ok, const void* key, const void* sa, const void* f,
        const void* cm, const void* pu_lo, const void* pu_hi,
        const void* leafcnt, const void* nchild, const void* hopsum,
        const void* depth, const void* meta, long long S, long long n_small,
        long long n_large, long long P0, long long Nn0, double lqc, void* out,
        void* stream) {
    if (S <= 0 || n_small + n_large <= 0) return 0;
    ScanArgs a;
    a.ok = (const unsigned char*)ok;
    a.key = (const double*)key;
    a.sa = (const double*)sa;
    a.f = (const double*)f;
    a.cm = (const double*)cm;
    a.pu_lo = (const long long*)pu_lo;
    a.pu_hi = (const long long*)pu_hi;
    a.leafcnt = (const long long*)leafcnt;
    a.nchild = (const long long*)nchild;
    a.hopsum = (const double*)hopsum;
    a.depth = (const double*)depth;
    a.meta = (const long long*)meta;
    a.S = S;
    a.n_small = n_small;
    a.P0 = P0;
    a.Nn0 = Nn0;
    a.lqc = lqc;
    a.out = (double*)out;
    const long long n_warp_blocks = (n_small + SR_WARPS - 1) / SR_WARPS;
    const long long blocks = n_warp_blocks + n_large;
    scan_reduce_batch_kernel<<<(unsigned)blocks, SR_THREADS, 0,
                               (cudaStream_t)stream>>>(a, n_warp_blocks);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the grid form: one scan of any number of PUs
// ---------------------------------------------------------------------------
#define SR_BIG_WPB SR_THREADS            // words per block of the word pass

struct BigScratch {
    unsigned* W;        // nWt bit words of `ok` (the last one empty)
    int* Cl;            // set bits before each word within its block
    long long* T;       // set bits per word block
    long long* Bp;      // set bits before each word block
    double* BK;         // per word block: its (key, index) argmin
    long long* BI;
    long long* NQ;      // per node block: queries, hops, overhead
    long long* NH;
    double* NO;
    double* win_k;      // the scan's argmin and whether its root is feasible
    long long* win_i;
    long long* root;
    long long nWt, nB1, nB3;
};

static long long align8(long long b) { return (b + 7) & ~7LL; }

// the scratch layout of a scan of P PUs and Nn nodes; its size in bytes
static long long big_layout(long long P, long long Nn, char* base,
                            BigScratch* s) {
    const long long nWt = (P + 31) / 32 + 1;
    const long long nB1 = (nWt + SR_BIG_WPB - 1) / SR_BIG_WPB;
    const long long nB3 = (Nn + SR_THREADS - 1) / SR_THREADS;
    long long o = 0;
    s->W = (unsigned*)(base + o);   o += align8(4 * nWt);
    s->Cl = (int*)(base + o);       o += align8(4 * nWt);
    s->T = (long long*)(base + o);  o += 8 * nB1;
    s->Bp = (long long*)(base + o); o += 8 * nB1;
    s->BK = (double*)(base + o);    o += 8 * nB1;
    s->BI = (long long*)(base + o); o += 8 * nB1;
    s->NQ = (long long*)(base + o); o += 8 * nB3;
    s->NH = (long long*)(base + o); o += 8 * nB3;
    s->NO = (double*)(base + o);    o += 8 * nB3;
    s->win_k = (double*)(base + o); o += 8;
    s->win_i = (long long*)(base + o); o += 8;
    s->root = (long long*)(base + o);  o += 8;
    s->nWt = nWt;
    s->nB1 = nB1;
    s->nB3 = nB3;
    return o;
}

// block b packs words [b * 256, (b + 1) * 256): warp w the 32 from
// b * 256 + 32 w, one ballot each; thread t keeps word b * 256 + t
__global__ void __launch_bounds__(SR_THREADS)
big_words_kernel(ScanArgs a, BigScratch s) {
    __shared__ int sT[SR_WARPS];
    __shared__ double sK[SR_WARPS];
    __shared__ long long sI[SR_WARPS];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int wid = t >> 5;
    const long long P = a.P0;
    const long long w0 = (long long)blockIdx.x * SR_BIG_WPB + 32 * wid;
    unsigned mine = 0u;
    double bk = CUDART_INF;
    long long bi = 0x7fffffffffffffffLL;
    for (int j = 0; j < 32; ++j) {
        const long long i = 32 * (w0 + j) + lane;
        const bool o = i < P && a.ok[i];
        const unsigned word = __ballot_sync(FULL_MASK, o);
        if (o) {
            const double kv = a.key[i];
            if (better(kv, i, bk, bi)) { bk = kv; bi = i; }
        }
        if (lane == j) mine = word;
    }
    for (int d = 16; d > 0; d >>= 1) {
        const double k2 = __shfl_xor_sync(FULL_MASK, bk, d);
        const long long i2 = __shfl_xor_sync(FULL_MASK, bi, d);
        if (better(k2, i2, bk, bi)) { bk = k2; bi = i2; }
    }
    // exclusive prefix of the popcounts in thread (= word) order
    const int pc = __popc(mine);
    int incl = pc;
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) sT[wid] = incl;
    if (lane == 0) {
        sK[wid] = bk;
        sI[wid] = bi;
    }
    __syncthreads();
    int before = 0;
    for (int j = 0; j < wid; ++j) before += sT[j];
    const long long w = w0 + lane;
    if (w < s.nWt) {
        s.W[w] = mine;
        s.Cl[w] = before + incl - pc;
    }
    if (t == 0) {
        long long tot = 0;
        double kk = sK[0];
        long long ii = sI[0];
        for (int j = 0; j < SR_WARPS; ++j) {
            tot += sT[j];
            if (better(sK[j], sI[j], kk, ii)) { kk = sK[j]; ii = sI[j]; }
        }
        s.T[blockIdx.x] = tot;
        s.BK[blockIdx.x] = kk;
        s.BI[blockIdx.x] = ii;
    }
}

// one thread: the word blocks' prefixes and the scan's argmin
__global__ void big_blocks_kernel(BigScratch s) {
    long long run = 0;
    double kk = CUDART_INF;
    long long ii = 0x7fffffffffffffffLL;
    for (long long b = 0; b < s.nB1; ++b) {
        s.Bp[b] = run;
        run += s.T[b];
        if (better(s.BK[b], s.BI[b], kk, ii)) { kk = s.BK[b]; ii = s.BI[b]; }
    }
    *s.win_k = kk;
    *s.win_i = ii;
}

// set bits of `ok` before position x (0 <= x <= P)
__device__ __forceinline__ long long big_cs(const BigScratch& s, long long x) {
    const long long w = x >> 5;
    return s.Bp[w / SR_BIG_WPB] + s.Cl[w]
        + __popc(s.W[w] & below(x & 31));
}

// one thread per plan node; per-block partials in lane, then warp order
__global__ void __launch_bounds__(SR_THREADS)
big_nodes_kernel(ScanArgs a, BigScratch s) {
    __shared__ long long sQ[SR_WARPS];
    __shared__ long long sH[SR_WARPS];
    __shared__ double sO[SR_WARPS];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int wid = t >> 5;
    const long long P = a.P0;
    const long long n = (long long)blockIdx.x * SR_THREADS + t;
    long long q = 0, h = 0;
    double ov = 0.0;
    if (n < a.Nn0) {
        long long lo = a.pu_lo[n];
        long long hi = a.pu_hi[n];
        lo = lo < P ? lo : P;
        hi = hi < P ? hi : P;
        const bool feas = big_cs(s, hi) > big_cs(s, lo);
        if (n == 0) *s.root = feas ? 1 : 0;
        if (feas) {
            const long long lc = a.leafcnt[n];
            q = lc;
            h = a.nchild[n];
            ov = node_term(a.hopsum[n], a.lqc, lc, a.depth[n]);
        }
    }
    for (int d = 16; d > 0; d >>= 1) {
        ov = __dadd_rn(ov, __shfl_xor_sync(FULL_MASK, ov, d));
        q += __shfl_xor_sync(FULL_MASK, q, d);
        h += __shfl_xor_sync(FULL_MASK, h, d);
    }
    if (lane == 0) {
        sQ[wid] = q;
        sH[wid] = h;
        sO[wid] = ov;
    }
    __syncthreads();
    if (t == 0) {
        long long qq = sQ[0], hh = sH[0];
        double oo = sO[0];
        for (int j = 1; j < SR_WARPS; ++j) {
            qq += sQ[j];
            hh += sH[j];
            oo = __dadd_rn(oo, sO[j]);
        }
        s.NQ[blockIdx.x] = qq;
        s.NH[blockIdx.x] = hh;
        s.NO[blockIdx.x] = oo;
    }
}

// one thread: the node blocks' partials in block order, then the row
__global__ void big_final_kernel(ScanArgs a, BigScratch s) {
    long long q = 0, h = 0;
    double ov = 0.0;
    for (long long b = 0; b < s.nB3; ++b) {
        q += s.NQ[b];
        h += s.NH[b];
        ov = __dadd_rn(ov, s.NO[b]);
    }
    write_row(a, 0, a.Nn0 > 0 && *s.root != 0, 0, *s.win_i, q, h, ov);
}

extern "C" long long heye_scan_reduce_big_bytes(long long P, long long Nn) {
    BigScratch s;
    return big_layout(P, Nn, nullptr, &s);
}

// one scan of P PUs (columns at ok_off, nodes at node_off) into the 7
// doubles at out, through `scratch` (heye_scan_reduce_big_bytes long)
extern "C" int heye_scan_reduce_big(
        const void* ok, const void* key, const void* sa, const void* f,
        const void* cm, const void* pu_lo, const void* pu_hi,
        const void* leafcnt, const void* nchild, const void* hopsum,
        const void* depth, long long ok_off, long long P, long long node_off,
        long long Nn, double lqc, void* out, void* scratch,
        long long scratch_bytes, void* stream) {
    if (P < 0 || Nn <= 0) return (int)cudaErrorInvalidValue;
    BigScratch s;
    if (scratch == nullptr
            || big_layout(P, Nn, (char*)scratch, &s) > scratch_bytes)
        return (int)cudaErrorInvalidValue;
    ScanArgs a;
    a.ok = (const unsigned char*)ok + ok_off;
    a.key = (const double*)key + ok_off;
    a.sa = (const double*)sa + ok_off;
    a.f = (const double*)f + ok_off;
    a.cm = (const double*)cm + ok_off;
    a.pu_lo = (const long long*)pu_lo + node_off;
    a.pu_hi = (const long long*)pu_hi + node_off;
    a.leafcnt = (const long long*)leafcnt + node_off;
    a.nchild = (const long long*)nchild + node_off;
    a.hopsum = (const double*)hopsum + node_off;
    a.depth = (const double*)depth + node_off;
    a.meta = nullptr;
    a.S = 1;
    a.n_small = 0;
    a.P0 = P;
    a.Nn0 = Nn;
    a.lqc = lqc;
    a.out = (double*)out;
    cudaStream_t st = (cudaStream_t)stream;
    big_words_kernel<<<(unsigned)s.nB1, SR_THREADS, 0, st>>>(a, s);
    big_blocks_kernel<<<1, 1, 0, st>>>(s);
    big_nodes_kernel<<<(unsigned)s.nB3, SR_THREADS, 0, st>>>(a, s);
    big_final_kernel<<<1, 1, 0, st>>>(a, s);
    return (int)cudaGetLastError();
}
