// The entry scan of one phase-2 re-walk, in one launch of one block.
//
// The walk's ordered commit re-walks a task whose entry plan covers one
// device when an earlier commit of the wave landed there.  Its two-step
// path is B1's same-device check over that device's ledger segment, the
// constraint glue around it, a splice into the task core's scan state, a
// patch of the signature's effective columns and B4's reduce of the plan:
// some fifty small PyTorch ops, two kernel launches and up to five host
// reads.  This kernel does the same arithmetic in one launch, and the
// caller reads its nine values with one copy:
//
//   1. the scan state's segment [lo, lo + nseg) reset to the infeasible
//      defaults (ok 0, sa +inf, f 1, wait 0);
//   2. B1's same-device form (slowdown_factors.cuh): the newcomer's factor
//      on each eligible candidate against the actives of the device's
//      ledger segment, each active's base pressures, and per (candidate,
//      active) pair the active's factor if the newcomer joins;
//   3. the constraint glue: per pair Alg. 1 l.15's verdict (an active's
//      predicted finish past its deadline) and the earliest instant the
//      verdict can flip; per candidate the tenancy count on its PU, the
//      wait behind the earliest finisher where the cap is reached; over
//      the check, whether a positive wait exists and the earliest flip;
//   4. the splice: each candidate's ok / sa / f / wait into the scan state;
//   5. the effective layer over the segment: cm = comm + wait at the
//      signature's columns (0 elsewhere), key = cm + sa * f, ok masked by
//      the deadline;
//   6. B4's reduce of the plan (scan_reduce.cuh), in the warp form for at
//      most 32 PUs and the block form above, as a stack of one takes them.
//
// out = [winner, queries, hops, overhead, sa[w], f[w], cm[w], waiting,
// flip]: the scan's seven values, then the two values the host turns into
// the segment's expiry instant (flip is +inf without a pair).
//
// Every add, multiply and divide is rounded on its own (__dadd_rn,
// __dmul_rn, __ddiv_rn: no contraction), in the order of the two-step
// path's PyTorch ops, so the columns it writes and the row it returns equal
// the two-step path's to the bit; counts are exact, minima and flags
// independent of order.  The kernel replaces no TPU kernel: the reference
// re-walks through the same two steps (repro/core/orchestrator.py).  Bound
// by launch latency: a device holds a handful of PUs and tens of actives,
// so the block does microseconds of work; what it saves is the two-step
// path's host time, its launches and all its host reads but one.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "slowdown_factors.cuh"
#include "scan_reduce.cuh"

#define RW_THREADS SR_THREADS    // block_scan takes the whole block

// Alg. 1 l.15's tolerance on an active's deadline, as the glue rounds it
constexpr double RW_DL_SLACK = 1.0 + 1e-9;

// torch.isfinite
__device__ __forceinline__ bool rw_finite(double x) {
    return x == x && x != CUDART_INF && x != -CUDART_INF;
}

// The launch's arguments, every field 8 bytes, in the order of
// kernels/walk_kernel.py RW_FIELDS.
struct RwArgs {
    // the newcomer's eligible candidates on the device, in the check's
    // order: PU index, device ordinal, position in the segment,
    // standalone, tenancy cap
    const long long* Pc;
    const long long* Dc;
    const long long* cols;
    const double* sa;
    const long long* maxten;
    long long C;
    // the signature's columns: position in the plan, comm
    const long long* ecols;
    const double* comm;
    long long C2;
    // the device's ledger view (A rows) and its per-ordinal segments
    const long long* Pa;
    const double* Ua;
    const double* Ma;
    const long long* uid_a;
    const double* est;
    const double* fac;
    const double* dl_a;
    const double* rel;
    const long long* astart;
    const long long* na;
    long long A;
    long long nd;
    // the snapshot's tables
    const int16_t* ncr;
    long long nP;
    const double* mt_vec;
    const double* mem_cap;
    const double* beta;
    long long R;
    double kappa;
    // the newcomer
    double u_new;
    double mem_new;
    long long uid_new;
    long long has_dl;
    double dl;
    double now;
    // the scan state's columns and the segment rewritten
    unsigned char* st_ok;
    double* st_sa;
    double* st_f;
    double* st_wait;
    long long lo;
    long long nseg;
    // the effective columns over the plan's P PUs
    unsigned char* ok;
    double* cm;
    double* key;
    long long P;
    // the plan
    const long long* pu_lo;
    const long long* pu_hi;
    const long long* leafcnt;
    const long long* nchild;
    const double* hopsum;
    const double* depth;
    long long Nn;
    double lqc;
    // the row and the scratch: a factor and a wait per candidate, a flag
    // per candidate, R + 1 base pressures per active, the wide pressures
    double* out;
    double* nf;
    double* waitc;
    int* bad;
    double* base;
    double* wide;
};
static_assert(sizeof(RwArgs) % 8 == 0, "RwArgs is a row of 8-byte fields");

template <class Acc>
__global__ void __launch_bounds__(RW_THREADS)
rewalk_entry_kernel(const RwArgs a) {
    __shared__ double sFlip[SR_WARPS];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int wid = t >> 5;
    const int R = (int)a.R;
    const int R1 = R + 1;
    const long long C = a.C;
    const bool glue = C > 0 && a.A > 0;

    // the device's ledger segment; every candidate on that device
    long long s0 = 0, n0 = 0;
    if (glue) {
        const long long d0 = a.Dc[0];
        if (d0 < 0 || d0 >= a.nd) __trap();
        s0 = a.astart[d0];
        n0 = a.na[d0];
        if (s0 < 0 || n0 < 0 || s0 + n0 > a.A) __trap();
        for (long long c = t; c < C; c += RW_THREADS)
            if (a.Dc[c] != d0) __trap();
    }

    // 1. the segment's defaults, each candidate's flag cleared
    for (long long i = t; i < a.nseg; i += RW_THREADS) {
        const long long p = a.lo + i;
        a.st_ok[p] = 0;
        a.st_sa[p] = CUDART_INF;
        a.st_f[p] = 1.0;
        a.st_wait[p] = 0.0;
    }
    for (long long c = t; c < C; c += RW_THREADS) a.bad[c] = 0;

    // 2. B1: each candidate's factor, then each active's base pressures
    for (long long w = t; w < C + n0; w += RW_THREADS) {
        Acc acc;
        acc.bind(a.wide, t, RW_THREADS, R);
        acc.zero();
        if (w < C) {
            if (n0 == 0) {             // no pair: the factors of no check
                a.nf[w] = 1.0;
                continue;
            }
            const long long pc = a.Pc[w];
            segment_pressures(acc, s0, n0, a.uid_new, pc, a.ncr + pc * a.nP,
                              a.Pa, a.Ua, a.Ma, a.uid_a);
            a.nf[w] = acc.factor(
                a.beta, R, clamp_max(a.mem_cap[pc], a.mem_new),
                __dmul_rn(pterm(a.mt_vec[pc], acc.mt, a.kappa), a.u_new),
                a.kappa);
        } else {
            const long long r = s0 + (w - C);
            const long long pa = a.Pa[r];
            segment_pressures(acc, s0, n0, a.uid_a[r], pa, a.ncr + pa * a.nP,
                              a.Pa, a.Ua, a.Ma, a.uid_a);
            acc.store(a.base + (r - s0) * R1, R);
        }
    }
    __syncthreads();

    // 3. per (candidate, active) pair, candidates in order, each with the
    //    actives of the segment in ledger order: B1's joined factor, then
    //    l.15's verdict and the flip instant
    double flip = CUDART_INF;
    const long long K = C * n0;
    for (long long k = t; k < K; k += RW_THREADS) {
        const long long c = k / n0;
        const long long r = s0 + (k - c * n0);
        const long long pc = a.Pc[c];
        const long long pa = a.Pa[r];
        const bool live = a.uid_a[r] != a.uid_new;
        const double* row = a.base + (r - s0) * R1;
        const int rac = a.ncr[pa * a.nP + pc];
        const int join = (live && pa != pc && rac >= 0) ? rac : -1;
        const double same = (live && pa == pc) ? 1.0 : 0.0;
        const double mtp = __dadd_rn(row[R], __dmul_rn(same, a.u_new));
        const double pf = Acc::pair_factor(
            row, R, join, clamp_max(a.mem_cap[pc], a.mem_new), a.beta,
            a.Ma[r], __dmul_rn(pterm(a.mt_vec[pa], mtp, a.kappa), a.Ua[r]),
            a.kappa);
        const double est = a.est[r];
        const double fac = a.fac[r] < 1e-12 ? 1e-12 : a.fac[r];
        double rem = __dsub_rn(est, a.now);
        rem = rem < 0.0 ? 0.0 : rem;
        rem = __ddiv_rn(rem, fac);
        const double fin = __dadd_rn(a.now, __dmul_rn(rem, pf));
        const double dlp = __dmul_rn(a.dl_a[r], RW_DL_SLACK);
        const bool fine = rw_finite(dlp);
        const double rel = a.rel[r];
        if (fine && __dsub_rn(fin, rel) > dlp) a.bad[c] = 1;
        // fin(t) is piecewise linear in t: the verdict flips only at
        // t1 in [now, est) or at t2 = rel + dl' in [max(now, est), inf)
        const double ratio = __ddiv_rn(pf, fac);
        const double t2 = __dadd_rn(rel, dlp);
        const double t1 = __ddiv_rn(__dsub_rn(t2, __dmul_rn(est, ratio)),
                                    __dsub_rn(1.0, ratio));
        const double f1 = (fine && ratio != 1.0 && t1 >= a.now && t1 < est)
            ? t1 : CUDART_INF;
        const double f2 = (fine && t2 >= a.now && t2 >= est) ? t2
            : CUDART_INF;
        flip = nan_min(flip, nan_min(f1, f2));
    }

    //    per candidate: its tenancy count over the view's rows (an active
    //    counts for the first candidate on its PU), the wait behind the
    //    earliest finisher where the cap is reached
    int waiting = 0;
    for (long long c = t; c < C; c += RW_THREADS) {
        double wt = 0.0;
        if (glue) {
            const long long pc = a.Pc[c];
            bool first = true;
            for (long long c2 = 0; c2 < c && first; ++c2)
                first = a.Pc[c2] != pc;
            long long cnt = 0;
            double mn = CUDART_INF;
            if (first) {
                for (long long r = 0; r < a.A; ++r) {
                    if (a.Pa[r] == pc) {
                        ++cnt;
                        mn = a.est[r] < mn ? a.est[r] : mn;
                    }
                }
            }
            if (cnt >= a.maxten[c]) {
                wt = __dsub_rn(mn, a.now);
                wt = wt < 0.0 ? 0.0 : wt;
                if (mn > a.now) waiting = 1;
            }
        }
        a.waitc[c] = wt;
    }
    waiting = __syncthreads_or(waiting);
    for (int d = 16; d > 0; d >>= 1)
        flip = nan_min(flip, __shfl_xor_sync(FULL_MASK, flip, d));
    if (lane == 0) sFlip[wid] = flip;
    __syncthreads();
    if (t == 0) {
        double f = sFlip[0];
        for (int j = 1; j < SR_WARPS; ++j) f = nan_min(f, sFlip[j]);
        a.out[7] = waiting ? 1.0 : 0.0;
        a.out[8] = f;
    }

    // 4. the splice into the scan state
    for (long long c = t; c < C; c += RW_THREADS) {
        const long long q = a.cols[c];
        if (q < 0 || q >= a.nseg) __trap();
        const long long p = a.lo + q;
        a.st_ok[p] = a.bad[c] == 0;
        a.st_sa[p] = a.sa[c];
        a.st_f[p] = a.nf[c];
        a.st_wait[p] = a.waitc[c];
    }
    __syncthreads();

    // 5. the effective layer over the segment
    for (long long i = t; i < a.nseg; i += RW_THREADS) a.cm[a.lo + i] = 0.0;
    __syncthreads();
    for (long long j = t; j < a.C2; j += RW_THREADS) {
        const long long p = a.ecols[j];
        if (p < a.lo || p >= a.lo + a.nseg) __trap();
        a.cm[p] = __dadd_rn(a.comm[j], a.st_wait[p]);
    }
    __syncthreads();
    for (long long i = t; i < a.nseg; i += RW_THREADS) {
        const long long p = a.lo + i;
        const double k = __dadd_rn(a.cm[p], __dmul_rn(a.st_sa[p], a.st_f[p]));
        a.key[p] = k;
        a.ok[p] = a.st_ok[p] && !(a.has_dl && k > a.dl);
    }
    __syncthreads();

    // 6. B4 over the plan
    ScanArgs s;
    s.ok = a.ok;
    s.key = a.key;
    s.sa = a.st_sa;
    s.f = a.st_f;
    s.cm = a.cm;
    s.pu_lo = a.pu_lo;
    s.pu_hi = a.pu_hi;
    s.leafcnt = a.leafcnt;
    s.nchild = a.nchild;
    s.hopsum = a.hopsum;
    s.depth = a.depth;
    s.meta = nullptr;
    s.S = 1;
    s.n_small = 0;
    s.P0 = a.P;
    s.Nn0 = a.Nn;
    s.lqc = a.lqc;
    s.out = a.out;
    if (a.P <= SR_WARP_MAX_P) {
        if (wid == 0) warp_scan(s, 0, lane);
    } else {
        block_scan(s, 0);
    }
}

// doubles of class scratch a launch takes: none where the pressures fit in
// registers, else R per thread of the block
extern "C" long long heye_rewalk_entry_wide_len(int R) {
    return R <= SD_REG_CLASSES ? 0 : (long long)R * RW_THREADS;
}

// one re-walk's entry scan: `args` points to an RwArgs row of `nbytes`
extern "C" int heye_rewalk_entry(const void* args, long long nbytes,
                                 void* stream) {
    if (args == nullptr || nbytes != (long long)sizeof(RwArgs))
        return (int)cudaErrorInvalidValue;
    RwArgs a;
    memcpy(&a, args, sizeof(RwArgs));
    if (a.R < 0 || a.C < 0 || a.C2 < 0 || a.A < 0 || a.nd < 0 || a.P <= 0
            || a.P > 32LL * SR_MAX_WORDS || a.Nn <= 0 || a.lo < 0
            || a.nseg < 0 || a.lo + a.nseg > a.P || a.out == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (a.R <= SD_REG_CLASSES) {
        rewalk_entry_kernel<Pressures><<<1, RW_THREADS, 0, st>>>(a);
    } else {
        if (a.wide == nullptr) return (int)cudaErrorInvalidValue;
        rewalk_entry_kernel<WidePressures><<<1, RW_THREADS, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}
