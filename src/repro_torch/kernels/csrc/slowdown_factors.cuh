// The device code of the slowdown factor aggregation (H-EYE section 3.4)
// that more than one kernel runs: the pressure term, a row's class
// pressures in registers (Pressures) or in a strided scratch
// (WidePressures), and the pressures of one ledger segment on one PU.
// slowdown_factors.cu builds its three forms on it, rewalk.cu the walk's
// fused re-walk; every product and sum is rounded on its own
// (__dmul_rn / __dadd_rn), so each form agrees to the bit with the others
// and with its plain PyTorch version.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define SD_REG_CLASSES 16
#define SD_PREFETCH 8
#define SD_MT SD_REG_CLASSES     // put()'s key of the tenancy pressure
#define SD_MT_WIDE 0x40000000    // the same key where classes reach past 16

// term(b, x) as the plain version rounds it: (b * x) * (1 + kappa * x)
__device__ __forceinline__ double pterm(double b, double x, double kappa) {
    if (x > 0.0 && b > 0.0)
        return __dmul_rn(__dmul_rn(b, x), __dadd_rn(1.0, __dmul_rn(kappa, x)));
    return 0.0;
}

// A row's class pressures, kept in registers: every access below has a
// compile-time index (a run-time index would put the row in local memory,
// one dependent round trip per pair).
struct Pressures {
    static constexpr int MT = SD_MT;
    double x[SD_REG_CLASSES];
    double mt;

    // registers need no scratch
    __device__ __forceinline__ void bind(double*, long long, long long,
                                         int) {}
    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int c = 0; c < SD_REG_CLASSES; ++c) x[c] = 0.0;
        mt = 0.0;
    }
    __device__ __forceinline__ void add(int r, double v) {
#pragma unroll
        for (int c = 0; c < SD_REG_CLASSES; ++c)
            if (c == r) x[c] = __dadd_rn(x[c], v);
    }
    // v to class k, to the tenancy pressure (k == SD_MT), or nowhere
    // (k < 0): selects, not branches, so the lookup that gave k is
    // sent off with its group instead of sinking to its use
    __device__ __forceinline__ void put(int k, double v) {
        add(k, v);
        if (k == SD_MT) mt = __dadd_rn(mt, v);
    }
    __device__ __forceinline__ double factor(const double* beta, int R,
                                             double m, double mt_term,
                                             double kappa) const {
        double prod = 1.0;
#pragma unroll
        for (int c = 0; c < SD_REG_CLASSES; ++c)
            if (c < R)
                prod = __dmul_rn(prod, __dadd_rn(1.0, __dmul_rn(
                    pterm(beta[c], x[c], kappa), m)));
        const double f = __dmul_rn(__dadd_rn(1.0, mt_term), prod);
        return (f != f) ? f : (f > 1.0 ? f : 1.0);
    }
    // row[0..R) = the class pressures, row[R] = the tenancy pressure
    __device__ __forceinline__ void store(double* row, int R) const {
#pragma unroll
        for (int c = 0; c < SD_REG_CLASSES; ++c)
            if (c < R) row[c] = x[c];
        row[R] = mt;
    }
    // the factor of the pressures row[0..R) with v added to class r
    // (r < 0: nothing added)
    static __device__ __forceinline__ double pair_factor(
        const double* row, int R, int r, double v, const double* beta,
        double m, double mt_term, double kappa) {
        Pressures acc;
#pragma unroll
        for (int c = 0; c < SD_REG_CLASSES; ++c)
            acc.x[c] = c < R ? row[c] : 0.0;
        if (r >= 0) acc.add(r, v);
        return acc.factor(beta, R, m, mt_term, kappa);
    }
};

__device__ __forceinline__ double finish_factor(double prod, double mt_term) {
    const double f = __dmul_rn(__dadd_rn(1.0, mt_term), prod);
    return (f != f) ? f : (f > 1.0 ? f : 1.0);
}

// Any number of classes: a thread's pressures at x[c * stride], in global
// scratch (a run-time class index costs a memory round trip per pair
// here, which only snapshots past SD_REG_CLASSES classes pay).
struct WidePressures {
    static constexpr int MT = SD_MT_WIDE;
    double* x;
    long long stride;
    int R;
    double mt;

    // thread g of a grid of s threads, at scratch + g
    __device__ __forceinline__ void bind(double* scratch, long long g,
                                         long long s, int r) {
        x = scratch + g;
        stride = s;
        R = r;
    }
    __device__ __forceinline__ void zero() {
        for (int c = 0; c < R; ++c) x[c * stride] = 0.0;
        mt = 0.0;
    }
    __device__ __forceinline__ void add(int r, double v) {
        if (r >= 0 && r < R) {
            double* p = x + r * stride;
            *p = __dadd_rn(*p, v);
        }
    }
    __device__ __forceinline__ void put(int k, double v) {
        if (k == MT) mt = __dadd_rn(mt, v);
        else add(k, v);
    }
    __device__ __forceinline__ double factor(const double* beta, int Rn,
                                             double m, double mt_term,
                                             double kappa) const {
        double prod = 1.0;
        for (int c = 0; c < Rn; ++c)
            prod = __dmul_rn(prod, __dadd_rn(1.0, __dmul_rn(
                pterm(beta[c], x[c * stride], kappa), m)));
        return finish_factor(prod, mt_term);
    }
    __device__ __forceinline__ void store(double* row, int Rn) const {
        for (int c = 0; c < Rn; ++c) row[c] = x[c * stride];
        row[Rn] = mt;
    }
    static __device__ __forceinline__ double pair_factor(
        const double* row, int Rn, int r, double v, const double* beta,
        double m, double mt_term, double kappa) {
        double prod = 1.0;
        for (int c = 0; c < Rn; ++c) {
            const double xc = c == r ? __dadd_rn(row[c], v) : row[c];
            prod = __dmul_rn(prod, __dadd_rn(1.0, __dmul_rn(
                pterm(beta[c], xc, kappa), m)));
        }
        return finish_factor(prod, mt_term);
    }
};

// torch.minimum: a NaN in either operand propagates
__device__ __forceinline__ double nan_min(double a, double b) {
    if (a != a) return a;
    if (b != b) return b;
    return a < b ? a : b;
}

// torch.clamp_max(cap, mem_new): a NaN cap stays NaN
__device__ __forceinline__ double clamp_max(double cap, double v) {
    return cap > v ? v : cap;
}

// the pressures on PU p (ncr row nrow) of the ledger rows [lo, lo + cnt),
// in ledger order, skipping rows of uid skip: same-PU usage to mt, memory
// usage to the pair's class; a group's lookups go out before its sums
template <class Acc>
__device__ __forceinline__ void segment_pressures(
    Acc& acc, long long lo, long long cnt, long long skip, long long p,
    const int16_t* __restrict__ nrow, const long long* __restrict__ Pa,
    const double* __restrict__ Ua, const double* __restrict__ Ma,
    const long long* __restrict__ uid_a) {
    const long long hi = lo + cnt;
    for (long long a0 = lo; a0 < hi; a0 += SD_PREFETCH) {
        long long pp[SD_PREFETCH];
        int rr[SD_PREFETCH];
#pragma unroll
        for (int u = 0; u < SD_PREFETCH; ++u)
            pp[u] = Pa[min(a0 + u, hi - 1)];
#pragma unroll
        for (int u = 0; u < SD_PREFETCH; ++u) rr[u] = nrow[pp[u]];
#pragma unroll
        for (int u = 0; u < SD_PREFETCH; ++u) {
            const long long a = min(a0 + u, hi - 1);
            const bool same = pp[u] == p;
            acc.put(a0 + u >= hi || uid_a[a] == skip ? -1
                        : (same ? Acc::MT : rr[u]),
                    same ? Ua[a] : Ma[a]);
        }
    }
}
