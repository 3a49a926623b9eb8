// Slowdown factor aggregation (H-EYE section 3.4), float64, three forms.
//
//   f = max(1, (1 + mt) * prod_r(1 + term(beta[r], x[r]) * mem))
//   term(b, x) = b * x * (1 + kappa * x)   where x > 0 and b > 0, else 0
//
// Replaces the TPU kernel repro/kernels/slowdown_kernel.py:47
// (slowdown_factors_pallas / _factors_kernel), which aggregates pressure
// rows that the host built around every call.
//
// * row:  one thread per given (N, R) pressure row.
// * pool: the DES repricing.  Thread i is member i of a co-running pool;
//   it walks j = 0..n-1 in ascending order over tiles of the members'
//   gathered columns in shared memory, adds U[j] to its tenancy pressure
//   where the PUs are equal and M[j] = min(memraw[j], mem_cap[P[j]]) to
//   class ncr_rclass[P[i], P[j]] elsewhere (where that class is >= 0),
//   reading the snapshot's int16 P x P table in place.
// * same-device: the walk's constraint checks, one block per newcomer of
//   a ragged stack (an int64 row of pointers, sizes and offsets each).
//   The block flags the devices its candidates sit on (several-device
//   items), then computes each candidate's pressures over its device's
//   ledger segment and each flagged active's base pressures over its own
//   segment, then every (candidate, active) pair row: the active's base
//   plus the newcomer's join term.
//
// A row's class pressures live in registers up to SD_REG_CLASSES classes
// (Pressures).  A snapshot with more classes takes the same kernels
// instantiated on WidePressures: each thread's pressures in a strided
// global scratch the wrapper allocates (class c of thread g at
// c * stride + g, so a warp's accesses are coalesced), the same sums in
// the same order.  The register path is the scheduler's (6 classes on
// the paper's testbed); the wide one exists so that no snapshot is
// refused.
//
// Pressures are summed in ascending co-runner (ledger) order, one sum per
// thread and no atomics, and every product and sum is rounded on its own
// (__dmul_rn / __dadd_rn: no fused contraction), so each form agrees to
// the bit with its plain PyTorch version.  Bound: launch latency at the
// scheduler's sizes (tens to a few thousand rows); beyond, the bytes of
// the gathered columns and the ncr entries read.
#include <cuda_runtime.h>
#include <stdint.h>

#define SD_REG_CLASSES 16
#define POOL_THREADS 128
#define SD_THREADS 128
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
    // issued with its group instead of sinking to its use
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

__global__ void slowdown_factors_kernel(const double* __restrict__ x,
                                        const double* __restrict__ beta,
                                        const double* __restrict__ mem,
                                        const double* __restrict__ mt,
                                        double* __restrict__ out,
                                        long long n, int R, double kappa) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const double* row = x + i * (long long)R;
    if (R <= SD_REG_CLASSES) {
        Pressures acc;
#pragma unroll
        for (int c = 0; c < SD_REG_CLASSES; ++c)
            acc.x[c] = c < R ? row[c] : 0.0;
        out[i] = acc.factor(beta, R, mem[i], mt[i], kappa);
    } else {
        // more classes: the row is read where it lies
        out[i] = WidePressures::pair_factor(row, R, -1, 0.0, beta, mem[i],
                                            mt[i], kappa);
    }
}

extern "C" int heye_slowdown_factors(const void* x, const void* beta,
                                     const void* mem, const void* mt,
                                     void* out, long long n, int R,
                                     double kappa, void* stream) {
    if (n <= 0) return 0;
    if (R < 0) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    slowdown_factors_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const double*)x, (const double*)beta, (const double*)mem,
        (const double*)mt, (double*)out, n, R, kappa);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pool form
// ---------------------------------------------------------------------------
template <class Acc>
__global__ void __launch_bounds__(POOL_THREADS)
slowdown_pool_kernel(const long long* __restrict__ members, long long n,
                     const long long* __restrict__ pu_i,
                     const double* __restrict__ U,
                     const double* __restrict__ memraw,
                     const long long* __restrict__ uid,
                     const double* __restrict__ mem_cap,
                     const int16_t* __restrict__ ncr, long long nP,
                     const double* __restrict__ mt_vec,
                     const double* __restrict__ beta, int R, double kappa,
                     int distinct, double* __restrict__ out,
                     double* __restrict__ wide) {
    __shared__ long long sP[POOL_THREADS];
    __shared__ long long sUid[POOL_THREADS];
    __shared__ double sU[POOL_THREADS];
    __shared__ double sM[POOL_THREADS];
    const long long i = (long long)blockIdx.x * POOL_THREADS + threadIdx.x;
    const bool mine = i < n;
    long long Pi = 0, uidi = 0;
    double Ui = 0.0, Mi = 0.0;
    if (mine) {
        const long long m = members[i];
        Pi = pu_i[m];
        Ui = U[m];
        Mi = nan_min(memraw[m], mem_cap[Pi]);
        uidi = uid[m];
    }
    const int16_t* nrow = ncr + Pi * nP;
    Acc acc;
    acc.bind(wide, i, (long long)gridDim.x * POOL_THREADS, R);
    acc.zero();
    for (long long j0 = 0; j0 < n; j0 += POOL_THREADS) {
        const long long j = j0 + threadIdx.x;
        if (j < n) {
            const long long m = members[j];
            const long long p = pu_i[m];
            sP[threadIdx.x] = p;
            sU[threadIdx.x] = U[m];
            sM[threadIdx.x] = nan_min(memraw[m], mem_cap[p]);
            sUid[threadIdx.x] = uid[m];
        }
        __syncthreads();
        if (mine) {
            const int cnt = (int)min((long long)POOL_THREADS, n - j0);
            for (int jb = 0; jb < cnt; jb += SD_PREFETCH) {
                // the group's class lookups in flight together, ahead of
                // the sums that need them
                int rr[SD_PREFETCH];
#pragma unroll
                for (int u = 0; u < SD_PREFETCH; ++u)
                    rr[u] = nrow[sP[min(jb + u, cnt - 1)]];
#pragma unroll
                for (int u = 0; u < SD_PREFETCH; ++u) {
                    const int jj = min(jb + u, cnt - 1);
                    const bool skip = jb + u >= cnt ||
                        (distinct ? (j0 + jj == i) : (sUid[jj] == uidi));
                    const bool same = sP[jj] == Pi;
                    acc.put(skip ? -1 : (same ? Acc::MT : rr[u]),
                            same ? sU[jj] : sM[jj]);
                }
            }
        }
        __syncthreads();
    }
    if (mine)
        out[i] = acc.factor(beta, R, Mi,
                            __dmul_rn(pterm(mt_vec[Pi], acc.mt, kappa), Ui),
                            kappa);
}

// doubles of class scratch a launch of the pool form over n members
// takes: none where the pressures fit in registers, else R per thread of
// its grid
extern "C" long long heye_slowdown_pool_wide_len(long long n, int R) {
    if (n <= 0 || R <= SD_REG_CLASSES) return 0;
    return (long long)R * ((n + POOL_THREADS - 1) / POOL_THREADS)
           * POOL_THREADS;
}

extern "C" int heye_slowdown_pool(const void* members, long long n,
                                  const void* pu_i, const void* U,
                                  const void* memraw, const void* uid,
                                  const void* mem_cap, const void* ncr,
                                  long long nP, const void* mt_vec,
                                  const void* beta, int R, double kappa,
                                  int distinct, void* out, void* wide,
                                  long long wide_len, void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + POOL_THREADS - 1) / POOL_THREADS);
    if (R <= SD_REG_CLASSES) {
        slowdown_pool_kernel<Pressures><<<blocks, POOL_THREADS, 0,
                                          (cudaStream_t)stream>>>(
            (const long long*)members, n, (const long long*)pu_i,
            (const double*)U, (const double*)memraw, (const long long*)uid,
            (const double*)mem_cap, (const int16_t*)ncr, nP,
            (const double*)mt_vec, (const double*)beta, R, kappa, distinct,
            (double*)out, nullptr);
    } else {
        if (wide == nullptr || wide_len < heye_slowdown_pool_wide_len(n, R))
            return (int)cudaErrorInvalidValue;
        slowdown_pool_kernel<WidePressures><<<blocks, POOL_THREADS, 0,
                                              (cudaStream_t)stream>>>(
            (const long long*)members, n, (const long long*)pu_i,
            (const double*)U, (const double*)memraw, (const long long*)uid,
            (const double*)mem_cap, (const int16_t*)ncr, nP,
            (const double*)mt_vec, (const double*)beta, R, kappa, distinct,
            (double*)out, (double*)wide);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// same-device form
// ---------------------------------------------------------------------------
// fields of an item's int64 row (kernels/slowdown_kernel.py, SD_FIELDS)
enum {
    SD_PC, SD_DC, SD_PA, SD_UA, SD_MA, SD_UID_A, SD_DA, SD_ASTART, SD_NA,
    SD_CS, SD_C, SD_A, SD_ND, SD_SINGLE, SD_S0, SD_N0, SD_U_NEW, SD_MEM_NEW,
    SD_UID_NEW, SD_NEWF_OFF, SD_PAIR_OFF, SD_K, SD_BASE_OFF, SD_BASE_LO,
    SD_FLAG_OFF, SD_NFIELDS
};

struct SdItem {
    const long long *Pc, *Dc, *Pa, *uid_a, *Da, *astart, *na, *cs;
    const double *Ua, *Ma;
    long long C, A, nd, s0, n0, uid_new, newf_off, pair_off, K, base_off,
        base_lo, flag_off;
    bool single;
    double u_new, mem_new;
};

__device__ __forceinline__ SdItem load_item(const long long* row) {
    SdItem it;
    it.Pc = (const long long*)row[SD_PC];
    it.Dc = (const long long*)row[SD_DC];
    it.Pa = (const long long*)row[SD_PA];
    it.Ua = (const double*)row[SD_UA];
    it.Ma = (const double*)row[SD_MA];
    it.uid_a = (const long long*)row[SD_UID_A];
    it.Da = (const long long*)row[SD_DA];
    it.astart = (const long long*)row[SD_ASTART];
    it.na = (const long long*)row[SD_NA];
    it.cs = (const long long*)row[SD_CS];
    it.C = row[SD_C];
    it.A = row[SD_A];
    it.nd = row[SD_ND];
    it.single = row[SD_SINGLE] != 0;
    it.s0 = row[SD_S0];
    it.n0 = row[SD_N0];
    it.u_new = __longlong_as_double(row[SD_U_NEW]);
    it.mem_new = __longlong_as_double(row[SD_MEM_NEW]);
    it.uid_new = row[SD_UID_NEW];
    it.newf_off = row[SD_NEWF_OFF];
    it.pair_off = row[SD_PAIR_OFF];
    it.K = row[SD_K];
    it.base_off = row[SD_BASE_OFF];
    it.base_lo = row[SD_BASE_LO];
    it.flag_off = row[SD_FLAG_OFF];
    return it;
}

// torch.clamp_max(cap, mem_new): a NaN cap stays NaN
__device__ __forceinline__ double clamp_max(double cap, double v) {
    return cap > v ? v : cap;
}

// the pressures on PU p (ncr row nrow) of the ledger rows [lo, lo + cnt),
// in ledger order, skipping rows of uid skip: same-PU usage to mt, memory
// usage to the pair's class; a group's lookups are issued before its sums
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

template <class Acc>
__global__ void __launch_bounds__(SD_THREADS)
slowdown_same_device_kernel(const long long* __restrict__ tab, int nfields,
                            const int16_t* __restrict__ ncr, long long nP,
                            const double* __restrict__ mt_vec,
                            const double* __restrict__ mem_cap,
                            const double* __restrict__ beta, int R,
                            double kappa, double* __restrict__ new_f,
                            long long* __restrict__ ci,
                            long long* __restrict__ ai,
                            double* __restrict__ act_pf,
                            double* __restrict__ base,
                            int* __restrict__ flags,
                            double* __restrict__ wide) {
    const SdItem it = load_item(tab + (long long)blockIdx.x * nfields);
    const int R1 = R + 1;
    double* bs = base + it.base_off;           // (rows, R + 1) per active
    int* fl = flags + it.flag_off;             // one per device ordinal

    // several-device items: flag the devices that hold a candidate
    if (!it.single) {
        for (long long d = threadIdx.x; d < it.nd; d += SD_THREADS) fl[d] = 0;
        __syncthreads();
        for (long long c = threadIdx.x; c < it.C; c += SD_THREADS)
            fl[it.Dc[c]] = 1;
        __syncthreads();
    }

    // candidates' rows, then the actives' base pressures
    const long long n_act = it.single ? it.n0 : it.A;
    const long long g = (long long)blockIdx.x * SD_THREADS + threadIdx.x;
    for (long long w = threadIdx.x; w < it.C + n_act; w += SD_THREADS) {
        Acc acc;
        acc.bind(wide, g, (long long)gridDim.x * SD_THREADS, R);
        acc.zero();
        if (w < it.C) {
            const long long c = w;
            const long long pc = it.Pc[c];
            long long lo = it.s0, cnt = it.n0;
            if (!it.single) {
                const long long d = it.Dc[c];
                lo = it.astart[d];
                cnt = it.na[d];
            }
            segment_pressures(acc, lo, cnt, it.uid_new, pc, ncr + pc * nP,
                              it.Pa, it.Ua, it.Ma, it.uid_a);
            new_f[it.newf_off + c] = acc.factor(
                beta, R, clamp_max(mem_cap[pc], it.mem_new),
                __dmul_rn(pterm(mt_vec[pc], acc.mt, kappa), it.u_new), kappa);
        } else {
            const long long a = it.base_lo + (w - it.C);
            long long lo = it.s0, cnt = it.n0;
            if (!it.single) {
                const long long d = it.Da[a];
                if (!fl[d]) continue;
                lo = it.astart[d];
                cnt = it.na[d];
            }
            const long long pa = it.Pa[a];
            segment_pressures(acc, lo, cnt, it.uid_a[a], pa, ncr + pa * nP,
                              it.Pa, it.Ua, it.Ma, it.uid_a);
            acc.store(bs + (a - it.base_lo) * R1, R);
        }
    }
    __syncthreads();

    // the (candidate, active) pair rows: candidates in order, each with the
    // actives of its device segment in ledger order
    for (long long k = threadIdx.x; k < it.K; k += SD_THREADS) {
        long long c, a;
        if (it.single) {
            c = k / it.n0;
            a = it.s0 + (k - c * it.n0);
        } else {
            // the first candidate whose inclusive pair count passes k
            long long lo = 0, hi = it.C - 1;
            while (lo < hi) {
                const long long mid = (lo + hi) >> 1;
                if (it.cs[mid] > k) hi = mid; else lo = mid + 1;
            }
            c = lo;
            const long long start = c ? it.cs[c - 1] : 0;
            a = it.astart[it.Dc[c]] + (k - start);
        }
        const long long pc = it.Pc[c];
        const long long pa = it.Pa[a];
        const bool live = it.uid_a[a] != it.uid_new;
        const double* row = bs + (a - it.base_lo) * R1;
        const int rac = ncr[pa * nP + pc];
        const int join = (live && pa != pc && rac >= 0) ? rac : -1;
        const double same = (live && pa == pc) ? 1.0 : 0.0;
        const double mtp = __dadd_rn(row[R], __dmul_rn(same, it.u_new));
        const long long o = it.pair_off + k;
        act_pf[o] = Acc::pair_factor(
            row, R, join, clamp_max(mem_cap[pc], it.mem_new), beta, it.Ma[a],
            __dmul_rn(pterm(mt_vec[pa], mtp, kappa), it.Ua[a]), kappa);
        ci[o] = c;
        ai[o] = a;
    }
}

// doubles of class scratch a launch of the same-device form over n_items
// items takes: none where the pressures fit in registers, else R per
// thread of its grid
extern "C" long long heye_slowdown_same_device_wide_len(int n_items, int R) {
    if (n_items <= 0 || R <= SD_REG_CLASSES) return 0;
    return (long long)R * n_items * SD_THREADS;
}

extern "C" int heye_slowdown_same_device(
    const void* tab, int n_items, int nfields, const void* ncr, long long nP,
    const void* mt_vec, const void* mem_cap, const void* beta, int R,
    double kappa, void* new_f, void* ci, void* ai, void* act_pf, void* base,
    void* flags, void* wide, long long wide_len, void* stream) {
    if (n_items <= 0) return 0;
    if (nfields != SD_NFIELDS) return (int)cudaErrorInvalidValue;
    if (R <= SD_REG_CLASSES) {
        slowdown_same_device_kernel<Pressures><<<n_items, SD_THREADS, 0,
                                                 (cudaStream_t)stream>>>(
            (const long long*)tab, nfields, (const int16_t*)ncr, nP,
            (const double*)mt_vec, (const double*)mem_cap,
            (const double*)beta, R, kappa, (double*)new_f, (long long*)ci,
            (long long*)ai, (double*)act_pf, (double*)base, (int*)flags,
            nullptr);
    } else {
        if (wide == nullptr
                || wide_len < heye_slowdown_same_device_wide_len(n_items, R))
            return (int)cudaErrorInvalidValue;
        slowdown_same_device_kernel<WidePressures><<<n_items, SD_THREADS, 0,
                                                     (cudaStream_t)stream>>>(
            (const long long*)tab, nfields, (const int16_t*)ncr, nP,
            (const double*)mt_vec, (const double*)mem_cap,
            (const double*)beta, R, kappa, (double*)new_f, (long long*)ci,
            (long long*)ai, (double*)act_pf, (double*)base, (int*)flags,
            (double*)wide);
    }
    return (int)cudaGetLastError();
}
