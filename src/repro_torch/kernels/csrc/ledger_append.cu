// The ordered commit's two writes, each in place in one launch.
//
// Every commit of the walk's phase 2 adds one row to the active ledger, and
// the next re-walk on the committed device reads that device's ledger view
// extended by the row.  Written op by op in PyTorch these are eight scalar
// writes (each a fill launch) and some twenty-five ops around ten
// concatenations plus a blocking upload of the new row's release time; here
// they are two launches that take every host value as an argument:
//
// * ledger_append: row i of the ledger's columns gets the row's estimated
//   finish, factor, deadline, usages, uid, compiled PU index and live = 1;
// * view_append: slot n of a device view's column buffers gets ledger row
//   i's columns, Ma = min(umem[i], mem_cap[pidx]) (NaN propagates, as
//   torch.minimum does), the release time and the device ordinal; the
//   view's segment counts are written into a fresh array, the previous
//   view's with [o] = n + 1 (o < 0: none).  Where the view moves to new
//   buffers (the first extension after a regather, or a full buffer) the
//   same launch first copies the previous view's n rows into them.
//
// Stores only, no arithmetic but the min: both are bit-equal to their plain
// versions.  A row is nine words, so both are bound by launch latency; what
// they save is the host's dispatch of some fifty ops a commit and the
// stream synchronise that follows a pageable upload.  They replace no TPU
// kernel: the reference appends with numpy (repro/core/orchestrator.py).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define LA_THREADS 256
#define LA_MAX_BLOCKS 1024

// The ledger row's launch arguments, every field 8 bytes, in the order of
// kernels/walk_kernel.py LA_FIELDS.
struct LaArgs {
    double* est;
    double* fac;
    double* dl;
    double* upu;
    double* umem;
    long long* uid;
    long long* pu_idx;
    uint8_t* live;          // torch.bool: one byte
    long long i;
    double v_est;
    double v_fac;
    double v_dl;
    double v_upu;
    double v_umem;
    long long v_uid;
    long long v_pidx;
};

// The view slot's launch arguments, in the order of VA_FIELDS.  The view's
// ten columns: P, est, fac, dl, upu, umem, Ma, uid, rel, Da.
struct VaArgs {
    // the destination buffers (capacity > n)
    long long* P;
    double* est;
    double* fac;
    double* dl;
    double* upu;
    double* umem;
    double* Ma;
    long long* uid;
    double* rel;
    long long* Da;
    // the previous view's columns, copied into rows [0, ncopy)
    const long long* sP;
    const double* sest;
    const double* sfac;
    const double* sdl;
    const double* supu;
    const double* sumem;
    const double* sMa;
    const long long* suid;
    const double* srel;
    const long long* sDa;
    long long ncopy;
    // ledger row i's columns
    const long long* lP;
    const double* lest;
    const double* lfac;
    const double* ldl;
    const double* lupu;
    const double* lumem;
    const long long* luid;
    long long i;
    const double* mem_cap;
    long long pidx;
    long long n;            // the slot written
    double v_rel;
    long long v_da;
    // segment counts per device ordinal
    const long long* na_src;
    long long* na_dst;
    long long nd;
    long long o;
};

__global__ void ledger_append_kernel(LaArgs a) {
    const long long i = a.i;
    a.est[i] = a.v_est;
    a.fac[i] = a.v_fac;
    a.dl[i] = a.v_dl;
    a.upu[i] = a.v_upu;
    a.umem[i] = a.v_umem;
    a.uid[i] = a.v_uid;
    a.pu_idx[i] = a.v_pidx;
    a.live[i] = 1;
}

__global__ void view_append_kernel(VaArgs a) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long k = t0; k < a.ncopy; k += stride) {
        a.P[k] = a.sP[k];
        a.est[k] = a.sest[k];
        a.fac[k] = a.sfac[k];
        a.dl[k] = a.sdl[k];
        a.upu[k] = a.supu[k];
        a.umem[k] = a.sumem[k];
        a.Ma[k] = a.sMa[k];
        a.uid[k] = a.suid[k];
        a.rel[k] = a.srel[k];
        a.Da[k] = a.sDa[k];
    }
    for (long long k = t0; k < a.nd; k += stride)
        a.na_dst[k] = k == a.o ? a.n + 1 : a.na_src[k];
    if (t0 == 0) {
        const long long i = a.i, n = a.n;
        const double um = a.lumem[i], cap = a.mem_cap[a.pidx];
        a.P[n] = a.lP[i];
        a.est[n] = a.lest[i];
        a.fac[n] = a.lfac[i];
        a.dl[n] = a.ldl[i];
        a.upu[n] = a.lupu[i];
        a.umem[n] = um;
        a.Ma[n] = um != um ? um : (cap != cap ? cap : (cap < um ? cap : um));
        a.uid[n] = a.luid[i];
        a.rel[n] = a.v_rel;
        a.Da[n] = a.v_da;
    }
}

// one ledger row: `args` points to an LaArgs row of `nbytes`
extern "C" int heye_ledger_append(const void* args, long long nbytes,
                                  void* stream) {
    if (args == nullptr || nbytes != (long long)sizeof(LaArgs))
        return (int)cudaErrorInvalidValue;
    LaArgs a;
    memcpy(&a, args, sizeof(LaArgs));
    if (a.i < 0) return (int)cudaErrorInvalidValue;
    ledger_append_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// one view slot: `args` points to a VaArgs row of `nbytes`
extern "C" int heye_view_append(const void* args, long long nbytes,
                                void* stream) {
    if (args == nullptr || nbytes != (long long)sizeof(VaArgs))
        return (int)cudaErrorInvalidValue;
    VaArgs a;
    memcpy(&a, args, sizeof(VaArgs));
    if (a.i < 0 || a.n < 0 || a.ncopy < 0 || a.ncopy > a.n || a.nd < 0
            || a.pidx < 0)
        return (int)cudaErrorInvalidValue;
    const long long work = a.ncopy > a.nd ? a.ncopy : a.nd;
    long long blocks = (work + LA_THREADS - 1) / LA_THREADS;
    if (blocks < 1) blocks = 1;
    if (blocks > LA_MAX_BLOCKS) blocks = LA_MAX_BLOCKS;
    view_append_kernel<<<(unsigned)blocks, LA_THREADS, 0,
                         (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
