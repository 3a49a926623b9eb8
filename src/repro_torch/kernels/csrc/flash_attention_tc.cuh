// Flash attention, forward, bfloat16 on Hopper's tensor cores (wgmma + TMA).
//
//   o[b,i,h,:] = sum_j softmax_j(mask(cap(q[b,i,h,:] . k[b,j,h/rep,:] * scale)))
//                * v[b,j,h/rep,:]
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:95
// (flash_attention_bhsd / _attn_kernel) for bfloat16 tensors; float32 goes
// to the CUDA-core kernel of flash_attention.cuh.
//
// Bound: operations.  Live (q, k) pairs times 4*hd flops; at the model's
// shape (B=2, S=4096, 16 q heads on 1 kv head, hd=256, window 2048) about
// 2.1e11 flop, 0.21 ms at the dense bf16 tensor-core peak.  Both products
// run on the tensor cores; the softmax between them on the CUDA cores.
//
// Block: 384 threads, three warpgroups.  Warpgroups 0 and 1 are consumers,
// each owning 64 of the block's BQ = 128 query rows of one (b, h); one
// thread of warpgroup 2 is the producer.  setmaxnreg gives the consumers
// 240 registers a thread and the producer 24.  Grid: (B*Hq, ceil(S/128)),
// the query tiles of every (b, h) walked from the last (with a causal mask
// the heaviest) to the first, so that the heavy blocks start first.
//
// Shared memory: the block's Q tile, loaded once by TMA, and a ring of two
// stages of K and V tiles of BK = 64 keys, each filled by TMA and completed
// on its own mbarrier (K and V apart, so that Q.K^T starts before V has
// landed); an "empty" mbarrier per stage, on which all 256 consumer threads
// arrive, hands the stage back to the producer.  Every tile is stored as
// boxes of CH columns, the widest of 64 / 32 / 16 that divides hd (128, 64
// or 32 bytes a row), with the TMA swizzle of that row width, which is the
// layout wgmma reads; at hd = 256 Q takes 64 KB and each stage 2 x 32 KB:
// 192 KB; at hd = 96 three boxes of 32 columns, 24 KB of Q and 2 x 12 KB a
// stage: 72 KB.
//
// TMA: Q, K and V are described as 4-D tensor maps over the model's
// (B, S, H, hd) layout, innermost first (hd, H, S, B), with boxes of
// (CH, 1, rows, 1).  Query head h reads kv head h / (Hq / Hkv)
// through the map's head coordinate: nothing is repeated.  Rows past S come
// in as zeros, so keys >= S are masked to -inf below (a zero key scores 0,
// not -inf).  The maps are encoded on the host (flash_attention.cu) and
// passed as __grid_constant__ parameters.
//
// S = Q.K^T: wgmma m64n64k16, both operands K-major in shared memory, fp32
// accumulators (32 a thread).  The scores are scaled, soft-capped and
// masked in registers.  Online softmax: each row lives on the four threads
// of a quad, which reduce the row max with two xor shuffles; the row sums
// stay per thread until the end.  P is rounded to bf16 in registers (the
// row sum adds the rounded values, so numerator and denominator weigh the
// same numbers) and O += P.V runs as wgmma m64nNk16 with A = P from
// registers (the accumulator layout of S is the A-fragment layout) and
// B = V from shared memory, MN-major (transposed), N = CH per box.
// O stays in fp32 registers: hd / 2 a thread, 128 at hd = 256.
//
// Masking follows the reference and the CUDA-core kernel exactly: scores
// are scaled after the dot, soft-capped, then masked with the finite
// NEG_INF = -2^30 while the running max starts at -inf.  A row whose keys
// in a live tile all fall outside its window sums exp(0) = 1 terms (exact
// in bf16), which the first real score wipes (exp(-2^30 - m) = 0); the
// causal diagonal guarantees that score.  Keys past S get -inf and weigh
// nothing, so any S is taken.  Only kv tiles masked for every row of the
// 128-row query tile are skipped; tiles that no mask touches skip the
// per-element mask.
//
// Each head dim is compiled in its own source (flash_attention_tc_hd*.cu)
// so that the build's parallel nvcc processes share the work.
#pragma once
#include <cuda.h>            // CUtensorMap; nothing of libcuda is linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <utility>

#define FATC_BQ 128
#define FATC_BK 64
#define FATC_STAGES 2
#define FATC_THREADS 384
#define FATC_NEG_INF (-1073741824.0f)
#define FATC_LOG2E 1.4426950408889634f

namespace fatc {

template <int HD> struct Cfg {
    // columns per box: the widest of 64 / 32 / 16 that divides HD (64 at
    // hd 64-256, 32 at hd 32 and 96, 16 at hd 16)
    static constexpr int CH = HD % 64 == 0 ? 64 : (HD % 32 == 0 ? 32 : 16);
    static constexpr int NB = HD / CH;                // boxes per row
    static_assert(HD % CH == 0 && HD % 16 == 0,
                  "the head dim must be a multiple of its box width");
    static constexpr int SW = 2 * CH;                 // bytes per smem row
    static constexpr int LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
    static constexpr int Q_BOX = FATC_BQ * SW;
    static constexpr int KV_BOX = FATC_BK * SW;
    static constexpr int Q_BYTES = NB * Q_BOX;
    static constexpr int KV_BYTES = NB * KV_BOX;
    static constexpr int SMEM = Q_BYTES + 2 * FATC_STAGES * KV_BYTES;
    static constexpr int KPB = CH / 16;               // k16 slices per box
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// one (columns, head, positions, batch) box of a tensor map into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins accumulator registers in place around the asynchronous products, so
// that the compiler moves no read or write of them across a fence or wait
template <int N> __device__ __forceinline__ void keep(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A and B K-major in shared
// memory at descriptors da + OA and db + OB (16-byte units)
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsa, dsb;\n"
        "setp.ne.b32 p, %36, 0;\n"
        "add.s64 dsa, %32, %34;\n"
        "add.s64 dsb, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31},"
        " dsa, dsb, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "n"(OA), "n"(OB), "r"(1));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16], A in registers, B MN-major
// (transposed) in shared memory at descriptor db + OB (16-byte units)
template <int OB>
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "add.s64 dsb, %12, %13;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, dsb, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB),
          "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A in registers, B MN-major
// (transposed) in shared memory at descriptor db + OB (16-byte units)
template <int OB>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %22, 0;\n"
        "add.s64 dsb, %20, %21;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15},"
        " {%16, %17, %18, %19}, dsb, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB),
          "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B MN-major
// (transposed) in shared memory at descriptor db + OB (16-byte units)
template <int OB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %38, 0;\n"
        "add.s64 dsb, %36, %37;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, dsb, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB),
          "r"(1));
}

template <int N, int OB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
    if constexpr (N == 16) wgmma_rs_n16<OB>(d, a, db);
    else if constexpr (N == 32) wgmma_rs_n32<OB>(d, a, db);
    else wgmma_rs_n64<OB>(d, a, db);
}

// S = Q . K^T: one m64n64k16 per 16 columns of the head dim.  Slice kk
// lies in box kk / KPB at byte 32 * (kk % KPB) of each swizzled row; the
// descriptor offsets (16-byte units) are immediates, so that only the two
// base descriptors are live.
template <int HD, int... KK>
__device__ __forceinline__ void qk_tile(float* sc, uint64_t dq, uint64_t dk,
                                        std::integer_sequence<int, KK...>) {
    using C = Cfg<HD>;
    (wgmma_ss_n64<(((KK / C::KPB) * C::Q_BOX + (KK % C::KPB) * 32) >> 4),
                  (((KK / C::KPB) * C::KV_BOX + (KK % C::KPB) * 32) >> 4)>(
         sc, dq, dk),
     ...);
}

// O += P . V: for each 16 keys kk and each box c of the head dim, one
// m64nCHk16 into accumulator columns [CH c, CH c + CH)
template <int HD, int... J>
__device__ __forceinline__ void pv_tile(float* oacc, uint32_t (*pa)[4],
                                        uint64_t dv,
                                        std::integer_sequence<int, J...>) {
    using C = Cfg<HD>;
    (wgmma_rs<C::CH, (((J % C::NB) * C::KV_BOX + (J / C::NB) * 16 * C::SW) >> 4)>(
         oacc + (J % C::NB) * (C::CH / 2), pa[J / C::NB], dv),
     ...);
}

}  // namespace fatc

template <int HD>
__global__ void __launch_bounds__(FATC_THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv,
                          int causal, int window, float scale, float softcap) {
    using C = fatc::Cfg<HD>;
    using namespace fatc;
    constexpr int BK = FATC_BK;
    extern __shared__ __align__(128) uint8_t fatc_smem[];
    __shared__ __align__(8) uint64_t bars[1 + 3 * FATC_STAGES];
    const uint32_t base = (smem_u32(fatc_smem) + 1023u) & ~1023u;
    const uint32_t sQ = base;
    const uint32_t sK = base + C::Q_BYTES;
    const uint32_t sV = sK + FATC_STAGES * C::KV_BYTES;
    const uint32_t bar_q = smem_u32(&bars[0]);
    const uint32_t bar_k = smem_u32(&bars[1]);                    // + 8 * stage
    const uint32_t bar_v = smem_u32(&bars[1 + FATC_STAGES]);
    const uint32_t bar_e = smem_u32(&bars[1 + 2 * FATC_STAGES]);

    const int bh = blockIdx.x;
    const int b = bh / Hq;
    const int h = bh - b * Hq;
    const int hk = h / (Hq / Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * FATC_BQ;

    // the kv tiles live for at least one row of this query tile
    int k_begin = 0, k_end = S;
    if (causal) k_end = min(S, q0 + FATC_BQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
    const int t_begin = k_begin / BK;
    const int n_tiles = (k_end + BK - 1) / BK - t_begin;

    const int tid = threadIdx.x;
    if (tid == 0) {
        bar_init(bar_q, 1);
#pragma unroll
        for (int s = 0; s < FATC_STAGES; ++s) {
            bar_init(bar_k + 8 * s, 1);
            bar_init(bar_v + 8 * s, 1);
            bar_init(bar_e + 8 * s, 256);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int wg = tid >> 7;

    if (wg == 2) {
        // ---------------- producer: one thread issues every TMA load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
        if (tid == 256) {
            bar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
            for (int c = 0; c < C::NB; ++c)
                tma_load_4d(sQ + c * C::Q_BOX, &tq, bar_q, c * C::CH, h, q0, b);
            for (int it = 0; it < n_tiles; ++it) {
                const int s = it % FATC_STAGES;
                const uint32_t par = (it / FATC_STAGES) & 1;
                const int k0 = (t_begin + it) * BK;
                bar_wait(bar_e + 8 * s, par ^ 1);
                bar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
#pragma unroll
                for (int c = 0; c < C::NB; ++c)
                    tma_load_4d(sK + s * C::KV_BYTES + c * C::KV_BOX, &tk,
                                bar_k + 8 * s, c * C::CH, hk, k0, b);
                bar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
#pragma unroll
                for (int c = 0; c < C::NB; ++c)
                    tma_load_4d(sV + s * C::KV_BYTES + c * C::KV_BOX, &tv,
                                bar_v + 8 * s, c * C::CH, hk, k0, b);
            }
        }
    } else {
        // ---------------- consumers: 64 query rows each
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
        const int t = tid & 127;
        const int lane = t & 31;
        const int qa = q0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);  // +8: half 1
        const int cq = 2 * (lane & 3);        // column in each 8-column block
        const int q_lo = q0 + 64 * wg;        // this warpgroup's rows
        const int q_hi = q_lo + 63;
        // base descriptors: this warpgroup's Q rows (K-major), stage 0's K
        // (K-major) and V (MN-major; LBO = the stride between boxes); stage
        // s lies s * KV_BYTES further on
        const uint64_t dq = make_desc(sQ + 64 * wg * C::SW, 16, 8 * C::SW,
                                      C::LAYOUT);
        const uint64_t dk0 = make_desc(sK, 16, 8 * C::SW, C::LAYOUT);
        const uint64_t dv0 = make_desc(sV, C::KV_BOX, 8 * C::SW, C::LAYOUT);

        float oacc[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
        float mrow[2] = {-INFINITY, -INFINITY};
        float lrow[2] = {0.0f, 0.0f};

        bar_wait(bar_q, 0);
        for (int it = 0; it < n_tiles; ++it) {
            const int s = it % FATC_STAGES;
            const uint32_t par = (it / FATC_STAGES) & 1;
            const int k0 = (t_begin + it) * BK;

            // S = Q . K^T (64 x 64 per warpgroup)
            float sc[BK / 2];
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
            bar_wait(bar_k + 8 * s, par);
            keep<BK / 2>(sc);
            wg_fence();
            const uint64_t stage_off = (uint64_t)(s * (C::KV_BYTES >> 4));
            qk_tile<HD>(sc, dq, dk0 + stage_off,
                        std::make_integer_sequence<int, HD / 16>{});
            wg_commit();
            wg_wait0();
            keep<BK / 2>(sc);

            // scale, soft cap, mask; accumulator i holds row qa + 8*((i>>1)&1),
            // key k0 + 8*(i>>2) + cq + (i&1)
            const bool edge = (k0 + BK > S) || (causal && k0 + BK - 1 > q_lo) ||
                              (window > 0 && k0 <= q_hi - window);
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                float x = sc[i] * scale;
                if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
                if (edge) {
                    const int qi = qa + 8 * ((i >> 1) & 1);
                    const int kp = k0 + 8 * (i >> 2) + cq + (i & 1);
                    bool live = true;
                    if (causal) live = kp <= qi;
                    if (window > 0) live = live && (kp > qi - window);
                    x = live ? x : FATC_NEG_INF;
                    if (kp >= S) x = -INFINITY;
                }
                sc[i] = x;
            }
            // online softmax
            float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
                mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
            float corr[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                corr[r] = exp2f((mrow[r] - mx[r]) * FATC_LOG2E);
                mrow[r] = mx[r];
            }
            uint32_t pa[BK / 16][4];
            float ps[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < BK / 4; ++i) {          // register pairs
                const int r = i & 1;
                const float p0 = exp2f((sc[2 * i] - mx[r]) * FATC_LOG2E);
                const float p1 = exp2f((sc[2 * i + 1] - mx[r]) * FATC_LOG2E);
                __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
                ps[r] += __low2float(pb) + __high2float(pb);
                pa[i / 4][i % 4] = *reinterpret_cast<uint32_t*>(&pb);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * corr[r] + ps[r];
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];

            // O += P . V
            bar_wait(bar_v + 8 * s, par);
            keep<HD / 2>(oacc);
            wg_fence();
            pv_tile<HD>(oacc, pa, dv0 + stage_off,
                        std::make_integer_sequence<int, BK / 16 * C::NB>{});
            wg_commit();
            wg_wait0();
            keep<HD / 2>(oacc);
            bar_arrive(bar_e + 8 * s);
        }

        // O / l, rounded to bf16, rows < S
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float l = lrow[r];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            inv[r] = 1.0f / fmaxf(l, 1e-30f);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qi = qa + 8 * r;
            if (qi < S) {
                __nv_bfloat16* dst =
                    o + (((long long)b * S + qi) * Hq + h) * HD + cq;
#pragma unroll
                for (int j = 0; j < HD / 8; ++j)
                    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                        __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv[r],
                                              oacc[4 * j + 2 * r + 1] * inv[r]);
            }
        }
    }
}

template <int HD>
static int fa_tc_launch(const CUtensorMap* tq, const CUtensorMap* tk,
                        const CUtensorMap* tv, void* o, int B, int S, int Hq,
                        int Hkv, int causal, int window, float scale,
                        float softcap, cudaStream_t stream) {
    const int smem = fatc::Cfg<HD>::SMEM + 1024;    // + slack for alignment
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B * Hq, (S + FATC_BQ - 1) / FATC_BQ);
    flash_attention_tc_kernel<HD><<<grid, FATC_THREADS, smem, stream>>>(
        *tq, *tk, *tv, (__nv_bfloat16*)o, S, Hq, Hkv, causal, window, scale,
        softcap);
    return (int)cudaGetLastError();
}

// One launcher per head dim, each defined in its own source.  tq, tk, tv
// point to host copies of the tensor maps (see flash_attention.cu).
#define FATC_LAUNCHER_ARGS                                                   \
    const CUtensorMap *tq, const CUtensorMap *tk, const CUtensorMap *tv,     \
        void *o, int B, int S, int Hq, int Hkv, int causal, int window,      \
        float scale, float softcap, cudaStream_t stream

#define FATC_DEFINE_LAUNCHER(HDV)                                            \
    int heye_fa_tc_hd##HDV(FATC_LAUNCHER_ARGS) {                             \
        return fa_tc_launch<HDV>(tq, tk, tv, o, B, S, Hq, Hkv, causal,       \
                                 window, scale, softcap, stream);            \
    }

int heye_fa_tc_hd16(FATC_LAUNCHER_ARGS);
int heye_fa_tc_hd32(FATC_LAUNCHER_ARGS);
int heye_fa_tc_hd64(FATC_LAUNCHER_ARGS);
int heye_fa_tc_hd96(FATC_LAUNCHER_ARGS);
int heye_fa_tc_hd128(FATC_LAUNCHER_ARGS);
int heye_fa_tc_hd256(FATC_LAUNCHER_ARGS);
