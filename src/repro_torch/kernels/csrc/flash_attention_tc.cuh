// Flash attention, forward, bfloat16 on Hopper's tensor cores (wgmma + TMA).
//
//   o[b,i,h,:] = sum_j softmax_j(mask(cap(q[b,i,h,:] . k[b,j,h/rep,:] * scale)))
//                * v[b,j,h/rep,:]
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:95
// (flash_attention_bhsd / _attn_kernel) for bfloat16 tensors; float32 goes
// to the CUDA-core kernel of flash_attention.cuh.
//
// Bound: operations.  Live (q, k) pairs times 4*hd flops, at the dense bf16
// tensor-core peak; at the model shapes 0.07 ms (granite-moe, B=2 S=4096
// Hq=16 Hkv=8 hd=64 causal) to 0.21 ms (phi-3-vision at hd 96, and the
// gemma3 / recurrentgemma path at hd 256 with a 2048 window).  Both
// products run on the tensor cores; the softmax between them runs on the
// CUDA cores and the SFU (one exp2 per score, 16 a cycle an SM), which at
// hd 64 takes as long as the two products of its tile.  The design keeps
// the tensor cores busy while the softmax runs:
//
// * Intra-warpgroup pipeline (FlashAttention-3's two-stage softmax / GEMM
//   pipeline).  Iteration n issues S_n = Q.K_n^T, then O += P_{n-1}.V_{n-1}
//   as a second wgmma group, waits with wait_group 1 (S_n is ready, P.V
//   still in flight) and runs the softmax of tile n under P.V.  The
//   wait_group 0 that ends P.V opens the next iteration, before O is
//   rescaled and P_n rounded: ptxas moves a wait up to the top of its
//   basic block, so placed after the softmax it would lift the wait above
//   it and the softmax would leave P.V's shadow.
// * Ping-pong between the consumer warpgroups.  Named barriers (ids 1 ..
//   NWG, bar.sync / bar.arrive over 256 threads) pass the right to issue
//   products from one warpgroup to the next, so one warpgroup's products
//   run while the others' softmax does.  All loop over the same kv tiles,
//   so their turns pair up.
// * Tiles per head dim (Tiles<HD>, below; exported by heye_fa_tc_tiles in
//   flash_attention.cu and mirrored by BF16_TILES in
//   kernels/flash_attention.py).  BK = 128 keys a tile at hd <= 128, which
//   halves the per-tile fixed cost (barrier waits, row-max shuffles, the
//   rescale of O) against 64; at hd 64 three consumer warpgroups (BQ =
//   192 rows, 160 registers a thread), whose third warp on every SM
//   sub-partition hides the softmax's latencies; a ring of 4 stages at hd
//   <= 64, 3 at hd 96, 2 at 128; hd 256 keeps BK = 64 and 2 stages (O 128
//   floats a thread).
// * Row sums on the tensor cores.  P.V runs hd + 8 wide: every V stage
//   holds a box of ones after V's boxes, so accumulator columns hd .. hd+7
//   sum each row's rounded weights, and the online rescale of O rescales
//   them too.  No unpacking and adding on the CUDA cores; at hd 256 (N
//   would pass wgmma's 256) the sums stay there.
// * P.V as one wgmma m64n(hd+8)k16 per 16 keys (hd 96: one m64n104k16, not
//   three of 32 columns); the V descriptor's leading byte offset steps from
//   one column box to the next, the box of ones last.
// * The scale folded into exp2: without a soft cap the scores stay raw
//   (the dot product), their row max is taken raw, and each weight is
//   exp2(fma(s, c, -m*c)) with c = scale*log2(e): one FFMA and one
//   ex2.approx a score.  O is rescaled only where a row max of the warp
//   moved.
//
// Block: 128 * (NWG + 1) threads.  Warpgroups 0 .. NWG-1 are consumers,
// each owning 64 of the block's BQ = 64 * NWG query rows of one (b, h);
// one thread of warpgroup NWG is the producer.  setmaxnreg gives the
// consumers 240 registers a thread (160 with three) and the producer 24.
// Grid: (B*Hq, ceil(S/BQ)), the query tiles of every (b, h) walked from
// the last (with a causal mask the heaviest) to the first, so that the
// heavy blocks start first.
//
// Shared memory: the block's Q tile, loaded once by TMA, and a ring of
// STAGES kv tiles of BK keys, K and V each filled by TMA and completed on
// its own mbarrier (so that Q.K^T starts before V has landed).  Two
// "empty" mbarriers per stage hand its K and its V back to the producer
// apart, every consumer thread arriving on the one once Q.K^T of the tile
// has completed and on the other once P.V has: the pipeline holds V of a
// tile one iteration longer than K, and with one barrier for both a ring
// of two stages would leave the producer nothing to prefetch.  Every tile
// is stored as boxes of CH columns, the widest of 64 / 32 / 16 that
// divides hd (128, 64 or 32 bytes a row), with the TMA swizzle of that row
// width, which is the layout wgmma reads: at hd 64 24 KB of Q and 4 x (16
// KB of K + 32 KB of V and ones); at hd 96 three boxes of 32 columns, 24
// KB of Q and 3 x (24 + 32) KB; at hd 256 64 KB of Q and 2 x 64 KB.
//
// TMA: Q, K and V are described as 4-D tensor maps over the model's
// (B, S, H, hd) layout, innermost first (hd, H, S, B), with boxes of
// (CH, 1, rows, 1).  Query head h reads kv head h / (Hq / Hkv)
// through the map's head coordinate: nothing is repeated.  Rows past S come
// in as zeros, so keys >= S are masked to -inf below (a zero key scores 0,
// not -inf).  The maps are encoded on the host (flash_attention.cu) and
// passed as __grid_constant__ parameters.
//
// S = Q.K^T: wgmma m64nBKk16, both operands K-major in shared memory, fp32
// accumulators (BK / 2 a thread), the first slice of the head dim
// overwriting them.  Online softmax: each row lives on the four threads of
// a quad, which reduce the row max with two xor shuffles.  P is rounded to
// bf16 in registers (the row sums add the rounded values, so numerator and
// denominator weigh the same numbers) and O += P.V runs with A = P from
// registers (the accumulator layout of S is the A-fragment layout) and B =
// V from shared memory, MN-major (transposed).  O stays in fp32 registers:
// (hd + 8) / 2 a thread.
//
// Masking follows the reference and the CUDA-core kernel: scores are
// scaled after the dot, soft-capped, then masked with a finite value while
// the running max starts at -inf.  With a soft cap the masked value is the
// reference's NEG_INF = -2^30 itself; without one the scores are raw and
// the masked value is M = -2^30 / scale rounded to a power of two (-2^30
// exactly once scaled where 1/scale is a power of two, as at hd 16, 64 and
// 256; within a factor sqrt(2) of it elsewhere), so that M*c is exact.
// Either way a row whose keys in a live tile all fall outside its window
// weighs each of them exp2(0) = 1 (exact in bf16), as the reference does,
// which the first real score wipes (its correction exp2(M*c - m*c) is 0),
// and once a real score is seen a masked one weighs exp2(< -1e9) = 0; the
// causal diagonal guarantees that score.  Keys past S get -inf and weigh
// nothing, so any S is taken.  Only kv tiles masked for every row of the
// query tile are skipped; tiles that no mask touches skip the per-element
// mask.
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

#define FATC_NEG_INF (-1073741824.0f)
#define FATC_LOG2E 1.4426950408889634f
#define FATC_MAX_DEVICES 64

namespace fatc {

// The tiles of each head dim: BK keys a kv tile, STAGES kv tiles in the
// ring, NWG consumer warpgroups of 64 query rows.
template <int HD> struct Tiles;
template <> struct Tiles<16> { static constexpr int BK = 128, STAGES = 4, NWG = 2; };
template <> struct Tiles<32> { static constexpr int BK = 128, STAGES = 4, NWG = 2; };
template <> struct Tiles<64> { static constexpr int BK = 128, STAGES = 4, NWG = 3; };
template <> struct Tiles<96> { static constexpr int BK = 128, STAGES = 3, NWG = 2; };
template <> struct Tiles<128> { static constexpr int BK = 128, STAGES = 2, NWG = 2; };
template <> struct Tiles<256> { static constexpr int BK = 64, STAGES = 2, NWG = 2; };

template <int HD> struct Cfg {
    static constexpr int BK = Tiles<HD>::BK;
    static constexpr int STAGES = Tiles<HD>::STAGES;
    static constexpr int NWG = Tiles<HD>::NWG;
    static constexpr int BQ = 64 * NWG;               // query rows a block
    static constexpr int THREADS = 128 * (NWG + 1);
    // registers a thread after setmaxnreg, within the SM's 65536
    static constexpr int PRODUCER_REGS = 24;
    static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;
    static_assert(128 * (PRODUCER_REGS + NWG * CONSUMER_REGS) <= 65536,
                  "the warpgroups' registers exceed the SM's");
    // columns per box: the widest of 64 / 32 / 16 that divides HD (64 at
    // hd 64-256, 32 at hd 32 and 96, 16 at hd 16)
    static constexpr int CH = HD % 64 == 0 ? 64 : (HD % 32 == 0 ? 32 : 16);
    static constexpr int NB = HD / CH;                // boxes per row
    static_assert(HD % CH == 0 && HD % 16 == 0 && HD <= 256,
                  "the head dim must be a multiple of its box width");
    static constexpr int SW = 2 * CH;                 // bytes per smem row
    static constexpr int LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
    static constexpr int Q_BOX = BQ * SW;
    static constexpr int KV_BOX = BK * SW;
    static constexpr int Q_BYTES = NB * Q_BOX;
    static constexpr int KV_BYTES = NB * KV_BOX;      // what TMA brings a stage
    // Row sums on the tensor cores: P.V runs N = HD + 8 wide over V and a
    // box of ones stored after V's boxes in every stage, so accumulator
    // columns HD .. HD+7 hold each row's sum of the rounded weights.  N is
    // at most 256: at hd 256 the sums stay on the CUDA cores.
    static constexpr bool SUM_ON_TC = HD + 8 <= 256;
    static constexpr int ON = HD + (SUM_ON_TC ? 8 : 0);   // P.V's width
    static constexpr int V_BYTES = KV_BYTES + (SUM_ON_TC ? KV_BOX : 0);
    static constexpr int SMEM = Q_BYTES + STAGES * (KV_BYTES + V_BYTES);
    static_assert(SMEM + 1024 + 8 * (1 + 4 * STAGES) <= 232448,
                  "the tiles exceed the shared memory of a block");
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

// the ping-pong of the consumer warpgroups: warpgroup w waits on named
// barrier 1 + w for its turn to issue products (its own 128 threads and
// the 128 of the warpgroup before it, which arrive there)
__device__ __forceinline__ void turn_wait(int wg) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + wg) : "memory");
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
// wait until at most N wgmma groups of this warpgroup are in flight
template <int N> __device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// pins registers in place around the asynchronous products, so that the
// compiler moves no read or write of them across a fence or wait (and
// reuses no register that an issued product still reads)
template <int N> __device__ __forceinline__ void keep(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N> __device__ __forceinline__ void keep(uint32_t* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The products.  wgmma_ss_nN: D[64 x N] (+)= A[64 x 16] * B[16 x N], A and
// B K-major in shared memory at descriptors da + OA and db + OB (16-byte
// units), SCALE_D 0 overwriting D.  wgmma_rs_nN: D[64 x N] += A[64 x 16] *
// B[16 x N], A in registers, B MN-major (transposed) in shared memory at
// descriptor db + OB.
#define FATC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FATC_D8(i) FATC_D4(i), FATC_D4(i + 4)

template <int OA, int OB, int SCALE_D>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsa, dsb;\n"
        "setp.ne.b32 p, %36, 0;\n"
        "add.s64 dsa, %32, %34;\n"
        "add.s64 dsb, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31}"
        ", dsa, dsb, p, 1, 1, 0, 0;\n}\n"
        : FATC_D8(0), FATC_D8(8), FATC_D8(16), FATC_D8(24)
        : "l"(da), "l"(db), "n"(OA), "n"(OB), "r"(SCALE_D));
}

template <int OA, int OB, int SCALE_D>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsa, dsb;\n"
        "setp.ne.b32 p, %68, 0;\n"
        "add.s64 dsa, %64, %66;\n"
        "add.s64 dsb, %65, %67;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        " %62, %63}"
        ", dsa, dsb, p, 1, 1, 0, 0;\n}\n"
        : FATC_D8(0), FATC_D8(8), FATC_D8(16), FATC_D8(24),
          FATC_D8(32), FATC_D8(40), FATC_D8(48), FATC_D8(56)
        : "l"(da), "l"(db), "n"(OA), "n"(OB), "r"(SCALE_D));
}

template <int OB>
__device__ __forceinline__ void wgmma_rs_n24(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "add.s64 dsb, %16, %17;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}"
        ", {%12, %13, %14, %15}, dsb, p, 1, 1, 1;\n}\n"
        : FATC_D8(0), FATC_D4(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(1));
}

template <int OB>
__device__ __forceinline__ void wgmma_rs_n40(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "add.s64 dsb, %24, %25;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19}"
        ", {%20, %21, %22, %23}, dsb, p, 1, 1, 1;\n}\n"
        : FATC_D8(0), FATC_D8(8), FATC_D4(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(1));
}

template <int OB>
__device__ __forceinline__ void wgmma_rs_n72(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %42, 0;\n"
        "add.s64 dsb, %40, %41;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}"
        ", {%36, %37, %38, %39}, dsb, p, 1, 1, 1;\n}\n"
        : FATC_D8(0), FATC_D8(8), FATC_D8(16), FATC_D8(24),
          FATC_D4(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(1));
}

template <int OB>
__device__ __forceinline__ void wgmma_rs_n104(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %58, 0;\n"
        "add.s64 dsb, %56, %57;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51}"
        ", {%52, %53, %54, %55}, dsb, p, 1, 1, 1;\n}\n"
        : FATC_D8(0), FATC_D8(8), FATC_D8(16), FATC_D8(24),
          FATC_D8(32), FATC_D8(40), FATC_D4(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(1));
}

template <int OB>
__device__ __forceinline__ void wgmma_rs_n136(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %74, 0;\n"
        "add.s64 dsb, %72, %73;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        " %62, %63, %64, %65, %66, %67}"
        ", {%68, %69, %70, %71}, dsb, p, 1, 1, 1;\n}\n"
        : FATC_D8(0), FATC_D8(8), FATC_D8(16), FATC_D8(24),
          FATC_D8(32), FATC_D8(40), FATC_D8(48), FATC_D8(56),
          FATC_D4(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(1));
}

template <int OB>
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 dsb;\n"
        "setp.ne.b32 p, %134, 0;\n"
        "add.s64 dsb, %132, %133;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
        " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
        " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
        " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
        " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
        ", {%128, %129, %130, %131}, dsb, p, 1, 1, 1;\n}\n"
        : FATC_D8(0), FATC_D8(8), FATC_D8(16), FATC_D8(24),
          FATC_D8(32), FATC_D8(40), FATC_D8(48), FATC_D8(56),
          FATC_D8(64), FATC_D8(72), FATC_D8(80), FATC_D8(88),
          FATC_D8(96), FATC_D8(104), FATC_D8(112), FATC_D8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(1));
}

#undef FATC_D8
#undef FATC_D4

template <int N, int OA, int OB, int SCALE_D>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
    static_assert(N == 64 || N == 128, "no Q.K^T product of this width");
    if constexpr (N == 64) wgmma_ss_n64<OA, OB, SCALE_D>(d, da, db);
    else wgmma_ss_n128<OA, OB, SCALE_D>(d, da, db);
}

template <int N, int OB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
    static_assert(N == 24 || N == 40 || N == 72 || N == 104 || N == 136 ||
                  N == 256, "no P.V product of this width");
    if constexpr (N == 24) wgmma_rs_n24<OB>(d, a, db);
    else if constexpr (N == 40) wgmma_rs_n40<OB>(d, a, db);
    else if constexpr (N == 72) wgmma_rs_n72<OB>(d, a, db);
    else if constexpr (N == 104) wgmma_rs_n104<OB>(d, a, db);
    else if constexpr (N == 136) wgmma_rs_n136<OB>(d, a, db);
    else wgmma_rs_n256<OB>(d, a, db);
}

// S = Q . K^T: one m64nBKk16 per 16 columns of the head dim, the first
// overwriting S.  Slice kk lies in box kk / KPB at byte 32 * (kk % KPB) of
// each swizzled row; the descriptor offsets (16-byte units) are
// immediates, so that only the two base descriptors are live.
template <int HD, int... KK>
__device__ __forceinline__ void qk_tile(float* sc, uint64_t dq, uint64_t dk,
                                        std::integer_sequence<int, KK...>) {
    using C = Cfg<HD>;
    (wgmma_ss<C::BK, (((KK / C::KPB) * C::Q_BOX + (KK % C::KPB) * 32) >> 4),
              (((KK / C::KPB) * C::KV_BOX + (KK % C::KPB) * 32) >> 4),
              (KK > 0)>(sc, dq, dk),
     ...);
}

// O += P . V: one m64nONk16 per 16 keys j (rows 16 j of every box, the
// box of ones among them; the descriptor's leading byte offset steps
// across the boxes)
template <int HD, int... J>
__device__ __forceinline__ void pv_tile(float* oacc, uint32_t (*pa)[4],
                                        uint64_t dv,
                                        std::integer_sequence<int, J...>) {
    using C = Cfg<HD>;
    (wgmma_rs<C::ON, ((J * 16 * C::SW) >> 4)>(oacc, pa[J], dv), ...);
}

// The softmax of one S tile, in place: soft cap (scaled scores) or raw
// scores, mask, the row max over this tile and the running max m, the
// correction exp2(m*c - m'*c) of what came before, then each weight
// exp2(fma(s, c, -m'*c)).  Accumulator i holds row qa + 8*((i>>1)&1), key
// k0 + 8*(i>>2) + cq + (i&1).  Returns whether a row max of the warp moved.
template <int BK>
__device__ __forceinline__ bool softmax_tile(
        float* sc, float* mrow, float* mc, float* corr, int k0, int qa, int cq,
        int q_lo, int q_hi, int S, int causal, int window, float scale,
        float softcap, float cm, float masked) {
    if (softcap > 0.0f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            const float x = sc[i] * scale;
            sc[i] = softcap * tanhf(x / softcap);
        }
    }
    const bool edge = (k0 + BK > S) || (causal && k0 + BK - 1 > q_lo) ||
                      (window > 0 && k0 <= q_hi - window);
    if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            const int qi = qa + 8 * ((i >> 1) & 1);
            const int kp = k0 + 8 * (i >> 2) + cq + (i & 1);
            bool live = true;
            if (causal) live = kp <= qi;
            if (window > 0) live = live && (kp > qi - window);
            float x = live ? sc[i] : masked;
            if (kp >= S) x = -INFINITY;
            sc[i] = x;
        }
    }
    // the row max in four independent chains a row, then combined
    float m4[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) m4[0][j] = m4[1][j] = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
        m4[(i >> 1) & 1][(i >> 2) & 3] =
            fmaxf(m4[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(fmaxf(mrow[r], fmaxf(m4[r][0], m4[r][1])),
                      fmaxf(m4[r][2], m4[r][3]));
    bool moved = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        moved = moved || mx[r] != mrow[r];
        const float m_c = mx[r] * cm;
        corr[r] = ex2(mc[r] - m_c);
        mrow[r] = mx[r];
        mc[r] = m_c;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
        sc[i] = ex2(fmaf(sc[i], cm, -mc[(i >> 1) & 1]));
    return __any_sync(0xffffffffu, moved);
}

// The weights rounded to bf16 into P (the A fragments of a P.V).  Where
// the row sums are not the tensor cores' (SUM true), their rounded values
// are added to the row sums, which take the tile's correction first.
template <int BK, bool SUM>
__device__ __forceinline__ void to_p(const float* sc, uint32_t (*pa)[4],
                                     float* lrow, const float* corr) {
    // the row sums in four independent chains a row, then combined
    float ps[2][4] = {};
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {          // register pairs
        __nv_bfloat162 pb = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
        if constexpr (SUM)
            ps[i & 1][(i >> 1) & 3] += __low2float(pb) + __high2float(pb);
        pa[i / 4][i % 4] = *reinterpret_cast<uint32_t*>(&pb);
    }
    if constexpr (SUM) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
            lrow[r] = lrow[r] * corr[r] +
                      ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
    }
}

// O times a tile's correction, where a row max of the warp moved
template <int N>
__device__ __forceinline__ void rescale(float* oacc, const float* corr,
                                        bool moved) {
    if (moved) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
    }
}

}  // namespace fatc

template <int HD>
__global__ void __launch_bounds__(fatc::Cfg<HD>::THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv,
                          int causal, int window, float scale, float softcap) {
    using C = fatc::Cfg<HD>;
    using namespace fatc;
    constexpr int BK = C::BK;
    constexpr int ST = C::STAGES;
    constexpr int NWG = C::NWG;
    extern __shared__ __align__(128) uint8_t fatc_smem[];
    __shared__ __align__(8) uint64_t bars[1 + 4 * ST];
    const uint32_t base = (smem_u32(fatc_smem) + 1023u) & ~1023u;
    const uint32_t sQ = base;
    const uint32_t sK = base + C::Q_BYTES;
    const uint32_t sV = sK + ST * C::KV_BYTES;     // stage s at s * V_BYTES
    const uint32_t bar_q = smem_u32(&bars[0]);
    const uint32_t bar_k = smem_u32(&bars[1]);                    // + 8 * stage
    const uint32_t bar_v = smem_u32(&bars[1 + ST]);
    const uint32_t bar_ek = smem_u32(&bars[1 + 2 * ST]);   // K handed back
    const uint32_t bar_ev = smem_u32(&bars[1 + 3 * ST]);   // V handed back

    const int bh = blockIdx.x;
    const int b = bh / Hq;
    const int h = bh - b * Hq;
    const int hk = h / (Hq / Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;

    // the kv tiles live for at least one row of this query tile
    int k_begin = 0, k_end = S;
    if (causal) k_end = min(S, q0 + C::BQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
    const int t_begin = k_begin / BK;
    const int n_tiles = (k_end + BK - 1) / BK - t_begin;

    const int tid = threadIdx.x;
    if (tid == 0) {
        bar_init(bar_q, 1);
#pragma unroll
        for (int s = 0; s < ST; ++s) {
            bar_init(bar_k + 8 * s, 1);
            bar_init(bar_v + 8 * s, 1);
            bar_init(bar_ek + 8 * s, 128 * NWG);
            bar_init(bar_ev + 8 * s, 128 * NWG);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (C::SUM_ON_TC) {
        // the box of ones after every stage's V, written once, made visible
        // to the tensor cores' (async proxy) reads
        uint8_t* gen = fatc_smem + (base - smem_u32(fatc_smem));
        for (int i = threadIdx.x; i < ST * C::KV_BOX / 16; i += C::THREADS) {
            const int st = i / (C::KV_BOX / 16);
            const int off = i - st * (C::KV_BOX / 16);
            *reinterpret_cast<uint4*>(gen + (sV - base) + st * C::V_BYTES +
                                      C::KV_BYTES + 16 * off) =
                make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    const int wg = tid >> 7;

    if (wg == NWG) {
        // ---------------- producer: one thread issues every TMA load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(C::PRODUCER_REGS) : "memory");
        if (tid == 128 * NWG) {
            bar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
            for (int c = 0; c < C::NB; ++c)
                tma_load_4d(sQ + c * C::Q_BOX, &tq, bar_q, c * C::CH, h, q0, b);
            for (int it = 0; it < n_tiles; ++it) {
                const int s = it % ST;
                const uint32_t par = (it / ST) & 1;
                const int k0 = (t_begin + it) * BK;
                bar_wait(bar_ek + 8 * s, par ^ 1);
                bar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
#pragma unroll
                for (int c = 0; c < C::NB; ++c)
                    tma_load_4d(sK + s * C::KV_BYTES + c * C::KV_BOX, &tk,
                                bar_k + 8 * s, c * C::CH, hk, k0, b);
                bar_wait(bar_ev + 8 * s, par ^ 1);
                bar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
#pragma unroll
                for (int c = 0; c < C::NB; ++c)
                    tma_load_4d(sV + s * C::V_BYTES + c * C::KV_BOX, &tv,
                                bar_v + 8 * s, c * C::CH, hk, k0, b);
            }
        }
    } else {
        // ---------------- consumers: 64 query rows each
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(C::CONSUMER_REGS) : "memory");
        const int t = tid & 127;
        const int lane = t & 31;
        const int qa = q0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);  // +8: half 1
        const int cq = 2 * (lane & 3);        // column in each 8-column block
        const int q_lo = q0 + 64 * wg;        // this warpgroup's rows
        const int q_hi = q_lo + 63;
        const int next = wg + 1 == NWG ? 0 : wg + 1;
        // base descriptors: this warpgroup's Q rows (K-major), stage 0's K
        // (K-major) and V (MN-major; LBO = the stride between boxes); stage
        // s lies s * KV_BYTES (K) or s * V_BYTES (V) further on
        const uint64_t dq = make_desc(sQ + 64 * wg * C::SW, 16, 8 * C::SW,
                                      C::LAYOUT);
        const uint64_t dk0 = make_desc(sK, 16, 8 * C::SW, C::LAYOUT);
        const uint64_t dv0 = make_desc(sV, C::KV_BOX, 8 * C::SW, C::LAYOUT);
        constexpr uint64_t K_STAGE = C::KV_BYTES >> 4;
        constexpr uint64_t V_STAGE = C::V_BYTES >> 4;
        // the exponent's factor and the masked value (see the header)
        const float cm = softcap > 0.0f ? FATC_LOG2E : scale * FATC_LOG2E;
        const float masked = softcap > 0.0f
            ? FATC_NEG_INF : ldexpf(-1.0f, 30 + __float2int_rn(-log2f(scale)));

        float oacc[C::ON / 2];
#pragma unroll
        for (int i = 0; i < C::ON / 2; ++i) oacc[i] = 0.0f;
        float sc[BK / 2];
        uint32_t pa[BK / 16][4];
        float mrow[2] = {-INFINITY, -INFINITY};
        float mc[2] = {-INFINITY, -INFINITY};
        float lrow[2] = {0.0f, 0.0f};
        float corr[2];

        bar_wait(bar_q, 0);
        if (wg == NWG - 1) turn_pass(0);      // warpgroup 0 issues first

        // tile 0: S_0 = Q . K_0^T alone, then its softmax
        bar_wait(bar_k, 0);
        turn_wait(wg);
        wg_fence();
        qk_tile<HD>(sc, dq, dk0, std::make_integer_sequence<int, HD / 16>{});
        wg_commit();
        turn_pass(next);
        wg_wait<0>();
        keep<BK / 2>(sc);
        bar_arrive(bar_ek);
        bool moved = softmax_tile<BK>(sc, mrow, mc, corr, t_begin * BK, qa, cq,
                                      q_lo, q_hi, S, causal, window, scale,
                                      softcap, cm, masked);

        for (int it = 1; it < n_tiles; ++it) {
            const int s = it % ST;
            const int sp = (it - 1) % ST;
            // P.V of tile it - 2 has completed (its V goes back): O takes
            // the correction of tile it - 1, whose weights become P.  The
            // wait opens the loop's body, so that the compiler, which
            // moves a wait up to the top of its block, cannot lift it
            // above the softmax that closes the body before it.
            wg_wait<0>();
            keep<C::ON / 2>(oacc);
            keep<BK / 4>(&pa[0][0]);
            if (it >= 2) bar_arrive(bar_ev + 8 * ((it - 2) % ST));
            rescale<C::ON>(oacc, corr, moved);
            to_p<BK, !C::SUM_ON_TC>(sc, pa, lrow, corr);
            // S_it = Q . K_it^T, then O += P_{it-1} . V_{it-1}
            bar_wait(bar_k + 8 * s, (it / ST) & 1);
            turn_wait(wg);
            wg_fence();
            qk_tile<HD>(sc, dq, dk0 + s * K_STAGE,
                        std::make_integer_sequence<int, HD / 16>{});
            wg_commit();
            bar_wait(bar_v + 8 * sp, ((it - 1) / ST) & 1);
            pv_tile<HD>(oacc, pa, dv0 + sp * V_STAGE,
                        std::make_integer_sequence<int, BK / 16>{});
            wg_commit();
            turn_pass(next);
            // S_it is ready: the softmax of tile it under P.V of tile it - 1
            wg_wait<1>();
            keep<BK / 2>(sc);
            bar_arrive(bar_ek + 8 * s);
            moved = softmax_tile<BK>(sc, mrow, mc, corr, (t_begin + it) * BK,
                                     qa, cq, q_lo, q_hi, S, causal, window,
                                     scale, softcap, cm, masked);
        }

        // the last P.V, once the one before it has completed
        wg_wait<0>();
        keep<C::ON / 2>(oacc);
        keep<BK / 4>(&pa[0][0]);
        rescale<C::ON>(oacc, corr, moved);
        to_p<BK, !C::SUM_ON_TC>(sc, pa, lrow, corr);
        const int sl = (n_tiles - 1) % ST;
        bar_wait(bar_v + 8 * sl, ((n_tiles - 1) / ST) & 1);
        wg_fence();
        pv_tile<HD>(oacc, pa, dv0 + sl * V_STAGE,
                    std::make_integer_sequence<int, BK / 16>{});
        wg_commit();
        wg_wait<0>();
        keep<C::ON / 2>(oacc);

        // O / l, rounded to bf16, rows < S
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float l;
            if constexpr (C::SUM_ON_TC) {
                l = oacc[HD / 2 + 2 * r];     // column HD: the whole row's sum
            } else {
                l = lrow[r];
                l += __shfl_xor_sync(0xffffffffu, l, 1);
                l += __shfl_xor_sync(0xffffffffu, l, 2);
            }
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

// The shared-memory attribute is set once per instantiation and device,
// at its first launch there.
template <int HD>
static int fa_tc_launch(const CUtensorMap* tq, const CUtensorMap* tk,
                        const CUtensorMap* tv, void* o, int B, int S, int Hq,
                        int Hkv, int causal, int window, float scale,
                        float softcap, cudaStream_t stream) {
    using C = fatc::Cfg<HD>;
    constexpr int smem = C::SMEM + 1024;            // + slack for alignment
    static bool ready[FATC_MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= FATC_MAX_DEVICES || !ready[dev]) {
        err = cudaFuncSetAttribute(flash_attention_tc_kernel<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return (int)err;
        if (dev < FATC_MAX_DEVICES) ready[dev] = true;
    }
    dim3 grid(B * Hq, (S + C::BQ - 1) / C::BQ);
    flash_attention_tc_kernel<HD><<<grid, C::THREADS, smem, stream>>>(
        *tq, *tk, *tv, (__nv_bfloat16*)o, S, Hq, Hkv, causal, window, scale,
        softcap);
    return (int)cudaGetLastError();
}

// One launcher per head dim, each defined in its own source.  tq, tk, tv
// point to host copies of the tensor maps (see flash_attention.cu), encoded
// with boxes of Cfg<hd>::BQ query rows and Cfg<hd>::BK keys.
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
