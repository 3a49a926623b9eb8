// Linear-recurrence scan h_t = a_t * h_{t-1} + b_t over (B, S, W) fp32,
// h_0 = 0 -- the core of the RG-LRU block.
//
// Replaces the TPU kernel repro/kernels/lru_scan.py:45 (lru_scan_pallas /
// _lru_kernel), which tiles (bs, bw) blocks into VMEM and carries h across
// the sequential time-chunk grid axis.
//
// Bound: bytes.  Each of a, b is read once and h written once: 3*B*S*W*4
// bytes, 402.6 MB at the model's (2, 4096, 4096).  The recurrence is
// sequential in t and independent across the B*W channels, so each
// channel's chain stays in one thread (4096 dependent fmul+fadd steps take
// ~20 us: the chain is not the limit).  What limits a thread-per-channel
// kernel is how few bytes its 8192 threads keep in flight, so here the
// chain is fed from a ring in shared memory that the Tensor Memory
// Accelerator keeps full:
//
// * one warp per block owns LRU_CH = 32 consecutive channels of one batch
//   row: 256 blocks at the model's shape, two per SM;
// * a ring of LRU_STAGES boxes of (LRU_T time steps x 32 channels) of a
//   and of b, each stage completing on its own mbarrier (expect-tx);
//   lane 0 refills a stage with the tile LRU_STAGES ahead as soon as the
//   warp has walked it, so LRU_STAGES - 1 tiles (80 KB a block, ~20 MB
//   over the card) are in flight while the chain runs;
// * each lane walks t over the arrived tile (the shared-memory loads do
//   not depend on h, so the unrolled loop issues them ahead of the chain)
//   and writes h back as one coalesced 128-byte row per step;
// * S and W that no tile divides: TMA fills the out-of-bounds part of a
//   box with zeros, the walk stops at S and lanes past W store nothing.
//
// The tensor maps are encoded on the host through the driver entry point
// (flash_attention.cu's way: no -lcuda).  TMA needs 16-byte aligned base
// addresses and rows (W % 4 == 0); any other input takes the
// thread-per-channel kernel below, the same arithmetic fed by plain
// loads.
//
// h = a*h + b is rounded as a product and a sum (__fmul_rn / __fadd_rn):
// nvcc may not contract it into an FMA, so both kernels agree to the bit
// with the plain version's two PyTorch ops.
#include <cuda.h>            // CUtensorMap; nothing of libcuda is linked
#include <cuda_runtime.h>
#include <stdint.h>

#define LRU_CH 32
#define LRU_T 64
#define LRU_STAGES 6
#define LRU_STAGE_FLOATS (LRU_T * LRU_CH)
#define LRU_SMEM (2 * LRU_STAGES * LRU_STAGE_FLOATS * 4)
#define LRU_UNROLL 8

namespace lru {

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

// one (channels, time steps, batch row) box of a tensor map into shared
// memory, completing on the mbarrier
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int w, int t,
                                            int b) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(w), "r"(t), "r"(b) : "memory");
}

}  // namespace lru

__global__ void __launch_bounds__(LRU_CH)
lru_scan_tma_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    float* __restrict__ h_out, int S, int W) {
    extern __shared__ __align__(128) float ring[];   // [stage][a|b][T][CH]
    __shared__ __align__(8) uint64_t full[LRU_STAGES];
    const int lane = threadIdx.x;
    const int wb = (W + LRU_CH - 1) / LRU_CH;
    const int b = blockIdx.x / wb;
    const int w0 = (blockIdx.x - b * wb) * LRU_CH;
    const int n_tiles = (S + LRU_T - 1) / LRU_T;
    const uint32_t bar0 = lru::smem_u32(&full[0]);
    const uint32_t ring0 = lru::smem_u32(ring);
    const uint32_t stage_bytes = 2u * LRU_STAGE_FLOATS * 4u;

    if (lane == 0) {
        for (int s = 0; s < LRU_STAGES; ++s) lru::bar_init(bar0 + 8 * s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < LRU_STAGES && s < n_tiles; ++s) {
            const uint32_t dst = ring0 + s * stage_bytes;
            lru::bar_expect_tx(bar0 + 8 * s, stage_bytes);
            lru::tma_load_3d(dst, &ta, bar0 + 8 * s, w0, s * LRU_T, b);
            lru::tma_load_3d(dst + stage_bytes / 2, &tb, bar0 + 8 * s, w0,
                             s * LRU_T, b);
        }
    }
    __syncwarp();

    const bool store = w0 + lane < W;
    float* out = h_out + ((long long)b * S) * W + w0 + lane;
    float h = 0.0f;
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % LRU_STAGES;
        lru::bar_wait(bar0 + 8 * s, (uint32_t)((i / LRU_STAGES) & 1));
        const float* sa = ring + s * 2 * LRU_STAGE_FLOATS + lane;
        const float* sb = sa + LRU_STAGE_FLOATS;
        const int t0 = i * LRU_T;
        float* o = out + (long long)t0 * W;
        if (t0 + LRU_T <= S) {
#pragma unroll
            for (int t = 0; t < LRU_T; t += LRU_UNROLL) {
                float av[LRU_UNROLL], bv[LRU_UNROLL];
#pragma unroll
                for (int u = 0; u < LRU_UNROLL; ++u) {
                    av[u] = sa[(t + u) * LRU_CH];
                    bv[u] = sb[(t + u) * LRU_CH];
                }
#pragma unroll
                for (int u = 0; u < LRU_UNROLL; ++u) {
                    h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
                    if (store) o[(long long)(t + u) * W] = h;
                }
            }
        } else {
            for (int t = 0; t < S - t0; ++t) {
                h = __fadd_rn(__fmul_rn(sa[t * LRU_CH], h), sb[t * LRU_CH]);
                if (store) o[(long long)t * W] = h;
            }
        }
        // every lane has read stage s: refill it with the tile LRU_STAGES on
        __syncwarp();
        const int nxt = i + LRU_STAGES;
        if (lane == 0 && nxt < n_tiles) {
            // order the warp's generic-proxy reads of the stage before the
            // async-proxy writes that overwrite it
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            const uint32_t dst = ring0 + s * stage_bytes;
            lru::bar_expect_tx(bar0 + 8 * s, stage_bytes);
            lru::tma_load_3d(dst, &ta, bar0 + 8 * s, w0, nxt * LRU_T, b);
            lru::tma_load_3d(dst + stage_bytes / 2, &tb, bar0 + 8 * s, w0,
                             nxt * LRU_T, b);
        }
    }
}

// thread per channel, for inputs TMA cannot describe (W % 4 != 0 or an
// unaligned base): UNROLL loads of a and of b in flight per thread
__global__ void lru_scan_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ h_out,
                                long long B, long long S, long long W) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= B * W) return;
    const long long bi = c / W;
    const long long w = c - bi * W;
    const long long base = bi * S * W + w;
    float h = 0.0f;
    long long t = 0;
    for (; t + LRU_UNROLL <= S; t += LRU_UNROLL) {
        float av[LRU_UNROLL], bv[LRU_UNROLL];
#pragma unroll
        for (int u = 0; u < LRU_UNROLL; ++u) {
            av[u] = a[base + (t + u) * W];
            bv[u] = b[base + (t + u) * W];
        }
#pragma unroll
        for (int u = 0; u < LRU_UNROLL; ++u) {
            h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
            h_out[base + (t + u) * W] = h;
        }
    }
    for (; t < S; ++t) {
        h = __fadd_rn(__fmul_rn(a[base + t * W], h), b[base + t * W]);
        h_out[base + t * W] = h;
    }
}

typedef CUresult (*lru_encode_fn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static lru_encode_fn lru_encoder() {
    static lru_encode_fn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = (lru_encode_fn)p;
    }
    return fn;
}

// A float32 (B, S, W) tensor as a 3-D map, innermost first (W, S, B);
// boxes of (LRU_CH, LRU_T, 1), no swizzle, out-of-bounds read as zeros.
static bool lru_encode(CUtensorMap* map, const void* ptr, long long B,
                       long long S, long long W) {
    lru_encode_fn fn = lru_encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {4ull * W, 4ull * W * S};
    const cuuint32_t box[3] = {LRU_CH, LRU_T, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
              dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

extern "C" int heye_lru_scan(const void* a, const void* b, void* h,
                             long long B, long long S, long long W,
                             void* stream) {
    if (B <= 0 || S <= 0 || W <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const bool tma = W % 4 == 0 && ((uintptr_t)a & 15) == 0 &&
                     ((uintptr_t)b & 15) == 0 && S < (1ll << 31) &&
                     B * ((W + LRU_CH - 1) / LRU_CH) < (1ll << 31);
    if (tma) {
        CUtensorMap ta, tb;
        if (!lru_encode(&ta, a, B, S, W) || !lru_encode(&tb, b, B, S, W))
            return (int)cudaErrorInvalidValue;
        cudaError_t err = cudaFuncSetAttribute(
            lru_scan_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            LRU_SMEM);
        if (err != cudaSuccess) return (int)err;
        const unsigned blocks = (unsigned)(B * ((W + LRU_CH - 1) / LRU_CH));
        lru_scan_tma_kernel<<<blocks, LRU_CH, LRU_SMEM, st>>>(
            ta, tb, (float*)h, (int)S, (int)W);
        return (int)cudaGetLastError();
    }
    const int threads = 64;
    const long long n = B * W;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    lru_scan_kernel<<<blocks, threads, 0, st>>>(
        (const float*)a, (const float*)b, (float*)h, B, S, W);
    return (int)cudaGetLastError();
}
