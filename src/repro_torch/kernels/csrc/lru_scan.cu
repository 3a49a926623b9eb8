// Linear-recurrence scan h_t = a_t * h_{t-1} + b_t over (B, S, W) fp32,
// h_0 = 0 -- the core of the RG-LRU block.
//
// Replaces the TPU kernel repro/kernels/lru_scan.py:45 (lru_scan_pallas /
// _lru_kernel), which tiles (bs, bw) blocks into VMEM and carries h across
// the sequential time-chunk grid axis.  On Hopper the recurrence is
// sequential in t and independent across the B*W channels, so one thread
// owns one channel and walks t = 0..S-1 in a register; consecutive threads
// own consecutive w, so every load and store of a time step is coalesced.
// Any S and W (no padding, no block-size search).
//
// Bound: bytes.  Each of a, b is read once and h written once: 3*B*S*W*4
// bytes.  With one thread per channel (8192 at the model's shape) the card
// is far from full, so the kernel is latency-bound; the loop is unrolled
// by UNROLL steps with the loads of a step group issued before its
// arithmetic, so UNROLL loads per thread are in flight at once.
//
// h = a*h + b is rounded as a product and a sum (__fmul_rn / __fadd_rn):
// nvcc may not contract it into an FMA, so the kernel agrees to the bit
// with the plain version's two PyTorch ops.
#include <cuda_runtime.h>

#define UNROLL 8

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
    for (; t + UNROLL <= S; t += UNROLL) {
        float av[UNROLL], bv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            av[u] = a[base + (t + u) * W];
            bv[u] = b[base + (t + u) * W];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
            h_out[base + (t + u) * W] = h;
        }
    }
    for (; t < S; ++t) {
        h = __fadd_rn(__fmul_rn(a[base + t * W], h), b[base + t * W]);
        h_out[base + t * W] = h;
    }
}

extern "C" int heye_lru_scan(const void* a, const void* b, void* h,
                             long long B, long long S, long long W,
                             void* stream) {
    if (B <= 0 || S <= 0 || W <= 0) return 0;
    const int threads = 64;   // 8192 channels -> 128 blocks over 132 SMs
    const long long n = B * W;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    lru_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)h, B, S, W);
    return (int)cudaGetLastError();
}
