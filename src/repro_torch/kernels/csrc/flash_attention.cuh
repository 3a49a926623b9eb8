// Online-softmax (flash) attention, forward, float32, on CUDA cores.
//
//   o[b,i,h,:] = sum_j softmax_j(mask(cap(q[b,i,h,:] . k[b,j,h/rep,:] * scale)))
//                * v[b,j,h/rep,:]
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:95
// (flash_attention_bhsd / _attn_kernel), whose grid walks (B*Hq, q blocks,
// kv blocks) with the kv axis sequential and (m, l, acc) carried in VMEM,
// for float32 tensors: it holds the float32 model route to the plain
// version at 1e-4, which TF32 tensor cores would not.  bfloat16 goes to the
// tensor-core kernel of flash_attention_tc.cuh.
// Here one thread block owns one (b, h) and a tile of BQ = 64 query rows and
// loops over the kv tiles itself: the online-softmax state lives in
// registers.  The tensors stay in the model's (B, S, H, hd) layout; a query
// head reads kv head h / rep (GQA / MQA) and no k/v is repeated.
//
// Threads: 256, four per query row.  Thread (r, g) holds the 4-column
// chunks 16m + 4g .. 16m + 4g + 3 (m = 0 .. HD/16 - 1) of its row's q and
// of its accumulator, in registers.  A score is four partial dots combined
// with two xor shuffles, so every thread of the four ends with the same
// bits.  The kv tile (BK = 32 keys of k and of v) sits
// in dynamic shared memory: 2*BK*HD*4 bytes, 64 KB at HD = 256, which needs
// the opt-in above 48 KB.  The inner loops read it as float4: one 16-byte
// shared load feeds four FMAs, broadcast across the eight rows of a warp
// and consecutive across its four column parts (conflict-free).
//
// Masking follows the reference: scores are scaled by 1/sqrt(hd) after the
// dot, soft-capped, then masked with the finite NEG_INF = -2^30 while the
// running max starts at -inf.  A row whose keys in a live tile all fall
// outside its window accumulates exp(0) terms, which the first real score
// wipes exactly (exp(-2^30 - m) = 0 in fp32); the causal diagonal
// guarantees that score.  Keys past the end of the sequence (S need not be
// a multiple of any tile) get -inf and weigh nothing.  Only kv tiles fully
// masked for every row of the query tile are skipped.
//
// Bound: operations.  Live (q, k) pairs times 4*hd flops; at the model's
// shape (B=2, S=4096, 16 heads, hd=256, window 2048) about 2.1e11 flop: no
// faster than ~3 ms at the fp32 peak of the CUDA cores.
//
// Each head dim is compiled in its own source (flash_attention_hd*.cu), so
// that the build's parallel nvcc processes share the work;
// flash_attention.cu dispatches on hd.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define FA_BQ 64
#define FA_BK 32
#define FA_THREADS 256
#define FA_NEG_INF (-1073741824.0f)

template <int HD>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int Hq, int Hkv, int causal, int window,
                       float scale, float softcap) {
    constexpr int NC = HD / 16;                // float4 chunks per thread
    constexpr int ROW4 = HD / 4;               // float4s per tile row
    extern __shared__ float4 smem4[];
    float4* Ks = smem4;                        // [BK][HD/4]
    float4* Vs = smem4 + FA_BK * ROW4;         // [BK][HD/4]
    float* Ksf = reinterpret_cast<float*>(Ks);
    float* Vsf = reinterpret_cast<float*>(Vs);

    const int tid = threadIdx.x;
    const int r = tid >> 2;                    // query row in the tile
    const int g = tid & 3;                     // column part
    const int q0 = blockIdx.x * FA_BQ;
    const int bh = blockIdx.y;
    const int b = bh / Hq;
    const int h = bh - b * Hq;
    const int hk = h / (Hq / Hkv);
    const int qi = q0 + r;
    const bool row_ok = qi < S;
    const long long q_off = (((long long)b * S + qi) * Hq + h) * HD;

    float4 qf[NC], acc[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
        const int c = 16 * m + 4 * g;
        qf[m] = row_ok
            ? make_float4(q[q_off + c], q[q_off + c + 1], q[q_off + c + 2],
                          q[q_off + c + 3])
            : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float mx = -INFINITY, l = 0.0f;

    // the kv tiles live for at least one row of this query tile
    int k_begin = 0, k_end = S;
    if (causal) k_end = min(S, q0 + FA_BQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
    const int t_begin = k_begin / FA_BK;
    const int t_end = (k_end + FA_BK - 1) / FA_BK;

    for (int t = t_begin; t < t_end; ++t) {
        const int k0 = t * FA_BK;
        __syncthreads();                       // the last tile's reads are done
        for (int e = tid; e < FA_BK * HD; e += FA_THREADS) {
            const int kr = e / HD;
            const int c = e - kr * HD;
            const int kpos = k0 + kr;
            float kv = 0.0f, vv = 0.0f;
            if (kpos < S) {
                const long long off =
                    (((long long)b * S + kpos) * Hkv + hk) * HD + c;
                kv = k[off];
                vv = v[off];
            }
            Ksf[e] = kv;
            Vsf[e] = vv;
        }
        __syncthreads();

        float s[FA_BK];
        float m_tile = -INFINITY;
#pragma unroll
        for (int kk = 0; kk < FA_BK; ++kk) {
            float part = 0.0f;
#pragma unroll
            for (int m = 0; m < NC; ++m) {
                const float4 kv4 = Ks[kk * ROW4 + 4 * m + g];
                part = fmaf(qf[m].x, kv4.x, part);
                part = fmaf(qf[m].y, kv4.y, part);
                part = fmaf(qf[m].z, kv4.z, part);
                part = fmaf(qf[m].w, kv4.w, part);
            }
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            float sc = part * scale;
            if (softcap > 0.0f) sc = softcap * tanhf(sc / softcap);
            const int kpos = k0 + kk;
            bool live = true;
            if (causal) live = live && (kpos <= qi);
            if (window > 0) live = live && (kpos > qi - window);
            sc = live ? sc : FA_NEG_INF;
            if (kpos >= S) sc = -INFINITY;
            s[kk] = sc;
            m_tile = fmaxf(m_tile, sc);
        }
        const float m_new = fmaxf(mx, m_tile);
        const float corr = expf(mx - m_new);
        float psum = 0.0f;
#pragma unroll
        for (int kk = 0; kk < FA_BK; ++kk) {
            const float p = expf(s[kk] - m_new);
            s[kk] = p;
            psum += p;
        }
        l = l * corr + psum;
#pragma unroll
        for (int m = 0; m < NC; ++m) {
            acc[m].x *= corr;
            acc[m].y *= corr;
            acc[m].z *= corr;
            acc[m].w *= corr;
        }
#pragma unroll
        for (int kk = 0; kk < FA_BK; ++kk) {
            const float p = s[kk];
#pragma unroll
            for (int m = 0; m < NC; ++m) {
                const float4 vv4 = Vs[kk * ROW4 + 4 * m + g];
                acc[m].x = fmaf(p, vv4.x, acc[m].x);
                acc[m].y = fmaf(p, vv4.y, acc[m].y);
                acc[m].z = fmaf(p, vv4.z, acc[m].z);
                acc[m].w = fmaf(p, vv4.w, acc[m].w);
            }
        }
        mx = m_new;
    }
    if (row_ok) {
        const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
        for (int m = 0; m < NC; ++m) {
            const long long c = q_off + 16 * m + 4 * g;
            o[c] = acc[m].x * inv;
            o[c + 1] = acc[m].y * inv;
            o[c + 2] = acc[m].z * inv;
            o[c + 3] = acc[m].w * inv;
        }
    }
}

template <int HD>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Hq, int Hkv, int causal, int window,
                     float scale, float softcap, cudaStream_t stream) {
    const int smem = 2 * FA_BK * HD * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((S + FA_BQ - 1) / FA_BQ, B * Hq);
    flash_attention_kernel<HD><<<grid, FA_THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S, Hq,
        Hkv, causal, window, scale, softcap);
    return (int)cudaGetLastError();
}

// One launcher per head dim, each defined in its own source.
#define FA_LAUNCHER_ARGS                                                     \
    const void *q, const void *k, const void *v, void *o, int B, int S,      \
        int Hq, int Hkv, int causal, int window, float scale, float softcap, \
        cudaStream_t stream

#define FA_DEFINE_LAUNCHER(HDV)                                              \
    int heye_fa_hd##HDV(FA_LAUNCHER_ARGS) {                                  \
        return fa_launch<HDV>(q, k, v, o, B, S, Hq, Hkv, causal, window,     \
                              scale, softcap, stream);                       \
    }

int heye_fa_hd16(FA_LAUNCHER_ARGS);
int heye_fa_hd32(FA_LAUNCHER_ARGS);
int heye_fa_hd64(FA_LAUNCHER_ARGS);
int heye_fa_hd96(FA_LAUNCHER_ARGS);
int heye_fa_hd128(FA_LAUNCHER_ARGS);
int heye_fa_hd256(FA_LAUNCHER_ARGS);
