// Flash attention: the C entry point, dispatching on the head dim to the
// launchers of flash_attention_hd*.cu.  The kernel and its design are in
// flash_attention.cuh.
#include "flash_attention.cuh"

// window <= 0: no window; softcap <= 0: no soft cap.  Returns the
// cudaError_t of the launch; hd outside {16, 32, 64, 128, 256} is refused.
extern "C" int heye_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int Hq, int Hkv, int hd, int is_bf16,
                                    int causal, int window, float scale,
                                    float softcap, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (hd) {
        case 16:
            return heye_fa_hd16(q, k, v, o, B, S, Hq, Hkv, is_bf16, causal,
                                window, scale, softcap, st);
        case 32:
            return heye_fa_hd32(q, k, v, o, B, S, Hq, Hkv, is_bf16, causal,
                                window, scale, softcap, st);
        case 64:
            return heye_fa_hd64(q, k, v, o, B, S, Hq, Hkv, is_bf16, causal,
                                window, scale, softcap, st);
        case 128:
            return heye_fa_hd128(q, k, v, o, B, S, Hq, Hkv, is_bf16, causal,
                                 window, scale, softcap, st);
        case 256:
            return heye_fa_hd256(q, k, v, o, B, S, Hq, Hkv, is_bf16, causal,
                                 window, scale, softcap, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
