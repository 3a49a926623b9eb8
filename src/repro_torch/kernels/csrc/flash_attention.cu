// Flash attention: the C entry point.  float32 goes to the CUDA-core kernel
// of flash_attention.cuh (launchers in flash_attention_hd*.cu), bfloat16 to
// the tensor-core kernel of flash_attention_tc.cuh (launchers in
// flash_attention_tc_hd*.cu), whose TMA tensor maps are encoded here.
//
// cuTensorMapEncodeTiled is a driver function; it is fetched through the
// runtime's cudaGetDriverEntryPoint, so the library links no -lcuda.
#include "flash_attention.cuh"
#include "flash_attention_tc.cuh"

typedef CUresult (*fa_encode_fn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static fa_encode_fn fa_encoder() {
    static fa_encode_fn fn = nullptr;
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
            fn = (fa_encode_fn)p;
    }
    return fn;
}

// A bfloat16 (B, S, H, hd) tensor as a 4-D map, innermost first (hd, H, S,
// B); boxes of (ch, 1, rows, 1), ch the widest of 64 / 32 / 16 that divides
// hd (fatc::Cfg::CH), with the swizzle of their row width (128, 64 or 32
// bytes), rows past S read as zeros.
static bool fa_encode(CUtensorMap* map, const void* ptr, int B, int S, int H,
                      int hd, int rows, int ch) {
    fa_encode_fn fn = fa_encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                                (cuuint64_t)B};
    const cuuint64_t row = 2ull * hd;
    const cuuint64_t strides[3] = {row, row * H, row * H * S};
    const cuuint32_t box[4] = {(cuuint32_t)ch, 1, (cuuint32_t)rows, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle sw = ch == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : ch == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
              dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 kernel's tiles at one head dim (fatc::Cfg): query rows and keys
// a block's tile (the tensor maps' box rows), kv stages in its ring, and
// the columns of a box.
struct FaTiles {
    int bq, bk, stages, ch;
};

template <int HD>
static FaTiles fa_tc_tiles() {
    using C = fatc::Cfg<HD>;
    return {C::BQ, C::BK, C::STAGES, C::CH};
}

static bool fa_tc_tiles(int hd, FaTiles* t) {
    switch (hd) {
        case 16: *t = fa_tc_tiles<16>(); return true;
        case 32: *t = fa_tc_tiles<32>(); return true;
        case 64: *t = fa_tc_tiles<64>(); return true;
        case 96: *t = fa_tc_tiles<96>(); return true;
        case 128: *t = fa_tc_tiles<128>(); return true;
        case 256: *t = fa_tc_tiles<256>(); return true;
        default: return false;
    }
}

// The tile table of the bf16 kernel, one head dim at a time, for the
// wrapper's grid check to hold against its own table
// (kernels/flash_attention.py BF16_TILES).  hd outside {16, 32, 64, 96,
// 128, 256} is cudaErrorInvalidValue.
extern "C" int heye_fa_tc_tiles(int hd, int* bq, int* bk, int* stages) {
    FaTiles t;
    if (!fa_tc_tiles(hd, &t)) return (int)cudaErrorInvalidValue;
    *bq = t.bq, *bk = t.bk, *stages = t.stages;
    return 0;
}

static int fa_bf16(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Hq, int Hkv, int hd, int causal,
                   int window, float scale, float softcap, cudaStream_t st) {
    FaTiles t;
    if (!fa_tc_tiles(hd, &t)) return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    if (!fa_encode(&tq, q, B, S, Hq, hd, t.bq, t.ch) ||
        !fa_encode(&tk, k, B, S, Hkv, hd, t.bk, t.ch) ||
        !fa_encode(&tv, v, B, S, Hkv, hd, t.bk, t.ch))
        return (int)cudaErrorInvalidValue;
    switch (hd) {
        case 16:
            return heye_fa_tc_hd16(&tq, &tk, &tv, o, B, S, Hq, Hkv, causal,
                                   window, scale, softcap, st);
        case 32:
            return heye_fa_tc_hd32(&tq, &tk, &tv, o, B, S, Hq, Hkv, causal,
                                   window, scale, softcap, st);
        case 64:
            return heye_fa_tc_hd64(&tq, &tk, &tv, o, B, S, Hq, Hkv, causal,
                                   window, scale, softcap, st);
        case 96:
            return heye_fa_tc_hd96(&tq, &tk, &tv, o, B, S, Hq, Hkv, causal,
                                   window, scale, softcap, st);
        case 128:
            return heye_fa_tc_hd128(&tq, &tk, &tv, o, B, S, Hq, Hkv, causal,
                                    window, scale, softcap, st);
        default:
            return heye_fa_tc_hd256(&tq, &tk, &tv, o, B, S, Hq, Hkv, causal,
                                    window, scale, softcap, st);
    }
}

static int fa_f32(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int Hq, int Hkv, int hd, int causal,
                  int window, float scale, float softcap, cudaStream_t st) {
    switch (hd) {
        case 16:
            return heye_fa_hd16(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                scale, softcap, st);
        case 32:
            return heye_fa_hd32(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                scale, softcap, st);
        case 64:
            return heye_fa_hd64(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                scale, softcap, st);
        case 96:
            return heye_fa_hd96(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                scale, softcap, st);
        case 128:
            return heye_fa_hd128(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                 scale, softcap, st);
        case 256:
            return heye_fa_hd256(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                 scale, softcap, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// window <= 0: no window; softcap <= 0: no soft cap.  Returns the
// cudaError_t of the launch; hd outside {16, 32, 64, 96, 128, 256}, or a
// tensor map the driver refuses, is cudaErrorInvalidValue.
extern "C" int heye_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int Hq, int Hkv, int hd, int is_bf16,
                                    int causal, int window, float scale,
                                    float softcap, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    return is_bf16 ? fa_bf16(q, k, v, o, B, S, Hq, Hkv, hd, causal, window,
                             scale, softcap, st)
                   : fa_f32(q, k, v, o, B, S, Hq, Hkv, hd, causal, window,
                            scale, softcap, st);
}
