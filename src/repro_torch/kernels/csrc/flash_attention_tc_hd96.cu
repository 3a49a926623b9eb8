// Flash attention at head dim 96, bfloat16 on the tensor cores; see
// flash_attention_tc.cuh (three boxes of 32 columns, 64-byte swizzle).
#include "flash_attention_tc.cuh"

FATC_DEFINE_LAUNCHER(96)
