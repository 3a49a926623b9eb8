// Flash attention at head dim 64, bfloat16 on the tensor cores; see
// flash_attention_tc.cuh.
#include "flash_attention_tc.cuh"

FATC_DEFINE_LAUNCHER(64)
