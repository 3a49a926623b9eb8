// Flash attention at head dim 256 (float32 and bfloat16); see
// flash_attention.cuh.
#include "flash_attention.cuh"

FA_DEFINE_LAUNCHER(256)
