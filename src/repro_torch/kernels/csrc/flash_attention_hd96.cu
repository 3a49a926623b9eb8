// Flash attention at head dim 96, float32 on CUDA cores; see
// flash_attention.cuh.
#include "flash_attention.cuh"

FA_DEFINE_LAUNCHER(96)
