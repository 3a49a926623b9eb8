"""Import all assigned architecture configs (registers them)."""
from .gemma3_4b import GEMMA3_4B
from .gemma3_1b import GEMMA3_1B
from .gemma2_2b import GEMMA2_2B
from .minitron_4b import MINITRON_4B
from .llama4_maverick_400b_a17b import LLAMA4_MAVERICK
from .granite_moe_1b_a400m import GRANITE_MOE
from .recurrentgemma_9b import RECURRENTGEMMA_9B
from .whisper_large_v3 import WHISPER_LARGE_V3
from .rwkv6_1b6 import RWKV6_1B6
from .phi3_vision_4b import PHI3_VISION

ALL = [GEMMA3_4B, GEMMA3_1B, GEMMA2_2B, MINITRON_4B, LLAMA4_MAVERICK,
       GRANITE_MOE, RECURRENTGEMMA_9B, WHISPER_LARGE_V3, RWKV6_1B6,
       PHI3_VISION]
