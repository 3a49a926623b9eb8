from .adamw import (OptConfig, adamw_update, clip_by_global_norm, global_norm,
                    init_opt_state, schedule)
from .compress import compress_grads, compressed_bytes, init_error
