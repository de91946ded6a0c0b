from .adamw import AdamWConfig, init as adamw_init, update as adamw_update, \
    clip_by_global_norm, global_norm
from .compression import TopKConfig, compress, compression_ratio, init_error
from .schedules import constant, cosine, linear_warmup

__all__ = ["AdamWConfig", "TopKConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress", "compression_ratio",
           "constant", "cosine", "global_norm", "init_error",
           "linear_warmup"]
