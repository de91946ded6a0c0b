from .adamw import AdamWConfig, init as adamw_init, update as adamw_update, \
    clip_by_global_norm, global_norm
from .schedules import constant, cosine, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "constant", "cosine", "global_norm", "linear_warmup"]
