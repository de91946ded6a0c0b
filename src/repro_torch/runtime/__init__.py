from .engine import EngineStats, PagedMLAEngine
from .loop import drive
from .prefix_cache import PrefixCache, PrefixCacheStats
from .sampling import SamplingParams
from .scheduler import (BlockAllocator, ContinuousScheduler, Request,
                        blocks_for)

__all__ = ["BlockAllocator", "ContinuousScheduler", "EngineStats",
           "PagedMLAEngine", "PrefixCache", "PrefixCacheStats", "Request",
           "SamplingParams", "blocks_for", "drive"]
