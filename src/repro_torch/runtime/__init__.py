from .engine import AsyncPagedMLAEngine, EngineStats, PagedMLAEngine
from .graphs import StepGraph
from .loop import LoopConfig, SimulatedFailure, TrainLoop, drive
from .prefix_cache import PrefixCache, PrefixCacheStats
from .sampling import SamplingParams
from .scheduler import (BlockAllocator, ContinuousScheduler, Request,
                        blocks_for)
from .steps import (TrainStepConfig, lm_loss, make_prefill_step,
                    make_paged_sample_step, make_serve_step,
                    make_train_step, scatter_prefill_to_paged)

__all__ = ["AsyncPagedMLAEngine", "BlockAllocator", "ContinuousScheduler", "EngineStats",
           "LoopConfig", "PagedMLAEngine", "PrefixCache", "PrefixCacheStats",
           "Request", "SamplingParams", "SimulatedFailure", "StepGraph",
           "TrainLoop",
           "TrainStepConfig", "blocks_for", "drive", "lm_loss",
           "make_paged_sample_step", "make_prefill_step", "make_serve_step",
           "make_train_step",
           "scatter_prefill_to_paged"]
