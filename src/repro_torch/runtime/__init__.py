from .engine import AsyncPagedMLAEngine, EngineStats, PagedMLAEngine
from .graphs import StepGraph
from .loop import LoopConfig, SimulatedFailure, TrainLoop, drive
from .prefix_cache import PrefixCache, PrefixCacheStats
from .sampling import SamplingParams
from .scheduler import (BlockAllocator, ContinuousScheduler, Request,
                        blocks_for)
from .spec import (accept_length, identity_draft, parse_draft_spec,
                   shallow_draft)
from .steps import (TrainStepConfig, lm_loss, make_prefill_step,
                    make_paged_sample_step, make_serve_step,
                    make_train_step, make_verify_step,
                    scatter_prefill_to_paged)

__all__ = ["AsyncPagedMLAEngine", "BlockAllocator", "ContinuousScheduler", "EngineStats",
           "LoopConfig", "PagedMLAEngine", "PrefixCache", "PrefixCacheStats",
           "Request", "SamplingParams", "SimulatedFailure", "StepGraph",
           "TrainLoop",
           "TrainStepConfig", "accept_length", "blocks_for", "drive",
           "identity_draft", "lm_loss", "make_paged_sample_step",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "make_verify_step", "parse_draft_spec",
           "scatter_prefill_to_paged", "shallow_draft"]
