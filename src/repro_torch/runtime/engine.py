"""Continuous-batching MLA serving engines over the paged latent pool
(ports of ``repro.runtime.engine.PagedMLAEngine`` and
``AsyncPagedMLAEngine``).

Glues the host-side ``ContinuousScheduler`` (admission, radix prefix cache,
block tables, copy-on-write, preemption) to the device steps of
``repro_torch.models``:

  * batched CHUNKED prefill straight into the pool: admitted requests
    prefill together, ``prefill_chunk`` tokens per request per step,
    attending their prefix-cache hits through the block table;
  * one paged decode step per tick over ALL slots (inactive slots ride
    along on the null block; their logits are discarded);
  * sampling on the engine's device: greedy argmax (ties to the lowest
    id) by default; ``temperature > 0`` draws with temperature / top-k
    from the key fold(fold(PRNGKey(sample_seed), rid), position),
    position the absolute index of the sampled token in the request's
    sequence — so recompute-preemption replay and n-way forks draw the
    reference's tokens (``steps.sample_tokens``, ``runtime.prng``); only
    the (B,) token ids come back to the host;
  * ``schemes.auto_dispatch`` re-run every decode step on the live
    (batch, max cache_len) point — all schemes compute the same function.

``impl='kernel'`` runs the paged attention in the CUDA kernels (K1 for
decode, K2 for prefill chunks; their plain versions on CPU tensors);
``impl='ref'`` on the gathered block-table view, and so does
``impl='chunked'`` (the reference's engine does the same: its decode and
chunk steps gather under 'chunked'), whose per-request prefill attends
through ``core.chunked_attention``'s block-pair walk; ``prefill_impl``
('gather' | 'kernel', or the reference's name 'pallas' for 'kernel')
overrides the chunk attention alone.  The pool is updated in place, in
the compute dtype (``cache_dtype='bf16'``) or quantized (``'int8'`` /
``'fp8'``: 1-byte codes with per-slot f32 scales, written by the chunked
prefill and the decode step, dequantized in the kernels' registers).
``prefill_mode='per_request'`` prefills each admitted request alone
through the contiguous MHA-mode prefill (``steps.make_prefill_step``) and
scatters its cache into the pool in whole blocks; it turns the prefix
cache off and refuses a quantized pool, as the reference does.
``partial_match=False`` (prefix hits end on a block boundary) and
``decode_block_reuse=False`` (no decode-completed block is cached) pass
to the scheduler: with ``admission='fcfs'`` they are the cold-cache
baseline of the serving benchmark.

``spec_k > 0`` with a draft (``runtime.spec``: 'self' or 'shallow:N')
turns each decode tick into a speculative round (:meth:`PagedMLAEngine.
_spec_round`): the draft proposes up to k tokens by paged decode against
its own pool (the draft pool: the scheduler's block geometry, the
engine's ``cache_dtype``, filled by the draft's own prefill of every
chunk), the target verifies them in one k + 1-query chunk step
(``models.verify_chunk_paged``: K2 under ``impl='kernel'``) and samples
its own token at every position on the device, and the host accepts the
leading drafts equal to those tokens and rewinds the lengths past them.
The tokens are plain decode's, greedy and seeded.

On a CUDA device the decode step (one per scheme), the prefill chunk and,
with ``spec_k``, the draft's decode step and chunk and the verify step
(one per scheme) run as CUDA graphs (``runtime.graphs.StepGraph``; the
reference's ``jit``), captured at first use or by
:meth:`PagedMLAEngine.warm_up`,
their capture time in ``EngineStats.capture_s``.  ``cuda_graphs=False``
runs the same steps eagerly; asking for graphs on the CPU raises.  A
step's inputs are copied from pinned host memory into the fixed device
buffers the steps read (``_upload``), so no upload waits for the device.

Two engines share this machinery:

  * ``PagedMLAEngine`` — the synchronous tick: schedule -> device step
    (ending in a synchronize) -> sample, one barrier per tick;
  * ``AsyncPagedMLAEngine`` — the double-buffered tick: the host runs
    tick N+1's scheduling while the device still executes tick N; the
    decode step samples on the device (``steps.make_paged_sample_step``)
    and only the (B,) ids come back, through a pinned buffer and a CUDA
    event, one tick late — token-identical to the synchronous engine.

``telemetry=`` (``obs.Telemetry``) arms the reference's hooks: the
per-step spans (step / schedule / prefill / prefill_chunk / device_step /
draft / verify / host_sample; the async engine's device_step on its own
track, ``TID_DEVICE``), the roofline drift rows (each decode tick timed
around ``device_step`` and each verify around ``verify``, both ending in
a device synchronize — dispatch to ready in the async engine — and each
admitted batch's prefill, priced on ``platform``), the step-time and
pool histograms, and the prefix cache's and scheduler's instants.  Off
(the default) each site costs one attribute check.

``mesh=`` (a ``launch.mesh.Mesh``: this process is one rank of a
(data, model) world, ``launch.mesh.launch``) serves sharded by
``shard_policy`` ('serve' | 'serve_2dtp' | 'dp' | 'tp', as in
``nn.sharding.make_rules``): ``max_batch`` is padded to a multiple of the
DP size; each rank keeps its shards of the weights
(``steps.commit_params``) and a whole replica of the pool, runs its DP
shard's batch rows and its heads (K1 / K2 at H / mp heads), gathers the
new latent rows of every DP shard and writes them all, in one order, so
the replicas stay bitwise equal.  The host side (scheduler, prefix
cache, block tables, admission, preemption) runs the same on every rank.
Tokens are sampled from the gathered full-vocab logits with the same
key stream, and rank 0's are broadcast, so the streams cannot fork.  A
mesh runs eagerly (``cuda_graphs`` None means False: gloo collectives
cannot be captured); graphs, ``spec_k > 0``, a per-request prefill and
the async engine under a mesh raise ``NotImplementedError``
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import models
from ..core import cache as cachelib
from ..core import mla as mlalib
from ..core.schemes import PlatformPoint, auto_dispatch
from ..kernels.mla_decode import mla_decode_paged_kernel
from ..kernels.mla_prefill import mla_prefill_paged_kernel
from ..models.blocks import IMPLS
from ..models.common import ModelConfig
from ..nn import collectives as coll
from ..obs import OFF_TELEMETRY, Telemetry
from ..obs.trace import PID_ENGINE
from .graphs import StepGraph
from .loop import drive
from . import spec as speclib
from .scheduler import ContinuousScheduler, Request, blocks_for
from .steps import (_dp_size, attach_absorbed_sharded, commit_params,
                    make_paged_sample_step, make_shard, make_prefill_step,
                    make_verify_step, sample_tokens, sample_window,
                    scatter_prefill_to_paged)

# PID_ENGINE tid 0 carries the host-phase spans; the async engine's
# device spans live on their own track, so a device step spanning two
# host ticks cannot break tid 0's nesting (obs.trace.validate_trace).
TID_DEVICE = 1
# the kernel wrappers whose launches a graph replays (runtime.graphs)
PAGED_KERNELS = (mla_decode_paged_kernel, mla_prefill_paged_kernel)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(see ROADMAP.md, queue 1)")


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0         # tokens actually prefilled (cache
    prompt_tokens: int = 0          # hits excluded) vs tokens submitted
    prefill_chunks: int = 0
    admissions: int = 0
    mid_gen_admissions: int = 0     # admitted while other slots were decoding
    preemptions: int = 0
    scheme_switches: int = 0
    spec_rounds: int = 0            # speculative draft+verify ticks
    spec_slot_rounds: int = 0       # per-slot verify rows across rounds
    spec_drafted: int = 0           # draft tokens proposed
    spec_accepted: int = 0          # draft tokens accepted by the target
    spec_draft_steps: int = 0       # draft decode steps run (port only)
    util_valid_sum: float = 0.0     # time-avg of valid/allocated
    util_pool_sum: float = 0.0
    util_samples: int = 0
    wall: float = 0.0
    capture_s: float = 0.0          # CUDA graph warm-up + capture time
    schemes_used: Dict[str, int] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict[str, float]:
        n = max(self.util_samples, 1)
        return {
            "steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prompt_tokens": self.prompt_tokens,
            "prefill_chunks": self.prefill_chunks,
            "admissions": self.admissions,
            "mid_gen_admissions": self.mid_gen_admissions,
            "preemptions": self.preemptions,
            "scheme_switches": self.scheme_switches,
            "tokens_per_s": (self.decode_tokens / self.wall)
            if self.wall > 0 else 0.0,
            "spec_rounds": self.spec_rounds,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": self.spec_accepted / self.spec_drafted
            if self.spec_drafted else 0.0,
            # per-REQUEST tokens per verify: the quantity the cost model's
            # break-even is stated in (1 <= E <= k + 1)
            "spec_mean_emitted": self.decode_tokens / self.spec_slot_rounds
            if self.spec_slot_rounds else 0.0,
            "cache_utilization": self.util_valid_sum / n,
            "pool_occupancy": self.util_pool_sum / n,
            "schemes_used": dict(self.schemes_used),
            "capture_s": self.capture_s,
        }


class PagedMLAEngine:
    # the step kind a decode tick runs: logits here, sampled ids in the
    # async engine
    _decode_kind = "decode"

    def __init__(self, cfg: ModelConfig, params, *, num_blocks: int,
                 block_size: int, max_batch: int,
                 max_blocks_per_req: Optional[int] = None,
                 compute_dtype=torch.float32, impl: str = "ref",
                 scheme: str = "auto",
                 platform: Optional[PlatformPoint] = None,
                 enable_prefix_cache: bool = True,
                 prefill_chunk: int = 32,
                 prefill_mode: str = "chunked",
                 prefill_impl: Optional[str] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0,
                 mesh=None, shard_policy: str = "serve", spec_k: int = 0,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params=None,
                 cache_dtype: str = "bf16",
                 admission: str = "cache_aware",
                 admission_age_bound: int = 64,
                 decode_block_reuse: bool = True,
                 partial_match: bool = True,
                 telemetry: Optional[Telemetry] = None, device="cuda",
                 cuda_graphs: Optional[bool] = None):
        if cfg.attn_kind != "mla":
            raise NotImplementedError("PagedMLAEngine requires an MLA model")
        if mesh is not None:
            if cuda_graphs:
                raise _not_ported("CUDA graphs of the mesh steps")
            if spec_k:
                raise _not_ported("speculative decoding under a mesh")
            if prefill_mode != "chunked":
                raise _not_ported("the per-request (contiguous) prefill "
                                  "under a mesh")
            cuda_graphs = False
        if scheme == "auto" and platform is None:
            raise ValueError("scheme='auto' needs a PlatformPoint")
        if scheme not in ("auto",) + mlalib.SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}")
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of "
                             f"{IMPLS}")
        if prefill_mode not in ("chunked", "per_request"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if prefill_impl in ("auto", ""):
            prefill_impl = None
        if prefill_impl == "pallas":     # the reference's name for K2
            prefill_impl = "kernel"
        if prefill_impl not in (None, "gather", "kernel"):
            raise ValueError(f"unknown prefill_impl {prefill_impl!r} "
                             "(None/'auto' | 'gather' | 'kernel')")
        cache_dtype = "bf16" if cache_dtype is None else cache_dtype
        cachelib.cache_dtype_info(cache_dtype)   # validate the name early
        if cache_dtype != "bf16" and prefill_mode != "chunked":
            raise NotImplementedError(
                "quantized cache_dtype requires prefill_mode='chunked' "
                "(the per-request scatter carries no scales)")
        if prefill_mode != "chunked":
            # the per-request path recomputes and rewrites WHOLE prompts,
            # which would scatter over read-only shared blocks
            enable_prefix_cache = False
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k:
            if prefill_mode != "chunked":
                raise NotImplementedError(
                    "speculative decoding requires prefill_mode='chunked' "
                    "(the draft pool is filled by the same chunked path)")
            if draft_cfg is None or draft_params is None:
                raise ValueError(
                    "spec_k > 0 needs draft_cfg + draft_params — build "
                    "them with runtime.spec.shallow_draft / identity_draft")
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab} != target {cfg.vocab}")
            if draft_cfg.attn_kind != "mla":
                raise NotImplementedError("drafts must be MLA models "
                                          "(they share the paged runtime)")
        self.cfg = cfg
        self.mla = cfg.mla_config()
        self.mesh = mesh
        # this rank's part of the sharded steps (None on one device)
        self.shard = make_shard(mesh, cfg, shard_policy)
        self.device = torch.device(device) if mesh is None else mesh.device
        # DP shards: the batch rows (tokens, tables, lengths) split over
        # 'data'; pad the slots to a multiple (the extra slots are empty
        # slots until admitted into)
        self._dp = 1 if mesh is None else _dp_size(mesh)
        max_batch = -(-max_batch // self._dp) * self._dp
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, got "
                             f"{self.device}")
        self.cuda_graphs = bool(cuda_graphs)
        # 'ru' streams the precomputed absorbed weights; attach them once
        # so every scheme sees the same param tree.  A fixed non-ru scheme
        # never reads them — skip the compute and memory.
        if mesh is None:
            self.params = mlalib.attach_absorbed_tree(params, self.mla) \
                if scheme in ("auto", "ru") else params
        else:
            self.params = commit_params(params, cfg, mesh, shard_policy)
            if scheme in ("auto", "ru"):
                self.params = attach_absorbed_sharded(self.params, cfg,
                                                      self.shard)
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype
        self.impl = impl
        self.scheme = scheme
        self.platform = platform
        self.block_size = block_size
        self.prefill_mode = prefill_mode
        # chunk attention: None follows ``impl``; 'gather' / 'kernel'
        # override it with the decode path pinned
        self.prefill_impl = prefill_impl
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._sample_seed = int(sample_seed)
        # cancellation flags from other threads, drained every tick
        self._cancel_lock = threading.Lock()
        self._cancels: set = set()
        # max_blocks_per_req bounds the block-table WIDTH, i.e. the extent
        # every step scans per request — size it to the longest request,
        # not the pool.
        self.sched = ContinuousScheduler(
            num_blocks=num_blocks, block_size=block_size,
            max_batch=max_batch, max_blocks_per_req=max_blocks_per_req,
            enable_prefix_cache=enable_prefix_cache,
            decode_window=spec_k + 1,
            admission=admission,
            admission_age_bound=admission_age_bound,
            decode_block_reuse=decode_block_reuse,
            partial_match=partial_match)
        self.pool = models.init_paged_cache(cfg, num_blocks, block_size,
                                            compute_dtype, self.device,
                                            cache_dtype)
        # -- speculative decoding: the draft model and its own pool, which
        # shares the scheduler's block geometry (one allocator and one
        # block table serve both), so accept / reject is one length rewind
        # and every block-level op (CoW copies) applies to both pools
        self.spec_k = int(spec_k)
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.draft_pool = None
        # drafts decode and prefill with 'seq' (all schemes compute the
        # same function; 'seq' needs no absorbed leaves, so a shallow draft
        # sliced from an un-absorbed tree serves every engine scheme)
        self._draft_scheme = "seq"
        self._spec_shapes: set = set()
        if spec_k:
            self.draft_pool = models.init_paged_cache(
                draft_cfg, num_blocks, block_size, compute_dtype,
                self.device, cache_dtype)
            if draft_params is params:
                # identity draft ('self'): the engine's prepared tree
                self.draft_params = self.params
        self.pending = np.zeros((max_batch,), np.int32)   # next token to feed
        # the fixed device buffers the steps read (a graph holds their
        # addresses), filled from pinned host memory every step
        self._inputs = self._step_inputs()
        self._graphs: Dict[Tuple[str, str], StepGraph] = {}
        self._last_scheme: Optional[str] = None
        self._last_point = (1, 1)     # (batch, cache_len) of the last pick
        self.stats = EngineStats()
        # bytes one cached token occupies across ALL layers of the pool,
        # at its storage dtype
        self.cache_token_bytes = cfg.n_layers * cachelib.bytes_per_token_latent(
            cfg.kv_lora_rank, cfg.qk_rope_dim,
            dtype_bytes=torch.empty((), dtype=compute_dtype).element_size(),
            cache_dtype=cache_dtype)
        # telemetry: the default is the no-op singleton, whose span()
        # returns a shared null context manager — each instrumented site
        # costs one attribute check when off
        self.tel = telemetry if telemetry is not None else OFF_TELEMETRY
        if self.tel.drift is not None and not self.tel.drift.active \
                and platform is not None:
            self.tel.drift.bind(mla=self.mla, platform=platform,
                                paged_block=block_size, dp_shards=self._dp,
                                cache_dtype=cache_dtype)
        if self.tel.enabled:
            self.sched.prefix.tel = self.tel

    # ----------------------------------------------------------- device ---

    def _host(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array as a tensor a copy to the device need not wait
        for: pinned on a CUDA engine (the caching host allocator keeps
        the pinned block until the copy that reads it has run, so no
        pinned memory is rewritten under a queued copy).  ``dtype``
        converts on the host: a conversion inside the copy would stage
        through pageable memory, and that copy waits."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the engine's device, by a copy that does
        not wait."""
        return self._host(a).to(self.device, non_blocking=True)

    def _upload(self, dst: Dict[str, torch.Tensor],
                src: Dict[str, np.ndarray]) -> None:
        """Copy this step's host arrays into its fixed device buffers,
        without waiting."""
        for k, a in src.items():
            dst[k].copy_(self._host(a, dst[k].dtype), non_blocking=True)

    def _step_inputs(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The device buffers of each step kind's inputs: 'decode'
        (token, block table, lengths) and 'chunk' (tokens (B, C), block
        table, lengths, n_valid); with ``spec_k``, 'draft' (decode's and
        the (B,) rids / poss of its sampler) and 'verify' (tokens
        (B, k + 1), block table, lengths, n_valid, rids, and each row's
        first absolute position, poss).  'draft_chunk' runs on 'chunk''s
        (``_buffers``)."""
        B, nb, C = self.sched.max_batch, self.sched.max_blocks, \
            self.prefill_chunk

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        out = {"decode": dict(token=z(B, dtype=torch.long),
                              block_table=z(B, nb), lengths=z(B)),
               "chunk": dict(tokens=z(B, C, dtype=torch.long),
                             block_table=z(B, nb), lengths=z(B),
                             n_valid=z(B))}
        if self.spec_k:
            out["draft"] = dict(token=z(B, dtype=torch.long),
                                block_table=z(B, nb), lengths=z(B),
                                rids=z(B, dtype=torch.long),
                                poss=z(B, dtype=torch.long))
            out["verify"] = dict(tokens=z(B, self.spec_k + 1,
                                          dtype=torch.long),
                                 block_table=z(B, nb), lengths=z(B),
                                 n_valid=z(B), rids=z(B, dtype=torch.long),
                                 poss=z(B, dtype=torch.long))
        return out

    def _buffers(self, kind: str) -> Dict[str, torch.Tensor]:
        """``kind``'s input buffers: the draft chunk replays on the ones
        the target's chunk was just given."""
        return self._inputs["chunk" if kind == "draft_chunk" else kind]

    def _chunk_impl(self) -> str:
        """Chunk-attention impl of the prefill, verify and draft chunk
        steps: ``prefill_impl`` when set, else ``impl`` (the models
        gather under 'chunked', as under 'ref')."""
        return {"gather": "ref", "kernel": "kernel",
                None: self.impl}[self.prefill_impl]

    def _model(self, kind: str):
        """(cfg, params, pool) a step of ``kind`` runs: the draft's for
        'draft' and 'draft_chunk', the target's otherwise."""
        if kind.startswith("draft"):
            return self.draft_cfg, self.draft_params, self.draft_pool
        return self.cfg, self.params, self.pool

    def _step_fn(self, kind: str, scheme: str):
        """The device step of ``kind`` under ``scheme``, as a function of
        its input buffers.  It holds the params and the pool, not the
        engine, so a graph of it dies with the engine."""
        cfg, params, pool = self._model(kind)
        shard = self.shard
        kw = dict(compute_dtype=self.compute_dtype, scheme=scheme)
        sample_kw = dict(temperature=self.temperature, top_k=self.top_k,
                         sample_seed=self._sample_seed)
        if kind == "verify":
            verify = make_verify_step(cfg, impl=self._chunk_impl(), **kw)

            def run_verify(tokens, block_table, lengths, n_valid, rids,
                           poss):
                logits, _ = verify(params, tokens, pool, block_table,
                                   lengths, n_valid)
                return sample_window(logits, rids, poss, **sample_kw), logits
            return run_verify
        if kind in ("chunk", "draft_chunk"):
            chunk_impl = self._chunk_impl()

            def chunk(tokens, block_table, lengths, n_valid):
                logits, _ = models.prefill_chunk_paged(
                    params, cfg, tokens, pool, block_table, lengths,
                    n_valid, impl=chunk_impl, shard=shard, **kw)
                return logits
            return chunk
        impl = self.impl
        if kind == "decode":
            def decode(token, block_table, lengths):
                logits, _ = models.decode_step(params, cfg, token, pool,
                                               block_table, lengths,
                                               impl=impl, shard=shard, **kw)
                return logits
            return decode
        # 'sample' (the async engine's tick) and 'draft' (the draft's
        # proposals): decode with the sampler folded in
        step = make_paged_sample_step(cfg, impl=impl, **sample_kw, **kw)

        def sample(token, block_table, lengths, rids, poss):
            return step(params, token, pool, block_table, lengths, rids,
                        poss)
        return sample

    def _graph(self, kind: str, scheme: str) -> StepGraph:
        """The captured graph of (kind, scheme), captured now if it is
        not yet: warmed up and captured on zeroed inputs (null block
        tables, length 0: every write lands in the null block), its time
        added to ``EngineStats.capture_s``."""
        g = self._graphs.get((kind, scheme))
        if g is not None:
            return g
        inputs = self._buffers(kind)
        for t in inputs.values():
            t.zero_()
        _, params, pool = self._model(kind)
        g = StepGraph(self._step_fn(kind, scheme), inputs,
                      held=lambda: [*cachelib.pool_leaves(pool),
                                    *cachelib.pool_leaves(params)],
                      counters=PAGED_KERNELS, name=f"{kind}/{scheme}")
        g.capture()
        self.stats.capture_s += g.capture_s
        self._graphs[(kind, scheme)] = g
        return g

    def _run_step(self, kind: str, scheme: str,
                  arrays: Optional[Dict[str, np.ndarray]] = None):
        """Upload ``arrays`` (None: none, the buffers hold this step's
        inputs already) into ``kind``'s input buffers and run the step:
        its graph's replay on a CUDA engine with graphs, the eager step
        otherwise.  Returns the step's output (a graph's is valid until
        its next replay)."""
        inputs = self._buffers(kind)
        if self.cuda_graphs:
            g = self._graph(kind, scheme)
            if arrays is not None:
                self._upload(inputs, arrays)
            return g.replay()
        if arrays is not None:
            self._upload(inputs, arrays)
        return self._step_fn(kind, scheme)(**inputs)

    def warm_up(self) -> float:
        """Capture the graphs a serve will replay before the first
        request, so no tick pays for a capture: the prefill chunk, and
        the decode step of every scheme the engine may dispatch — with
        ``spec_k``, instead of the decode steps (a spec engine runs none),
        the draft's decode step and chunk and the verify step of every
        such scheme.  Returns the seconds it took (also in
        ``EngineStats.capture_s``); a no-op without graphs."""
        if not self.cuda_graphs:
            return 0.0
        t0 = self.stats.capture_s
        schemes = ("seq", "rc", "ru") if self.scheme == "auto" \
            else (self.scheme,)
        for scheme in schemes:
            self._graph("verify" if self.spec_k else self._decode_kind,
                        scheme)
        if self.prefill_mode == "chunked":
            self._graph("chunk", self._chunk_scheme())
        if self.spec_k:
            self._graph("draft", self._draft_scheme)
            self._graph("draft_chunk", self._draft_scheme)
        return self.stats.capture_s - t0

    def graph_plans(self) -> Dict[str, Dict[str, dict]]:
        """The kernel plans each captured graph recorded at capture,
        by graph name."""
        return {g.name: dict(g.plans) for g in self._graphs.values()}

    def close(self) -> None:
        """Drop the captured graphs (their memory pools go with them)."""
        self._graphs.clear()

    @property
    def spec_compiles(self) -> int:
        """Distinct speculative step shapes run so far (the reference
        counts its compiles): verify steps (at most one a scheme, all at
        chunk k + 1) plus the draft decode step."""
        return len(self._spec_shapes)

    def _pick_scheme(self, verify_k: int = 0) -> str:
        active = self.sched.active_slots
        cache_len = int(self.sched.lengths[active].max()) + 1 if active else 1
        # the live dispatch point, kept for the drift channel: predictions
        # are evaluated at the point the dispatch saw
        self._last_point = (max(len(active), 1), cache_len)
        if self.scheme != "auto":
            self._last_scheme = self.scheme
            return self.scheme
        s = auto_dispatch(self.mla, self.platform, cache_len=cache_len,
                          batch=max(len(active), 1),
                          paged_block=self.block_size, dp_shards=self._dp,
                          verify_k=verify_k, cache_dtype=self.cache_dtype)
        if self._last_scheme is not None and s != self._last_scheme:
            self.stats.scheme_switches += 1
        self._last_scheme = s
        return s

    def _chunk_scheme(self) -> str:
        """A fixed engine scheme prefills with the same absorption ordering;
        'auto' (and 'naive', which has no latent chunk path) prefill with
        'seq' — all schemes compute the same function."""
        return self.scheme if self.scheme in ("seq", "rc", "ru") else "seq"

    def _sample_tokens(self, rows, slots) -> Dict[int, int]:
        """One token per listed slot from its logits row (``rows``
        (len(slots), V); each slot still holds its request), sampled on
        the rows' device by :func:`steps.sample_tokens`: greedy at
        ``temperature <= 0``, else under the key fold(fold(seed, rid),
        position) with position = the prompt length plus the tokens the
        request holds — the absolute index of the sampled token, which
        recompute preemption replays unchanged (the replayed prompt grows
        by exactly the generated tokens).  Under a mesh every rank holds
        the same gathered rows and samples them; rank 0's tokens are
        broadcast, so no rank's stream can fork from the others'."""
        rids = poss = None
        if self.temperature > 0.0:
            reqs = [self.sched.slots[s] for s in slots]
            rids = self._dev(np.asarray([r.rid for r in reqs], np.int64))
            poss = self._dev(np.asarray([r.plen + len(r.tokens)
                                         for r in reqs], np.int64))
        toks = sample_tokens(rows, rids, poss, temperature=self.temperature,
                             top_k=self.top_k,
                             sample_seed=self._sample_seed)
        if self.mesh is not None:
            toks = coll.broadcast(toks.contiguous(), self.mesh, src=0)
        toks = toks.cpu().numpy()
        return {s: int(toks[i]) for i, s in enumerate(slots)}

    def _sync_device(self) -> None:
        """Block until this tick's device work has retired, so ``wall``
        and ``tokens_per_s`` time the work and not its launch."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------- prefill ----

    def _run_chunked_prefill(self, admitted, step_i: int) -> None:
        """Prefill every just-admitted request's un-cached prompt suffix as
        a batch, ``prefill_chunk`` tokens per request per step.  Rows that
        exhaust their prompt sample generated token #1 from that chunk's
        last-valid logits and register their blocks in the radix cache."""
        C = self.prefill_chunk
        B = self.sched.max_batch
        tr = self.tel.tracer
        drift = self.tel.drift if (self.tel.drift is not None
                                   and self.tel.drift.active) else None
        t_pf = time.perf_counter() if drift else 0.0
        pending = dict(admitted)
        fill = {slot: req.n_cached for slot, req in admitted}
        if self.spec_k and self.cuda_graphs:
            # its capture zeroes the buffers it shares with the chunk, so
            # it comes before the chunk's upload
            self._graph("draft_chunk", self._draft_scheme)
        while pending:
            tokens = np.zeros((B, C), np.int32)
            lens = np.zeros((B,), np.int32)
            nv = np.zeros((B,), np.int32)
            finishing = []
            for slot, req in list(pending.items()):
                start = fill[slot]
                take = min(req.plen - start, C)
                tokens[slot, :take] = req.prompt[start:start + take]
                lens[slot] = start
                nv[slot] = take
                fill[slot] = start + take
                if fill[slot] >= req.plen:
                    finishing.append((slot, req))
                    del pending[slot]
            with tr.span("prefill_chunk"):
                arrays = dict(tokens=tokens,
                              block_table=self.sched.block_table,
                              lengths=lens, n_valid=nv)
                logits = self._run_step("chunk", self._chunk_scheme(),
                                        arrays)
                if self.spec_k:
                    # the draft prefills the SAME chunk into its own pool,
                    # so a request drafts as soon as it is admitted
                    # (prefix-cache hits skip both pools alike: shared
                    # block ids hold valid latents in each), from the
                    # buffers the chunk was just given
                    self._run_step("draft_chunk", self._draft_scheme)
            self.stats.prefill_tokens += int(nv.sum())
            self.stats.prefill_chunks += 1
            for slot, req in finishing:
                tok = self._sample_tokens(logits[slot][None], [slot])[slot]
                # register blocks only now — their latents are in the pool
                self.sched.commit_prefill(slot)
                self._fork_and_seed(slot, logits[slot][None], step_i)
                if self.sched.record_prefill_sample(slot, tok, step_i) is None:
                    self.pending[slot] = tok
        if drift:
            # one drift row per admitted batch, over the whole chunk walk
            # (the cost model prices a full prompt's chunk sequence); the
            # measured time includes the finishing rows' first-token
            # sampling, as in the reference
            self._sync_device()
            seq_len = max(req.plen for _, req in admitted)
            cached = min(req.n_cached for _, req in admitted)
            if seq_len > cached:
                # the cost model's names: 'pallas' = the paged prefill
                # kernel (K2 here), 'gather' = the block-table view
                impl = "pallas" if self._chunk_impl() == "kernel" \
                    else "gather"
                drift.record_prefill(self._chunk_scheme(), len(admitted),
                                     seq_len, C, impl,
                                     time.perf_counter() - t_pf,
                                     cached_prefix=cached)

    def _run_per_request_prefill(self, admitted, step_i: int) -> None:
        """Contiguous prefill of each admitted request alone (capacity
        rounded up to whole blocks), its cache scattered into the pool in
        whole blocks.  Incompatible with prefix sharing."""
        for slot, req in admitted:
            cap = blocks_for(req.plen, self.block_size) * self.block_size
            prefill = make_prefill_step(self.cfg, capacity=cap,
                                        compute_dtype=self.compute_dtype,
                                        impl=self.impl)
            logits, cache = prefill(
                self.params,
                self._dev(np.asarray(req.prompt, np.int64)[None]))
            self.pool = scatter_prefill_to_paged(
                self.pool, cache, self._dev(self.sched.block_table[slot]))
            self.stats.prefill_tokens += req.plen
            tok = self._sample_tokens(logits[0][None], [slot])[slot]
            self.sched.commit_prefill(slot)
            self._fork_and_seed(slot, logits[0][None], step_i)
            if self.sched.record_prefill_sample(slot, tok, step_i) is None:
                self.pending[slot] = tok

    def _fork_and_seed(self, slot: int, row, step_i: int) -> None:
        """Fork a just-prefilled n > 1 parent (scheduler.fork_group) and
        give every child its first token from the parent's last-position
        prefill logits."""
        kids = self.sched.fork_group(slot)
        if not kids:
            return
        cslots = [cs for cs, _ in kids]
        picks = self._sample_tokens(row.expand(len(kids), -1), cslots)
        for cs in cslots:
            tok = picks[cs]
            if self.sched.record_prefill_sample(cs, tok, step_i) is None:
                self.pending[cs] = tok

    # ------------------------------------------------------------- run ----

    def validate_sampling(self, sp) -> None:
        """Raise ValueError unless the per-request ``SamplingParams`` are
        servable by this engine: the engine-global knobs (temperature,
        top_k, seed) must equal the engine's own when set; None means
        'inherit'.  The reference's rule, and its messages word for word
        (the frontend returns them in its 400 bodies): the async engine's
        step, compiled there and captured here, holds them."""
        if sp is None:
            return
        if sp.temperature is not None \
                and float(sp.temperature) != self.temperature:
            raise ValueError(
                f"temperature={sp.temperature} != engine temperature "
                f"{self.temperature}; per-request overrides are baked "
                f"into the compiled step — set it engine-wide or leave "
                f"None to inherit")
        if sp.top_k is not None and int(sp.top_k) != self.top_k:
            raise ValueError(
                f"top_k={sp.top_k} != engine top_k {self.top_k}; set it "
                f"engine-wide or leave None")
        if sp.seed is not None and int(sp.seed) != self._sample_seed:
            raise ValueError(
                f"seed={sp.seed} != engine sample_seed "
                f"{self._sample_seed}; set it engine-wide or leave None")

    def submit(self, req: Request) -> None:
        self.validate_sampling(req.sampling)
        self.sched.submit(req)

    @property
    def idle(self) -> bool:
        """No queued or running work: ``runtime.loop.drive`` may stop ticking."""
        return self.sched.all_done

    def request_cancel(self, rid: int) -> None:
        """Flag ``rid`` for cancellation.  Thread-safe; the engine drains
        the flags at the start of its next tick and releases the
        request's slot and blocks (scheduler.cancel)."""
        with self._cancel_lock:
            self._cancels.add(rid)

    def _process_cancels(self, step_i: int) -> None:
        with self._cancel_lock:
            rids, self._cancels = self._cancels, set()
        for rid in sorted(rids):
            self.sched.cancel(rid, step_i)

    def _drain_cow(self) -> None:
        """Apply the scheduler's queued copy-on-write block copies to the
        pool.  Independent pairs go in one indexed copy per pool leaf; a
        CHAINED batch (some dst re-read as a later src) must apply in
        queue order, one pair at a time."""
        pairs = self.sched.drain_cow()
        if not pairs:
            return
        srcs = [p[0] for p in pairs]
        dsts = [p[1] for p in pairs]
        # block-level ops track both pools (same geometry)
        pools = [p for p in (self.pool, self.draft_pool) if p is not None]
        if len(pairs) == 1 or (set(srcs) & set(dsts)):
            for src, dst in pairs:
                for pool in pools:
                    cachelib.copy_block_paged(pool, src, dst)
            return
        s, d = (self._dev(np.asarray(srcs, np.int64)),
                self._dev(np.asarray(dsts, np.int64)))
        for pool in pools:
            cachelib.copy_blocks_paged(pool, s, d)

    def step(self) -> None:
        """One scheduler tick: admit + batched prefill, then one batched
        decode step over all slots."""
        t0 = time.perf_counter()
        step_i = self.stats.steps
        self._process_cancels(step_i)
        was_decoding = self.sched.n_active > 0
        tr = self.tel.tracer
        drift = self.tel.drift if (self.tel.drift is not None
                                   and self.tel.drift.active) else None

        with tr.span("step"):
            with tr.span("schedule"):
                # grow running requests BEFORE admitting: otherwise a
                # just-admitted request could take the last blocks, get
                # preempted immediately, and throw away the prefill it
                # just paid for.
                self.stats.preemptions += len(
                    self.sched.ensure_step_capacity())
                self._drain_cow()
                admitted = self.sched.try_admit(step_i)
                # partial-hit tail copies queued by try_admit land before
                # prefill
                self._drain_cow()
            for _, req in admitted:
                self.stats.admissions += 1
                self.stats.prompt_tokens += req.plen
                if was_decoding:
                    self.stats.mid_gen_admissions += 1
            if admitted:
                with tr.span("prefill"):
                    if self.prefill_mode == "chunked":
                        self._run_chunked_prefill(admitted, step_i)
                    else:
                        self._run_per_request_prefill(admitted, step_i)
                # fork-group tail copies land before both forks' decode
                # writes
                self._drain_cow()

            active = self.sched.active_slots
            if active and self.spec_k:
                self._spec_round(active, step_i)
            elif active:
                scheme = self._pick_scheme()
                self.stats.schemes_used[scheme] = \
                    self.stats.schemes_used.get(scheme, 0) + 1
                t_dev = time.perf_counter() if drift else 0.0
                with tr.span("device_step"):
                    logits = self._run_step(
                        "decode", scheme,
                        dict(token=self.pending,
                             block_table=self.sched.block_table,
                             lengths=self.sched.lengths))
                    # the reference blocks here too: the span and the
                    # drift row time the step, not its launch
                    self._sync_device()
                if drift:
                    b, cl = self._last_point
                    drift.record_decode(scheme, b, cl,
                                        time.perf_counter() - t_dev)
                with tr.span("host_sample"):
                    picks = self._sample_tokens(
                        logits[self._dev(np.asarray(active))], active)
                    self.sched.advance(picks, step_i)
                for s, t in picks.items():
                    self.pending[s] = t
                self.stats.decode_tokens += len(active)

            u = self.sched.utilization()
            self.stats.util_valid_sum += u["valid_frac"]
            self.stats.util_pool_sum += u["pool_frac"]
            self.stats.util_samples += 1
            self._sync_device()
        self.stats.steps += 1
        dt = time.perf_counter() - t0
        self.stats.wall += dt
        if self.tel.metrics is not None:
            m = self.tel.metrics
            m.histogram("step_ms").record(dt * 1e3)
            m.histogram("pool_occupancy").record(u["pool_frac"])
            m.histogram("pool_allocated_bytes").record(
                u["allocated_blocks"] * self.block_size
                * self.cache_token_bytes)

    # ------------------------------------------------ speculative round ----

    def _spec_round(self, active, step_i: int) -> None:
        """One draft + verify + accept tick over all active slots (the
        reference's ``_spec_round``).

        1. DRAFT: the draft proposes up to k tokens a slot by paged decode
           against its own pool, sampling on the device with the target's
           rule — greedy, or the fold(rid, absolute position) key of the
           position it proposes — so an identity draft proposes what the
           target will sample.  The loop runs each slot's whole write
           window (nv[s] = min(k + 1, remaining budget)), so the last
           draft's latent is written too: its proposal is discarded, but
           its write keeps the draft pool complete when all k are
           accepted.  A slot whose window is used up re-writes the same
           token at the same position (idempotent), so one step shape
           (one graph) serves ragged windows.
        2. VERIFY: one chunk step of the target over [pending, d_1 ..
           d_{nv-1}] at C = k + 1 (``steps.make_verify_step``), its
           token at every position sampled on the device
           (``steps.sample_window``) under plain decode's keys.
        3. ACCEPT: the leading drafts equal to the target's tokens are
           accepted; the round emits them plus one bonus / correction
           token (``spec.accept_length``).  Rejection is a host-side
           length rewind (``scheduler.advance_multi``)."""
        k = self.spec_k
        B = self.sched.max_batch
        tr = self.tel.tracer
        drift = self.tel.drift if (self.tel.drift is not None
                                   and self.tel.drift.active) else None
        nv = np.zeros((B,), np.int32)
        rids = np.zeros((B,), np.int64)
        base = np.zeros((B,), np.int64)
        for s in active:
            req = self.sched.slots[s]
            nv[s] = self.sched._window(req)
            rids[s] = req.rid
            base[s] = req.plen + len(req.tokens)   # abs pos, next sample
        bt = self.sched.block_table
        # ---- 1. draft ---------------------------------------------------
        drafts = np.zeros((B, k), np.int64)
        d_pending = self.pending.astype(np.int64)
        d_lens = self.sched.lengths.copy()
        self._spec_shapes.add(("draft", self._draft_scheme))
        with tr.span("draft"):
            for j in range(int(nv.max())):
                # the proposal at absolute position d_lens + 1 draws the
                # key the target samples THAT position with in verify
                prop = self._run_step(
                    "draft", self._draft_scheme,
                    dict(token=d_pending, block_table=bt, lengths=d_lens,
                         rids=rids, poss=d_lens.astype(np.int64) + 1)
                ).cpu().numpy()
                self.stats.spec_draft_steps += 1
                for s in active:
                    if j < nv[s] - 1:
                        drafts[s, j] = prop[s]
                        self.stats.spec_drafted += 1
                    if j + 1 < nv[s]:    # still drafting next iteration
                        d_pending[s] = prop[s]
                        d_lens[s] += 1
        # ---- 2. verify --------------------------------------------------
        tokens_v = np.zeros((B, k + 1), np.int64)
        for s in active:
            tokens_v[s, 0] = self.pending[s]
            tokens_v[s, 1:nv[s]] = drafts[s, :nv[s] - 1]
        scheme = self._pick_scheme(verify_k=k)
        self.stats.schemes_used[scheme] = \
            self.stats.schemes_used.get(scheme, 0) + 1
        self._spec_shapes.add(("verify", scheme))
        t_v = time.perf_counter() if drift else 0.0
        with tr.span("verify"):
            target, _ = self._verify(scheme, dict(
                tokens=tokens_v, block_table=bt, lengths=self.sched.lengths,
                n_valid=nv, rids=rids, poss=base))
        if drift:
            b, cl = self._last_point
            drift.record_verify(scheme, b, cl, k, time.perf_counter() - t_v)
        # ---- 3. accept + host-side length rewind ------------------------
        with tr.span("host_sample"):
            emitted = {}
            for s in active:
                t_s = target[s, :nv[s]]
                n_acc = speclib.accept_length(drafts[s, :nv[s] - 1], t_s)
                emitted[s] = [int(t) for t in t_s[:n_acc + 1]]
                self.stats.spec_accepted += n_acc
            self.sched.advance_multi(emitted, step_i)
        for s, toks in emitted.items():
            if self.sched.slots[s] is not None:
                self.pending[s] = toks[-1]
        self.stats.decode_tokens += sum(len(t) for t in emitted.values())
        self.stats.spec_rounds += 1
        self.stats.spec_slot_rounds += len(active)

    def _verify(self, scheme: str, arrays: Dict[str, np.ndarray]):
        """Run the verify step on ``arrays`` and wait for it; returns the
        target's tokens (B, k + 1) on the host and the step's logits
        (B, k + 1, V) on the device (a graph's, valid until its next
        replay)."""
        ids, logits = self._run_step("verify", scheme, arrays)
        return ids.cpu().numpy(), logits

    def run(self, requests: List[Request], *, max_steps: int = 100_000,
            log_every: int = 0, log=print) -> Dict[str, float]:
        """Drive a request stream to completion (:func:`runtime.loop.drive`)."""
        return drive(self, requests, max_steps=max_steps,
                     log_every=log_every, log=log)

    def summary(self) -> Dict[str, float]:
        """Engine stats + prefix-cache stats + allocator totals."""
        out = self.stats.summary()
        out.update(self.sched.prefix.summary())
        out["total_blocks_allocated"] = float(
            self.sched.allocator.total_allocs)
        out["fork_groups"] = float(self.sched.fork_groups)
        out["fork_children"] = float(self.sched.forked_children)
        out["spec_compiles"] = float(self.spec_compiles)
        out["cache_dtype"] = self.cache_dtype
        out["cache_token_bytes"] = float(self.cache_token_bytes)
        out["cuda_graphs"] = self.cuda_graphs
        return out


# --------------------------------------------------------- async engine ----


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-unaccounted fused decode step."""
    tokens: torch.Tensor                 # (B,) ids: pinned host (CUDA)
    ready: Optional[torch.cuda.Event]    # recorded after their copy (CUDA)
    entries: List[Tuple[int, Request]]   # (dispatch slot, request)
    deferred: List[Tuple[int, Request]]  # slot released, token value pending
    t_disp_tr: float                     # tracer ``now()`` clock at dispatch
    t_disp_perf: float                   # perf_counter at dispatch (drift)
    scheme: str
    point: Tuple[int, int]               # (batch, cache_len) dispatch point
    fetched: Optional[np.ndarray] = None  # host copy, once someone needed it

    def fetch(self) -> np.ndarray:
        """The step's ids on the host: waits on the step's event and on
        nothing else."""
        if self.fetched is None:
            if self.ready is not None:
                self.ready.synchronize()
            self.fetched = self.tokens.numpy().copy()
        return self.fetched


class AsyncPagedMLAEngine(PagedMLAEngine):
    """Double-buffered engine: host work for tick N+1 overlaps the
    device's execution of tick N.

    Per tick (plain decode; ``spec_k > 0`` drains the pipeline and runs
    the synchronous :meth:`PagedMLAEngine._spec_round` — accept / rewind
    is host work that depends on the values):

      1. *schedule* — while the device still runs the step dispatched
         last tick: requests whose in-flight token is structurally their
         last (``len(tokens) + 1 >= max_new``) release their slot and
         blocks at once (the token VALUE arrives in step 3); block
         growth, preemption, CoW drain and admission run as usual.  CoW
         copies, prefill chunks and the decode dispatch are queued on the
         one current stream, after the step in flight, so the device's
         order of operations is the synchronous engine's;
      2. *prefill* — admitted prompts chunk-prefill (finishing rows sample
         on the host path, which waits for the device: admission ticks
         pay this bubble, steady decode ticks do not);
      3. *host_sample* — wait on the in-flight step's event, read its (B,)
         ids from the pinned buffer (the only device-to-host transfer of
         a decode tick), emit the retrospective ``device_step`` span on
         the device track (``TID_DEVICE``), and account the tokens:
         append, stop sequences, deferred finishes, ``pending``;
      4. *dispatch* — upload the tick's inputs from pinned memory,
         run the fused decode + sample step
         (``steps.make_paged_sample_step``; its graph on a CUDA engine),
         queue the copy of its ids to the pinned buffer, record the event,
         advance ``lengths`` structurally, and return without waiting —
         unless every dispatched token is its request's last: then
         nothing can overlap it, and it is accounted in the same tick
         (the reference waits for one more tick).

    Token identity with the synchronous engine (greedy and seeded) holds
    because sampling keys fold (rid, absolute position) and each logits
    row depends only on its own request: the one-tick-late accounting
    moves WHEN slots free up, never what a request's next token is.  A
    preempted victim with an unaccounted in-flight token folds it into
    its replayed prompt first (:meth:`_fixup_preempted`), and a cancelled
    one keeps it (:meth:`_process_cancels`; the reference drops it): the
    two early waits, so replay and cancel match the synchronous engine
    exactly.
    """

    _decode_kind = "sample"

    def __init__(self, *args, **kwargs):
        if kwargs.get("mesh") is not None:
            raise _not_ported("the async engine under a mesh")
        super().__init__(*args, **kwargs)
        dec = self._inputs["decode"]
        B = dec["token"].shape[0]
        self._inputs["sample"] = dict(
            dec, rids=torch.zeros(B, dtype=torch.long, device=self.device),
            poss=torch.zeros(B, dtype=torch.long, device=self.device))
        # one pinned buffer for the ids suffices: a step is accounted
        # (its ids read) before the next one is dispatched
        self._ids_host = torch.zeros(B, dtype=torch.long,
                                     pin_memory=self.device.type == "cuda")
        self._inflight: Optional[_Inflight] = None

    @property
    def idle(self) -> bool:
        return self.sched.all_done and self._inflight is None

    # ------------------------------------------------------------- tick ----

    def step(self) -> None:
        if self.spec_k:
            # drain, then run the synchronous spec tick: double-buffering
            # applies to plain decode; spec rounds are host-interactive
            self._drain_inflight()
            return super().step()
        t0 = time.perf_counter()
        step_i = self.stats.steps
        self._process_cancels(step_i)
        was_decoding = self.sched.n_active > 0 or self._inflight is not None
        tr = self.tel.tracer

        with tr.span("step"):
            with tr.span("schedule"):
                self._release_structural_finishes()
                preempted = self.sched.ensure_step_capacity()
                self.stats.preemptions += len(preempted)
                if preempted:
                    self._fixup_preempted(preempted, step_i)
                self._drain_cow()
                admitted = self.sched.try_admit(step_i)
                # partial-hit tail copies queued by try_admit land before
                # prefill
                self._drain_cow()
            for _, req in admitted:
                self.stats.admissions += 1
                self.stats.prompt_tokens += req.plen
                if was_decoding:
                    self.stats.mid_gen_admissions += 1
            if admitted:
                with tr.span("prefill"):
                    if self.prefill_mode == "chunked":
                        self._run_chunked_prefill(admitted, step_i)
                    else:
                        self._run_per_request_prefill(admitted, step_i)
                # fork-group tail copies land before both forks' decode
                # writes
                self._drain_cow()

            self._account(step_i)

            active = self.sched.active_slots
            if active:
                self._dispatch(active)
                if all(len(r.tokens) + 1 >= r.max_new
                       for _, r in self._inflight.entries):
                    # every dispatched token is its request's last: no
                    # later tick depends on this one's slots, so account
                    # it now and finish them in this tick, as the
                    # synchronous engine does (its step count then equals
                    # the synchronous engine's)
                    self._account(step_i)

            u = self.sched.utilization()
            self.stats.util_valid_sum += u["valid_frac"]
            self.stats.util_pool_sum += u["pool_frac"]
            self.stats.util_samples += 1
        self.stats.steps += 1
        dt = time.perf_counter() - t0
        self.stats.wall += dt
        if self.tel.metrics is not None:
            m = self.tel.metrics
            m.histogram("step_ms").record(dt * 1e3)
            m.histogram("pool_occupancy").record(u["pool_frac"])
            m.histogram("pool_allocated_bytes").record(
                u["allocated_blocks"] * self.block_size
                * self.cache_token_bytes)

    # --------------------------------------------------- pipeline stages ---

    def _process_cancels(self, step_i: int) -> None:
        """Cancel the flagged requests, after settling the in-flight token
        of each that is running: the synchronous engine had already
        appended that token (or finished the request with it) when the
        cancel arrived, so the cancelled output matches its own.  A
        cancel of a running request is the one other place this engine
        waits for a step early."""
        with self._cancel_lock:
            rids, self._cancels = self._cancels, set()
        inf = self._inflight
        if rids and inf is not None:
            keep = []
            for slot, req in inf.entries:
                if req.rid not in rids or req.slot != slot \
                        or req.finish_reason:
                    keep.append((slot, req))
                    continue
                tok = int(inf.fetch()[slot])
                req.tokens.append(tok)
                self.stats.decode_tokens += 1
                self.pending[slot] = tok
                self.sched._check_stop(req)
                if req.done:
                    self.sched._finish(slot, step_i)
            inf.entries = keep
        for rid in sorted(rids):
            self.sched.cancel(rid, step_i)

    def _feed_freed(self, slot: int, tok: int) -> None:
        """Leave ``tok`` as the next input of ``slot`` if the slot is still
        free, as the synchronous engine leaves every sampled token there.
        A free slot rides along in each decode step, and at a MoE capacity
        that drops tokens its row competes with the live rows for expert
        slots: its input must be the synchronous engine's, or live tokens
        could differ.  A slot already re-admitted has its new request's
        token."""
        if self.sched.slots[slot] is None:
            self.pending[slot] = tok

    def _release_structural_finishes(self) -> None:
        """Free the slots of in-flight requests whose pending token is
        structurally their last (budget-predicted; stop hits cannot be
        predicted and are found at account time, one tick later).  Their
        blocks become admissible now, while the device works."""
        inf = self._inflight
        if inf is None:
            return
        keep = []
        for slot, req in inf.entries:
            if req.slot == slot and not req.finish_reason \
                    and len(req.tokens) + 1 >= req.max_new:
                self.sched._release_slot(slot)
                inf.deferred.append((slot, req))
            else:
                keep.append((slot, req))
        inf.entries = keep

    def _fixup_preempted(self, preempted: List[Request],
                         step_i: int) -> None:
        """Recompute preemption under an unaccounted in-flight token: the
        scheduler already folded ``tokens`` into the victim's prompt; the
        in-flight token must join that fold for the replay to match the
        synchronous engine.  The one place this engine waits for a step
        early (preemption is the overloaded-pool path)."""
        inf = self._inflight
        if inf is None:
            return
        victims = {id(r) for r in preempted}
        keep, fix = [], []
        for slot, req in inf.entries:
            (fix if id(req) in victims else keep).append((slot, req))
        inf.entries = keep
        if not fix:
            return
        toks = inf.fetch()
        for slot, req in fix:
            tok = int(toks[slot])
            self._feed_freed(slot, tok)
            req.prompt = np.concatenate(
                [req.prompt, np.asarray([tok], np.int32)])
            req.max_new -= 1
            self.stats.decode_tokens += 1
            # the folded token may complete a stop sequence: the sync
            # engine would have finished the request instead of
            # preempting it, so finish it here (it is back on the waiting
            # queue) and it never replays past its stop
            if self.sched._check_stop(req):
                self.sched.waiting.remove(req)
                req.finished_step = step_i
                req.finish_t = time.perf_counter()
                self.sched.finished.append(req)

    def _account(self, step_i: int) -> None:
        """Read and account the in-flight step's token ids (the only
        device-to-host wait of a steady decode tick)."""
        inf = self._inflight
        if inf is None:
            return
        self._inflight = None
        tr = self.tel.tracer
        drift = self.tel.drift if (self.tel.drift is not None
                                   and self.tel.drift.active) else None
        with tr.span("host_sample"):
            already = inf.fetched is not None
            toks = inf.fetch()
            if tr.enabled:
                tr.set_thread_name(PID_ENGINE, TID_DEVICE, "device stream")
                tr.complete(
                    "device_step", PID_ENGINE, TID_DEVICE,
                    inf.t_disp_tr, tr.now(),
                    args={"scheme": inf.scheme,
                          "batch": len(inf.entries) + len(inf.deferred)})
            if drift and not already:
                # dispatch to ready: the device time when the device is
                # the bottleneck, an upper bound otherwise
                b, cl = inf.point
                drift.record_decode(inf.scheme, b, cl,
                                    time.perf_counter() - inf.t_disp_perf)
            for slot, req in inf.entries:
                if req.finish_reason == "cancelled" or req.slot != slot:
                    continue
                tok = int(toks[slot])
                req.tokens.append(tok)
                self.stats.decode_tokens += 1
                self.pending[slot] = tok
                self.sched._check_stop(req)
                if req.done:
                    self.sched._finish(slot, step_i)
            for slot, req in inf.deferred:
                if req.finish_reason == "cancelled":
                    continue
                tok = int(toks[slot])
                self._feed_freed(slot, tok)
                req.tokens.append(tok)
                self.stats.decode_tokens += 1
                self.sched._check_stop(req)
                if not req.finish_reason:
                    req.finish_reason = "length"
                req.finished_step = step_i
                req.finish_t = time.perf_counter()
                self.sched.finished.append(req)

    def _dispatch(self, active: List[int]) -> None:
        """Run the fused decode + sample step for the current actives and
        return without waiting; ``lengths`` advance structurally (the step
        writes each fed token's latent at position lengths[s])."""
        scheme = self._pick_scheme()
        self.stats.schemes_used[scheme] = \
            self.stats.schemes_used.get(scheme, 0) + 1
        B = self.sched.max_batch
        rids = np.zeros((B,), np.int64)
        poss = np.zeros((B,), np.int64)
        entries = []
        for s in active:
            req = self.sched.slots[s]
            rids[s] = req.rid
            poss[s] = req.plen + len(req.tokens)
            entries.append((s, req))
        tr = self.tel.tracer
        t_tr, t_perf = tr.now(), time.perf_counter()
        ids = self._run_step("sample", scheme, dict(
            token=self.pending, block_table=self.sched.block_table,
            lengths=self.sched.lengths, rids=rids, poss=poss))
        ready = None
        if self.device.type == "cuda":
            self._ids_host.copy_(ids, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        else:
            self._ids_host.copy_(ids)
        self._inflight = _Inflight(
            tokens=self._ids_host, ready=ready, entries=entries, deferred=[],
            t_disp_tr=t_tr, t_disp_perf=t_perf, scheme=scheme,
            point=self._last_point)
        for s in active:
            self.sched.lengths[s] += 1
            if int(self.sched.lengths[s]) % self.block_size == 0:
                # a generated block just structurally completed; its
                # latent write is in flight, but any later reader is
                # queued after it on the same stream
                self.sched.register_decode_blocks(s)

    def _drain_inflight(self) -> None:
        """Account any in-flight step now."""
        self._account(self.stats.steps)
