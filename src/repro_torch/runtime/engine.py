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
``impl='ref'`` on the gathered block-table view; ``prefill_impl``
('gather' | 'kernel', or the reference's name 'pallas' for 'kernel')
overrides the chunk attention alone.  The pool is updated in place, in
the compute dtype (``cache_dtype='bf16'``) or quantized (``'int8'`` /
``'fp8'``: 1-byte codes with per-slot f32 scales, written by the chunked
prefill and the decode step, dequantized in the kernels' registers).
``prefill_mode='per_request'`` prefills each admitted request alone
through the contiguous MHA-mode prefill (``steps.make_prefill_step``) and
scatters its cache into the pool in whole blocks; it turns the prefix
cache off and refuses a quantized pool, as the reference does.

On a CUDA device the decode step (one per scheme) and the prefill chunk
run as CUDA graphs (``runtime.graphs.StepGraph``; the reference's
``jit``), captured at first use or by :meth:`PagedMLAEngine.warm_up`,
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
host_sample; the async engine's device_step on its own track,
``TID_DEVICE``), the roofline drift rows (each decode tick timed around
``device_step``, which ends in a device synchronize — dispatch to ready
in the async engine — and each admitted batch's prefill, priced on
``platform``), the step-time and pool histograms, and the prefix cache's
and scheduler's instants.  Off (the default) each site costs one
attribute check.  Speculative decoding and meshes are not ported yet:
asking for them raises ``NotImplementedError`` (ROADMAP.md).
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
from ..models.common import ModelConfig
from ..obs import OFF_TELEMETRY, Telemetry
from ..obs.trace import PID_ENGINE
from .graphs import StepGraph
from .loop import drive
from .scheduler import ContinuousScheduler, Request, blocks_for
from .steps import (make_paged_sample_step, make_prefill_step, sample_tokens,
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
                 mesh=None, spec_k: int = 0,
                 cache_dtype: str = "bf16",
                 admission: str = "cache_aware",
                 admission_age_bound: int = 64,
                 telemetry: Optional[Telemetry] = None, device="cuda",
                 cuda_graphs: Optional[bool] = None):
        if cfg.attn_kind != "mla":
            raise NotImplementedError("PagedMLAEngine requires an MLA model")
        if scheme == "auto" and platform is None:
            raise ValueError("scheme='auto' needs a PlatformPoint")
        if scheme not in ("auto",) + mlalib.SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}")
        if impl not in ("ref", "kernel"):
            raise ValueError(f"unknown impl {impl!r}; expected 'ref' | "
                             f"'kernel'")
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
        if spec_k:
            raise _not_ported("speculative decoding (spec_k > 0)")
        if mesh is not None:
            raise _not_ported("mesh serving")
        self.cfg = cfg
        self.mla = cfg.mla_config()
        self.device = torch.device(device)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, got "
                             f"{self.device}")
        self.cuda_graphs = bool(cuda_graphs)
        # 'ru' streams the precomputed absorbed weights; attach them once
        # so every scheme sees the same param tree.  A fixed non-ru scheme
        # never reads them — skip the compute and memory.
        self.params = mlalib.attach_absorbed_tree(params, self.mla) \
            if scheme in ("auto", "ru") else params
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
            admission=admission,
            admission_age_bound=admission_age_bound)
        self.pool = models.init_paged_cache(cfg, num_blocks, block_size,
                                            compute_dtype, self.device,
                                            cache_dtype)
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
                                paged_block=block_size,
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
        table, lengths, n_valid)."""
        B, nb, C = self.sched.max_batch, self.sched.max_blocks, \
            self.prefill_chunk

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return {"decode": dict(token=z(B, dtype=torch.long),
                               block_table=z(B, nb), lengths=z(B)),
                "chunk": dict(tokens=z(B, C, dtype=torch.long),
                              block_table=z(B, nb), lengths=z(B),
                              n_valid=z(B))}

    def _chunk_impl(self) -> str:
        """Chunk-attention impl: ``prefill_impl`` when set, else
        ``impl``."""
        return {"gather": "ref", "kernel": "kernel",
                None: self.impl}[self.prefill_impl]

    def _step_fn(self, kind: str, scheme: str):
        """The device step of ``kind`` under ``scheme``, as a function of
        its input buffers.  It holds the params and the pool, not the
        engine, so a graph of it dies with the engine."""
        params, cfg, pool = self.params, self.cfg, self.pool
        kw = dict(compute_dtype=self.compute_dtype, scheme=scheme)
        if kind == "chunk":
            chunk_impl = self._chunk_impl()

            def chunk(tokens, block_table, lengths, n_valid):
                logits, _ = models.prefill_chunk_paged(
                    params, cfg, tokens, pool, block_table, lengths,
                    n_valid, impl=chunk_impl, **kw)
                return logits
            return chunk
        impl = self.impl
        if kind == "decode":
            def decode(token, block_table, lengths):
                logits, _ = models.decode_step(params, cfg, token, pool,
                                               block_table, lengths,
                                               impl=impl, **kw)
                return logits
            return decode
        step = make_paged_sample_step(
            cfg, impl=impl, temperature=self.temperature,
            top_k=self.top_k, sample_seed=self._sample_seed, **kw)

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
        inputs = self._inputs[kind]
        for t in inputs.values():
            t.zero_()
        params, pool = self.params, self.pool
        g = StepGraph(self._step_fn(kind, scheme), inputs,
                      held=lambda: [*cachelib.pool_leaves(pool),
                                    *cachelib.pool_leaves(params)],
                      counters=PAGED_KERNELS, name=f"{kind}/{scheme}")
        g.capture()
        self.stats.capture_s += g.capture_s
        self._graphs[(kind, scheme)] = g
        return g

    def _run_step(self, kind: str, scheme: str,
                  arrays: Dict[str, np.ndarray]):
        """Upload ``arrays`` into ``kind``'s input buffers and run the
        step: its graph's replay on a CUDA engine with graphs, the eager
        step otherwise.  Returns the step's output (a graph's is valid
        until its next replay)."""
        if self.cuda_graphs:
            g = self._graph(kind, scheme)
            self._upload(self._inputs[kind], arrays)
            return g.replay()
        self._upload(self._inputs[kind], arrays)
        return self._step_fn(kind, scheme)(**self._inputs[kind])

    def warm_up(self) -> float:
        """Capture the graphs a serve will replay — the decode step of
        every scheme the engine may dispatch, and the prefill chunk —
        before the first request, so no tick pays for a capture.  Returns the seconds it took (also
        in ``EngineStats.capture_s``); a no-op without graphs."""
        if not self.cuda_graphs:
            return 0.0
        t0 = self.stats.capture_s
        schemes = ("seq", "rc", "ru") if self.scheme == "auto" \
            else (self.scheme,)
        for scheme in schemes:
            self._graph(self._decode_kind, scheme)
        if self.prefill_mode == "chunked":
            self._graph("chunk", self._chunk_scheme())
        return self.stats.capture_s - t0

    def graph_plans(self) -> Dict[str, Dict[str, dict]]:
        """The kernel plans each captured graph recorded at capture,
        by graph name."""
        return {g.name: dict(g.plans) for g in self._graphs.values()}

    def close(self) -> None:
        """Drop the captured graphs (their memory pools go with them)."""
        self._graphs.clear()

    def _pick_scheme(self) -> str:
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
                          paged_block=self.block_size,
                          cache_dtype=self.cache_dtype)
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
        by exactly the generated tokens)."""
        rids = poss = None
        if self.temperature > 0.0:
            reqs = [self.sched.slots[s] for s in slots]
            rids = self._dev(np.asarray([r.rid for r in reqs], np.int64))
            poss = self._dev(np.asarray([r.plen + len(r.tokens)
                                         for r in reqs], np.int64))
        toks = sample_tokens(rows, rids, poss, temperature=self.temperature,
                             top_k=self.top_k,
                             sample_seed=self._sample_seed).cpu().numpy()
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
                logits = self._run_step(
                    "chunk", self._chunk_scheme(),
                    dict(tokens=tokens, block_table=self.sched.block_table,
                         lengths=lens, n_valid=nv))
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
        if len(pairs) == 1 or (set(srcs) & set(dsts)):
            for src, dst in pairs:
                cachelib.copy_block_paged(self.pool, src, dst)
            return
        cachelib.copy_blocks_paged(self.pool,
                                   self._dev(np.asarray(srcs, np.int64)),
                                   self._dev(np.asarray(dsts, np.int64)))

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
            if active:
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

    Per tick:

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
