"""Continuous-batching MLA serving engine over the paged latent pool (port
of the synchronous ``repro.runtime.engine.PagedMLAEngine``).

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
``impl='ref'`` on the gathered block-table view.  The pool is updated in
place, in the compute dtype (``cache_dtype='bf16'``) or quantized
(``'int8'`` / ``'fp8'``: 1-byte codes with per-slot f32 scales, written
by the chunked prefill and the decode step, dequantized in the kernels'
registers).  ``prefill_mode='per_request'`` prefills each admitted
request alone through the contiguous MHA-mode prefill
(``steps.make_prefill_step``) and scatters its cache into the pool in
whole blocks; it turns the prefix cache off and refuses a quantized pool,
as the reference does.

``telemetry=`` (``obs.Telemetry``) arms the reference's hooks: the
per-step spans (step / schedule / prefill / prefill_chunk / device_step /
host_sample), the roofline drift rows (each decode tick timed around
``device_step``, which ends in a device synchronize, and each admitted
batch's prefill, priced on ``platform``), the step-time and pool
histograms, and the prefix cache's and scheduler's instants.  Off (the
default) each site costs one attribute check.  Speculative decoding,
the async engine and meshes are not ported yet: asking for them raises
``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import models
from ..core import cache as cachelib
from ..core import mla as mlalib
from ..core.schemes import PlatformPoint, auto_dispatch
from ..models.common import ModelConfig
from ..obs import OFF_TELEMETRY, Telemetry
from .loop import drive
from .scheduler import ContinuousScheduler, Request, blocks_for
from .steps import make_prefill_step, sample_tokens, scatter_prefill_to_paged


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
        }


class PagedMLAEngine:
    def __init__(self, cfg: ModelConfig, params, *, num_blocks: int,
                 block_size: int, max_batch: int,
                 max_blocks_per_req: Optional[int] = None,
                 compute_dtype=torch.float32, impl: str = "ref",
                 scheme: str = "auto",
                 platform: Optional[PlatformPoint] = None,
                 enable_prefix_cache: bool = True,
                 prefill_chunk: int = 32,
                 prefill_mode: str = "chunked",
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0,
                 mesh=None, spec_k: int = 0,
                 cache_dtype: str = "bf16",
                 admission: str = "cache_aware",
                 admission_age_bound: int = 64,
                 telemetry: Optional[Telemetry] = None, device="cuda"):
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

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

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
                logits, self.pool = models.prefill_chunk_paged(
                    self.params, self.cfg, self._dev(tokens).long(),
                    self.pool, self._dev(self.sched.block_table),
                    self._dev(lens), self._dev(nv),
                    compute_dtype=self.compute_dtype, impl=self.impl,
                    scheme=self._chunk_scheme())
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
                impl = "pallas" if self.impl == "kernel" else "gather"
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
        'inherit'.  The reference's rule: its async engine bakes them into
        the compiled step."""
        if sp is None:
            return
        if sp.temperature is not None \
                and float(sp.temperature) != self.temperature:
            raise ValueError(
                f"temperature={sp.temperature} != engine temperature "
                f"{self.temperature}; set it engine-wide or leave None to "
                f"inherit")
        if sp.top_k is not None and int(sp.top_k) != self.top_k:
            raise ValueError(f"top_k={sp.top_k} != engine top_k "
                             f"{self.top_k}; set it engine-wide or leave "
                             f"None")
        if sp.seed is not None and int(sp.seed) != self._sample_seed:
            raise ValueError(f"seed={sp.seed} != engine sample_seed "
                             f"{self._sample_seed}; set it engine-wide or "
                             f"leave None")

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
                    logits, self.pool = models.decode_step(
                        self.params, self.cfg,
                        self._dev(self.pending).long(), self.pool,
                        self._dev(self.sched.block_table),
                        self._dev(self.sched.lengths),
                        compute_dtype=self.compute_dtype, impl=self.impl,
                        scheme=scheme)
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
        return out
