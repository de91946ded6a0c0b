"""Host-side continuous-batching scheduler over the paged latent-KV pool.

Copied from ``repro.runtime.scheduler`` (numpy only): the port keeps its
own copy so it never imports the JAX package.

The device side (core.cache paged layout, kernels.mla_decode paged kernel)
is pure and shape-static; everything ragged and dynamic lives here, in
numpy, between device steps:

  * ``BlockAllocator`` — a REF-COUNTED free list over the global block
    pool.  Block 0 is the reserved NULL block: unassigned block-table
    entries point at it so every block-table-driven gather/DMA stays
    in-bounds.  ``fork`` (refcount += 1) and ``release`` (refcount -= 1)
    replace raw ``free`` throughout the scheduler — prefix-shared blocks
    are mapped by several requests at once (runtime.prefix_cache).
  * ``ContinuousScheduler`` — fixed ``max_batch`` decode slots.  Requests
    are admitted into free slots whenever the pool can cover their
    prompt (+1 for the first generated token); ``try_admit`` first matches
    the longest cached prefix in the radix ``PrefixCache`` — token-
    granular: a hit may end mid-block, materialized by a queued
    copy-on-write of the partial source block — and maps the request's
    leading block-table entries onto the shared pool blocks, so only the
    un-cached suffix needs prefilling (``Request.n_cached``).  Admission
    order is ``admission='fcfs'`` (strict) or ``'cache_aware'``
    (longest-cached-prefix first with an ``admission_age_bound``
    starvation bound).  Each decode step lazily allocates one more block
    for any request crossing a block boundary — and registers the block
    just completed in the trie (``decode_block_reuse``), so a follow-up
    conversation turn re-hits its own generation; finished requests
    release their blocks — trie-registered ones stay resident as
    LRU-evictable prefix cache, the rest return to the free list
    immediately.
  * n-way PARALLEL SAMPLING (``SamplingParams.n > 1``): the prompt
    prefills once, then ``fork_group`` maps every pre-admitted fork
    child onto the parent's full prompt blocks (``BlockAllocator.fork``)
    with a copy-on-write tail, and each fork decodes as an ordinary
    independent request (own stop/cancel/preemption, consecutive rids,
    own sampling-key stream).
  * Out-of-blocks mid-decode first evicts LRU refcount-zero cached
    blocks, then preempts the youngest running request (recompute-style:
    its prompt + generated tokens re-enter the waiting queue as a longer
    prompt — whose prefix usually re-hits the cache), so the oldest
    requests always make progress.

The scheduler is deliberately model-agnostic: it hands out numpy block
tables / lengths / copy-on-write block pairs; ``runtime.engine`` owns
params, device steps, the chunked prefill -> pool scatter, and the device
side of every CoW copy (``cow_pending``).

A decode tick writes ``decode_window`` cache positions per request: 1
for plain decode, ``spec_k + 1`` under speculative decoding (the verify
step writes the fed token and up to k drafts), clipped to the request's
remaining budget; admission and block growth reserve that window, and
``advance_multi`` accounts a round's accepted tokens.  ``partial_match=
False`` matches whole blocks only and ``decode_block_reuse=False``
registers no decode-completed block: with ``admission='fcfs'`` the
two give the cold-cache baseline the serving benchmark compares the
defaults with.  With telemetry on, ``fork_group`` puts a ``fork_group``
instant on the trace (through ``prefix.tel``, as in the reference).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import warnings
from time import perf_counter
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from .prefix_cache import PrefixCache
from .sampling import SamplingParams

NULL_BLOCK = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (plen,) int32
    # generation budget — the scheduler's MUTABLE working copy
    # (preemption shrinks it as output folds into the prompt).  None
    # defers to ``sampling.max_tokens``; passing it directly is the
    # legacy pre-SamplingParams constructor, kept via a deprecation shim.
    max_new: Optional[int] = None
    arrival: int = 0              # loop step at which it becomes visible
    tokens: List[int] = dataclasses.field(default_factory=list)
    # per-request termination: generation also stops when the
    # output's suffix matches any of these token-id sequences ("stop"),
    # or when the frontend cancels the request mid-flight ("cancelled").
    # The matched stop tokens are excluded from ``output`` (n_trunc hides
    # them — they may span a preemption fold, so the prompt isn't edited).
    stop: List[List[int]] = dataclasses.field(default_factory=list)
    finish_reason: str = ""       # "" while running; length|stop|cancelled
    n_trunc: int = 0              # trailing output tokens hidden by a stop
    slot: int = -1
    admitted_step: int = -1
    finished_step: int = -1
    n_preempted: int = 0
    orig_plen: int = -1           # preemption folds output into the prompt
    n_cached: int = 0             # prompt tokens served by the prefix cache
    # lifecycle wall clock (perf_counter seconds, -1 = not reached):
    # stamped by the scheduler at each transition so telemetry can build
    # queued/prefill/decode spans and TTFT/TPOT retrospectively.  admit_t
    # and first_tok_t keep their FIRST value across preemptions (TTFT is
    # time to the first token the user ever saw); preempt_ts logs each
    # preemption instant.
    submit_t: float = -1.0
    admit_t: float = -1.0
    first_tok_t: float = -1.0
    finish_t: float = -1.0
    preempt_ts: List[float] = dataclasses.field(default_factory=list)
    # -- request API: consolidated per-request knobs.  max_new /
    # stop above remain the scheduler's mutable working copies,
    # initialized from here.
    sampling: Optional[SamplingParams] = None
    # n-way parallel sampling: ``sampling.n - 1`` fork children ride on
    # the parent through the queue (rids rid+1 .. rid+n-1, sampling
    # n=1); ``fork_group`` maps them onto the parent's prompt blocks
    # right after its prefill, after which each is an ordinary
    # independent request.  ``forked`` stays True across preemption so a
    # replayed parent never re-forks.
    fork_children: List["Request"] = dataclasses.field(default_factory=list)
    forked: bool = False
    n_skipped: int = 0            # times bypassed by cache-aware admission

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.sampling is None:
            if self.max_new is None:
                raise ValueError(
                    "Request needs sampling=SamplingParams(...) (or the "
                    "legacy max_new=)")
            warnings.warn(
                "Request(prompt, max_new, stop=...) is deprecated; pass "
                "sampling=SamplingParams(max_tokens=..., stop=..., ...)",
                DeprecationWarning, stacklevel=3)
            self.sampling = SamplingParams.from_legacy(self.max_new,
                                                       self.stop)
        else:
            self.sampling = self.sampling.validate()
            if self.max_new is None:
                self.max_new = self.sampling.max_tokens
            if not self.stop:
                self.stop = [list(s) for s in self.sampling.stop]
        if self.orig_plen < 0:
            self.orig_plen = self.plen

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def output(self) -> List[int]:
        """All generated tokens, including any folded into the prompt by a
        preemption, minus any trailing matched stop sequence."""
        out = list(self.prompt[self.orig_plen:]) + list(self.tokens)
        return out[:len(out) - self.n_trunc] if self.n_trunc else out

    @property
    def done(self) -> bool:
        return bool(self.finish_reason) or len(self.tokens) >= self.max_new


class BlockAllocator:
    """Ref-counted free-list allocator over ``num_blocks`` fixed-size
    blocks; block 0 (NULL) is never handed out.

    ``alloc`` hands out blocks at refcount 1; ``fork`` adds a reference
    (prefix sharing); ``release`` drops one and REPORTS blocks reaching
    zero without freeing them — the caller (PrefixCache) decides whether
    a zero block stays cached (LRU-evictable) or is ``free``d."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)    # O(1) double-free detection
        self.refcount: Dict[int, int] = {}  # allocated block -> references
        self.total_allocs = 0               # cumulative blocks handed out

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def _check_id(self, b: int) -> None:
        if not (0 < b < self.num_blocks):
            raise ValueError(f"bad block id {b}")

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks at refcount 1, or None (and no change) if the
        pool is short."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(got)
        for b in got:
            self.refcount[b] = 1
        self.total_allocs += n
        return got

    def fork(self, blocks: List[int]) -> None:
        """Add one reference per block (prefix-cache hit).  Reviving a
        cached refcount-0 block is legal; forking a free block is not."""
        for b in blocks:
            self._check_id(b)
            if b in self._free_set or b not in self.refcount:
                raise ValueError(f"fork of unallocated block {b}")
            self.refcount[b] += 1

    def release(self, blocks: List[int]) -> List[int]:
        """Drop one reference per block; returns the blocks that reached
        refcount 0 (still allocated — route them to ``free`` or keep them
        cached)."""
        zeroed = []
        for b in blocks:
            self._check_id(b)
            rc = self.refcount.get(b)
            if rc is None or b in self._free_set:
                raise ValueError(f"release of unallocated block {b}")
            if rc <= 0:
                raise ValueError(f"release of refcount-0 block {b}")
            self.refcount[b] = rc - 1
            if rc == 1:
                zeroed.append(b)
        return zeroed

    def free(self, blocks: List[int]) -> None:
        """Return blocks to the free list.  Only unshared blocks
        (refcount <= 1) may be freed; shared blocks must be ``release``d
        by each holder."""
        for b in blocks:
            self._check_id(b)
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            if self.refcount.get(b, 0) > 1:
                raise ValueError(f"free of shared block {b} "
                                 f"(refcount {self.refcount[b]})")
            self.refcount.pop(b, None)
            self._free.append(b)
            self._free_set.add(b)


def blocks_for(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


class ContinuousScheduler:
    """Slots, block tables and lengths of the running requests, their
    queue, and the radix prefix cache over the pool (module docstring).

    ``decode_window`` is the number of cache positions one decode tick
    may WRITE per request: 1 for plain decode, ``spec_k + 1`` for
    speculative decoding.  Admission and per-step block growth reserve
    the window (clipped to each request's remaining budget), so a verify
    write never runs past the block table (:meth:`_require_table_room`)."""

    def __init__(self, *, num_blocks: int, block_size: int, max_batch: int,
                 max_blocks_per_req: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 decode_window: int = 1,
                 admission: str = "fcfs",
                 admission_age_bound: int = 64,
                 decode_block_reuse: bool = True,
                 partial_match: bool = True):
        if decode_window < 1:
            raise ValueError(f"decode_window must be >= 1, {decode_window}")
        if admission not in ("fcfs", "cache_aware"):
            raise ValueError(f"unknown admission policy {admission!r} "
                             "(expected 'fcfs' or 'cache_aware')")
        if admission_age_bound < 1:
            raise ValueError("admission_age_bound must be >= 1")
        self.allocator = BlockAllocator(num_blocks)
        self.block_size = block_size
        self.decode_window = decode_window
        self.admission = admission
        self.admission_age_bound = admission_age_bound
        self.decode_block_reuse = decode_block_reuse
        self.prefix = PrefixCache(self.allocator, block_size,
                                  enabled=enable_prefix_cache,
                                  partial=partial_match)
        self.max_batch = max_batch
        self.max_blocks = max_blocks_per_req or (num_blocks - 1)
        self.block_table = np.full((max_batch, self.max_blocks), NULL_BLOCK,
                                   np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.blocks_of: Dict[int, List[int]] = {}
        self.waiting: Deque[Request] = collections.deque()
        self.finished: List[Request] = []
        self._admit_order: List[int] = []   # slots, oldest admission first
        # (src, dst) device copies the engine must run before the next
        # pool write (copy-on-write breaks of shared write targets,
        # partial-match tails, fork-group tails)
        self.cow_pending: List[Tuple[int, int]] = []
        self.fork_groups = 0        # parallel-sampling groups forked
        self.forked_children = 0    # fork children spawned across groups

    # ------------------------------------------------------------ queue ---

    def submit(self, req: Request) -> None:
        if req.submit_t < 0:
            req.submit_t = perf_counter()
        if req.sampling.n > 1 and not req.forked and not req.fork_children:
            # materialize the fork children now so cancellation and group
            # accounting have real Request objects; they ride on the
            # parent (NOT the queue) until fork_group seats them.  The
            # caller owns rid uniqueness for [rid, rid + n).
            one = dataclasses.replace(req.sampling, n=1)
            for i in range(1, req.sampling.n):
                child = Request(rid=req.rid + i, prompt=req.prompt,
                                arrival=req.arrival, sampling=one)
                child.submit_t = req.submit_t
                req.fork_children.append(child)
        self.waiting.append(req)

    @property
    def active_slots(self) -> List[int]:
        return [s for s in range(self.max_batch) if self.slots[s] is not None]

    @property
    def n_active(self) -> int:
        return len(self.active_slots)

    @property
    def all_done(self) -> bool:
        return not self.waiting and not self.active_slots

    # -------------------------------------------------------- admission ---

    def _pick_waiting(self) -> Request:
        """The waiting request admission should try next.  'fcfs': the
        queue head.  'cache_aware': the request with the longest
        currently-cached prefix (probed with ``PrefixCache.lookup_len`` —
        no forks, no stats), arrival order breaking ties — warm
        conversation turns jump cold prompts, multiplying the hit rate
        the decode-block registrations create.  Starvation bound: any
        request already bypassed ``admission_age_bound`` times is served
        first regardless of its cache affinity."""
        if self.admission == "fcfs" or len(self.waiting) <= 1:
            return self.waiting[0]
        for req in self.waiting:
            if req.n_skipped >= self.admission_age_bound:
                return req
        best, best_len = None, -1
        for req in self.waiting:
            n = self.prefix.lookup_len(req.prompt)
            if n > best_len:
                best, best_len = req, n
        return best

    def _dequeue(self, req: Request) -> None:
        """Remove ``req`` from the waiting queue; under cache-aware
        admission every request it jumped over ages by one (the
        starvation counter ``_pick_waiting`` honors)."""
        idx = self.waiting.index(req)
        self.waiting.remove(req)
        for jumped in itertools.islice(self.waiting, idx):
            jumped.n_skipped += 1

    def try_admit(self, step: int = 0) -> List[Tuple[int, Request]]:
        """Admission into free slots (``admission`` picks the order; see
        ``_pick_waiting``).  The radix cache is consulted first: the
        longest cached prefix is ``fork``ed onto the request's leading
        block-table entries (``req.n_cached`` tokens need no prefill);
        fresh blocks cover the rest of the prompt plus the first
        generated token.  A token-granular match ending MID-BLOCK is
        materialized copy-on-write: the first fresh block becomes a
        private copy of the cached partial source via a queued device
        copy the engine runs before prefill.

        An n-way parallel-sampling parent admits as a GROUP, atomically:
        one slot per fork plus each fork's private tail blocks are
        reserved now, so ``fork_group`` (which runs later the same tick,
        right after the parent's prefill) can never fail mid-flight.

        If the pool cannot cover the picked request even after LRU
        eviction, admission stops.  Returns [(slot, request)] admitted
        now — parents only, fork children never prefill; the engine
        prefills the un-cached suffixes as a batch and then calls
        ``commit_prefill`` (+ ``fork_group``) per request."""
        admitted = []
        free = collections.deque(
            s for s in range(self.max_batch) if self.slots[s] is None)
        while self.waiting and free:
            req = self._pick_waiting()
            group = [] if req.forked else req.fork_children
            if 1 + len(group) > len(free):
                break
            need = blocks_for(req.plen + self._window(req), self.block_size)
            n_shared_full = req.plen // self.block_size
            child_needs = [blocks_for(c.plen + self._window(c),
                                      self.block_size) - n_shared_full
                           for c in group]
            if need > self.max_blocks:
                raise ValueError(
                    f"request {req.rid}: prompt {req.plen} needs {need} "
                    f"blocks > max_blocks_per_req {self.max_blocks}")
            if need + sum(child_needs) > self.allocator.num_blocks - 1:
                # can NEVER fit, even with an empty pool — fail fast
                # instead of refusing admission forever
                raise ValueError(
                    f"request {req.rid}: prompt {req.plen} (x{1 + len(group)}"
                    f" parallel samples) needs {need + sum(child_needs)} "
                    f"blocks > pool size {self.allocator.num_blocks - 1}")
            shared = self.prefix.match(req.prompt)
            fresh = self.prefix.alloc(need - len(shared))
            if fresh is None:               # out of blocks: admission refused
                self.prefix.cancel_match(req.prompt, shared)
                break
            reserved: List[List[int]] = []
            for cn in child_needs:
                got = self.prefix.alloc(cn)
                if got is None:
                    break
                reserved.append(got)
            if len(reserved) < len(group):  # group doesn't fit atomically
                for got in reserved:
                    self.prefix.release(got)
                self.prefix.release(fresh)
                self.prefix.cancel_match(req.prompt, shared)
                break
            self._dequeue(req)
            slot = free.popleft()
            blocks = list(shared) + fresh
            req.slot, req.admitted_step = slot, step
            if req.admit_t < 0:
                req.admit_t = perf_counter()
            req.n_cached = shared.n_tokens(self.block_size)
            self.slots[slot] = req
            self.blocks_of[slot] = blocks
            self.block_table[slot] = NULL_BLOCK
            self.block_table[slot, :need] = blocks
            self.lengths[slot] = req.plen
            self._admit_order.append(slot)
            if shared.partial_len:
                # Materialize the mid-block tail: fresh[0] (block index
                # len(shared), where the partial tokens live) becomes a
                # private copy of the cached source.  Releasing the
                # source fork immediately is safe: the engine drains
                # cow_pending between admission and prefill, so the copy
                # is enqueued ahead of every later pool write in stream
                # order — even if eviction recycles the source block
                # this very tick, its latents are still intact when the
                # copy executes.
                self.cow_pending.append((shared.partial_src, fresh[0]))
                self.prefix.count_cow()
                self.prefix.release([shared.partial_src])
            for child, got in zip(group, reserved):
                # seat the fork child now (slot + private tail blocks);
                # its shared prompt mapping and lengths arrive at
                # fork_group, after the parent's prefill this tick.
                cslot = free.popleft()
                child.slot, child.admitted_step = cslot, step
                if child.admit_t < 0:
                    child.admit_t = perf_counter()
                self.slots[cslot] = child
                self.blocks_of[cslot] = list(got)
                self.block_table[cslot] = NULL_BLOCK
                for i, b in enumerate(got):
                    self.block_table[cslot, n_shared_full + i] = b
                self.lengths[cslot] = 0
                self._admit_order.append(cslot)
            admitted.append((slot, req))
        return admitted

    def fork_group(self, slot: int) -> List[Tuple[int, Request]]:
        """Fork the just-prefilled parent in ``slot`` n ways (parallel
        sampling): each pre-admitted fork child maps the parent's FULL
        prompt blocks read-only (``BlockAllocator.fork``, refcount += 1)
        ahead of the private tail blocks reserved at admission; a
        mid-block prompt tail is materialized by queueing a parent-tail
        -> child-tail device copy on ``cow_pending`` (the engine drains
        it before the next decode dispatch, so the copy is ordered ahead
        of both forks' future writes).  Called by the engine right after
        ``commit_prefill``; the parent's last-position logits then seed
        every child's first token, each sampled on its own
        fold(child rid, position) key stream.  Idempotent across
        preemption replay (``forked``).  Returns [(child_slot, child)].
        """
        parent = self.slots[slot]
        if parent is None or parent.forked or not parent.fork_children:
            return []
        parent.forked = True
        n_full = parent.plen // self.block_size
        shared = self.blocks_of[slot][:n_full]
        tail = parent.plen % self.block_size
        out = []
        for child in parent.fork_children:
            cslot = child.slot
            self.allocator.fork(shared)
            self.blocks_of[cslot] = list(shared) + self.blocks_of[cslot]
            self.block_table[cslot, :n_full] = shared
            self.lengths[cslot] = parent.plen
            child.n_cached = parent.plen    # served by the fork, not prefill
            if tail:
                self.cow_pending.append((self.blocks_of[slot][n_full],
                                         self.blocks_of[cslot][n_full]))
                self.prefix.count_cow()
            out.append((cslot, child))
        self.fork_groups += 1
        self.forked_children += len(out)
        tel = self.prefix.tel
        if tel is not None:
            tel.tracer.instant("fork_group", args={"rid": parent.rid,
                                                   "n": 1 + len(out)})
        return out

    def commit_prefill(self, slot: int) -> int:
        """Register the request's full prompt blocks in the radix cache.
        MUST be called only after the engine's prefill has scattered the
        corresponding latents into the pool — matches hand out pool
        contents, not promises.  Returns the number of blocks newly
        registered."""
        req = self.slots[slot]
        n_full = req.plen // self.block_size
        return self.prefix.insert(req.prompt, self.blocks_of[slot][:n_full])

    def register_decode_blocks(self, slot: int) -> int:
        """Register the slot's completed blocks — prompt AND generated
        tokens — in the radix trie, so a later request whose prompt
        embeds this generation (the follow-up turn of a conversation,
        an agent replaying a transcript) re-hits it instead of
        re-prefilling.  Called as ``lengths`` crosses each block
        boundary; idempotent — trie paths already present are only
        LRU-refreshed, and a block registered once is never offered
        again (``PrefixCache.insert``).  Safe against speculative
        rewind: only blocks fully below ``lengths`` are offered, and
        ``lengths`` advances over ACCEPTED tokens only, so rejected-draft
        latents always sit past the registered range."""
        if not self.decode_block_reuse or not self.prefix.enabled:
            return 0
        req = self.slots[slot]
        n_full = int(self.lengths[slot]) // self.block_size
        if n_full <= req.plen // self.block_size:
            return 0    # nothing decode-filled completes a new block yet
        seq = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        return self.prefix.insert(seq[:n_full * self.block_size],
                                  self.blocks_of[slot][:n_full], decode=True)

    # ----------------------------------------------------- decode cycle ---

    def _window(self, req: Request) -> int:
        """Write window of the next decode tick for ``req``: the verify
        window clipped to the remaining generation budget (a request about
        to finish never writes — or needs blocks for — the full k + 1)."""
        return max(1, min(self.decode_window,
                          req.max_new - len(req.tokens)))

    def _require_table_room(self, slot: int, n_tokens: int) -> None:
        """Raise if ``n_tokens`` total tokens would overflow slot's block
        table.  ``core.cache.update_latent_paged`` cannot detect this —
        JAX clamps the out-of-range page index onto the request's LAST
        block and silently overwrites it — so the host must refuse first."""
        if blocks_for(n_tokens, self.block_size) > self.max_blocks:
            req = self.slots[slot]
            raise RuntimeError(
                f"block table full: request {req.rid if req else '?'} in "
                f"slot {slot} needs {n_tokens} token slots but the table "
                f"caps at {self.max_blocks} blocks x {self.block_size} = "
                f"{self.max_blocks * self.block_size} tokens; a device "
                f"write would clamp onto the last block and silently "
                f"overwrite it (raise max_blocks_per_req or max_new)")

    def ensure_step_capacity(self) -> List[Request]:
        """Grow each active request's allocation so the next decode tick's
        write window (positions lengths[slot] .. lengths[slot] + window - 1;
        window = ``decode_window`` budget-clipped) has blocks.  Oldest
        admissions grow first; on pool exhaustion the cache is
        LRU-evicted, then the YOUNGEST running request is preempted
        (recompute-style) so the oldest always make progress.  If a
        write-target block turns out shared (prefix-forked or
        trie-registered), the share is broken copy-on-write: a private
        block is allocated and the (src, dst) device copy is queued on
        ``cow_pending`` for the engine.  Returns the preempted requests."""
        preempted: List[Request] = []
        for slot in list(self._admit_order):          # oldest first
            if self.slots[slot] is None:              # already preempted
                continue
            window = self._window(self.slots[slot])
            self._require_table_room(slot, int(self.lengths[slot]) + window)
            need = blocks_for(int(self.lengths[slot]) + window,
                              self.block_size)
            while need > len(self.blocks_of[slot]):
                got = self.prefix.alloc(1)
                if got is None:
                    if self.n_active <= 1:
                        raise RuntimeError(
                            "pool exhausted with a single running request; "
                            "increase num_blocks or max cache length")
                    victim, vslot = self._preempt_youngest()
                    preempted.append(victim)
                    if vslot == slot:     # preempted ourselves: stop growing
                        break
                    continue
                self.blocks_of[slot].extend(got)
                self.block_table[slot, len(self.blocks_of[slot]) - 1] = got[0]
            if self.slots[slot] is not None:
                self._cow_write_target(slot, window)
        return preempted

    def _cow_write_target(self, slot: int, window: int = 1) -> None:
        """Copy-on-write: if any block about to receive one of this slot's
        next ``window`` tokens is shared, swap in a private copy.
        Structurally this does not arise from prefix sharing, fork
        groups or decode-block registration alone (shared / registered
        blocks are always FULL — writes land strictly past them), but a
        preempted request replaying through a partial cache hit, or an
        external fork, can put a shared block under the write cursor."""
        lo = int(self.lengths[slot]) // self.block_size
        hi = (int(self.lengths[slot]) + window - 1) // self.block_size
        for widx in range(lo, min(hi, len(self.blocks_of[slot]) - 1) + 1):
            old = self.blocks_of[slot][widx]
            if not self.prefix.is_write_shared(old):
                continue
            got = self.prefix.alloc(1)
            if got is None:
                raise RuntimeError(
                    f"pool exhausted breaking a copy-on-write share of "
                    f"block {old} (slot {slot}); increase num_blocks")
            self.blocks_of[slot][widx] = got[0]
            self.block_table[slot, widx] = got[0]
            self.prefix.release([old])
            self.prefix.count_cow()
            self.cow_pending.append((old, got[0]))

    def drain_cow(self) -> List[Tuple[int, int]]:
        """Hand the queued (src, dst) copy-on-write block copies to the
        engine (which owns the device pool) and clear the queue."""
        out, self.cow_pending = self.cow_pending, []
        return out

    def _preempt_youngest(self) -> Tuple[Request, int]:
        slot = self._admit_order[-1]
        req = self.slots[slot]
        # recompute-style: prompt + generated so far re-enter the queue as
        # a longer prompt (per-position-keyed sampling makes the replay
        # identical — see engine._sample)
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        req.max_new -= len(req.tokens)
        req.tokens = []
        req.n_preempted += 1
        req.preempt_ts.append(perf_counter())
        self._release_slot(slot)
        self.waiting.appendleft(req)
        return req, slot

    def record_prefill_sample(self, slot: int, tok: int,
                              step: int = 0) -> Optional[Request]:
        """Account the token sampled from the PREFILL logits (generated
        token #1 — sampled but not yet written to the cache).  Returns the
        request if that already finishes it (max_new == 1, or a
        single-token stop sequence)."""
        req = self.slots[slot]
        req.tokens.append(int(tok))
        if req.first_tok_t < 0:
            req.first_tok_t = perf_counter()
        self._check_stop(req)
        if req.done:
            return self._finish(slot, step)
        return None

    def advance(self, sampled: Dict[int, int], step: int = 0) -> List[Request]:
        """Account one decode step: ``sampled[slot]`` is the token the step
        just produced for that slot; the token fed INTO the step is now in
        the cache (lengths += 1).  Finished requests are evicted and their
        blocks released (trie-registered ones stay LRU-evictable).
        Returns the requests finished this step."""
        return self.advance_multi({s: [t] for s, t in sampled.items()}, step)

    def advance_multi(self, emitted: Dict[int, List[int]],
                      step: int = 0) -> List[Request]:
        """Account one SPECULATIVE round: ``emitted[slot]`` is the ordered
        list of tokens the verify step produced for that slot (accepted
        drafts + one bonus/correction token, at most the slot's write
        window).  The cache gained the fed token plus every accepted draft
        — lengths += len(emitted); the LAST emitted token is the new
        pending token (not yet written; rejected drafts' latents sit past
        ``lengths`` and are overwritten before they can ever be attended).
        Len-1 lists are plain :meth:`advance`.  Returns the requests
        finished this round."""
        done: List[Request] = []
        for slot, toks in emitted.items():
            req = self.slots[slot]
            if req is None or not toks:
                continue
            if len(toks) > self._window(req):
                raise ValueError(
                    f"slot {slot}: {len(toks)} emitted tokens exceed the "
                    f"write window {self._window(req)}")
            # token-at-a-time so a stop hit is token-exact: tokens after
            # the match (later accepted drafts in a spec round) are
            # discarded, never accounted.
            for t in toks:
                self.lengths[slot] += 1
                req.tokens.append(int(t))
                if int(self.lengths[slot]) % self.block_size == 0:
                    # a block of generated latents just completed — make
                    # it matchable (multi-turn decode-block reuse)
                    self.register_decode_blocks(slot)
                if self._check_stop(req) or req.done:
                    break
            if req.done:
                done.append(self._finish(slot, step))
        return done

    def _check_stop(self, req: Request) -> bool:
        """True if the output's suffix now matches one of the request's
        stop sequences; marks it finished ("stop") and hides the matched
        tokens from ``output``.  Matched against ``output`` (not just
        ``tokens``) so a sequence spanning a preemption fold still hits."""
        if not req.stop or req.finish_reason:
            return bool(req.finish_reason)
        out = list(req.prompt[req.orig_plen:]) + list(req.tokens)
        for seq in req.stop:
            n = len(seq)
            if n and n <= len(out) and out[-n:] == [int(t) for t in seq]:
                req.finish_reason = "stop"
                req.n_trunc = n
                return True
        return False

    def _finish(self, slot: int, step: int) -> Request:
        """Evict a finished request from its slot and account it."""
        req = self.slots[slot]
        if not req.finish_reason:
            req.finish_reason = "length"
        req.finished_step = step
        req.finish_t = perf_counter()
        self._release_slot(slot)
        self.finished.append(req)
        return req

    def cancel(self, rid: int, step: int = 0) -> Optional[Request]:
        """Abort a request wherever it is.  Waiting requests leave the
        queue; running requests release their slot and blocks (trie-
        registered prefix blocks stay cached and unpoisoned — the pool
        contents they index are still valid prompt latents).  Fork
        groups: cancelling a not-yet-forked waiting parent takes its
        children with it; cancelling a single not-yet-forked child just
        shrinks the group; post-fork, every member is an ordinary
        independent request and cancels alone.  Unknown or already-
        finished rids are a no-op.  Returns the cancelled request
        (``finish_reason == "cancelled"``) or None."""
        def retire(r: Request) -> Request:
            r.finish_reason = "cancelled"
            r.finished_step = step
            r.finish_t = perf_counter()
            self.finished.append(r)
            return r

        for req in self.waiting:
            if req.rid == rid:
                self.waiting.remove(req)
                if not req.forked:
                    # pre-admission children exist only as attachments
                    for child in req.fork_children:
                        retire(child)
                    req.fork_children = []
                return retire(req)
            if not req.forked:
                for child in req.fork_children:
                    if child.rid == rid:
                        req.fork_children.remove(child)
                        return retire(child)
        for slot in self.active_slots:
            req = self.slots[slot]
            if req.rid == rid:
                req.finish_reason = "cancelled"
                return self._finish(slot, step)
        return None

    def _release_slot(self, slot: int) -> None:
        self.prefix.release(self.blocks_of.pop(slot))
        req = self.slots[slot]
        req.slot = -1
        self.slots[slot] = None
        self.block_table[slot] = NULL_BLOCK
        self.lengths[slot] = 0
        self._admit_order.remove(slot)

    # ------------------------------------------------------------- stats ---

    def utilization(self) -> Dict[str, float]:
        """valid_frac: valid tokens / allocated slots (internal
        fragmentation); pool_frac: allocated blocks / pool size (cached
        refcount-0 blocks are counted separately as cached_blocks)."""
        alloc_blocks = sum(len(v) for v in self.blocks_of.values())
        valid = int(self.lengths[self.active_slots].sum()) \
            if self.active_slots else 0
        return {
            "valid_frac": valid / (alloc_blocks * self.block_size)
            if alloc_blocks else 0.0,
            "pool_frac": alloc_blocks / (self.allocator.num_blocks - 1),
            "valid_tokens": float(valid),
            "allocated_blocks": float(alloc_blocks),
            "cached_blocks": float(self.prefix.num_evictable),
        }
