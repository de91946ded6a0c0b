"""Radix prefix cache over the paged latent-KV block pool.

Copied from ``repro.runtime.prefix_cache`` (numpy only): the port keeps
its own copy so it never imports the JAX package.

Requests sharing a prompt prefix (system prompt, few-shot preamble) should
share pool *blocks* instead of recomputing and re-storing the same latents
— the serving-side dual of the paper's bytes-per-token result: MLA's
compact ``{ckv|krope}`` cache cuts the bytes each token costs; prefix
sharing cuts the redundant *tokens* entirely.

Design (vLLM/SGLang-style, at block granularity):

  * A trie ("radix tree" at full-block granularity) keyed by the CONTENT
    of each full token block: every edge is a ``block_size``-tuple of
    token ids, every node owns one pool block holding the latents of
    exactly those tokens in that prefix position.  Matching a new prompt
    walks the trie block-by-block from the root.
  * Blocks are REF-COUNTED in the :class:`~.scheduler.BlockAllocator`:
    a trie hit ``fork``s the block (refcount += 1) and maps the request's
    leading block-table entries onto it; ``release`` (refcount -= 1)
    replaces raw ``free`` everywhere in the scheduler.
  * Copy-on-write boundary: full matched blocks are mapped read-only; a
    hit may additionally end MID-BLOCK (``MatchResult.partial_len``
    tokens into one more cached block) — the scheduler materializes that
    tail by allocating a private block and queueing a device-side block
    copy (``core.cache.copy_block_paged``), so only the genuinely novel
    suffix runs through prefill.  Matches are capped at ``plen - 1``
    tokens so at least one prompt token always prefills — the
    last-position logits are what samples the first generated token.
    Should a write ever target a block that is shared or trie-registered
    (decode-block registration, n-way forks), the scheduler breaks the
    share with the same block copy before writing.
  * DECODE blocks are registered too: as a request's length crosses each
    block boundary, the just-completed block of generated-token latents
    enters the trie under its token content
    (``scheduler.register_decode_blocks``) — a follow-up conversation
    turn whose prompt embeds the previous turn's output re-hits its own
    generation instead of re-prefilling it.
  * Eviction is LRU over refcount-ZERO cached blocks instead of the
    immediate reuse of a plain free list: when a request releases its blocks, the
    trie-registered ones stay resident (refcount 0, evictable) so a later
    request with the same prefix revives them with a ``fork``; the free
    list is replenished lazily by :meth:`PrefixCache.alloc` evicting the
    least-recently-used childless trie nodes.

Intra-tick ordering: a request's blocks are registered (``insert``) only
AFTER its prefill has scattered their latents into the pool, so a match
can never hand out blocks whose contents are not yet written.

Host-side and model-agnostic, like the rest of ``runtime.scheduler`` —
the engine owns the device pool; this module only deals in block ids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _block_keys(tokens: Sequence[int], block_size: int) -> List[Tuple[int, ...]]:
    """Content keys of the FULL blocks of ``tokens`` (partial tail dropped)."""
    toks = np.asarray(tokens).tolist()
    n_full = len(toks) // block_size
    return [tuple(toks[i * block_size:(i + 1) * block_size])
            for i in range(n_full)]


def _common_prefix_len(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class MatchResult(List[int]):
    """A :meth:`PrefixCache.match` hit.

    The LIST CONTENT is the full-block part of the match (forked pool
    block ids, exactly what match() always returned), so every existing
    ``len(shared)`` / ``shared + fresh`` / ``match(...) == [...]`` caller
    keeps working.  On top of that a hit may end mid-block:

      partial_src   pool block id whose leading ``partial_len`` token
                    slots extend the match (forked on behalf of the
                    caller, like the full blocks), or None
      partial_len   tokens matched inside ``partial_src`` (0 = none)

    The caller materializes the partial tail copy-on-write: allocate a
    private block, queue a device copy ``partial_src -> private``, then
    ``release([partial_src])`` — the trie block is only ever READ by the
    copy, which the engine orders before any later pool write.
    """

    def __init__(self, blocks: Sequence[int] = (),
                 partial_src: Optional[int] = None, partial_len: int = 0):
        super().__init__(blocks)
        self.partial_src = partial_src
        self.partial_len = int(partial_len)

    def n_tokens(self, block_size: int) -> int:
        """Total prompt tokens this match serves from the cache."""
        return len(self) * block_size + self.partial_len


class _Node:
    """One cached block: an edge of the trie (keyed by its token content in
    the parent) plus the pool block id holding those tokens' latents."""
    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent):
        self.key = key                      # Tuple[int, ...] | None (root)
        self.block = block                  # pool block id | None (root)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0            # match() calls
    hits: int = 0               # match() calls serving >= 1 token
    hit_tokens: int = 0         # tokens served from the cache (incl. partial)
    lookup_tokens: int = 0      # prompt tokens offered for matching
    partial_hits: int = 0       # matches that ended mid-block
    partial_hit_tokens: int = 0  # tokens served from partial tail blocks
    inserted_blocks: int = 0    # total trie registrations (prompt + decode)
    decode_blocks_inserted: int = 0  # registrations from decode boundaries
    evictions: int = 0
    cow_copies: int = 0

    @property
    def hit_rate(self) -> float:
        """Token-level hit rate over all offered prompt tokens."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0


class PrefixCache:
    """Radix index + refcount/eviction policy over a ``BlockAllocator``.

    ``enabled=False`` degrades to a transparent pass-through (every alloc /
    release behaves exactly like a raw free-list) so the scheduler
    carries one code path.
    """

    def __init__(self, allocator, block_size: int, *, enabled: bool = True,
                 partial: bool = True):
        self.allocator = allocator
        self.block_size = block_size
        self.enabled = enabled
        # token-granular partial-block matching; False matches whole
        # blocks only (the cold-cache baseline)
        self.partial = partial
        self.root = _Node(None, None, None)
        self._node_of: Dict[int, _Node] = {}     # registered block -> node
        self._evictable: Dict[int, _Node] = {}   # refcount-0 cached blocks
        self._clock = 0
        self.stats = PrefixCacheStats()
        # duck-typed telemetry hook (obs.Telemetry); the engine attaches
        # it when telemetry is on.  None (the default) costs one
        # ``is None`` check at the eviction / CoW sites.
        self.tel = None

    # ------------------------------------------------------------ lookup ---

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int]) -> MatchResult:
        """Longest cached prefix of ``tokens``: full blocks as the list
        content, plus (``partial=True``) a token-granular tail —
        ``partial_len`` tokens into one more cached block whose content
        extends the prefix (``MatchResult``).  Every returned block,
        including the partial source, is ``fork``ed (refcount +1) on
        behalf of the caller.

        Capped at ``len(tokens) - 1`` tokens: a full-prompt hit would
        leave nothing to prefill, but the last position's logits are
        needed to sample the first generated token — at least the final
        prompt token is always recomputed privately.
        """
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(tokens)
        if not self.enabled:
            return MatchResult()
        budget = max(len(tokens) - 1, 0)
        node, blocks = self.root, []
        for key in _block_keys(tokens, self.block_size)[:budget // self.block_size]:
            child = node.children.get(key)
            if child is None:
                break
            self.allocator.fork([child.block])
            self._evictable.pop(child.block, None)
            child.last_used = self._tick()
            blocks.append(child.block)
            node = child
        partial_src, partial_len = None, 0
        if self.partial:
            tail = self._partial_child(node, tokens, len(blocks), budget)
            if tail is not None:
                child, partial_len = tail
                self.allocator.fork([child.block])
                self._evictable.pop(child.block, None)
                child.last_used = self._tick()
                partial_src = child.block
        if blocks or partial_len:
            self.stats.hits += 1
            self.stats.hit_tokens += len(blocks) * self.block_size \
                + partial_len
        if partial_len:
            self.stats.partial_hits += 1
            self.stats.partial_hit_tokens += partial_len
        return MatchResult(blocks, partial_src, partial_len)

    def _partial_child(self, node: _Node, tokens: Sequence[int],
                       n_full: int, budget: int):
        """The cached block extending the match past its last full block:
        the child of ``node`` sharing the longest non-empty token prefix
        with the remainder of ``tokens``, clipped to the ``budget``-token
        cap.  Returns (node, matched_len) or None."""
        start = n_full * self.block_size
        tail_budget = min(budget - start, self.block_size)
        if tail_budget <= 0 or not node.children:
            return None
        rest = tuple(np.asarray(tokens).tolist()[start:start + tail_budget])
        best, best_len = None, 0
        for key, child in node.children.items():
            n = _common_prefix_len(key, rest)
            if n > best_len:
                best, best_len = child, n
        return (best, best_len) if best is not None else None

    def lookup_len(self, tokens: Sequence[int]) -> int:
        """Tokens a :meth:`match` would serve right now — NO forks, no
        stats, no LRU touch.  The cache-aware admission policy probes
        every waiting request with this each tick; only the request
        actually admitted runs the real (side-effecting) match."""
        if not self.enabled:
            return 0
        budget = max(len(tokens) - 1, 0)
        node, n_full = self.root, 0
        for key in _block_keys(tokens, self.block_size)[:budget // self.block_size]:
            child = node.children.get(key)
            if child is None:
                break
            n_full += 1
            node = child
        n = n_full * self.block_size
        if self.partial:
            tail = self._partial_child(node, tokens, n_full, budget)
            if tail is not None:
                n += tail[1]
        return n

    def cancel_match(self, tokens: Sequence[int],
                     blocks: "MatchResult") -> None:
        """Undo a ``match`` whose admission was refused: release the forked
        blocks (full AND partial source) and back out the stats, so the
        reported hit rate counts only tokens actually served from the
        cache (a pool-pressured queue head re-matching every scheduler
        tick must not inflate it)."""
        self.release(blocks)
        psrc = getattr(blocks, "partial_src", None)
        plen = getattr(blocks, "partial_len", 0)
        if psrc is not None:
            self.release([psrc])
        self.stats.lookups -= 1
        self.stats.lookup_tokens -= len(tokens)
        if blocks or plen:
            self.stats.hits -= 1
            self.stats.hit_tokens -= len(blocks) * self.block_size + plen
        if plen:
            self.stats.partial_hits -= 1
            self.stats.partial_hit_tokens -= plen

    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               decode: bool = False) -> int:
        """Register a request's FULL sequence blocks in the trie — prompt
        blocks after prefill (the engine's ``commit_prefill``), or
        prompt+generated blocks as decode crosses each block boundary
        (``decode=True``, scheduler.register_decode_blocks).

        ``blocks[i]`` must hold the latents of tokens
        ``[i*bs, (i+1)*bs)`` — i.e. call this only after those latents
        are in the pool (or their writes are enqueued ahead of any
        future reader, the async dispatch-order argument).  Paths
        already present keep their existing block (the caller's duplicate
        stays private and is simply freed on release); new paths adopt
        the caller's block without taking an extra refcount — trie
        residency is tracked separately and only pins a block once its
        refcount drops to zero (it becomes LRU-evictable, not free).
        Returns the number of newly registered blocks.
        """
        if not self.enabled:
            return 0
        node, added = self.root, 0
        for key, blk in zip(_block_keys(tokens, self.block_size), blocks):
            child = node.children.get(key)
            if child is None:
                if blk in self._node_of:     # already registered elsewhere
                    break                    # (defensive; ids are unique)
                child = _Node(key, blk, node)
                node.children[key] = child
                self._node_of[blk] = child
                added += 1
                self.stats.inserted_blocks += 1
                if decode:
                    self.stats.decode_blocks_inserted += 1
            child.last_used = self._tick()
            node = child
        return added

    # ------------------------------------------------- refcount lifecycle --

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block.  Blocks reaching refcount 0 go to
        the LRU-evictable set if trie-registered (their latents stay warm
        for future matches), straight back to the free list otherwise."""
        zeroed = self.allocator.release(blocks)
        for b in zeroed:
            node = self._node_of.get(b)
            if node is not None:
                node.last_used = self._tick()
                self._evictable[b] = node
            else:
                self.allocator.free([b])

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh private blocks (refcount 1), evicting LRU
        cached blocks as needed.  None (and no state change) if the pool
        cannot cover the request even after evicting everything."""
        short = n - self.allocator.num_free
        if short > 0:
            self.evict(short)
        return self.allocator.alloc(n)

    def evict(self, n: int) -> int:
        """Evict up to ``n`` refcount-zero cached blocks, least recently
        used childless nodes first (a node with children cannot go or it
        would orphan deeper cached blocks).  Returns the number evicted.

        The per-eviction scan over the evictable set is O(cached) — fine
        at this pool scale; a last_used heap with stale-entry filtering
        is the drop-in upgrade when pools reach many thousands of
        blocks."""
        evicted = 0
        while evicted < n:
            leaves = [nd for nd in self._evictable.values()
                      if not nd.children]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            self._drop_node(victim)
            evicted += 1
            self.stats.evictions += 1
        if evicted and self.tel is not None:
            self.tel.tracer.instant("prefix_evict", args={"n": evicted})
            if self.tel.metrics is not None:
                self.tel.metrics.counter("prefix_cache.evictions").inc(evicted)
        return evicted

    def _drop_node(self, node: _Node) -> None:
        del node.parent.children[node.key]
        del self._node_of[node.block]
        del self._evictable[node.block]
        self.allocator.free([node.block])

    # ----------------------------------------------------- write guarding --

    def is_write_shared(self, block: int) -> bool:
        """True if writing ``block`` in place would corrupt state another
        holder can see: refcount > 1 (another request maps it) or trie-
        registered (a future match would read it)."""
        return self.allocator.refcount.get(block, 0) > 1 \
            or block in self._node_of

    def count_cow(self) -> None:
        self.stats.cow_copies += 1
        if self.tel is not None:
            self.tel.tracer.instant("cow_copy")
            if self.tel.metrics is not None:
                self.tel.metrics.counter("prefix_cache.cow_copies").inc()

    # ------------------------------------------------------------- stats ---

    @property
    def num_cached(self) -> int:
        """Blocks resident in the trie (shared or evictable)."""
        return len(self._node_of)

    @property
    def num_evictable(self) -> int:
        return len(self._evictable)

    def summary(self) -> Dict[str, float]:
        s = self.stats
        return {
            "prefix_lookups": float(s.lookups),
            "prefix_hits": float(s.hits),
            "prefix_hit_tokens": float(s.hit_tokens),
            "prefix_lookup_tokens": float(s.lookup_tokens),
            "prefix_hit_rate": s.hit_rate,
            "prefix_partial_hits": float(s.partial_hits),
            "prefix_partial_hit_tokens": float(s.partial_hit_tokens),
            "prefix_inserted_blocks": float(s.inserted_blocks),
            "prefix_decode_inserted_blocks": float(s.decode_blocks_inserted),
            "prefix_evictions": float(s.evictions),
            "prefix_cow_copies": float(s.cow_copies),
            "prefix_cached_blocks": float(self.num_cached),
        }

    # ---------------------------------------------------------- invariants -

    def check_invariants(self, live_refs: Dict[int, int]) -> None:
        """Assert the refcount bookkeeping matches ``live_refs`` (block ->
        number of live block-table references); used by the hypothesis
        property test.  Raises AssertionError on violation."""
        rc = self.allocator.refcount
        for b, n in live_refs.items():
            assert rc.get(b, 0) == n, \
                f"block {b}: refcount {rc.get(b, 0)} != {n} live references"
        for b, c in rc.items():
            if c == 0:
                assert b in self._evictable, \
                    f"block {b} has refcount 0 but is not evictable"
            else:
                assert live_refs.get(b, 0) == c, \
                    f"block {b}: refcount {c} but {live_refs.get(b, 0)} refs"
        free = set(self.allocator._free)
        assert not (free & set(rc)), "freed block still carries a refcount"
        assert not (free & set(self._node_of)), "freed block still cached"
