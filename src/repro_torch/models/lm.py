"""Decoder-only LM for serving and training (port of
``repro.models.lm``): MLA models, the attention families (dense GQA /
MQA / MHA, MoE over GQA, a VLM's patch prefix) and the recurrent ones
(Jamba's periods of Mamba and GQA layers with dense and MoE FFNs, xLSTM's
mLSTM / sLSTM stack).

Layer stack = prefix + periods + suffix of ``ModelConfig.layer_plan``.
The JAX package scans each period over stacked weights; the port keeps one
parameter dict and one pool per layer (``params["period"][p]["s{i}"]``)
and runs the stack as a Python loop.  Under ``cfg.remat`` each period of
the training forward runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of the scanned body).

    lm_defs(cfg)                                              param defs
    forward(params, cfg, tokens, ...)                   -> logits, aux
    prefill(params, cfg, tokens, embeds=..., capacity=...)
                                                        -> logits, cache
    decode_step_contiguous(params, cfg, token, cache, index, ...)
                                                        -> logits, cache
    prefill_chunk_paged(params, cfg, tokens, pool, ...) -> logits, pool
    verify_chunk_paged(params, cfg, tokens, pool, ...)  -> logits, pool
    decode_step(params, cfg, token, pool, ...)          -> logits, pool
    init_cache(cfg, batch, capacity, ...)                     cache tree
    init_paged_cache(cfg, num_blocks, block_size, ...)        pool tree

Caches and pools are updated in place (``core.cache``); the returned tree
is the one passed in (``prefill`` returns a new one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..nn import layers as nl
from ..nn import module as nnm
from .blocks import (AUX_KEYS, Ctx, sub_apply, sub_cache, sub_defs,
                     sub_paged_cache)
from .common import ModelConfig, Sub


def _stacked_fan_in(p: nnm.P, n: int) -> nnm.P:
    """The JAX package draws a period's leaves stacked (n, *shape), so the
    stacking axis counts in their fan-in; keep that distribution."""
    if p.init != "fan_in" or p.scale is not None:
        return p
    return dataclasses.replace(
        p, scale=(n * max(1, math.prod(p.shape[:-1]))) ** -0.5)


def lm_defs(cfg: ModelConfig) -> Dict:
    prefix, period, n_periods, suffix = cfg.layer_plan()
    period_defs = [
        nnm.map_defs(lambda _, p: _stacked_fan_in(p, n_periods),
                     {f"s{i}": sub_defs(cfg, desc)
                      for i, desc in enumerate(period)})
        for _ in range(n_periods)]
    return {
        "embed": nl.embed_defs(cfg.vocab, cfg.d_model),
        "ln_f": nl.rmsnorm_defs(cfg.d_model),
        "prefix": {f"l{i}": sub_defs(cfg, desc,
                                     d_ff=cfg.first_dense_d_ff or None)
                   for i, desc in enumerate(prefix)},
        "period": period_defs,
        "suffix": {f"l{i}": sub_defs(cfg, desc)
                   for i, desc in enumerate(suffix)},
    }


def param_count(cfg: ModelConfig) -> int:
    return nnm.count_params(lm_defs(cfg))


def layers(cfg: ModelConfig, tree) -> Iterator[Tuple[Sub, Dict]]:
    """(descriptor, per-layer node of ``tree``) in stack order, for any
    tree laid out like :func:`lm_defs` (params, defs or pools)."""
    prefix, period, n_periods, suffix = cfg.layer_plan()
    for i, desc in enumerate(prefix):
        yield desc, tree["prefix"][f"l{i}"]
    for p in range(n_periods):
        for i, desc in enumerate(period):
            yield desc, tree["period"][p][f"s{i}"]
    for i, desc in enumerate(suffix):
        yield desc, tree["suffix"][f"l{i}"]


def _layout(cfg: ModelConfig, leaf) -> Dict:
    """A tree laid out like the layers of :func:`lm_defs`, ``leaf(desc)``
    at each layer."""
    prefix, period, n_periods, suffix = cfg.layer_plan()
    return {
        "prefix": {f"l{i}": leaf(d) for i, d in enumerate(prefix)},
        "period": [{f"s{i}": leaf(d) for i, d in enumerate(period)}
                   for _ in range(n_periods)],
        "suffix": {f"l{i}": leaf(d) for i, d in enumerate(suffix)},
    }


def _run_stack(params, cfg: ModelConfig, x, ctx: Ctx, pools=None):
    """Returns (x, pools, aux summed over layers).  ``pools`` (laid out
    like the params) is None in train mode; in prefill mode the tree of
    new contiguous caches is returned in its place."""
    prefix, period, n_periods, suffix = cfg.layer_plan()
    aux_sum = {k: x.new_zeros((), dtype=torch.float32) for k in AUX_KEYS}
    if ctx.mode == "prefill":
        pools = _layout(cfg, lambda _: None)

    def run(descs, p_node, pool_node, keys, x):
        """The sublayers ``keys`` of one node, in order; returns x and
        their summed aux as a tuple (checkpoint-friendly).  A new cache
        (prefill) is stored into ``pool_node``."""
        aux_tot = [x.new_zeros((), dtype=torch.float32) for _ in AUX_KEYS]
        for desc, key in zip(descs, keys):
            pool = pool_node[key] if pool_node is not None else None
            x, new, aux = sub_apply(p_node[key], cfg, desc, x,
                                    dataclasses.replace(ctx, cache=pool))
            if ctx.mode == "prefill":
                pool_node[key] = new
            aux_tot = [a + aux[k] for a, k in zip(aux_tot, AUX_KEYS)]
        return (x, *aux_tot)

    def node(tree, *path):
        for k in path:
            tree = tree[k] if tree is not None else None
        return tree

    segments = [(prefix, ("prefix",), [f"l{i}" for i in range(len(prefix))],
                 False)]
    segments += [(period, ("period", p), [f"s{i}" for i in range(len(period))],
                  ctx.mode == "train" and cfg.remat)
                 for p in range(n_periods)]
    segments.append((suffix, ("suffix",),
                     [f"l{i}" for i in range(len(suffix))], False))
    for descs, path, keys, remat in segments:
        if not descs:
            continue
        p_node = node(params, *path)
        if ctx.shard is not None:
            # this rank's weights with their 'data' parts gathered, one
            # node of layers at a time
            p_node = ctx.shard.local(p_node, node(ctx.shard.axes, *path))
        args = (descs, p_node, node(pools, *path), keys)
        if remat:
            x, *aux = checkpoint(run, *args, x, use_reentrant=False)
        else:
            x, *aux = run(*args, x)
        aux_sum = {k: aux_sum[k] + a for k, a in zip(AUX_KEYS, aux)}
    return x, pools, aux_sum


def _embed(params, cfg: ModelConfig, tokens, dtype, embeds=None,
           shard=None):
    """Token embeddings in ``dtype`` (times sqrt(d_model), rounded to
    ``dtype``, for gemma-style configs), after the (B, P, D) modality
    prefix ``embeds`` if given (a VLM's patch embeddings).  Under a mesh
    (``shard``) the rows of this DP shard, ``params["embed"]`` this
    rank's table with its 'data' part gathered (:func:`_local_embed`)."""
    if shard is None:
        x = nl.embed(params["embed"], tokens, dtype)
    else:
        x = nl.embed(params["embed"], shard.local_rows(tokens), dtype,
                     shard=shard)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    if embeds is not None:
        x = torch.cat([embeds.to(dtype), x], dim=1)
    return x


def _logits(params, cfg: ModelConfig, x, shard=None):
    """The head.  Under a mesh (``shard``) x is this DP shard's rows and
    every rank gets the whole batch's full-vocab rows
    (``nn.layers.unembed``)."""
    x = nl.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return nl.unembed(params["embed"], x, shard=shard)


def _local_embed(params, shard):
    """``params`` with the (tied) table's 'data' part gathered, once a
    step for the embedding and the head (a no-op without a mesh)."""
    if shard is None:
        return params
    return {**params, "embed": shard.local(params["embed"],
                                           shard.axes["embed"])}


def forward(params, cfg: ModelConfig, tokens, *, embeds=None,
            compute_dtype=torch.bfloat16, impl: str = "ref",
            scheme: str = "seq", return_hidden: bool = False):
    """Training forward.  tokens: (B, L_text); embeds: (B, P, D) modality
    prefix (a VLM's patches) or None.  Returns (logits (B, P + L_text, V),
    aux); with ``return_hidden`` the final-norm hidden states instead of
    logits (the vocab-chunked loss unembeds them itself).  ``impl``
    'kernel' runs every layer's attention in the flash-attention kernels
    (forward and backward); 'ref' densely.  Training runs MLA in MHA
    mode, so ``scheme`` must be 'seq' (the decode schemes 'rc'/'ru' apply
    to serving only)."""
    if scheme != "seq":
        raise ValueError(f"training runs MLA in MHA mode: scheme must be "
                         f"'seq', got {scheme!r}")
    x = _embed(params, cfg, tokens, compute_dtype, embeds)
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device).expand(B, L)
    ctx = Ctx(mode="train", impl=impl, scheme=scheme, positions=positions)
    x, _, aux = _run_stack(params, cfg, x, ctx)
    if return_hidden:
        return nl.rmsnorm(params["ln_f"], x, cfg.norm_eps), aux
    return _logits(params, cfg, x), aux


def prefill(params, cfg: ModelConfig, tokens, *, embeds=None,
            capacity: int = 0, compute_dtype=torch.bfloat16,
            impl: str = "ref", scheme: str = "seq"):
    """Contiguous prefill of a batch of equal-length prompts.

    tokens: (B, L_text); embeds: (B, P, D) modality prefix or None, so L
    = P + L_text positions are cached.  Runs the whole prompt (MLA in
    MHA mode; the attention dense under 'ref', in the flash-attention
    forward kernel under 'kernel', block pair by block pair under
    'chunked') and returns (last-token logits (B, V), a contiguous cache
    tree of ``capacity`` (default L) positions holding the L entries:
    latent caches for MLA, KV caches for the other attention layers, and
    each recurrent layer's state after the L positions),
    for :func:`decode_step_contiguous`, whose ``index`` then counts the
    P cached patches too.  ``scheme`` matters at MLA decode only."""
    x = _embed(params, cfg, tokens, compute_dtype, embeds)
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device).expand(B, L)
    ctx = Ctx(mode="prefill", impl=impl, scheme=scheme, positions=positions,
              capacity=capacity or L)
    x, caches, _ = _run_stack(params, cfg, x, ctx)
    return _logits(params, cfg, x[:, -1]), caches


def decode_step_contiguous(params, cfg: ModelConfig, token, cache,
                           index: int, *, compute_dtype=torch.bfloat16,
                           impl: str = "ref", scheme: str = "seq"):
    """One decode step over contiguous caches: token (B,), ``index`` a host
    int (the tokens already cached, shared by the batch).  The JAX
    package's ``decode_step(token, cache, index)``; its paged form is
    :func:`decode_step` here.  ``impl`` 'kernel' runs MLA's latent
    attention in kernel K3; the other families' one-token attention is
    ``core.attention.gqa_decode`` either way, as in the reference.
    Returns (logits (B, V), cache)."""
    x = _embed(params, cfg, token, compute_dtype)
    ctx = Ctx(mode="decode", impl=impl, scheme=scheme, index=int(index))
    x, cache, _ = _run_stack(params, cfg, x, ctx, cache)
    return _logits(params, cfg, x), cache


def prefill_chunk_paged(params, cfg: ModelConfig, tokens, pool,
                        block_tables, lengths, n_valid, *,
                        compute_dtype=torch.bfloat16, impl: str = "ref",
                        scheme: str = "seq", shard=None):
    """One batched prefill CHUNK straight into the paged pool.

    tokens: (B, C) int — row b holds its request's next ``n_valid[b]``
    prompt tokens (rest is padding) at absolute positions ``lengths[b]``..
    Returns (logits (B, V) of each row's last valid position, pool) — the
    logits matter only for the chunk that finishes a request's prompt.
    ``impl`` 'kernel' runs the chunk attention in the paged prefill kernel;
    'ref' on the gathered block-table view.

    ``shard`` (an ``nn.sharding.Shard``, ``runtime.steps.make_shard``):
    run as this rank's part of the step sharded over its mesh by its
    policy.  Every rank passes the whole batch's inputs, ``params``
    holding its shards (``weights.shard_params``) and ``pool`` its
    replica; it computes its DP shard's rows and its heads, writes every
    row's latents into its replica and returns the whole batch's
    logits."""
    params = _local_embed(params, shard)
    x, pool = _chunk_paged_hidden(params, cfg, tokens, pool, block_tables,
                                  lengths, n_valid,
                                  compute_dtype=compute_dtype, impl=impl,
                                  scheme=scheme, shard=shard)
    nv = n_valid if shard is None else shard.local_rows(n_valid)
    last = torch.clamp(nv.long() - 1, min=0)
    h = x[torch.arange(x.shape[0], device=x.device), last]
    return _logits(params, cfg, h, shard), pool


def verify_chunk_paged(params, cfg: ModelConfig, tokens, pool,
                       block_tables, lengths, n_valid, *,
                       compute_dtype=torch.bfloat16, impl: str = "ref",
                       scheme: str = "seq"):
    """The multi-token VERIFY step of speculative decoding: the chunked
    paged prefill with logits at EVERY chunk position.

    tokens: (B, C) int — row b holds [last sampled token, draft_1 ..
    draft_{n_valid[b]-1}] at absolute positions lengths[b].. (C = k + 1).
    The attention and the pool writes are :func:`prefill_chunk_paged`'s;
    the head returns (B, C, V): row (b, j) is the target's next-token
    distribution after draft j.  Positions past ``n_valid`` write the
    null block and their logits are never read.  Returns (logits,
    pool)."""
    x, pool = _chunk_paged_hidden(params, cfg, tokens, pool, block_tables,
                                  lengths, n_valid,
                                  compute_dtype=compute_dtype, impl=impl,
                                  scheme=scheme)
    return _logits(params, cfg, x), pool


def _chunk_paged_hidden(params, cfg: ModelConfig, tokens, pool,
                        block_tables, lengths, n_valid, *, compute_dtype,
                        impl, scheme, shard=None):
    """Shared body of prefill_chunk_paged / verify_chunk_paged: one (B, C)
    chunk through the stack against the paged pool; returns the pre-norm
    hidden states (B, C, D) — this DP shard's rows under a mesh — and the
    pool."""
    x = _embed(params, cfg, tokens, compute_dtype, shard=shard)
    ctx = Ctx(mode="prefill_chunk", impl=impl, scheme=scheme,
              block_tables=block_tables, lengths=lengths, n_valid=n_valid,
              shard=shard)
    x, pool, _ = _run_stack(params, cfg, x, ctx, pool)
    return x, pool


def decode_step(params, cfg: ModelConfig, token, pool, block_tables,
                lengths, *, compute_dtype=torch.bfloat16, impl: str = "ref",
                scheme: str = "seq", shard=None):
    """Paged continuous-batching decode: token (B,), ``lengths`` (B,)
    int32 ragged per-request cache lengths, ``block_tables`` (B, nb).
    Returns (logits (B, V), pool).  ``shard`` as for
    :func:`prefill_chunk_paged`."""
    params = _local_embed(params, shard)
    x = _embed(params, cfg, token, compute_dtype, shard=shard)
    ctx = Ctx(mode="decode", impl=impl, scheme=scheme,
              block_tables=block_tables, lengths=lengths, shard=shard)
    x, pool, _ = _run_stack(params, cfg, x, ctx, pool)
    return _logits(params, cfg, x, shard), pool


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device="cuda") -> Dict:
    """Contiguous cache tree laid out like the layers of :func:`lm_defs`:
    one (batch, capacity, .) latent cache per MLA layer, one KV cache per
    other attention layer (a windowed layer's capped at cfg.max_seq), one
    state without a capacity axis per recurrent layer."""
    return _layout(cfg, lambda d: sub_cache(cfg, d, batch, capacity, dtype,
                                            device))


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device="cuda",
                     cache_dtype=None) -> Dict:
    """Pool tree laid out like the layers of :func:`lm_defs`: one
    (num_blocks, block_size, .) latent block pool per MLA layer, shared by
    all requests (int8 / fp8 with scale leaves for ``cache_dtype``).
    Block tables and lengths live outside it (one table per request,
    shared across layers)."""
    return _layout(cfg, lambda d: sub_paged_cache(cfg, d, num_blocks,
                                                  block_size, dtype, device,
                                                  cache_dtype))
