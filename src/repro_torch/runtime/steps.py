"""Step builders (port of ``repro.runtime.steps``: its single-device
half and the layouts of its sharded paged serving): the causal-LM loss
and the training step, the contiguous serving steps, the per-request
prefill handoff into the paged pool, and the specs of the paged steps'
params and pool under a mesh.

    lm_loss(params, cfg, tokens, labels, ...)  -> (loss, metrics)
    make_train_step(cfg, opt_cfg, ts)          -> step(params, opt_state,
                                                       batch)
    make_prefill_step(cfg, capacity=...)       -> fn(params, tokens,
                                                     embeds=None)
                                                  -> (logits, cache)
    make_serve_step(cfg)                       -> fn(params, token, cache,
                                                     index) -> (logits,
                                                                cache)
    make_paged_sample_step(cfg, ...)           -> fn(params, token, pool,
                                                     block_tables, lengths,
                                                     rids, poss) -> tokens
    make_verify_step(cfg, ...)                 -> fn(params, tokens, pool,
                                                     block_tables, lengths,
                                                     n_valid) -> (logits
                                                     (B, C, V), pool)
    scatter_prefill_to_paged(pool, cache, pages) -> pool
    sample_tokens(logits, rids, poss, ...)     -> (B,) token ids
    sample_window(logits, rids, poss, ...)     -> (B, C) token ids
    sample_scores(logits, rids, poss, ...)     -> (B, V) perturbed scores
    cache_pspecs(pool, rules, paged=True)      -> spec tree (replicated)
    paged_param_shardings(params, cfg, mesh, rules)
                                               -> spec tree of params
    commit_params(params, cfg, mesh, policy)   -> this rank's shards
    make_shard(mesh, cfg, policy)              -> nn.sharding.Shard
    attach_absorbed_sharded(params, cfg, shard)
                                               -> + this rank's w_absorb

The paged steps themselves (``models.prefill_chunk_paged`` /
``decode_step``, the reference's ``make_chunked_prefill_step`` /
``make_paged_serve_step``) run sharded when given ``shard=``, the
``Shard`` of the mesh and the policy.

The training step takes gradients with ``torch.autograd.grad`` over the
plain param tree and applies the in-place AdamW of ``optim.adamw``: it
overwrites the params and moments it is given and returns them.  The
serving steps run under ``torch.inference_mode()``; the serve step
updates the cache it is given in place (the reference donates it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import models
from ..core import cache as cachelib
from ..models.common import ModelConfig
from ..nn import layers as nl
from ..nn import module as nnm
from ..nn import sharding as shd
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import tree_leaves, tree_map
from . import prng

METRIC_KEYS = ("loss", "ce", "balance", "z_loss", "dropped_frac")


def _ce_terms(logits, labels):
    """Σ masked CE and Σ mask over a (B, L, V) block, in f32."""
    logits = logits.float()
    mask = (labels >= 0).float()
    labels_safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def _chunk_ce(embed_params, xc, lc):
    return _ce_terms(nl.unembed(embed_params, xc), lc)


def lm_loss(params, cfg: ModelConfig, tokens, labels, *, embeds=None,
            compute_dtype=torch.bfloat16, impl: str = "ref",
            scheme: str = "seq", loss_chunk: int = 0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross entropy (+ the MoE aux losses).  labels are the
    next tokens; entries < 0 are masked.  With a modality prefix (embeds
    (B, P, D)) only the text positions are scored.

    ``loss_chunk > 0``: vocab-chunked CE — the (B, L, V) logits are never
    materialized; the final hidden states are unembedded and scored
    ``loss_chunk`` positions at a time, each chunk recomputed in the
    backward pass (``torch.utils.checkpoint``), so at most
    B x loss_chunk x V logits are live."""
    if loss_chunk:
        x, aux = models.forward(params, cfg, tokens, embeds=embeds,
                                compute_dtype=compute_dtype, impl=impl,
                                scheme=scheme, return_hidden=True)
        x = x[:, x.shape[1] - labels.shape[1]:]
        B, L, D = x.shape
        c = min(loss_chunk, L)
        pad = -L % c
        if pad:
            x = torch.cat([x, x.new_zeros((B, pad, D))], dim=1)
            labels = torch.cat([labels, labels.new_full((B, pad), -100)],
                               dim=1)
        ce_sum = x.new_zeros((), dtype=torch.float32)
        n_tok = x.new_zeros((), dtype=torch.float32)
        for i in range(0, x.shape[1], c):
            s, m = checkpoint(_chunk_ce, params["embed"], x[:, i:i + c],
                              labels[:, i:i + c], use_reentrant=False)
            ce_sum, n_tok = ce_sum + s, n_tok + m
    else:
        logits, aux = models.forward(params, cfg, tokens, embeds=embeds,
                                     compute_dtype=compute_dtype, impl=impl,
                                     scheme=scheme)
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
        ce_sum, n_tok = _ce_terms(logits, labels)
    ce = ce_sum / torch.clamp(n_tok, min=1.0)
    loss = ce
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux["balance"] \
            + 1e-3 * aux["z_loss"]
    return loss, {"loss": loss, "ce": ce, **aux}


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1           # gradient accumulation
    compute_dtype: Any = torch.bfloat16
    impl: str = "ref"
    scheme: str = "seq"
    loss_chunk: int = 0             # vocab-chunked CE (0 = dense logits)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    ts: TrainStepConfig = TrainStepConfig()):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics); batch is {tokens, labels} (B, L) integer tensors on the
    params' device, and for a VLM ``embeds`` (B, P, D), its patch
    prefix, for an encoder-decoder ``embeds`` (B, n_frames, D), its stub
    frames.  ``microbatches`` > 1 splits the batch, sums f32
    gradients and averages them, as the reference's scan does."""

    def grads_of(params, batch):
        leaves = list(tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, metrics = lm_loss(
                params, cfg, batch["tokens"], batch["labels"],
                embeds=batch.get("embeds"),
                compute_dtype=ts.compute_dtype, impl=ts.impl,
                scheme=ts.scheme, loss_chunk=ts.loss_chunk)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        it = iter(g if g is not None else torch.zeros_like(t)
                  for g, t in zip(grads, leaves))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return tree_map(lambda _: next(it), params), metrics

    def step(params, opt_state, batch):
        mb = ts.microbatches
        if mb > 1:
            g_sum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            m_sum = {k: 0.0 for k in METRIC_KEYS}
            for i in range(mb):
                part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                        for k, v in batch.items()}
                g, m = grads_of(params, part)
                tree_map(lambda a, b: a.add_(b), g_sum, g)
                m_sum = {k: m_sum[k] + m[k] for k in METRIC_KEYS}
            grads = tree_map(lambda a: a / mb, g_sum)
            metrics = {k: v / mb for k, v in m_sum.items()}
        else:
            grads, metrics = grads_of(params, batch)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                      opt_state)
        return params, opt_state, {**metrics, **opt_metrics}

    return step


# ------------------------------------------------------------- serving ---


def make_prefill_step(cfg: ModelConfig, *, capacity: int,
                      compute_dtype=torch.bfloat16, impl: str = "ref",
                      scheme: str = "seq"):
    """Returns fn(params, tokens (B, L), embeds=None) -> (last-token
    logits (B, V), a contiguous cache tree of ``capacity`` positions
    holding the P + L entries, P the length of the modality prefix
    ``embeds`` (B, P, D), a VLM's patches).  An encoder-decoder's
    ``embeds`` (B, n_frames, D) are its stub frames: its self cache holds
    the L decoder positions, its cross cache the n_frames encoded ones.
    ``impl`` 'kernel' attends in the flash-attention forward kernel (MLA
    in MHA mode, and every other attention family)."""

    def run(params, tokens, embeds=None):
        with torch.inference_mode():
            return models.prefill(params, cfg, tokens, embeds=embeds,
                                  capacity=capacity,
                                  compute_dtype=compute_dtype, impl=impl,
                                  scheme=scheme)

    return run


def make_serve_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                    impl: str = "ref", scheme: str = "seq"):
    """Returns fn(params, token (B,), cache, index) -> (logits (B, V),
    cache): one decode step over contiguous caches, the new token written
    at the host int ``index`` (the positions cached, a VLM's patches
    included; an encoder-decoder's decoder tokens alone), the cache
    updated in place.  ``impl`` 'kernel' attends in
    kernel K3 for MLA; the other families decode in
    ``core.attention.gqa_decode``, as the reference does."""

    def run(params, token, cache, index: int):
        with torch.inference_mode():
            return models.decode_step_contiguous(
                params, cfg, token, cache, index,
                compute_dtype=compute_dtype, impl=impl, scheme=scheme)

    return run


def make_paged_sample_step(cfg: ModelConfig, *,
                           compute_dtype=torch.bfloat16, impl: str = "ref",
                           scheme: str = "seq", temperature: float = 0.0,
                           top_k: int = 0, sample_seed: int = 0):
    """The paged decode step with sampling folded in (the async engine's
    step; the reference's ``make_paged_sample_step``):

        fn(params, token (B,), pool, block_tables (B, nb), lengths (B,),
           rids (B,), poss (B,)) -> next_token (B,) int64

    the pool updated in place.  Every slot is sampled (inactive rows draw
    tokens the scheduler discards) by :func:`sample_tokens`: greedy, or
    temperature / top-k under fold(fold(seed, rids[b]), poss[b]) — rows
    are independent, so each live row gets the token the host path's
    gathered rows get.  Only the (B,) ids leave the step; the (B, V)
    logits stay on the device.  ``rids`` / ``poss`` are int64 tensors on
    the pool's device (unused when greedy).  No op in it waits for the
    host or copies from it, so a CUDA graph can capture it
    (``runtime.graphs``)."""

    def run(params, token, pool, block_tables, lengths, rids, poss):
        logits, _ = models.decode_step(params, cfg, token, pool,
                                       block_tables, lengths,
                                       compute_dtype=compute_dtype,
                                       impl=impl, scheme=scheme)
        return sample_tokens(logits, rids, poss, temperature=temperature,
                             top_k=top_k, sample_seed=sample_seed)

    return run


def make_verify_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                     impl: str = "ref", scheme: str = "seq"):
    """The speculative-decoding verify step over the paged pool (the
    reference's ``make_verify_step``, single device):

        fn(params, tokens (B, C), pool, block_tables (B, nb), lengths (B,),
           n_valid (B,)) -> (logits (B, C, V), pool)

    the chunked prefill at C = k + 1 with logits at every position
    (``models.verify_chunk_paged``): row b scores its last sampled token
    plus ``n_valid[b] - 1`` drafts against its resident latent prefix,
    and writes their latents into the pool in place.  ``impl`` 'kernel'
    attends in kernel K2."""
    if cfg.attn_kind != "mla":
        raise NotImplementedError("paged serving requires attn_kind='mla'")

    def run(params, tokens, pool, block_tables, lengths, n_valid):
        return models.verify_chunk_paged(params, cfg, tokens, pool,
                                         block_tables, lengths, n_valid,
                                         compute_dtype=compute_dtype,
                                         impl=impl, scheme=scheme)

    return run


def _layer_pairs(pool_tree, cache_tree):
    """(pool, cache) of each layer of two trees laid out alike."""
    if isinstance(pool_tree, dict) and "ckv" in pool_tree:
        yield pool_tree, cache_tree
        return
    keys = pool_tree.keys() if isinstance(pool_tree, dict) \
        else range(len(pool_tree))
    for k in keys:
        yield from _layer_pairs(pool_tree[k], cache_tree[k])


def scatter_prefill_to_paged(pool_tree, cache_tree, pages):
    """Write one request's contiguous prefill cache (batch 1, every
    layer) into the paged pool at its ``pages`` ((max_blocks,) int32
    tensor, padded with the null block), in place.  Whole blocks are
    written; the tail inside the last block is masked at attention time.

    A quantized pool raises, as in the reference: the contiguous cache
    carries no scales — use chunked prefill, whose writes quantize."""
    pairs = list(_layer_pairs(pool_tree, cache_tree))
    if any(cachelib.is_quantized_pool(pool) for pool, _ in pairs):
        raise NotImplementedError(
            "scatter_prefill_to_paged does not support quantized pools; "
            "use prefill_mode='chunked'")
    for pool, cache in pairs:
        for name in ("ckv", "krope"):
            bs = pool[name].shape[-2]
            contig = cache[name][0]                           # (cap, D)
            n_pg = -(-contig.shape[0] // bs)
            pad = n_pg * bs - contig.shape[0]
            if pad:
                contig = torch.cat([contig, contig.new_zeros(
                    (pad, contig.shape[1]))])
            cachelib.write_blocks_paged(
                pool[name], pages[:n_pg],
                contig.reshape(n_pg, bs, contig.shape[1]))
    return pool_tree


# ------------------------------------------------------------ sampling ---


def sample_scores(logits, rids, poss, *, temperature: float, top_k: int = 0,
                  sample_seed: int = 0) -> torch.Tensor:
    """The scores seeded sampling takes the argmax of (``temperature >
    0``): row b's f32 logits divided by the temperature, cut to the top
    k (every logit ``>=`` the k-th largest stays, so ties pass and more
    than k may; the rest become -inf), plus Gumbel noise drawn under the
    key fold(fold(PRNGKey(sample_seed), rids[b]), poss[b]) — the
    reference's ``jax.random.categorical``.  logits (B, V); rids, poss
    (B,) int tensors on the logits' device; returns (B, V) float32.

    The division is a multiply by the float32 reciprocal of the
    temperature, which is what XLA compiles the reference's
    ``rows / temperature`` into."""
    dev = logits.device
    # a host float holding the f32 reciprocal exactly: the multiply runs
    # in f32 on either device, and nothing is copied to the card
    recip = float(np.float32(1.0) / np.float32(temperature))
    rows = logits.float() * recip
    if top_k > 0:
        kth = torch.topk(rows, min(top_k, rows.shape[-1]),
                         dim=-1).values[:, -1:]
        rows = torch.where(rows >= kth, rows,
                           torch.full_like(rows, -float("inf")))
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(sample_seed, dev), rids),
                        poss)
    return prng.gumbel(keys, rows.shape[-1:]) + rows


def sample_tokens(logits, rids, poss, *, temperature: float, top_k: int = 0,
                  sample_seed: int = 0) -> torch.Tensor:
    """One token per logits row, on the rows' device (the body of the
    reference's ``make_paged_sample_step``): greedy argmax at
    ``temperature <= 0`` (``rids`` / ``poss`` unused); else the argmax of
    :func:`sample_scores` (ties to the lowest id).  Returns (B,) int64."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(sample_scores(logits, rids, poss,
                                      temperature=temperature, top_k=top_k,
                                      sample_seed=sample_seed), dim=-1)


def sample_window(logits, rids, poss, *, temperature: float, top_k: int = 0,
                  sample_seed: int = 0) -> torch.Tensor:
    """One token per position of a verify window: logits (B, C, V), row b
    at absolute positions poss[b] .. poss[b] + C - 1, each drawn by
    :func:`sample_tokens` under fold(fold(seed, rids[b]), position), the
    key plain decode uses for that position.  Returns (B, C) int64."""
    B, C, V = logits.shape
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    offs = torch.arange(C, dtype=poss.dtype, device=poss.device)
    flat = sample_tokens(logits.reshape(B * C, V),
                         rids[:, None].expand(B, C).reshape(-1),
                         (poss[:, None] + offs).reshape(-1),
                         temperature=temperature, top_k=top_k,
                         sample_seed=sample_seed)
    return flat.reshape(B, C)


# ------------------------------------------------- paged serving, mesh ----


def cache_pspecs(cache_tree, rules, *, paged: bool = False):
    """Spec tree of a decode cache.  ``paged``: the tree is a PAGED
    latent block pool, whose leaves (num_blocks, block_size, D) have no
    batch dim to shard.  It replicates over 'model' (head shards re-read
    the same compact pool: the MQA structure of absorbed MLA) AND over
    the DP axes, because per-request block tables map any slot to any
    pool block — a DP shard of the batch may read or write anywhere in
    the pool.  What DP buys is per-device traffic, not capacity.  The
    contiguous caches' specs (batch over DP, the cache's seq dim for
    distributed flash-decode) belong to the contiguous path under a
    mesh, which is not ported (ROADMAP.md)."""
    if not paged:
        raise NotImplementedError(
            "contiguous caches under a mesh are not ported to repro_torch "
            "yet (see ROADMAP.md, queue 1)")
    return tree_map(lambda _: (), cache_tree)


def _dp_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= mesh.size(a)
    return n


def make_shard(mesh, cfg: ModelConfig, policy: str = "serve"):
    """The ``nn.sharding.Shard`` of ``cfg``'s paged steps over ``mesh``
    under ``policy``, which the engine builds once and hands to
    ``models.decode_step`` / ``prefill_chunk_paged`` as ``shard=``; None
    without a mesh."""
    if mesh is None:
        return None
    axes = nnm.map_defs(lambda _, p: p.axes, models.model_defs(cfg))
    return shd.Shard(mesh, policy, cfg, axes)


def _absorbed_def(cfg: ModelConfig) -> nnm.P:
    """The P of an attached ``w_absorb`` (H, D_ql, D_kvl): heads split
    like the factors it absorbs."""
    return nnm.P((cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank),
                 ("heads", None, None))


def _graft(defs, params, absorbed: nnm.P):
    """The P tree matching ``params``' actual structure: defs-declared
    leaves take their def, attached ``w_absorb`` leaves ``absorbed``."""
    if isinstance(params, dict):
        return {k: absorbed if k == "w_absorb" else _graft(defs[k], v,
                                                           absorbed)
                for k, v in params.items()}
    if isinstance(params, list):
        return [_graft(d, v, absorbed) for d, v in zip(defs, params)]
    return defs


def paged_param_defs(params, cfg: ModelConfig):
    """P tree of ``params`` (the engine attaches ``w_absorb`` leaves that
    ``model_defs`` does not declare)."""
    return _graft(models.model_defs(cfg), params, _absorbed_def(cfg))


def paged_param_shardings(params, cfg: ModelConfig, mesh, rules):
    """Spec tree matching ``params``' actual structure: defs-declared
    weights take their rule spec, absorbed leaves shard over heads
    ('model') like the factors they absorb."""
    return shd.param_specs(paged_param_defs(params, cfg), rules)


def commit_params(params, cfg: ModelConfig, mesh, policy: str = "serve"):
    """This rank's shard of every leaf of a (possibly absorb-carrying)
    param tree under ``policy``'s layout, on the mesh's device: the
    reference commits the tree to its shardings once, so that the steps
    never reshard.  ``weights.shard_params``."""
    from ..weights import shard_params
    return shard_params(params, cfg, mesh, policy)


def attach_absorbed_sharded(params, cfg: ModelConfig, shard):
    """``core.mla.attach_absorbed_tree`` for a tree of this rank's shards
    (``shard``: :func:`make_shard`): each MLA sublayer's ``w_absorb`` for
    this rank's heads, whole over the q lora dim, from factors whose
    'data' parts ('q_lora' under 'serve_2dtp') are gathered once here."""
    from ..core import mla as mlalib
    mcfg = cfg.mla_config()

    def visit(node, axes):
        if isinstance(node, dict):
            if "w_uq" in node and "w_uk" in node:
                full = shard.local({k: node[k] for k in ("w_uq", "w_uk")},
                                   axes, logical=("q_lora",))
                absorb = mlalib.absorb_qk(full, mcfg)
                return {**node, "w_absorb": absorb.to(node["w_uq"].dtype)}
            return {k: visit(v, axes[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, a) for v, a in zip(node, axes)]
        return node

    return visit(params, shard.axes)
