"""The paged MLA latent pool (port of the paged section of
``repro.core.cache``).

A global pool of fixed-size token blocks shared by all requests,
addressed through per-request block tables.  The {ckv | krope} split is
kept (two pools, one block geometry) so the PV product reads ``ckv``
directly:

  * pool shapes: ckv (N_blocks, bs, D_kvl), krope (N_blocks, bs, D_rope);
  * block 0 is the reserved NULL block — the allocator never hands it out
    and unassigned block-table entries point at it, so every gather and
    every block-table walk stays in bounds;
  * ``block_table`` (B, max_blocks) int32 maps request-local block j to a
    pool block; ``lengths`` (B,) int32 counts tokens already cached (the
    next decode token is written at position lengths[b]).

Unlike the JAX package, whose arrays are immutable, the port UPDATES THE
POOL IN PLACE: every write and copy below mutates the tensors it is given
and returns the same dict, so a decode step never holds two pools.

Only the unquantized pool (the compute dtype: bf16 or f32) is ported; the
int8/fp8 pool with per-slot scales is still to be ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch

CACHE_DTYPES = ("bf16", "int8", "fp8")


def _is_quantized(cache_dtype: Optional[str]) -> bool:
    if cache_dtype in (None, "bf16", "bfloat16"):
        return False
    if cache_dtype in ("int8", "fp8"):
        return True
    raise ValueError(f"unknown cache_dtype {cache_dtype!r}; "
                     f"expected one of {CACHE_DTYPES}")


def bytes_per_token_latent(kv_lora: int, rope_dim: int, dtype_bytes: int = 2,
                           cache_dtype: Optional[str] = None) -> float:
    """Latent-cache bytes per cached token.  Quantized storage pays 1 byte
    per element plus two f32 per-token-row scales ({ckv|krope} split)."""
    if not _is_quantized(cache_dtype):
        return (kv_lora + rope_dim) * dtype_bytes
    return (kv_lora + rope_dim) * 1 + 2 * 4


def cache_element_bytes(kv_lora: int, rope_dim: int, dtype_bytes: int = 2,
                        cache_dtype: Optional[str] = None) -> float:
    """Effective bytes per latent-cache ELEMENT (scale overhead amortized
    over the (D_kvl + D_rope) row) — the bytes-per-element axis the hwmodel
    cost terms multiply by."""
    tok = bytes_per_token_latent(kv_lora, rope_dim, dtype_bytes, cache_dtype)
    return tok / float(kv_lora + rope_dim)


def paged_latent_cache(num_blocks: int, block_size: int, kv_lora: int,
                       rope_dim: int, dtype=torch.bfloat16,
                       device="cuda") -> Dict[str, torch.Tensor]:
    """Paged split-layout latent pool of one layer (block 0 = null block)."""
    return {
        "ckv": torch.zeros((num_blocks, block_size, kv_lora), dtype=dtype,
                           device=device),
        "krope": torch.zeros((num_blocks, block_size, rope_dim), dtype=dtype,
                             device=device),
    }


def update_latent_paged(pool: Dict[str, torch.Tensor], block_table, lengths,
                        ckv_new, krope_new) -> Dict[str, torch.Tensor]:
    """Write one new token per request into the pool, in place.

    ckv_new (B, D_kvl), krope_new (B, D_rope) land at position lengths[b]:
    pool block ``block_table[b, lengths[b] // bs]``, slot ``lengths[b] % bs``.
    The scheduler guarantees that block is allocated and that
    ``lengths[b] < block_table.shape[1] * bs``."""
    bs = pool["ckv"].shape[-2]
    page = torch.gather(block_table, 1, (lengths // bs).long()[:, None])[:, 0]
    page, slot = page.long(), (lengths % bs).long()
    pool["ckv"][page, slot] = ckv_new.to(pool["ckv"].dtype)
    pool["krope"][page, slot] = krope_new.to(pool["krope"].dtype)
    return pool


def update_latent_paged_chunk(pool: Dict[str, torch.Tensor], block_table,
                              lengths, n_valid, ckv_new, krope_new
                              ) -> Dict[str, torch.Tensor]:
    """Write a CHUNK of new tokens per request into the pool, in place.

    ckv_new (B, C, D_kvl), krope_new (B, C, D_rope): row b's chunk token c
    is valid iff ``c < n_valid[b]`` and lands at absolute position
    ``lengths[b] + c``.  Invalid tokens (chunk padding, idle rows) go to
    the NULL block, which absorbs the garbage and is never attended."""
    bs = pool["ckv"].shape[-2]
    C = ckv_new.shape[1]
    c = torch.arange(C, dtype=lengths.dtype, device=lengths.device)
    pos = lengths[:, None] + c[None, :]                            # (B, C)
    valid = c[None, :] < n_valid[:, None]
    blk = torch.clamp(pos // bs, 0, block_table.shape[1] - 1).long()
    page = torch.where(valid, torch.gather(block_table, 1, blk), 0).long()
    slot = (pos % bs).long()
    pool["ckv"][page, slot] = ckv_new.to(pool["ckv"].dtype)
    pool["krope"][page, slot] = krope_new.to(pool["krope"].dtype)
    return pool


def pool_leaves(pool_tree) -> Iterator[torch.Tensor]:
    """Every pool tensor of a model's pool tree (all layers, both leaves)."""
    if isinstance(pool_tree, torch.Tensor):
        yield pool_tree
    elif isinstance(pool_tree, dict):
        for v in pool_tree.values():
            yield from pool_leaves(v)
    else:
        for v in pool_tree:
            yield from pool_leaves(v)


def copy_block_paged(pool_tree, src: int, dst: int):
    """Copy one pool block's contents (all leaves, all layers) from block
    ``src`` to block ``dst``, in place — the device side of a
    copy-on-write break."""
    for a in pool_leaves(pool_tree):
        a[dst] = a[src]
    return pool_tree


def copy_blocks_paged(pool_tree, srcs, dsts):
    """Batched :func:`copy_block_paged`: blocks srcs[i] -> dsts[i] (all
    leaves, all layers) in one indexed copy per leaf.  Pairs must be
    independent: every src is gathered before any dst is written, so a dst
    reused as a later src would read stale data — chained batches go
    through :func:`copy_block_paged` in order instead."""
    for a in pool_leaves(pool_tree):
        a[dsts] = a[srcs]
    return pool_tree


def gather_latent_paged(pool: Dict[str, torch.Tensor], block_table):
    """Materialize the contiguous (B, max_blocks*bs, D) view of each
    request's cache — the reference path (the kernels read the pool in
    place through the block table and never build this)."""
    B, nb = block_table.shape
    bs = pool["ckv"].shape[-2]
    block_table = block_table.long()
    ckv = pool["ckv"][block_table].reshape(B, nb * bs, pool["ckv"].shape[-1])
    krope = pool["krope"][block_table].reshape(B, nb * bs,
                                               pool["krope"].shape[-1])
    return ckv, krope


def paged_valid_mask(capacity: int, lengths):
    """(B, capacity) bool mask over the gathered view: request b may attend
    positions <= lengths[b] (its new token was already written there)."""
    j = torch.arange(capacity, device=lengths.device)
    return j[None, :] <= lengths[:, None]
