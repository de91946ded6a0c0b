"""Decode-time latent caches of MLA (port of the MLA sections of
``repro.core.cache``): the contiguous per-request cache and the paged
block pool, optionally stored quantized.

Contiguous cache (``latent_cache``): ckv (B, S, D_kvl), krope (B, S,
D_rope) in the compute dtype; ``update_latent`` writes new tokens at
``index`` along S.

Paged pool: a global pool of fixed-size token blocks shared by all
requests, addressed through per-request block tables.  The {ckv | krope}
split is kept (two pools, one block geometry) so the PV product reads
``ckv`` directly:

  * pool shapes: ckv (N_blocks, bs, D_kvl), krope (N_blocks, bs, D_rope);
  * block 0 is the reserved NULL block — the allocator never hands it out
    and unassigned block-table entries point at it, so every gather and
    every block-table walk stays in bounds;
  * ``block_table`` (B, max_blocks) int32 maps request-local block j to a
    pool block; ``lengths`` (B,) int32 counts tokens already cached (the
    next decode token is written at position lengths[b]).

Quantized storage (``cache_dtype`` 'int8' or 'fp8', e4m3fn): the data
leaves hold 1-byte codes and two more leaves ``ckv_scale`` /
``krope_scale`` (N, bs, 1) f32 hold one scale per token slot, so stored
q ~= x / scale and x ~= q.float() * scale, with scale = amax(|x|, row) /
qmax (1 for an all-zero row, so the null block stays exactly zero).
Writes quantize; the gathered reference view dequantizes; the pool itself
is never dequantized.

Unlike the JAX package, whose arrays are immutable, the port UPDATES
CACHES IN PLACE: every write and copy below mutates the tensors it is
given and returns the same dict, so a decode step never holds two caches.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch

CACHE_DTYPES = ("bf16", "int8", "fp8")


def cache_dtype_info(cache_dtype: Optional[str]):
    """Map a ``--cache-dtype`` name to (storage dtype, qmax); (None, None)
    for the unquantized pool, which keeps the caller's compute dtype."""
    if cache_dtype in (None, "bf16", "bfloat16"):
        return None, None
    if cache_dtype == "int8":
        return torch.int8, 127.0
    if cache_dtype == "fp8":
        return torch.float8_e4m3fn, 448.0
    raise ValueError(f"unknown cache_dtype {cache_dtype!r}; "
                     f"expected one of {CACHE_DTYPES}")


def is_quantized_pool(pool: Dict[str, torch.Tensor]) -> bool:
    return "ckv_scale" in pool


def _qmax(qdtype) -> float:
    return 127.0 if qdtype == torch.int8 else 448.0


def quantize_latent(x, qmax: float, qdtype):
    """Per-token-row symmetric quantization: (q in ``qdtype``, f32 scale
    of shape x.shape[:-1] + (1,)) with x ~= q.float() * scale.  The
    reference's arithmetic step for step (f32 amax / qmax, x / scale,
    round half to even and clip for int8), so codes and scales agree bit
    for bit."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = x32 / scale
    if not qdtype.is_floating_point:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(qdtype), scale


def dequantize_latent(q, scale):
    """Inverse of :func:`quantize_latent`: an f32 tensor."""
    return q.float() * scale


def bytes_per_token_dense(n_kv: int, head_dim: int, dtype_bytes: int = 2) -> int:
    """K and V cache bytes per cached token of one dense (MHA / GQA) layer."""
    return 2 * n_kv * head_dim * dtype_bytes


def bytes_per_token_latent(kv_lora: int, rope_dim: int, dtype_bytes: int = 2,
                           cache_dtype: Optional[str] = None) -> float:
    """Latent-cache bytes per cached token.  Quantized storage pays 1 byte
    per element plus two f32 per-token-row scales ({ckv|krope} split)."""
    if cache_dtype_info(cache_dtype)[1] is None:
        return (kv_lora + rope_dim) * dtype_bytes
    return (kv_lora + rope_dim) * 1 + 2 * 4


def cache_element_bytes(kv_lora: int, rope_dim: int, dtype_bytes: int = 2,
                        cache_dtype: Optional[str] = None) -> float:
    """Effective bytes per latent-cache ELEMENT (scale overhead amortized
    over the (D_kvl + D_rope) row) — the bytes-per-element axis the hwmodel
    cost terms multiply by."""
    tok = bytes_per_token_latent(kv_lora, rope_dim, dtype_bytes, cache_dtype)
    return tok / float(kv_lora + rope_dim)


# ------------------------------------------------------------ contiguous --


def latent_cache(batch: int, capacity: int, kv_lora: int, rope_dim: int,
                 dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Contiguous split-layout latent cache of one layer: ckv (B, S,
    D_kvl), krope (B, S, D_rope), zeros."""
    return {
        "ckv": torch.zeros((batch, capacity, kv_lora), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, capacity, rope_dim), dtype=dtype,
                             device=device),
    }


def update_latent(cache: Dict[str, torch.Tensor], ckv_new, krope_new,
                  index: int) -> Dict[str, torch.Tensor]:
    """Write (B, L_new, D_kvl) + (B, L_new, D_rope) at positions
    ``index`` .. ``index + L_new - 1`` along S, in place (the reference
    donates its cache to the same effect).  ``index`` is a host int."""
    n = ckv_new.shape[1]
    cache["ckv"][:, index:index + n] = ckv_new.to(cache["ckv"].dtype)
    cache["krope"][:, index:index + n] = krope_new.to(cache["krope"].dtype)
    return cache


# ----------------------------------------------------------------- paged --


def paged_latent_cache(num_blocks: int, block_size: int, kv_lora: int,
                       rope_dim: int, dtype=torch.bfloat16, device="cuda",
                       cache_dtype: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """Paged split-layout latent pool of one layer (block 0 = null block).
    ``cache_dtype`` 'int8' / 'fp8' stores the data leaves quantized and
    adds the (N, bs, 1) f32 scale leaves, initialised to 1; 'bf16' / None
    keeps the pool at ``dtype``."""
    qdtype, _ = cache_dtype_info(cache_dtype)
    shape = {"ckv": (num_blocks, block_size, kv_lora),
             "krope": (num_blocks, block_size, rope_dim)}
    if qdtype is None:
        return {k: torch.zeros(v, dtype=dtype, device=device)
                for k, v in shape.items()}
    return {
        "ckv": torch.zeros(shape["ckv"], dtype=qdtype, device=device),
        "ckv_scale": torch.ones((num_blocks, block_size, 1),
                                dtype=torch.float32, device=device),
        "krope": torch.zeros(shape["krope"], dtype=qdtype, device=device),
        "krope_scale": torch.ones((num_blocks, block_size, 1),
                                  dtype=torch.float32, device=device),
    }


def _last_writer(page, slot, bs: int):
    """For each writing row (flattened), the last row that writes the same
    pool slot.  Idle rows and chunk padding all write into the NULL
    block, and which of several writes to one address lands is left open
    on a GPU; that slot is then read back by idle rows, whose outputs
    compete with live rows for MoE capacity.  Giving every writer of an
    address the same row makes the pool's content one function of the
    inputs."""
    addr = (page * bs + slot).reshape(-1)
    srt, perm = torch.sort(addr, stable=True)
    last = torch.searchsorted(srt, srt, right=True) - 1
    win = torch.empty_like(perm)
    win[perm] = perm[last]
    return win


def _write_slots(pool, page, slot, ckv_new, krope_new):
    """Store rows at (page, slot), quantizing first for a quantized pool;
    rows that share an address all write the last one's values."""
    win = _last_writer(page, slot, pool["ckv"].shape[-2])
    ckv_new = ckv_new.reshape(win.numel(), -1)[win].view_as(ckv_new)
    krope_new = krope_new.reshape(win.numel(), -1)[win].view_as(krope_new)
    if is_quantized_pool(pool):
        qdtype = pool["ckv"].dtype
        for name, x in (("ckv", ckv_new), ("krope", krope_new)):
            q, s = quantize_latent(x, _qmax(qdtype), qdtype)
            pool[name][page, slot] = q
            pool[name + "_scale"][page, slot] = s
        return pool
    pool["ckv"][page, slot] = ckv_new.to(pool["ckv"].dtype)
    pool["krope"][page, slot] = krope_new.to(pool["krope"].dtype)
    return pool


def update_latent_paged(pool: Dict[str, torch.Tensor], block_table, lengths,
                        ckv_new, krope_new) -> Dict[str, torch.Tensor]:
    """Write one new token per request into the pool, in place.

    ckv_new (B, D_kvl), krope_new (B, D_rope) land at position lengths[b]:
    pool block ``block_table[b, lengths[b] // bs]``, slot ``lengths[b] % bs``.
    The scheduler guarantees that block is allocated and that
    ``lengths[b] < block_table.shape[1] * bs``."""
    bs = pool["ckv"].shape[-2]
    page = torch.gather(block_table, 1, (lengths // bs).long()[:, None])[:, 0]
    return _write_slots(pool, page.long(), (lengths % bs).long(), ckv_new,
                        krope_new)


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
    return _write_slots(pool, page, (pos % bs).long(), ckv_new, krope_new)


def pool_leaves(pool_tree) -> Iterator[torch.Tensor]:
    """Every pool tensor of a model's pool tree (all layers, all leaves,
    the scale leaves of a quantized pool included)."""
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
    place through the block table and never build this).  A quantized
    pool's GATHERED view is dequantized to f32; the pool itself never
    is."""
    B, nb = block_table.shape
    block_table = block_table.long()

    def view(name):
        x = pool[name][block_table]
        return x.reshape(B, nb * x.shape[2], x.shape[-1])

    if is_quantized_pool(pool):
        return (dequantize_latent(view("ckv"), view("ckv_scale")),
                dequantize_latent(view("krope"), view("krope_scale")))
    return view("ckv"), view("krope")


def write_blocks_paged(pool_leaf, pages, values):
    """Write whole blocks (the per-request prefill handoff), in place:
    pool_leaf (N, bs, D), pages (n_pg,) pool-block ids (null-block entries
    absorb the padding), values (n_pg, bs, D)."""
    pool_leaf[pages.long()] = values.to(pool_leaf.dtype)
    return pool_leaf


def paged_valid_mask(capacity: int, lengths):
    """(B, capacity) bool mask over the gathered view: request b may attend
    positions <= lengths[b] (its new token was already written there)."""
    j = torch.arange(capacity, device=lengths.device)
    return j[None, :] <= lengths[:, None]
