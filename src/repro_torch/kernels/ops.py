"""Public entry points of the attention kernels (port of
``repro.kernels.ops``; of its shard_map branches, the paged MLA ones).

  impl='ref'    the plain PyTorch oracle (``ref``: dense, or the gathered
                paged view, one exact softmax)
  impl='kernel' the hand-written CUDA kernel for CUDA tensors; its plain
                blockwise version for CPU tensors (``flash_attention`` /
                ``mla_decode`` / ``mla_prefill`` wrappers)

The paged functions take a quantized pool's ``ckv_scales`` /
``krope_scales`` (N, bs, 1) f32: the kernels dequantize in registers,
the oracle on the gathered f32 view.

Under a mesh a rank calls the paged functions as they are, in the
place of the reference's shard_map: q carries this rank's heads (those
of its 'model' index) and its DP shard's batch rows, the block tables,
indices / lengths and n_valid the same rows (``core.mla`` cuts them with
``nn.sharding.Shard.local_rows``), and the block POOL and its scales are
the rank's whole replica (the MQA structure of absorbed MLA: head shards
re-read the same compact pool).  The kernels run at the local heads and
rows.
"""
from __future__ import annotations

from typing import Optional

from . import ref
from .flash_attention import flash_attention
from .mla_decode import mla_decode_kernel, mla_decode_paged_kernel
from .mla_prefill import mla_prefill_paged_kernel

IMPLS = ("ref", "kernel")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected {IMPLS}")


def attention(q, k, v, *, impl: str = "ref", causal: bool = True,
              window: Optional[int] = None, q_offset: int = 0,
              softmax_scale: Optional[float] = None):
    """q: (B, H, Lq, Dqk); k, v: (B, Hkv, Lk, D) -> (B, H, Lq, Dv).
    'kernel' is differentiable through the flash backward kernels."""
    _check_impl(impl)
    if impl == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset,
                                       softmax_scale=softmax_scale)
    return flash_attention(q, k, v, causal, window, q_offset, softmax_scale)


def mla_decode_attention(q_full, ckv, krope, index: int, *,
                         impl: str = "ref",
                         softmax_scale: Optional[float] = None,
                         rescale: str = "exp_add"):
    """Absorbed-MLA decode over a contiguous latent cache: q_full
    (B,H,Dl+Dr), ckv (B,S,Dl), krope (B,S,Dr), one host-int ``index``
    shared by the batch -> (B,H,Dl).  ``rescale`` as for
    :func:`mla_decode_paged_attention`."""
    _check_impl(impl)
    if impl == "ref":
        return ref.mla_decode_ref(q_full, ckv, krope, index,
                                  softmax_scale=softmax_scale)
    return mla_decode_kernel(q_full, ckv, krope, index,
                             softmax_scale=softmax_scale, rescale=rescale)


def mla_decode_paged_attention(q_full, ckv_pages, krope_pages, block_tables,
                               indices, *, impl: str = "ref",
                               softmax_scale: Optional[float] = None,
                               ckv_scales=None, krope_scales=None,
                               rescale: str = "exp_add"):
    """Paged absorbed-MLA decode: q_full (B,H,Dl+Dr), pool pages
    (N,bs,Dl)/(N,bs,Dr), block_tables (B,nb), per-request ``indices``
    (B,) -> (B,H,Dl).  ``rescale`` picks the kernel's online-softmax
    correction (AMLA 'exp_add' or classic 'mul'); the oracle's exact
    softmax ignores it."""
    _check_impl(impl)
    if impl == "ref":
        return ref.mla_decode_paged_ref(q_full, ckv_pages, krope_pages,
                                        block_tables, indices,
                                        softmax_scale=softmax_scale,
                                        ckv_scales=ckv_scales,
                                        krope_scales=krope_scales)
    return mla_decode_paged_kernel(q_full, ckv_pages, krope_pages,
                                   block_tables, indices,
                                   softmax_scale=softmax_scale,
                                   ckv_scales=ckv_scales,
                                   krope_scales=krope_scales,
                                   rescale=rescale)


def mla_prefill_paged_attention(q_full, ckv_pages, krope_pages, block_tables,
                                lengths, n_valid, *, impl: str = "ref",
                                softmax_scale: Optional[float] = None,
                                ckv_scales=None, krope_scales=None,
                                rescale: str = "exp_add"):
    """Paged chunked-prefill MLA attention: q_full (B,C,H,Dl+Dr), pool
    pages (N,bs,Dl)/(N,bs,Dr), block_tables (B,nb), per-request
    ``lengths``/``n_valid`` (B,) -> (B,C,H,Dl).  See
    :func:`mla_decode_paged_attention` for ``impl`` and ``rescale``."""
    _check_impl(impl)
    if impl == "ref":
        return ref.mla_prefill_paged_ref(q_full, ckv_pages, krope_pages,
                                         block_tables, lengths, n_valid,
                                         softmax_scale=softmax_scale,
                                         ckv_scales=ckv_scales,
                                         krope_scales=krope_scales)
    return mla_prefill_paged_kernel(q_full, ckv_pages, krope_pages,
                                    block_tables, lengths, n_valid,
                                    softmax_scale=softmax_scale,
                                    ckv_scales=ckv_scales,
                                    krope_scales=krope_scales,
                                    rescale=rescale)
