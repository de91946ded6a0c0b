"""Public entry points of the paged MLA attention kernels (port of
``repro.kernels.ops``, single device, without its shard_map branches).

  impl='ref'    the plain PyTorch oracle (``ref``: gathered view, one
                exact softmax)
  impl='kernel' the hand-written CUDA kernel for CUDA tensors; its plain
                blockwise version for CPU tensors (``mla_decode`` /
                ``mla_prefill`` wrappers)
"""
from __future__ import annotations

from typing import Optional

from . import ref
from .mla_decode import mla_decode_paged_kernel
from .mla_prefill import mla_prefill_paged_kernel

IMPLS = ("ref", "kernel")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected {IMPLS}")


def mla_decode_paged_attention(q_full, ckv_pages, krope_pages, block_tables,
                               indices, *, impl: str = "ref",
                               softmax_scale: Optional[float] = None,
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
                                        softmax_scale=softmax_scale)
    return mla_decode_paged_kernel(q_full, ckv_pages, krope_pages,
                                   block_tables, indices,
                                   softmax_scale=softmax_scale,
                                   rescale=rescale)


def mla_prefill_paged_attention(q_full, ckv_pages, krope_pages, block_tables,
                                lengths, n_valid, *, impl: str = "ref",
                                softmax_scale: Optional[float] = None,
                                rescale: str = "exp_add"):
    """Paged chunked-prefill MLA attention: q_full (B,C,H,Dl+Dr), pool
    pages (N,bs,Dl)/(N,bs,Dr), block_tables (B,nb), per-request
    ``lengths``/``n_valid`` (B,) -> (B,C,H,Dl).  See
    :func:`mla_decode_paged_attention` for ``impl`` and ``rescale``."""
    _check_impl(impl)
    if impl == "ref":
        return ref.mla_prefill_paged_ref(q_full, ckv_pages, krope_pages,
                                         block_tables, lengths, n_valid,
                                         softmax_scale=softmax_scale)
    return mla_prefill_paged_kernel(q_full, ckv_pages, krope_pages,
                                    block_tables, lengths, n_valid,
                                    softmax_scale=softmax_scale,
                                    rescale=rescale)
