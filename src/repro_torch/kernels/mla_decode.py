"""Wrapper of the paged absorbed-MLA flash-decode CUDA kernel (K1,
``csrc/mla_decode_paged.cu``), the port of the Pallas
``repro.kernels.mla_decode.mla_decode_paged_kernel``.

For CUDA tensors it launches the kernel on the current stream (and raises
if it cannot); for CPU tensors it runs the kernel's plain PyTorch version,
``ref.mla_decode_paged_ref`` with the same ``rescale``.  Nothing else
falls back.  ``mla_decode_paged_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, ref
from ._launch import DTYPE_CODES, check_pool_args, raise_on_error


def mla_decode_paged_kernel(q_full, ckv_pages, krope_pages, block_tables,
                            indices, *, softmax_scale: Optional[float] = None,
                            rescale: str = "exp_add"):
    """Paged flash-decode over the latent block pool.

    q_full (B, H, Dl+Dr); ckv_pages (N, bs, Dl); krope_pages (N, bs, Dr);
    block_tables (B, nb) int32; indices (B,) int32 — newest valid position
    per request (-1 = inactive slot -> zero output).  Returns (B, H, Dl) in
    q_full's dtype.  ``rescale``: 'exp_add' (AMLA, default) or 'mul'."""
    if rescale not in ref.RESCALES:
        raise ValueError(f"unknown rescale {rescale!r}; expected "
                         f"{ref.RESCALES}")
    B, H, D = q_full.shape
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q_full.device.type == "cpu":
        return ref.mla_decode_paged_ref(q_full, ckv_pages, krope_pages,
                                        block_tables, indices,
                                        softmax_scale=scale, rescale=rescale)
    check_pool_args(q_full, ckv_pages, krope_pages, block_tables, indices)
    N, bs, Dl = ckv_pages.shape
    out = torch.empty((B, H, Dl), dtype=q_full.dtype, device=q_full.device)
    if B == 0:
        return out
    err = build.load("mla_decode_paged").mla_decode_paged(
        q_full.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
        block_tables.data_ptr(), indices.data_ptr(), out.data_ptr(),
        B, H, Dl, krope_pages.shape[-1], N, bs, block_tables.shape[1],
        float(scale), DTYPE_CODES[q_full.dtype], int(rescale == "exp_add"),
        torch.cuda.current_stream(q_full.device).cuda_stream)
    raise_on_error(err, "mla_decode_paged")
    mla_decode_paged_kernel.launches += 1
    return out


mla_decode_paged_kernel.launches = 0
