"""Wrapper of the paged chunked-prefill MLA attention CUDA kernel (K2,
``csrc/mla_prefill_paged.cu``), the port of the Pallas
``repro.kernels.mla_prefill.mla_prefill_paged_kernel``.

The pool is bf16 / f32 or int8 / fp8 with per-slot scales.  For CUDA
tensors it launches the kernel on the current stream (and raises if it
cannot); for CPU tensors it runs the kernel's plain PyTorch version,
``ref.mla_prefill_paged_ref`` with the same ``rescale``.  Nothing else
falls back.  bf16 q runs the tensor-core split-KV walk that K1 runs
(``csrc/mla_decode_tc.cuh``), a CTA for 64 heads of one (request, chunk
row): the wrapper plans the splits (``_launch.prefill_plan``) and
allocates the f32 partials, the library launches the walk and its
combine kernel; f32 q runs the CUDA-core walk.
``mla_prefill_paged_kernel.launches`` counts wrapper calls that launched
the kernel (the combine included); ``.last_plan`` is the plan of the last
launch (``n_split`` 0 for the CUDA-core walk).  Its CPU model is
``ref.mla_prefill_split_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, ref
from ._launch import (DTYPE_CODES, check_pool_args, check_rescale,
                      prefill_plan, ptr, raise_on_error, tc_workspace)


def mla_prefill_paged_kernel(q_full, ckv_pages, krope_pages, block_tables,
                             lengths, n_valid, *,
                             softmax_scale: Optional[float] = None,
                             ckv_scales=None, krope_scales=None,
                             rescale: str = "exp_add"):
    """Paged chunked-prefill flash attention over the latent block pool.

    q_full (B, C, H, Dl+Dr); ckv_pages (N, bs, Dl); krope_pages
    (N, bs, Dr); block_tables (B, nb) int32; lengths (B,) int32 — absolute
    position of each row's first chunk token; n_valid (B,) int32 — real
    tokens per row (0 = idle slot -> zero rows).  A quantized pool passes
    ``ckv_scales`` / ``krope_scales`` (N, bs, 1) f32, as for the decode
    kernel.  Returns (B, C, H, Dl) in q_full's dtype.  ``rescale``:
    'exp_add' (AMLA, default) or 'mul'."""
    check_rescale(rescale)
    ref.check_scales(ckv_scales, krope_scales)
    B, C, H, D = q_full.shape
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q_full.device.type == "cpu":
        return ref.mla_prefill_paged_ref(q_full, ckv_pages, krope_pages,
                                         block_tables, lengths, n_valid,
                                         softmax_scale=scale, rescale=rescale,
                                         ckv_scales=ckv_scales,
                                         krope_scales=krope_scales)
    pool_code = check_pool_args(q_full, ckv_pages, krope_pages, block_tables,
                                lengths, n_valid, ckv_scales=ckv_scales,
                                krope_scales=krope_scales)
    N, bs, Dl = ckv_pages.shape
    Dr, nb = krope_pages.shape[-1], block_tables.shape[1]
    out = torch.empty((B, C, H, Dl), dtype=q_full.dtype, device=q_full.device)
    if B == 0 or C == 0:
        return out
    plan = prefill_plan(q_full, Dl, Dr, nb, bs, (ckv_pages, krope_pages))
    ws = None
    if plan["n_split"]:
        ws = tc_workspace(q_full, B * C, H, Dl, plan["n_split"])
    err = build.load("mla_prefill_paged").mla_prefill_paged(
        q_full.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
        ptr(ckv_scales), ptr(krope_scales), block_tables.data_ptr(),
        lengths.data_ptr(), n_valid.data_ptr(), out.data_ptr(), B, C, H, Dl,
        Dr, N, bs, nb, float(scale), DTYPE_CODES[q_full.dtype], pool_code,
        int(rescale == "exp_add"), ptr(ws), plan["n_split"],
        plan["split_pos"],
        torch.cuda.current_stream(q_full.device).cuda_stream)
    raise_on_error(err, "mla_prefill_paged")
    mla_prefill_paged_kernel.launches += 1
    mla_prefill_paged_kernel.last_plan = plan
    return out


mla_prefill_paged_kernel.launches = 0
mla_prefill_paged_kernel.last_plan = None
