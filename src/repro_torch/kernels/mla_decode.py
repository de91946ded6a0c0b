"""Wrappers of the absorbed-MLA flash-decode CUDA kernels, the ports of
the Pallas kernels of ``repro.kernels.mla_decode``:

  * ``mla_decode_paged_kernel`` — K1, ``csrc/mla_decode_paged.cu``
    (``mla_decode_paged_kernel``): the paged pool, bf16 / f32 or int8 /
    fp8 with per-slot scales;
  * ``mla_decode_kernel`` — K3, ``csrc/mla_decode.cu``
    (``mla_decode_kernel``): one contiguous latent cache per request.

For CUDA tensors each launches its kernel on the current stream (and
raises if it cannot); for CPU tensors it runs the kernel's plain PyTorch
version in ``ref`` with the same ``rescale``.  Nothing else falls back.
bf16 q runs the tensor-core split-KV walk (``csrc/mla_decode_tc.cuh``):
the wrapper picks the split count (``_launch.split_plan``) and allocates
the f32 partials, and the library launches the walk and the combine
kernel that merges the splits; f32 q runs the CUDA-core walk.
``<wrapper>.launches`` counts wrapper calls that launched the kernel
(the combine included), and ``<wrapper>.last_plan`` is the plan of the
last launch (``n_split``, ``split_pos``, ``grid``; ``n_split`` 0 for the
CUDA-core walk).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, ref
from ._launch import (DTYPE_CODES, check_cache_args, check_pool_args,
                      check_rescale, decode_plan, ptr, raise_on_error,
                      rows_plan, tc_walk_takes, tc_workspace)


def mla_decode_paged_kernel(q_full, ckv_pages, krope_pages, block_tables,
                            indices, *, softmax_scale: Optional[float] = None,
                            ckv_scales=None, krope_scales=None,
                            rescale: str = "exp_add"):
    """Paged flash-decode over the latent block pool.

    q_full (B, H, Dl+Dr); ckv_pages (N, bs, Dl); krope_pages (N, bs, Dr);
    block_tables (B, nb) int32; indices (B,) int32 — newest valid position
    per request (-1 = inactive slot -> zero output).  A quantized pool
    (int8 / fp8 e4m3fn pages) passes ``ckv_scales`` / ``krope_scales``
    (N, bs, 1) f32; the kernel dequantizes in registers.  Returns
    (B, H, Dl) in q_full's dtype.  ``rescale``: 'exp_add' (AMLA, default)
    or 'mul'."""
    check_rescale(rescale)
    ref.check_scales(ckv_scales, krope_scales)
    B, H, D = q_full.shape
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q_full.device.type == "cpu":
        return ref.mla_decode_paged_ref(q_full, ckv_pages, krope_pages,
                                        block_tables, indices,
                                        softmax_scale=scale, rescale=rescale,
                                        ckv_scales=ckv_scales,
                                        krope_scales=krope_scales)
    pool_code = check_pool_args(q_full, ckv_pages, krope_pages, block_tables,
                                indices, ckv_scales=ckv_scales,
                                krope_scales=krope_scales)
    N, bs, Dl = ckv_pages.shape
    Dr, nb = krope_pages.shape[-1], block_tables.shape[1]
    out = torch.empty((B, H, Dl), dtype=q_full.dtype, device=q_full.device)
    if B == 0:
        return out
    plan, ws = rows_plan(B, H), None
    if tc_walk_takes(q_full, Dl, Dr, (ckv_pages, krope_pages)):
        # splits of the table's reach: the indices stay on the device
        plan = decode_plan(nb * bs, B, H, q_full.device)
        ws = tc_workspace(q_full, B, H, Dl, plan["n_split"])
    err = build.load("mla_decode_paged").mla_decode_paged(
        q_full.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
        ptr(ckv_scales), ptr(krope_scales), block_tables.data_ptr(),
        indices.data_ptr(), out.data_ptr(), B, H, Dl, Dr, N, bs, nb,
        float(scale), DTYPE_CODES[q_full.dtype], pool_code,
        int(rescale == "exp_add"), ptr(ws), plan["n_split"],
        plan["split_pos"],
        torch.cuda.current_stream(q_full.device).cuda_stream)
    raise_on_error(err, "mla_decode_paged")
    mla_decode_paged_kernel.launches += 1
    mla_decode_paged_kernel.last_plan = plan
    return out


mla_decode_paged_kernel.launches = 0
mla_decode_paged_kernel.last_plan = None


def mla_decode_kernel(q_full, ckv, krope, index: int, *,
                      softmax_scale: Optional[float] = None,
                      rescale: str = "exp_add"):
    """Flash-decode over a contiguous latent cache.

    q_full (B, H, Dl+Dr) = [q_latent ; q_rope]; ckv (B, S, Dl), krope
    (B, S, Dr) in q's dtype, any S, any batch / position strides with a
    contiguous last dimension (views are read in place, nothing is
    padded or copied); ``index`` a host int — the newest valid position,
    shared by the batch (positions > index are never read; a negative
    index gives zero rows).  Returns (B, H, Dl) in q_full's dtype.
    ``rescale``: 'exp_add' (AMLA, default) or 'mul'."""
    check_rescale(rescale)
    if isinstance(index, torch.Tensor):
        raise TypeError("index must be a host int (a device scalar would "
                        "sync every step)")
    index = int(index)
    B, H, D = q_full.shape
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if q_full.device.type == "cpu":
        return ref.mla_decode_ref(q_full, ckv, krope, index,
                                  softmax_scale=scale, rescale=rescale)
    check_cache_args(q_full, ckv, krope)
    S, Dl, Dr = ckv.shape[1], ckv.shape[2], krope.shape[-1]
    out = torch.empty((B, H, Dl), dtype=q_full.dtype, device=q_full.device)
    if B == 0 or S == 0:
        return out.zero_()
    plan, ws = rows_plan(B, H), None
    strides = (ckv.stride(0), ckv.stride(1), krope.stride(0), krope.stride(1))
    if tc_walk_takes(q_full, Dl, Dr, (ckv, krope), strides):
        # index is a host int: exactly index + 1 positions to split
        plan = decode_plan(min(index + 1, S), B, H, q_full.device)
        ws = tc_workspace(q_full, B, H, Dl, plan["n_split"])
    err = build.load("mla_decode").mla_decode(
        q_full.data_ptr(), ckv.data_ptr(), krope.data_ptr(), out.data_ptr(),
        B, H, S, Dl, Dr, *strides, index, float(scale),
        DTYPE_CODES[q_full.dtype], int(rescale == "exp_add"), ptr(ws),
        plan["n_split"], plan["split_pos"],
        torch.cuda.current_stream(q_full.device).cuda_stream)
    raise_on_error(err, "mla_decode")
    mla_decode_kernel.launches += 1
    mla_decode_kernel.last_plan = plan
    return out


mla_decode_kernel.launches = 0
mla_decode_kernel.last_plan = None
