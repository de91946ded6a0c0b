"""Checks shared by the CUDA kernel wrappers (``mla_decode``,
``mla_prefill``): what the kernels take, validated before any pointer is
handed to them."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DL = 512          # csrc/mla_paged_common.cuh: kMaxDl
MAX_DR = 512
TILE = 16             # csrc/mla_paged_common.cuh: kTile


def check_pool_args(q_full, ckv_pages, krope_pages, block_tables, *ints):
    """Raise ValueError unless the tensors are what the paged kernels
    take: one CUDA device, contiguous, q and pool in one float dtype the
    kernels are built for, int32 tables and per-request ints."""
    tensors = (q_full, ckv_pages, krope_pages, block_tables) + ints
    dev = q_full.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the paged kernels need every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q_full.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q_full.dtype}; the kernels "
                         f"take {sorted(map(str, DTYPE_CODES))}")
    if ckv_pages.dtype != q_full.dtype or krope_pages.dtype != q_full.dtype:
        raise ValueError("q_full, ckv_pages and krope_pages must share one "
                         f"dtype, got {q_full.dtype}, {ckv_pages.dtype}, "
                         f"{krope_pages.dtype}")
    for t in (block_tables,) + ints:
        if t.dtype != torch.int32:
            raise ValueError(f"block tables and lengths must be int32, got "
                             f"{t.dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the paged kernels take contiguous tensors")
    if ckv_pages.dim() != 3 or krope_pages.dim() != 3 \
            or ckv_pages.shape[:2] != krope_pages.shape[:2]:
        raise ValueError(f"pool pages must be (N, bs, Dl) and (N, bs, Dr), "
                         f"got {tuple(ckv_pages.shape)} and "
                         f"{tuple(krope_pages.shape)}")
    Dl, Dr = ckv_pages.shape[-1], krope_pages.shape[-1]
    if q_full.shape[-1] != Dl + Dr:
        raise ValueError(f"q_full's last dim {q_full.shape[-1]} != "
                         f"Dl + Dr = {Dl + Dr}")
    if Dl % TILE or not 0 < Dl <= MAX_DL or not 0 < Dr <= MAX_DR:
        raise ValueError(f"the kernels take Dl a multiple of {TILE} up to "
                         f"{MAX_DL} and 0 < Dr <= {MAX_DR}, got Dl={Dl}, "
                         f"Dr={Dr}")
    B = q_full.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or any(t.shape != (B,) for t in ints):
        raise ValueError(f"block_tables must be (B, nb) and lengths (B,) "
                         f"with B = {B}")


def raise_on_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
