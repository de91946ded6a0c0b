"""Checks and launch plans shared by the kernel wrappers (``mla_decode``,
``mla_prefill``, ``flash_attention``): what the kernels take, validated
before any pointer is handed to them, and which route, split count, tiles
and grid a launch gets.  Each wrapper records the plan it launched as
``<wrapper>.last_plan``."""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .ref import RESCALES

# dtype codes of the C entry points (csrc/mla_paged_common.cuh: kF32 ...)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
POOL_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}   # quantized storage
MAX_DL = 512          # csrc/mla_paged_common.cuh: kMaxDl
MAX_DR = 512
TILE = 16             # csrc/mla_paged_common.cuh: kTile
ROWS = 16             # csrc/mla_paged_common.cuh: kRows, heads a CTA
# the tensor-core decode walk of csrc/mla_decode_tc.cuh (bf16 q)
TC_ROWS = 64          # kRowsTC: heads a CTA
TC_POS = 64           # kPos: positions a staged tile
TC_MAX_K = 576        # kMaxK: Dl + round16(Dr) its buffers hold


def check_rescale(rescale: str) -> None:
    if rescale not in RESCALES:
        raise ValueError(f"unknown rescale {rescale!r}; expected {RESCALES}")


def ptr(t) -> Optional[int]:
    """A tensor's device pointer for ctypes; None (NULL) for None."""
    return None if t is None else t.data_ptr()


def _check_devices(*tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the MLA kernels need every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")


def _check_q(q_full) -> None:
    if q_full.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q_full.dtype}; the kernels "
                         f"take {sorted(map(str, DTYPE_CODES))}")


def _check_widths(q_full, Dl: int, Dr: int) -> None:
    if q_full.shape[-1] != Dl + Dr:
        raise ValueError(f"q_full's last dim {q_full.shape[-1]} != "
                         f"Dl + Dr = {Dl + Dr}")
    if Dl % TILE or not 0 < Dl <= MAX_DL or not 0 < Dr <= MAX_DR:
        raise ValueError(f"the kernels take Dl a multiple of {TILE} up to "
                         f"{MAX_DL} and 0 < Dr <= {MAX_DR}, got Dl={Dl}, "
                         f"Dr={Dr}")


def check_pool_args(q_full, ckv_pages, krope_pages, block_tables, *ints,
                    ckv_scales=None, krope_scales=None) -> int:
    """Raise ValueError unless the tensors are what the paged kernels
    take: one CUDA device, contiguous, q in a float dtype the kernels are
    built for, the pool in q's dtype or quantized (int8 / fp8 e4m3fn)
    with (N, bs, 1) f32 scales for both leaves, int32 tables and
    per-request ints.  Returns the pool's dtype code."""
    scales = tuple(s for s in (ckv_scales, krope_scales) if s is not None)
    tensors = (q_full, ckv_pages, krope_pages, block_tables) + ints + scales
    _check_devices(*tensors)
    _check_q(q_full)
    if ckv_pages.dtype != krope_pages.dtype:
        raise ValueError(f"ckv_pages and krope_pages must share one dtype, "
                         f"got {ckv_pages.dtype}, {krope_pages.dtype}")
    if ckv_pages.dtype in POOL_CODES:
        if len(scales) != 2:
            raise ValueError(f"a {ckv_pages.dtype} pool needs ckv_scales and "
                             f"krope_scales")
        shape = tuple(ckv_pages.shape[:2]) + (1,)
        for s in scales:
            if s.dtype != torch.float32 or tuple(s.shape) != shape:
                raise ValueError(f"scales must be float32 {shape}, got "
                                 f"{s.dtype} {tuple(s.shape)}")
        code = POOL_CODES[ckv_pages.dtype]
    elif ckv_pages.dtype != q_full.dtype:
        raise ValueError(f"an unquantized pool must be in q_full's dtype "
                         f"{q_full.dtype}, got {ckv_pages.dtype}")
    elif scales:
        raise ValueError("scales come only with an int8 / fp8 pool")
    else:
        code = DTYPE_CODES[q_full.dtype]
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
    _check_widths(q_full, ckv_pages.shape[-1], krope_pages.shape[-1])
    B = q_full.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or any(t.shape != (B,) for t in ints):
        raise ValueError(f"block_tables must be (B, nb) and lengths (B,) "
                         f"with B = {B}")
    return code


def check_cache_args(q_full, ckv, krope) -> None:
    """Raise ValueError unless the operands are what the contiguous decode
    kernel takes: one CUDA device, q_full (B, H, Dl+Dr) contiguous, ckv
    (B, S, Dl) and krope (B, S, Dr) in q's dtype with a contiguous last
    dimension (any batch and position strides)."""
    _check_devices(q_full, ckv, krope)
    _check_q(q_full)
    if ckv.dtype != q_full.dtype or krope.dtype != q_full.dtype:
        raise ValueError(f"q_full, ckv and krope must share one dtype, got "
                         f"{q_full.dtype}, {ckv.dtype}, {krope.dtype}")
    if not q_full.is_contiguous():
        raise ValueError("q_full must be contiguous")
    if q_full.dim() != 3 or ckv.dim() != 3 or krope.dim() != 3 \
            or ckv.shape[:2] != krope.shape[:2] \
            or ckv.shape[0] != q_full.shape[0]:
        raise ValueError(f"expected q_full (B, H, Dl+Dr), ckv (B, S, Dl), "
                         f"krope (B, S, Dr); got {tuple(q_full.shape)}, "
                         f"{tuple(ckv.shape)}, {tuple(krope.shape)}")
    if ckv.stride(-1) != 1 or krope.stride(-1) != 1:
        raise ValueError("ckv and krope need a contiguous last dimension")
    _check_widths(q_full, ckv.shape[-1], krope.shape[-1])


def tc_walk_takes(q_full, Dl: int, Dr: int, tensors=(), strides=()) -> bool:
    """Whether a decode call runs the tensor-core walk: bf16 q, Dr a
    multiple of 8 and Dl + round16(Dr) <= TC_MAX_K (its copies move 16
    bytes of bf16, 8 of codes), every operand 16-byte aligned and every
    element stride a multiple of 8.  Anything else the checks admit (f32
    q above all) runs the CUDA-core walk ``attend_rows``."""
    return (q_full.dtype == torch.bfloat16 and Dr % 8 == 0
            and Dl + -(-Dr // 16) * 16 <= TC_MAX_K
            and all(t.data_ptr() % 16 == 0 for t in (q_full,) + tensors)
            and all(s % 8 == 0 for s in strides))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(n_pos: int, B: int, H: int, sms: int) -> Tuple[int, int]:
    """(n_split, split_pos) of the tensor-core walk over positions
    [0, n_pos): whole tiles of TC_POS positions a split, and as many
    splits as keep ceil(H / TC_ROWS) x B x n_split CTAs (one an SM, for
    their shared memory) within one wave of ``sms`` SMs; none is empty
    for a request that reaches n_pos."""
    tiles = -(-max(n_pos, 0) // TC_POS)
    if tiles == 0:
        return 1, TC_POS
    n = min(tiles, max(1, sms // (-(-H // TC_ROWS) * B)))
    per_split = -(-tiles // n)
    return -(-tiles // per_split), per_split * TC_POS


def decode_plan(n_pos: int, B: int, H: int, device,
                sms: Optional[int] = None) -> dict:
    """The launch plan of a bf16 decode call on the tensor-core walk:
    ``split_plan`` over n_pos positions on ``device``'s SMs (or ``sms``)
    and the grid (ceil(H / TC_ROWS), n_split, B).  The wrappers record
    the plan they launched as ``<wrapper>.last_plan``."""
    n_split, split_pos = split_plan(n_pos, B, H, sms or sm_count(device))
    return dict(n_split=n_split, split_pos=split_pos,
                grid=(-(-H // TC_ROWS), n_split, B))


def rows_plan(B: int, H: int) -> dict:
    """The launch plan of a call on ``attend_rows``: no splits, a CTA for
    every ROWS query rows of a request (H heads for decode, C x H
    (chunk row, head) pairs for prefill)."""
    return dict(n_split=0, split_pos=0, grid=(-(-H // ROWS), B))


MAX_GRID_YZ = 65535   # CUDA's limit on gridDim.y and gridDim.z


def prefill_plan(q_full, Dl: int, Dr: int, nb: int, bs: int,
                 tensors=(), sms: Optional[int] = None) -> dict:
    """The launch plan of a K2 (paged chunked prefill) call on q_full
    (B, C, H, Dl + Dr): the tensor-core walk when it takes the operands
    (``tc_walk_takes``) and B x C fits the grid's z, with ``split_plan``
    over the table's reach (nb x bs positions; the lengths stay on the
    device) for B x C rows of heads and the grid (ceil(H / TC_ROWS),
    n_split, B x C); else ``attend_rows`` (n_split 0) on C x H rows a
    request.  ``sms``: the SM count (default: q_full's device's)."""
    B, C, H, _ = q_full.shape
    if tc_walk_takes(q_full, Dl, Dr, tensors) and B * C <= MAX_GRID_YZ:
        return decode_plan(nb * bs, B * C, H, q_full.device, sms)
    return rows_plan(B, C * H)


# flash attention (K4, K5, K6): the forward's tensor-core walk
# (csrc/flash_attention_fwd_tc.cuh) and the WMMA kernels' tile choice
# (csrc/flash_common.cuh choose_tiles, fwd_smem / dq_smem / dkv_smem of
# csrc/flash_attention_{fwd,bwd_dq,bwd_dkv}.cu)
FLASH_TC_ROWS = 128    # kRowsQ: query rows a CTA
FLASH_TC_KEYS = 64     # kKeys: keys a staged tile
FLASH_TC_MAX_D = 256   # kMaxD
FLASH_TILES = ((64, 64), (64, 32), (32, 64), (32, 32), (16, 32), (32, 16),
               (16, 16))
SMEM_TWO_PER_SM = 113 * 1024
SMEM_MAX = 232448


def _flash_tc_takes(q, v, scale: float, tensors) -> bool:
    Dqk, Dv = q.shape[-1], v.shape[-1]
    return (q.dtype == torch.bfloat16 and scale > 0
            and Dqk % 16 == 0 and Dv % 16 == 0
            and Dqk <= FLASH_TC_MAX_D and Dv <= FLASH_TC_MAX_D
            and all(t.data_ptr() % 16 == 0
                    and all(s % 8 == 0 for s in t.stride()[:3])
                    for t in tensors))


def flash_fwd_tc_takes(q, k, v, out, scale: float) -> bool:
    """Whether a K4 call runs the tensor-core walk: bf16, Dqk and Dv
    multiples of 16 up to FLASH_TC_MAX_D, every operand 16-byte aligned
    and its batch, head and length strides multiples of 8 elements (its
    copies move 16 bytes), and a positive softmax scale (the walk takes
    the row max of the unscaled scores).  Anything else the checks admit
    (f32 above all) runs the WMMA kernel."""
    return _flash_tc_takes(q, v, scale, (q, k, v, out))


def flash_bwd_tc_takes(q, k, v, do, outs, scale: float) -> bool:
    """Whether a K5 / K6 call runs its tensor-core walk
    (csrc/flash_attention_bwd_tc.cuh): what ``flash_fwd_tc_takes`` asks,
    of q, k, v, dO and the gradients ``outs``; a positive scale keeps
    exp2(s scale log2(e) - lse log2(e)) one FFMA."""
    return _flash_tc_takes(q, v, scale, (q, k, v, do) + tuple(outs))


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _bytes(n: int, size: int) -> int:
    return -(-n * size // 128) * 128


def _tile(es: int, rows: int, cols: int) -> int:
    """Bytes of a (rows x cols) tile of ``es``-byte elements in a WMMA
    kernel's shared memory: rows padded by 16 bytes, arrays rounded to
    128 bytes (csrc/flash_common.cuh ``ld_of``, ``bytes_of``)."""
    return _bytes(rows * (_round16(cols) + 16 // es), es)


def _f32_tile(rows: int, cols: int) -> int:
    """The same for an f32 tile (``ldf_of``: rows padded by 4 floats)."""
    return _bytes(rows * (_round16(cols) + 4), 4)


def flash_fwd_smem(es: int, bq: int, bk: int, Dqk: int, Dv: int) -> int:
    """Shared memory of a WMMA forward CTA (``fwd_smem`` of
    csrc/flash_attention_fwd.cu) for elements of ``es`` bytes."""
    return (_tile(es, bq, Dqk) + _tile(es, bk, Dqk) + _tile(es, bk, Dv)
            + _f32_tile(bq, bk) + _tile(es, bq, bk) + _f32_tile(bq, Dv)
            + 3 * _bytes(bq, 4))


def flash_dq_smem(es: int, bq: int, bk: int, Dqk: int, Dv: int) -> int:
    """Shared memory of a WMMA K5 CTA (``dq_smem`` of
    csrc/flash_attention_bwd_dq.cu)."""
    return (_tile(es, bq, Dqk) + _tile(es, bq, Dv) + _tile(es, bk, Dqk)
            + _tile(es, bk, Dv) + 2 * _f32_tile(bq, bk) + _tile(es, bq, bk)
            + _f32_tile(bq, Dqk) + 2 * _bytes(bq, 4))


def flash_dkv_smem(es: int, bq: int, bk: int, Dqk: int, Dv: int) -> int:
    """Shared memory of a WMMA K6 CTA (``dkv_smem`` of
    csrc/flash_attention_bwd_dkv.cu)."""
    return (_tile(es, bk, Dqk) + _tile(es, bk, Dv) + _f32_tile(bk, Dqk)
            + _f32_tile(bk, Dv) + _tile(es, bq, Dqk) + _tile(es, bq, Dv)
            + 2 * _f32_tile(bq, bk) + 2 * _tile(es, bq, bk)
            + 2 * _bytes(bq, 4))


def flash_wmma_tiles(es: int, Dqk: int, Dv: int,
                     smem=flash_fwd_smem) -> Tuple[int, int]:
    """(bq, bk) of a WMMA flash kernel whose shared memory ``smem`` gives
    (the forward's by default; ``flash_dq_smem``, ``flash_dkv_smem``):
    the first candidate that fits two CTAs on an SM, else the first that
    fits one (``choose_tiles``; the kernels refuse any other pick)."""
    for limit in (SMEM_TWO_PER_SM, SMEM_MAX):
        for bq, bk in FLASH_TILES:
            if smem(es, bq, bk, Dqk, Dv) <= limit:
                return bq, bk
    raise ValueError(f"no WMMA tile fits head dims {Dqk}, {Dv}")


def flash_fwd_plan(q, k, v, out, scale: float) -> dict:
    """The launch plan of a K4 call: ``route`` 'tc' (the tensor-core
    walk, ``flash_fwd_tc_takes``) or 'wmma', the tiles (query rows, keys)
    a CTA takes, and the grid (ceil(Lq / rows), B x H)."""
    B, H, Lq, Dqk = q.shape
    if flash_fwd_tc_takes(q, k, v, out, scale):
        route, tiles = "tc", (FLASH_TC_ROWS, FLASH_TC_KEYS)
    else:
        route = "wmma"
        tiles = flash_wmma_tiles(q.element_size(), Dqk, v.shape[-1])
    return dict(route=route, tiles=tiles, grid=(-(-Lq // tiles[0]), B * H))


# flash attention backward (K5, K6): the tensor-core walks of
# csrc/flash_attention_bwd_tc.cuh
FLASH_BWD_KEYS = 64      # kKeys: K5's staged key tile, K6's keys a CTA
FLASH_BWD_QUERIES = 64   # kQueries: K6's staged query tile


def flash_dq_tc_rows(Dqk: int, Dv: int) -> int:
    """Query rows of a K5 CTA on the walk (``dq_rows``): 128, or 64 where
    the staged tiles of 128 rows would not fit shared memory."""
    return 128 if Dqk <= 192 and Dv <= 128 else 64


def flash_bwd_plan(kind: str, q, k, v, do, outs, scale: float) -> dict:
    """The launch plan of a K5 (``kind`` 'dq') or K6 ('dkv') call:
    ``route`` 'tc' (the tensor-core walk, ``flash_bwd_tc_takes``) or
    'wmma', the tiles (query rows, keys) and the grid: K5 (ceil(Lq /
    rows), B x H), K6 (ceil(Lk / keys), B x Hkv)."""
    B, H, Lq, Dqk = q.shape
    Hkv, Lk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if flash_bwd_tc_takes(q, k, v, do, outs, scale):
        route = "tc"
        tiles = ((flash_dq_tc_rows(Dqk, Dv), FLASH_BWD_KEYS) if kind == "dq"
                 else (FLASH_BWD_QUERIES, FLASH_BWD_KEYS))
    else:
        route = "wmma"
        tiles = flash_wmma_tiles(q.element_size(), Dqk, Dv,
                                 flash_dq_smem if kind == "dq"
                                 else flash_dkv_smem)
    grid = ((-(-Lq // tiles[0]), B * H) if kind == "dq"
            else (-(-Lk // tiles[1]), B * Hkv))
    return dict(route=route, tiles=tiles, grid=grid)


def _key_range(q0, q1, Lk, causal, window, q_offset):
    """csrc/flash_common.cuh ``Mask::key_range``."""
    lo, hi = 0, Lk
    if causal:
        hi = min(hi, q_offset + q1)
    if window is not None:
        lo = max(lo, q_offset + q0 - window + 1)
    return lo, max(hi, lo)


def _query_range(k0, k1, Lq, causal, window, q_offset):
    """csrc/flash_common.cuh ``Mask::query_range``."""
    lo, hi = 0, Lq
    if causal:
        lo = max(lo, k0 - q_offset)
    if window is not None:
        hi = min(hi, k1 - 1 + window - q_offset)
    return lo, max(hi, lo)


def flash_dq_walk(Lq: int, Lk: int, *, causal: bool, window: Optional[int],
                  q_offset: int, rows: int):
    """K5's walk as ``dq_tc_kernel`` takes it, for the CPU tests: yields
    (r0, k0, cls) for every 16-row warp block r0 of every CTA (``rows``
    query rows) and every 64-key tile k0 the CTA visits; ``cls`` is
    'skip' (the warp leaves the tile alone), 'interior' (no pair is
    masked) or 'edge' (pairs are masked one by one).  Tiles a CTA does
    not visit are not yielded."""
    kk = FLASH_BWD_KEYS
    for q0 in range(0, Lq, rows):
        k_lo, k_hi = _key_range(q0, min(q0 + rows, Lq), Lk, causal, window,
                                q_offset)
        t0 = k_lo // kk
        n_kt = (k_hi - 1) // kk - t0 + 1 if k_hi > k_lo else 0
        for r0 in range(q0, q0 + rows, 16):
            w_lo, w_hi = (_key_range(r0, min(r0 + 16, Lq), Lk, causal,
                                     window, q_offset) if r0 < Lq
                          else (0, 0))
            for t in range(n_kt):
                k0 = (t0 + t) * kk
                if not (w_hi > w_lo and k0 < w_hi and k0 + kk > w_lo):
                    cls = "skip"
                elif (k0 + kk > Lk
                      or (causal and k0 + kk - 1 > q_offset + r0)
                      or (window is not None
                          and k0 <= q_offset + r0 + 15 - window)):
                    cls = "edge"
                else:
                    cls = "interior"
                yield r0, k0, cls


def flash_dkv_walk(Lq: int, Lk: int, *, causal: bool,
                   window: Optional[int], q_offset: int):
    """K6's walk as ``dkv_tc_kernel`` takes it (for one query head; every
    head walks the same tiles), for the CPU tests: yields (k0, q0, kb0,
    qb0, cls) for every 64-key CTA k0, every 64-query tile q0 it visits
    and every (16 keys kb0 x 32 queries qb0) phase-1 block of it; ``cls``
    as in ``flash_dq_walk``."""
    kk, kq = FLASH_BWD_KEYS, FLASH_BWD_QUERIES
    for k0 in range(0, Lk, kk):
        q_lo, q_hi = _query_range(k0, min(k0 + kk, Lk), Lq, causal, window,
                                  q_offset)
        qt0 = q_lo // kq
        nqt = (q_hi - 1) // kq - qt0 + 1 if q_hi > q_lo else 0
        for t in range(nqt):
            q0 = (qt0 + t) * kq
            for kb0 in range(k0, k0 + kk, 16):
                b_lo, b_hi = (_query_range(kb0, min(kb0 + 16, Lk), Lq,
                                           causal, window, q_offset)
                              if kb0 < Lk else (0, 0))
                for qb0 in (q0, q0 + 32):
                    if not (kb0 < Lk and qb0 < Lq and qb0 < b_hi
                            and qb0 + 32 > b_lo):
                        cls = "skip"
                    elif (kb0 + 16 > Lk or qb0 + 32 > Lq
                          or (causal and kb0 + 15 > q_offset + qb0)
                          or (window is not None
                              and kb0 <= q_offset + qb0 + 31 - window)):
                        cls = "edge"
                    else:
                        cls = "interior"
                    yield k0, q0, kb0, qb0, cls


def tc_workspace(q_full, B: int, H: int, Dl: int, n_split: int):
    """The f32 partials of the tensor-core walk, (acc | m, l) of every
    (request, head, split): B * H * n_split * (Dl + 2) floats."""
    return torch.empty(B * H * n_split * (Dl + 2), dtype=torch.float32,
                       device=q_full.device)


def raise_on_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
