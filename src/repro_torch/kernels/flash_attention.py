"""Flash attention forward and backward (K4, K5, K6): the port of the
Pallas ``repro.kernels.flash_attention``.

    flash_attention(q, k, v, causal, window, q_offset, softmax_scale)

is a ``torch.autograd.Function`` (the reference's ``custom_vjp``): q
(B, H, Lq, Dqk), k (B, Hkv, Lk, Dqk), v (B, Hkv, Lk, Dv) -> (B, H, Lq, Dv)
in q's dtype, causal and/or sliding-window GQA attention with the
queries at absolute positions ``q_offset + i``.  The forward keeps the
f32 log-sum-exp; the backward computes delta = sum(dO * O) in PyTorch and
runs the dQ pass and the dK/dV pass.

Three CUDA kernels carry it (``csrc/flash_attention_fwd.cu``,
``flash_attention_bwd_dq.cu``, ``flash_attention_bwd_dkv.cu``), each
behind a wrapper here that checks its operands, launches it on the
current stream, raises on a nonzero ``cudaError_t`` and counts the launch
(``flash_fwd_kernel.launches`` and so on).  Each kernel has two routes
(``_launch.flash_fwd_plan``, ``flash_bwd_plan``): bf16 with head dims
that are multiples of 16 up to 256 and aligned operands (the training
and prefill paths) runs a tensor-core walk, ``csrc/flash_attention_fwd_tc.cuh``
for the forward, ``csrc/flash_attention_bwd_tc.cuh`` for dQ and dK/dV;
everything else the WMMA kernel; ``<wrapper>.last_plan`` is the plan of
the last launch (route, tiles, grid).  ``flash_bwd_walk_ref`` models the
backward walks on the CPU.  Beside each kernel is its plain
blockwise PyTorch version (``*_plain``: the Pallas kernel's arithmetic,
one key block at a time, in f32).  A wrapper runs the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises.

Layout: the kernels take element strides for the batch, head and length
dimensions and need only a contiguous last dimension, so the MLA path's
``q.transpose(1, 2)`` views of (B, L, H, D) tensors go in without a copy,
and the outputs (out, dQ, dK, dV) are allocated in their input's
dimension order, so ``out.transpose(1, 2)`` is contiguous again.  The
only copy is of a gradient dO whose last dimension is not contiguous
(none on the training path).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from ._launch import (DTYPE_CODES, flash_bwd_plan, flash_dkv_walk,
                      flash_dq_tc_rows, flash_dq_walk, flash_fwd_plan,
                      raise_on_error)

NEG_INF = -2.0 ** 30
LOG2E = 1.4426950408889634
MAX_D = 576          # the Pallas module's stated head-dim limit
BLOCK_K = 128        # key block of the plain versions


# ------------------------------------------------------- plain versions ----


def _mask(Lq: int, k0: int, nk: int, *, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """(Lq, nk) bool: query row i may attend key k0 + j."""
    q_pos = q_offset + torch.arange(Lq, device=device)[:, None]
    k_pos = k0 + torch.arange(nk, device=device)[None, :]
    m = torch.ones((Lq, nk), dtype=torch.bool, device=device)
    if causal:
        m &= k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    return m


def _grouped(x, Hkv: int):
    """(B, H, L, D) -> (B, Hkv, G, L, D) in f32."""
    B, H, L, D = x.shape
    return x.float().reshape(B, Hkv, H // Hkv, L, D)


def flash_fwd_plain(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    scale: float):
    """K4's plain version: the online-softmax forward over key blocks in
    f32.  Returns (out (B, H, Lq, Dv) in q's dtype, lse (B, H, Lq) f32)."""
    B, H, Lq, _ = q.shape
    Hkv, Lk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    qg = _grouped(q, Hkv)
    m = torch.full(qg.shape[:-1] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape[:-1] + (Dv,), device=q.device)
    for k0 in range(0, Lk, BLOCK_K):
        kb = k[:, :, k0:k0 + BLOCK_K].float()[:, :, None]
        vb = v[:, :, k0:k0 + BLOCK_K].float()[:, :, None]
        mask = _mask(Lq, k0, kb.shape[3], causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
        s = torch.where(mask, (qg @ kb.transpose(-1, -2)) * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vb
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype).reshape(B, H, Lq, Dv)
    lse = (m + torch.log(l_safe))[..., 0].reshape(B, H, Lq)
    return out, lse


def _probs_and_ds(qg, kb, vb, dog, lse, delta, mask, scale):
    s = (qg @ kb.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = dog @ vb.transpose(-1, -2)
    return p, p * (dp - delta) * scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                       window: Optional[int] = None, q_offset: int = 0,
                       scale: float):
    """K5's plain version: dQ accumulated over key blocks in f32."""
    B, H, Lq, Dqk = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    qg, dog = _grouped(q, Hkv), _grouped(do, Hkv)
    lse_g = lse.reshape(B, Hkv, H // Hkv, Lq, 1)
    dl_g = delta.reshape(B, Hkv, H // Hkv, Lq, 1)
    dq = torch.zeros_like(qg)
    for k0 in range(0, Lk, BLOCK_K):
        kb = k[:, :, k0:k0 + BLOCK_K].float()[:, :, None]
        vb = v[:, :, k0:k0 + BLOCK_K].float()[:, :, None]
        mask = _mask(Lq, k0, kb.shape[3], causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
        _, ds = _probs_and_ds(qg, kb, vb, dog, lse_g, dl_g, mask, scale)
        dq += ds @ kb
    return dq.to(q.dtype).reshape(B, H, Lq, Dqk)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: float):
    """K6's plain version: dK and dV of each key block, summed over the
    G query heads of its key head and over all query rows, in f32."""
    B, H, Lq, _ = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    qg, dog = _grouped(q, Hkv), _grouped(do, Hkv)
    lse_g = lse.reshape(B, Hkv, H // Hkv, Lq, 1)
    dl_g = delta.reshape(B, Hkv, H // Hkv, Lq, 1)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    for k0 in range(0, Lk, BLOCK_K):
        kb = k[:, :, k0:k0 + BLOCK_K].float()[:, :, None]
        vb = v[:, :, k0:k0 + BLOCK_K].float()[:, :, None]
        mask = _mask(Lq, k0, kb.shape[3], causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
        p, ds = _probs_and_ds(qg, kb, vb, dog, lse_g, dl_g, mask, scale)
        dv[:, :, k0:k0 + BLOCK_K] = (p.transpose(-1, -2) @ dog).sum(2)
        dk[:, :, k0:k0 + BLOCK_K] = (ds.transpose(-1, -2) @ qg).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_walk_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                       window: Optional[int] = None, q_offset: int = 0,
                       scale: float):
    """The CPU model of K5's and K6's tensor-core walks
    (csrc/flash_attention_bwd_tc.cuh), for the tests: (dQ, dK, dV) summed
    over exactly the blocks the walks visit (``_launch.flash_dq_walk``,
    ``flash_dkv_walk``), pairs masked only in 'edge' blocks, p = exp2(s c
    - lse log2(e)) and dS in f32, rounded to q's dtype only as operands of
    the accumulating products, which accumulate in f32."""
    B, H, Lq, Dqk = q.shape
    Hkv, Lk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    rnd = lambda x: x.to(q.dtype).float()
    qg, dog = _grouped(q, Hkv), _grouped(do, Hkv)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    lse_g = lse.reshape(B, Hkv, G, Lq, 1) * LOG2E
    dl_g = delta.reshape(B, Hkv, G, Lq, 1)
    opts = dict(causal=causal, window=window, q_offset=q_offset)

    def block(r0, r1, k0, k1, edge):
        """p and dS of query rows [r0, r1) x keys [k0, k1)."""
        s = qg[..., r0:r1, :] @ kf[..., k0:k1, :].transpose(-1, -2)
        p = torch.exp2(s * (scale * LOG2E) - lse_g[..., r0:r1, :])
        if edge:
            mask = _mask(Lq, k0, k1 - k0, device=q.device, **opts)[r0:r1]
            p = torch.where(mask, p, 0.0)
        dp = dog[..., r0:r1, :] @ vf[..., k0:k1, :].transpose(-1, -2)
        return p, p * (dp - dl_g[..., r0:r1, :]) * scale

    dq = torch.zeros_like(qg)
    for r0, k0, cls in flash_dq_walk(Lq, Lk, rows=flash_dq_tc_rows(Dqk, Dv),
                                     **opts):
        if cls != "skip" and r0 < Lq:
            r1, k1 = min(r0 + 16, Lq), min(k0 + 64, Lk)
            _, ds = block(r0, r1, k0, k1, cls == "edge")
            dq[..., r0:r1, :] += rnd(ds) @ kf[..., k0:k1, :]
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for _, _, kb0, qb0, cls in flash_dkv_walk(Lq, Lk, **opts):
        if cls != "skip":
            kb1, qb1 = min(kb0 + 16, Lk), min(qb0 + 32, Lq)
            p, ds = block(qb0, qb1, kb0, kb1, cls == "edge")
            dv[:, :, kb0:kb1] += (rnd(p).transpose(-1, -2)
                                  @ dog[..., qb0:qb1, :]).sum(2)
            dk[:, :, kb0:kb1] += (rnd(ds).transpose(-1, -2)
                                  @ qg[..., qb0:qb1, :]).sum(2)
    return (dq.to(q.dtype).reshape(B, H, Lq, Dqk), dk.to(k.dtype),
            dv.to(v.dtype))


# --------------------------------------------------------- CUDA wrappers ---


_LL = ctypes.c_longlong


def _check(q, k, v, *more) -> None:
    """Raise ValueError unless the operands are what the kernels take."""
    tensors = (q, k, v) + more
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the flash-attention kernels need every operand "
                         f"on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernels take "
                         f"{sorted(map(str, DTYPE_CODES))}")
    if any(t.dtype != q.dtype for t in (k, v) + more[:1]):
        raise ValueError("q, k, v (and dO) must share one dtype, got "
                         f"{[t.dtype for t in (q, k, v) + more[:1]]}")
    if any(t.dim() != 4 for t in (q, k, v)):
        raise ValueError("q, k, v must be (B, heads, L, D)")
    B, H, Lq, Dqk = q.shape
    _, Hkv, Lk, Dk = k.shape
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or Dk != Dqk
            or Hkv == 0 or H % Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k (B, Hkv, Lk, Dqk), "
                         f"v (B, Hkv, Lk, Dv) with H % Hkv == 0")
    if not (0 < Dqk <= MAX_D and 0 < v.shape[-1] <= MAX_D):
        raise ValueError(f"head dims must be in 1..{MAX_D}, got Dqk={Dqk}, "
                         f"Dv={v.shape[-1]}")
    if any(t.stride(-1) != 1 for t in (q, k, v) + more[:1]):
        raise ValueError("the kernels need a contiguous last dimension")


def _check_rows(q, *rows) -> None:
    shape = q.shape[:3]
    for t in rows:
        if t.dtype != torch.float32 or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(f"lse and delta must be contiguous f32 "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _empty_like_layout(t, shape, dtype=None):
    """An empty tensor of ``shape`` whose batch/head/length dimensions are
    laid out in ``t``'s order (last dimension contiguous)."""
    perm = sorted(range(3), key=lambda i: (-t.stride(i), i)) + [3]
    base = torch.empty([shape[i] for i in perm], dtype=dtype or t.dtype,
                       device=t.device)
    return base.permute([perm.index(i) for i in range(4)])


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (_LL * len(vals))(*vals)


def _dims(q, k, v, causal, window, q_offset, loads, *extra):
    """The kernels' int arguments; ``extra``: the plan's route (1 for
    'tc') and tiles."""
    B, H, Lq, Dqk = q.shape
    Hkv, Lk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    es = q.element_size()
    vec = all(t.data_ptr() % 16 == 0
              and all(s * es % 16 == 0 for s in t.stride()[:3])
              for t in loads) and Dqk * es % 16 == 0 and Dv * es % 16 == 0
    vals = [B, H, Hkv, Lq, Lk, Dqk, Dv, int(causal), int(window is not None),
            int(window or 0), int(q_offset), DTYPE_CODES[q.dtype], int(vec),
            *extra]
    return (ctypes.c_int * len(vals))(*vals)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_kernel(q, k, v, *, causal: bool = True,
                     window: Optional[int] = None, q_offset: int = 0,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (out (B, H, Lq, Dv) in q's dtype and layout, lse (B, H, Lq)
    f32).  CPU tensors run :func:`flash_fwd_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
    _check(q, k, v)
    B, H, Lq, _ = q.shape
    out = _empty_like_layout(q, (B, H, Lq, v.shape[-1]))
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    plan = flash_fwd_plan(q, k, v, out, scale)
    tc = plan["route"] == "tc"
    err = build.load("flash_attention_fwd").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v, out),
        _dims(q, k, v, causal, window, q_offset, (q, k, v), int(tc),
              *(0, 0) if tc else plan["tiles"]), float(scale), _stream(q))
    raise_on_error(err, "flash_attention_fwd")
    flash_fwd_kernel.launches += 1
    flash_fwd_kernel.last_plan = plan
    return out, lse


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: float) -> torch.Tensor:
    """K5: dQ (B, H, Lq, Dqk) in q's dtype and layout.  CPU tensors run
    :func:`flash_bwd_dq_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                  window=window, q_offset=q_offset,
                                  scale=scale)
    _check(q, k, v, do, lse, delta)
    _check_rows(q, lse, delta)
    if do.shape != q.shape[:3] + v.shape[-1:]:
        raise ValueError(f"dO must be {tuple(q.shape[:3] + v.shape[-1:])}, "
                         f"got {tuple(do.shape)}")
    dq = _empty_like_layout(q, q.shape)
    if dq.numel() == 0:
        return dq
    plan = flash_bwd_plan("dq", q, k, v, do, (dq,), scale)
    err = build.load("flash_attention_bwd_dq").flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq),
        _dims(q, k, v, causal, window, q_offset, (q, k, v, do),
              int(plan["route"] == "tc"), *plan["tiles"]),
        float(scale), _stream(q))
    raise_on_error(err, "flash_attention_bwd_dq")
    flash_bwd_dq_kernel.launches += 1
    flash_bwd_dq_kernel.last_plan = plan
    return dq


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, *, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: (dK in k's dtype and layout, dV in v's).  CPU tensors run
    :func:`flash_bwd_dkv_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                   window=window, q_offset=q_offset,
                                   scale=scale)
    _check(q, k, v, do, lse, delta)
    _check_rows(q, lse, delta)
    if do.shape != q.shape[:3] + v.shape[-1:]:
        raise ValueError(f"dO must be {tuple(q.shape[:3] + v.shape[-1:])}, "
                         f"got {tuple(do.shape)}")
    dk = _empty_like_layout(k, k.shape)
    dv = _empty_like_layout(v, v.shape)
    if dk.numel() == 0:
        return dk, dv
    if q.numel() == 0:               # no query attends: zero gradients
        return dk.zero_(), dv.zero_()
    plan = flash_bwd_plan("dkv", q, k, v, do, (dk, dv), scale)
    err = build.load("flash_attention_bwd_dkv").flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv),
        _dims(q, k, v, causal, window, q_offset, (q, k, v, do),
              int(plan["route"] == "tc"), *plan["tiles"]),
        float(scale), _stream(q))
    raise_on_error(err, "flash_attention_bwd_dkv")
    flash_bwd_dkv_kernel.launches += 1
    flash_bwd_dkv_kernel.last_plan = plan
    return dk, dv


flash_fwd_kernel.launches = 0
flash_fwd_kernel.last_plan = None
flash_bwd_dq_kernel.launches = 0
flash_bwd_dq_kernel.last_plan = None
flash_bwd_dkv_kernel.launches = 0
flash_bwd_dkv_kernel.last_plan = None


# ------------------------------------------------------- autograd Function -


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        out, lse = flash_fwd_kernel(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = torch.sum(do.float() * out.float(), dim=-1).contiguous()
        dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, **ctx.opts)
        dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, softmax_scale: Optional[float] = None):
    """q: (B, H, Lq, Dqk); k, v: (B, Hkv, Lk, Dqk/Dv) -> (B, H, Lq, Dv),
    differentiable in q, k and v."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                 float(scale))
