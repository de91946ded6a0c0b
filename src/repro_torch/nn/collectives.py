"""The collectives of a mesh axis, from ``dist.all_reduce`` and
``dist.broadcast`` alone.

Gloo takes CUDA tensors for those two calls (it stages them through the
host itself) and NCCL takes everything, so one code path runs on the
CPU, on ranks that share one card (gloo) and on ranks with a card each
(NCCL).  An all-gather is an all-reduce of a zero-filled buffer into
which each rank has written its own slice: exact, since x + 0 = x (a
-0.0 element comes back as +0.0).  Every function returns its input
untouched on an axis of size 1, and counts the bytes it hands to the
backend in ``mesh.collective_bytes``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_reduce_sum(x: torch.Tensor, mesh, axis: Optional[str]
                   ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (None: the whole
    mesh), the same bits on every rank; a new tensor."""
    n = mesh.world if axis is None else mesh.size(axis)
    if n == 1:
        return x
    y = x.contiguous().clone()
    mesh.collective_bytes += y.numel() * y.element_size()
    dist.all_reduce(y, group=mesh.group(axis))
    return y


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in
    coordinate order (every rank's ``x`` has the same shape)."""
    return all_gather_many([x], mesh, axis, [dim])[0]


def all_gather_many(xs, mesh, axis: str, dims):
    """:func:`all_gather` of each ``xs[i]`` on ``dims[i]``, in one
    all-reduce a dtype (the zero-filled buffers laid end to end)."""
    n = mesh.size(axis)
    if n == 1:
        return list(xs)
    out = [None] * len(xs)
    by_dtype: dict = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        bufs = []
        for i in idx:
            x, d = xs[i], dims[i] % xs[i].dim()
            shape = list(x.shape)
            k = shape[d]
            shape[d] = n * k
            buf = x.new_zeros(shape)
            buf.narrow(d, mesh.index(axis) * k, k).copy_(x)
            bufs.append(buf)
        flat = bufs[0].reshape(-1) if len(bufs) == 1 \
            else torch.cat([b.reshape(-1) for b in bufs])
        mesh.collective_bytes += flat.numel() * flat.element_size()
        dist.all_reduce(flat, group=mesh.group(axis))
        off = 0
        for i, buf in zip(idx, bufs):
            out[i] = flat[off:off + buf.numel()].view(buf.shape)
            off += buf.numel()
    return out


def all_gather_blocks(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``x`` gathered over several mesh axes at once, axis ``a`` on
    ``dims[a]``, in one all-reduce: each rank writes its block of the
    zero-filled whole (exact: each element comes from one rank)."""
    axes = [a for a in dims if mesh.size(a) > 1]
    if not axes:
        return x
    if len(axes) > 1 and len(axes) != sum(n > 1 for n in mesh.shape):
        raise ValueError(f"gathering over {axes} of a {mesh.shape} mesh")
    shape, box = list(x.shape), [slice(None)] * x.dim()
    for a in axes:
        d = dims[a] % x.dim()
        k = x.shape[d]
        shape[d] = k * mesh.size(a)
        box[d] = slice(mesh.index(a) * k, (mesh.index(a) + 1) * k)
    buf = x.new_zeros(shape)
    buf[tuple(box)] = x
    mesh.collective_bytes += buf.numel() * buf.element_size()
    dist.all_reduce(buf, group=mesh.group(axes[0] if len(axes) == 1
                                             else None))
    return buf


def broadcast(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of the mesh, in place."""
    if mesh.world == 1:
        return x
    mesh.collective_bytes += x.numel() * x.element_size()
    dist.broadcast(x, src=src, group=mesh.group(None))
    return x
