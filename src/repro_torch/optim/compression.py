"""Error-feedback top-k gradient compression (port of
``repro.optim.compression``).

Each step adds the carried error to the fresh gradient, keeps the top-k
fraction of entries by magnitude, and carries the residual: ``sent +
new_error == grad + error_in`` exactly.  The operator works leaf by leaf
with a per-leaf k on trees of nested dicts and lists, keeps the mask
dense (a threshold on |g|, no scatter) and is deterministic.  Leaves
under ``min_elems`` pass through whole.  The threshold is the k-th
largest |g| (``_kth_largest``), so a tie at it keeps every tied entry
(more than k), as in the reference.

The arithmetic is the reference's, term for term, so the results are
bitwise equal to it: ``sent = g * mask`` with an f32 mask (a dropped
negative entry sends -0.0) and ``error = g - sent``.  The temporaries
are reused in place: beside its input and error a leaf costs two f32
copies of itself (``g + err``, which becomes the new error, and one
buffer for |g|, the mask and ``sent``) and the selection's own.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .adamw import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TopKConfig:
    fraction: float = 0.01          # keep top 1% of entries per leaf
    min_elems: int = 1024           # leaves smaller than this pass through


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_leaf(g, err, fraction: float, min_elems: int):
    g = g.to(torch.float32) + err
    n = g.numel()
    if n < min_elems:
        return g, torch.zeros_like(g)
    k = max(1, int(n * fraction))
    mask = g.abs()
    thresh = _kth_largest(mask.reshape(-1), k)
    sent = mask.ge_(thresh).mul_(g)         # mask * g == g * mask
    return sent, g.sub_(sent)


def _kth_largest(flat, k: int):
    """The k-th largest value of ``flat``, exactly.  On the card the
    smallest of ``torch.topk``'s k (its multi-block radix select); on the
    CPU, where topk partially sorts one row on one core, the (n - k +
    1)-th smallest of ``torch.kthvalue`` (a quickselect).  Both select
    the same element value."""
    if flat.is_cuda:
        return torch.topk(flat, k, sorted=False).values.min()
    return torch.kthvalue(flat, flat.numel() - k + 1).values


def compress(cfg: TopKConfig, grads, error):
    """Returns (sparse_grads, new_error). sparse + error == grads + error_in."""
    out = tree_map(lambda g, e: _compress_leaf(g, e, cfg.fraction,
                                               cfg.min_elems), grads, error)
    return _pick(out, 0), _pick(out, 1)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]          # a leaf's (sent, error) pair


def compression_ratio(cfg: TopKConfig, params) -> float:
    """Effective bytes ratio of the compressed all-reduce: top-k as
    (value+index) pairs = k * 8 bytes vs n * 4 bytes dense."""
    total_n, total_sent = 0, 0.0
    for p in tree_leaves(params):
        n = p.numel()
        total_n += n
        total_sent += n if n < cfg.min_elems else \
            max(1, int(n * cfg.fraction)) * 2
    return total_sent / max(total_n, 1)
