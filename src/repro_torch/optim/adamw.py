"""AdamW as plain functions over the parameter tree (port of
``repro.optim.adamw``; not ``torch.optim.AdamW``, whose clip and decay
differ from the reference's).

State is a dict {step, mu, nu}; ``mu``/``nu`` mirror the param tree in
``AdamWConfig.moment_dtype`` (f32 by default).  As in the reference: the
gradient is clipped by its global norm with scale min(1, c / max(norm,
1e-12)), decay applies only to leaves with ndim >= 2, and the bias
correction uses the new step.  The reference counts ndim on its stacked
layout, where a scanned period's leaves carry a leading layer axis, so
its period norm scales decay while the unstacked ones do not; the port
keeps a period as a list of per-layer trees and counts each list level
as that axis, to compute the same update.

Unlike the reference, :func:`update` works **in place**: it overwrites
the parameter and moment tensors it is given and returns the same
objects.  At full DeepSeek-V2 width the reference's functional form
does not fit one card: it makes an f32 copy of every gradient to clip
it, and several f32 temporaries per leaf, and the MoE ``gate_up`` leaf
alone has 2.52 B elements (10 GB per f32 copy).  So the norm is taken
leaf by leaf, the clip scale is folded into the update, and each leaf is
updated in slices along its first axis of at most ``SLICE_ELEMENTS``
elements (128 MB per f32 temporary).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Tuple, Union

import torch

SLICE_ELEMENTS = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32   # update math runs in f32 either way


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of trees of nested dicts and lists."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def init(params, cfg: AdamWConfig = None) -> Dict[str, Any]:
    md = cfg.moment_dtype if cfg is not None else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=md, device=p.device)
    dev = next(tree_leaves(params)).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


def _slices(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of ``ts`` along the first axis, each of at most
    SLICE_ELEMENTS elements (0-d tensors whole)."""
    t0 = ts[0]
    if t0.dim() == 0 or t0.numel() <= SLICE_ELEMENTS:
        yield ts
        return
    rows = max(1, SLICE_ELEMENTS // (t0.numel() // t0.shape[0]))
    for i in range(0, t0.shape[0], rows):
        yield tuple(t[i:i + rows] for t in ts)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = None
    for x in tree_leaves(tree):
        for (s,) in _slices(x):
            sq = torch.sum(torch.square(s.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(f32 grads scaled to global norm <= max_norm, norm).  ``update``
    does not call it (it folds the scale in instead); kept for parity."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place (see the module docstring).  Returns
    (params, state, metrics) — the same params and moment tensors,
    overwritten."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr = cfg.lr(step) if callable(cfg.lr) else torch.tensor(
        cfg.lr, dtype=torch.float32, device=step.device)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=step.device),
                          step.float())
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=step.device),
                          step.float())

    def upd(p, g, mu, nu, stacked):
        decay = p.dim() + stacked >= 2
        for ps, gs, ms, ns in _slices(p, g, mu, nu):
            g32 = gs.float() * scale
            m32 = b1 * ms.float() + (1 - b1) * g32
            n32 = b2 * ns.float() + (1 - b2) * g32 * g32
            delta = (m32 / bc1) / (torch.sqrt(n32 / bc2) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
            ms.copy_(m32)
            ns.copy_(n32)

    def walk(p, g, mu, nu, stacked):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], g[k], mu[k], nu[k], stacked)
        elif isinstance(p, (list, tuple)):
            for xs in zip(p, g, mu, nu):
                walk(*xs, stacked + 1)
        else:
            upd(p, g, mu, nu, stacked)

    walk(params, grads, state["mu"], state["nu"], 0)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
