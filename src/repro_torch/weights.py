"""Move a ``repro`` (JAX) parameter tree into the port.

The JAX package stacks the weights of each repeating period of
``layer_plan`` along a leading axis (its layer scan), and so the layers
of whisper's encoder and decoder; the port keeps one dict per layer, in
a list (``period``, ``encoder``, ``decoder``).  :func:`from_jax_params`
walks the port's own parameter definitions, takes each leaf from the JAX
tree (given as numpy arrays, ``jax.device_get`` of the params), unstacks
each list's leaves per layer, checks every shape, and puts the result on
``device``.  With it the two
packages compute the same function in the parity tests.
:func:`opt_state_from_jax` carries a JAX AdamW state {step, mu, nu}
across the same way.  :func:`shard_params` keeps one rank's shards of a
tree under a mesh's sharding policy; ``nn.sharding.gather_tensor``
recovers each full leaf from the ranks' shards.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .models import model_defs
from .models.common import ModelConfig
from .nn import module as nnm
from .nn import sharding as shd
from .nn.module import P


def _tensor(a, p: P, path: str, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"{path}: JAX leaf has shape {a.shape}, the port "
                         f"expects {p.shape}")
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: no numpy twin
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def _take(defs, src, path: str, dtype, device, period: Optional[int] = None):
    if isinstance(defs, P):
        return _tensor(src if period is None else np.asarray(src)[period],
                       defs, path, dtype, device)
    if set(defs) - set(src):
        raise KeyError(f"{path}: JAX tree lacks {sorted(set(defs) - set(src))}")
    # leaves the port derives itself (w_absorb) are not taken over
    return {k: _take(v, src[k], f"{path}/{k}", dtype, device, period)
            for k, v in defs.items()}


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device="cuda", dtype: Optional[torch.dtype] = None):
    """The port's parameter tree for ``cfg`` holding the values of the JAX
    tree ``tree`` (numpy leaves), on ``device``, cast to ``dtype`` if
    given."""
    out = {}
    for k, d in model_defs(cfg).items():
        if isinstance(d, list):          # stacked on a leading axis there
            out[k] = [_take(layer, tree[k], f"{k}[{i}]", dtype, device,
                            period=i) for i, layer in enumerate(d)]
        else:
            out[k] = _take(d, tree[k], k, dtype, device)
    return out


def opt_state_from_jax(state: Dict[str, Any], cfg: ModelConfig, *,
                       device="cuda"):
    """The port's AdamW state for ``cfg`` holding the JAX state ``state``
    ({step, mu, nu}, numpy leaves), moments kept in their dtype."""
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device),
            "mu": from_jax_params(state["mu"], cfg, device=device),
            "nu": from_jax_params(state["nu"], cfg, device=device)}


def local_shape(shape, entries, mesh):
    """The shape of one rank's shard of a ``shape`` tensor under the spec
    ``entries``."""
    out = []
    for n, entry in zip(shape, entries):
        k = 1
        for a in shd._names(entry, mesh):
            k *= mesh.size(a)
        out.append(n // k)
    return tuple(out)


def shard_params(params, cfg: ModelConfig, mesh, policy: str = "serve"):
    """This rank's shard of every leaf of ``params`` (``cfg``'s tree, with
    or without attached ``w_absorb`` leaves) under the sharding rules of
    ``policy`` over ``mesh`` (``nn.sharding.make_rules``), moved to the
    mesh's device.  A leaf that already has its shard's shape is kept as
    it is, so a rank may build its shards itself, leaf by leaf."""
    from .runtime.steps import paged_param_defs
    rules = shd.make_rules(mesh, mode=policy, cfg=cfg)

    def take(t, p: P, path: str):
        entries = shd.spec(p.axes, rules)
        if tuple(t.shape) == tuple(p.shape):
            t = shd.shard_tensor(t, entries, mesh)
        elif tuple(t.shape) != local_shape(p.shape, entries, mesh):
            raise ValueError(f"{path}: shape {tuple(t.shape)} is neither "
                             f"{p.shape} nor its shard's")
        return t.to(mesh.device)

    def walk(node, defs, path):
        if isinstance(defs, P):
            return take(node, defs, path)
        if isinstance(node, dict):
            return {k: walk(v, defs[k], f"{path}/{k}")
                    for k, v in node.items()}
        return [walk(v, d, f"{path}[{i}]")
                for i, (v, d) in enumerate(zip(node, defs))]

    return walk(params, paged_param_defs(params, cfg), "")


def init_sharded_params(cfg: ModelConfig, mesh, policy: str = "serve", *,
                        seed: int, dtype=torch.float32):
    """This rank's shards of ``nnm.init_params(model_defs(cfg), seed=seed,
    dtype=dtype, device=mesh.device)``, drawn leaf by leaf: each full
    leaf is drawn from the same generator walk (so its bits are
    init_params') and only this rank's shard is kept, so at most one full
    leaf lives at a time."""
    rules = shd.make_rules(mesh, mode=policy, cfg=cfg)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(seed)

    def draw(_, p: P):
        full = nnm._init_one(p, gen, dtype, mesh.device)
        return shd.shard_tensor(full, shd.spec(p.axes, rules), mesh)

    return nnm.map_defs(draw, model_defs(cfg))
