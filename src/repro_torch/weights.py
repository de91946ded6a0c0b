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
across the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .models import model_defs
from .models.common import ModelConfig
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
