"""Declarative parameter definitions and their initialization (port of
``repro.nn.module``).

A model is described by a tree (nested dicts / lists) of ``P`` leaves;
``init_params`` turns it into the same tree of tensors.  The port draws
from one ``torch.Generator`` on the target device, walking the tree in
order, with the JAX package's distributions (``normal``, ``embed``,
``fan_in``, ``ones``, ``zeros``) — the same distributions, not the same
bits (tests that compare the two packages move weights across with
``repro_torch.weights.from_jax_params``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

Tree = Any  # nested dict / list


@dataclasses.dataclass(frozen=True)
class P:
    """Declarative parameter definition.

    shape : concrete shape
    axes  : logical axis name per dim (kept for parity with the JAX defs)
    init  : 'normal' | 'zeros' | 'ones' | 'embed' | 'fan_in'
    scale : stddev override (default: fan-in scaled)
    """

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"
    scale: Optional[float] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank mismatch")


def _std(p: P) -> float:
    if p.scale is not None:
        return p.scale
    if p.init == "normal":
        return 0.02
    if p.init == "embed":
        return 1.0
    # fan-in = product of all dims except the last (output) dim.
    return max(1, math.prod(p.shape[:-1])) ** -0.5


def _init_one(p: P, gen: torch.Generator, dtype, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init not in ("normal", "embed", "fan_in"):
        raise ValueError(f"unknown init {p.init}")
    # drawn in place at the parameter dtype: no f32 temporary of the
    # largest (expert-bank) leaves at full width
    t = torch.empty(p.shape, dtype=dtype, device=device)
    return t.normal_(0.0, _std(p), generator=gen)


def map_defs(fn: Callable[[str, P], Any], defs: Tree, prefix: str = "") -> Tree:
    """Map over a tree of P leaves, passing the string path to ``fn``."""
    if isinstance(defs, P):
        return fn(prefix, defs)
    if isinstance(defs, dict):
        return {k: map_defs(fn, v, f"{prefix}/{k}") for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return type(defs)(map_defs(fn, v, f"{prefix}/{i}")
                          for i, v in enumerate(defs))
    raise TypeError(f"unexpected node {type(defs)} at {prefix}")


def init_params(defs: Tree, *, seed: int, dtype=torch.float32,
                device="cuda") -> Tree:
    """Random parameters for ``defs`` on ``device``, drawn from one
    generator seeded with ``seed`` on that device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return map_defs(lambda _, p: _init_one(p, gen, dtype, device), defs)


def count_params(defs: Tree) -> int:
    n = [0]

    def add(_, p):
        n[0] += math.prod(p.shape)

    map_defs(add, defs)
    return n[0]
