"""The parts of ``jax.random`` the JAX package calls, in PyTorch, bit for
bit: the Threefry-2x32 counter hash (20 rounds, Random123's
``threefry2x32_20``), legacy uint32 keys, ``fold_in``, ``split``,
``random_bits``, ``uniform``, ``randint``, ``normal``, ``gumbel`` and
``categorical``.

What is reproduced is jax's default configuration: the ``threefry2x32``
implementation with ``jax_threefry_partitionable=True`` (the counters of
an array of random bits are the iota of its flat index, split into a
high and a low 32-bit word, and 32-bit draws are ``bits1 ^ bits2``), and
Gumbel noise in mode ``'low'``, ``-log(-log(uniform(tiny, 1)))``, and
normal draws as sqrt(2) erfinv(uniform(nextafter(-1, 0), 1)).

PyTorch has no uint32 arithmetic, so every 32-bit word is carried in an
int64 tensor holding a value in [0, 2^32) and masked back to 32 bits
after each add, multiply and rotate.  Nothing shifts a negative value
right and no product leaves int64.  Every function runs on the device of
its key and gives the same bits on the CPU and on CUDA; only the two
logarithms of ``gumbel`` and the ``erfinv`` of ``normal`` go through
floating-point library code.

A key is an int64 tensor of shape (..., 2); leading dimensions are a
batch of keys (``fold_in`` and the draws broadcast over them).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
# the rotation amount of each of the 20 rounds: groups of four, even
# groups (13, 15, 26, 6), odd groups (17, 29, 16, 24); a key is injected
# after each group
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
SCHEDULE = tuple(r for g in range(5) for r in ROTATIONS[g % 2])
KS_PARITY = 0x1BD11BDA
F32_TINY = torch.finfo(torch.float32).tiny

IntLike = Union[int, torch.Tensor]


def _word(v: IntLike, device) -> torch.Tensor:
    """An int64 tensor on ``device``: a tensor as it is, a Python int
    made there by a fill (never copied from host memory, so a CUDA graph
    can capture every draw)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k0: IntLike, k1: IntLike, x0: IntLike, x1: IntLike
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on (key, counter) word pairs that
    broadcast against each other; returns the two output words."""
    dev = next(v.device for v in (k0, k1, x0, x1)
               if isinstance(v, torch.Tensor))
    k0, k1, x0, x1 = torch.broadcast_tensors(
        *(_word(v, dev) for v in (k0, k1, x0, x1)))
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for rnd, r in enumerate(SCHEDULE):
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, r) ^ x0
        if rnd % 4 == 3:                    # key injection g + 1
            g = rnd // 4
            x0 = (x0 + ks[(g + 1) % 3]) & MASK
            x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: the key words
    are (0, seed mod 2^32)."""
    return torch.stack([_word(0, device), _word(int(seed) & MASK, device)])


def _data(data: IntLike, key: torch.Tensor) -> torch.Tensor:
    return _word(data, key.device) & MASK


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter (0, data) under ``key``.
    ``data`` is a uint32 value (an int, or a tensor that broadcasts
    against the key's batch dimensions)."""
    h0, h1 = threefry2x32(key[..., 0], key[..., 1], 0, _data(data, key))
    return torch.stack([h0, h1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): key i is the hash of
    the counter (0, i).  Returns (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    h0, h1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, lo)
    return torch.stack([h0, h1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``jax.random.bits``: the hash of each element's flat index
    (high word, low word), its two output words xor-ed.  Returns int64
    values in [0, 2^32) of shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,))
    k1 = key[..., 1].reshape(lead + (1,))
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
    return (b0 ^ b1).reshape(lead + shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform``: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into [minval, maxval), floored at
    minval — every step in float32, as jax does it."""
    bits = random_bits(key, shape)
    one = 0x3F800000                       # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _mul32(a: torch.Tensor, b: IntLike) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32), without leaving int64."""
    b = _word(b, a.device)
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint`` over [minval, maxval): two 32-bit
    draws from ``split(key)`` combined as hi * (2^32 mod span) + lo,
    reduced mod span, with jax's uint32 wrap-around in each step.
    Returns int32."""
    if not (-2**31 <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint takes int32 bounds")
    k = split(key, 2)
    hi_bits = random_bits(k[..., 0, :], shape)
    lo_bits = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    off = (_mul32(hi_bits % span, mult) + lo_bits % span) & MASK
    return (minval + off % span).to(torch.int32)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 ``jax.random.normal``: sqrt(2) * erfinv(u), u uniform over
    [nextafter(-1, 0), 1), in float32."""
    u = uniform(key, shape, minval=-1.0 + 2.0 ** -24, maxval=1.0)
    return torch.erfinv(u) * torch.full((), math.sqrt(2), dtype=torch.float32,
                                        device=key.device)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 ``jax.random.gumbel`` in mode 'low'."""
    u = uniform(key, shape, minval=F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


# PyTorch takes the log of a contiguous float CPU tensor in MKL's VML, 2,048
# elements a thread.  When a process's first VML log runs on two threads at
# once, one thread's chunk can come back hundreds of ulps off (4,096
# elements: 3 fresh processes in 600 read up to 840 ulps; later calls were
# exact).  So the module takes a one-element log, which runs on one thread,
# before ``gumbel`` can take its first.
torch.log(torch.ones(1))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.categorical)(keys, logits)``: row b draws
    ``argmax(gumbel(keys[b], (V,)) + logits[b])`` (ties to the lowest
    id).  keys (B, 2), logits (B, V) float32; returns (B,) int64."""
    g = gumbel(keys, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
