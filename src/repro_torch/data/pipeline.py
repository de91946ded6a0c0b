"""Deterministic synthetic LM data (port of ``repro.data.pipeline``).

The global batch of a step is a pure function of (seed, step): each row
is drawn from a generator keyed by (seed, step, global row id), so any
host count produces the same global batch, and the iterator's whole
state is {step}.  The token mixture is the reference's: 75 % of tokens
from the first min(32, V // 4) ids, the rest uniform over the vocabulary,
so cross entropy falls from ln V within tens of steps.

The reference draws with jax's threefry (``jax.random.fold_in``), which
the port does not reproduce (ROADMAP.md, queue 1 item 10); it draws from
numpy's ``default_rng`` keyed the same way instead, so the two packages'
token streams differ (same distribution, different tokens).  Parity
tests hand both packages the same numpy batches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of n_hosts {self.n_hosts}")
        return self.global_batch // self.n_hosts


@dataclasses.dataclass
class DataState:
    step: int = 0


def _row_at(seed: int, step: int, row: int, L: int, V: int) -> np.ndarray:
    """One global row (L,) int32 — a pure function of (seed, step, row)."""
    rng = np.random.default_rng([seed, step, row])
    narrow_v = max(2, min(32, V // 4))
    base = rng.integers(0, V, L, dtype=np.int32)
    narrow = rng.integers(0, narrow_v, L, dtype=np.int32)
    gate = rng.random(L) < 0.75
    return np.where(gate, narrow, base)


def _batch_at(cfg: DataConfig, step: int,
              host_id: Optional[int] = None) -> np.ndarray:
    """Tokens (local_batch, seq_len + 1) of this host at ``step``; rows
    are keyed by their global id."""
    host = cfg.host_id if host_id is None else host_id
    rows = range(host * cfg.local_batch, (host + 1) * cfg.local_batch)
    return np.stack([_row_at(cfg.seed, step, r, cfg.seq_len + 1, cfg.vocab)
                     for r in rows])


class SyntheticLM:
    """Iterator with explicit, restorable state."""

    def __init__(self, cfg: DataConfig, state: Optional[DataState] = None):
        self.cfg = cfg
        self.state = state or DataState()

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens (B, L), labels (B, L)) and advances the state."""
        toks = _batch_at(self.cfg, self.state.step)
        self.state = DataState(self.state.step + 1)
        return toks[:, :-1], toks[:, 1:]

    def peek_global(self, step: int) -> np.ndarray:
        """The full global batch at a step (every host's rows)."""
        return np.concatenate(
            [_batch_at(dataclasses.replace(self.cfg, host_id=h), step)
             for h in range(self.cfg.n_hosts)], axis=0)

    def state_dict(self) -> dict:
        return {"step": self.state.step}

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState(int(d["step"]))
