"""Deterministic synthetic LM data (port of ``repro.data.pipeline``).

The global batch of a step is a pure function of (seed, step): each row
draws from the key fold(fold(PRNGKey(seed), step), global row id), so
any host count produces the same global batch, and the iterator's whole
state is {step}.  The token mixture is the reference's: 75 % of tokens
from the first min(32, V // 4) ids, the rest uniform over the
vocabulary, so cross entropy falls from ln V within tens of steps.

The draws are the reference's, bit for bit: ``runtime.prng`` reproduces
the ``jax.random`` calls (``split(key, 3)``, two ``randint`` and a
``uniform`` gate), so both packages yield the same tokens for the same
(seed, step, n_hosts, host_id).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


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


def _rows_at(seed: int, step: int, rows: np.ndarray, L: int,
             V: int) -> np.ndarray:
    """Global rows (len(rows), L) int32 — each a pure function of (seed,
    step, row), drawn as the reference's ``_row_at``."""
    # imported here: runtime's package imports this one (TrainLoop)
    from ..runtime import prng

    key = prng.fold_in(prng.PRNGKey(seed), step)
    key = prng.fold_in(key, torch.as_tensor(rows, dtype=torch.int64))
    k = prng.split(key, 3)
    narrow_v = max(2, min(32, V // 4))
    base = prng.randint(k[:, 0], (L,), 0, V)
    narrow = prng.randint(k[:, 2], (L,), 0, narrow_v)
    gate = prng.uniform(k[:, 1], (L,)) < 0.75
    return torch.where(gate, narrow, base).numpy()


def _batch_at(cfg: DataConfig, step: int,
              host_id: Optional[int] = None) -> np.ndarray:
    """Tokens (local_batch, seq_len + 1) of this host at ``step``; rows
    are keyed by their global id."""
    host = cfg.host_id if host_id is None else host_id
    rows = np.arange(host * cfg.local_batch, (host + 1) * cfg.local_batch)
    return _rows_at(cfg.seed, step, rows, cfg.seq_len + 1, cfg.vocab)


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
