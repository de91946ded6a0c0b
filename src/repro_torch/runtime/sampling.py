"""Per-request sampling / generation parameters — the request API.

Copied from ``repro.runtime.sampling``: the port keeps its own copy so
it never imports the JAX package.

``SamplingParams`` consolidates the knobs that used to be scattered
across ``Request`` fields (``max_new``, ``stop``), engine-constructor
defaults (``temperature`` / ``top_k`` / ``sample_seed``) and ad-hoc HTTP
body parsing in ``launch.server``:

    req = Request(rid=0, prompt=ids,
                  sampling=SamplingParams(max_tokens=64, n=4,
                                          stop=((13,),)))

``n > 1`` requests n-way PARALLEL SAMPLING: the prompt prefills once,
then the sequence forks n ways through ``BlockAllocator.fork`` +
copy-on-write on the partial tail block (runtime.scheduler.fork_group).
Each fork samples with its own fold(rid + i, position) key stream, so
the group is token-identical to n independent requests submitted with
consecutive rids — the caller reserves the rid range
``[rid, rid + n)``.

``temperature`` / ``top_k`` / ``seed`` default to None = inherit the
engine's configured values.  A non-None value must MATCH the engine
configuration: the async engine folds sampling into the compiled step
(temperature / top-k / seed are baked into the compiled program), so a
per-request override would mint a new compiled-step variant per value —
exactly what the hot-path auditor's unchanged-by-construction check
forbids.  The engine validates this at ``submit`` and raises a clear
``ValueError`` instead of silently retracing.

The legacy ``Request(prompt, max_new, stop=...)`` constructor keeps
working through a deprecation shim (scheduler.Request.__post_init__
builds the equivalent SamplingParams and warns); it is pinned by
tests/test_multiturn_fork.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Immutable per-request generation spec.

    max_tokens   generation budget (>= 1)
    temperature  None = engine default; 0 = greedy; > 0 seeded sampling
    top_k        None = engine default; 0 = full vocab
    seed         None = engine default sampling seed
    stop         stop token-id sequences (generation ends when the output
                 suffix matches one; the match is hidden from the output)
    n            parallel samples: prefill once, fork the sequence n ways
                 (rids [rid, rid + n) are consumed by the group)
    """

    max_tokens: int = 16
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None
    stop: Tuple[Tuple[int, ...], ...] = ()
    n: int = 1

    def __post_init__(self):
        # normalize stop to hashable nested tuples so params stay frozen
        # whether built from JSON lists or tuples
        object.__setattr__(
            self, "stop",
            tuple(tuple(int(t) for t in s) for s in self.stop))

    def validate(self) -> "SamplingParams":
        """Raise ValueError on out-of-range fields; returns self so the
        frontend can chain ``SamplingParams(...).validate()``."""
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.max_tokens < 1:
            raise ValueError(
                f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.temperature is not None and self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        for s in self.stop:
            if not s:
                raise ValueError("empty stop sequence")
        return self

    @classmethod
    def from_legacy(cls, max_new: int,
                    stop: Optional[Sequence[Sequence[int]]] = None
                    ) -> "SamplingParams":
        """The deprecation shim target for ``Request(prompt, max_new,
        stop=...)`` call sites."""
        return cls(max_tokens=int(max_new),
                   stop=tuple(tuple(int(t) for t in s)
                              for s in (stop or ())))
