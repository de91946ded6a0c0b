"""Structured logging for the serving runtime (copied from
``repro.obs.logger``).

Replaces the ad-hoc ``print`` / ``log(f"[engine] ...")`` paths so every
engine/loop line carries machine-readable context (step, request id,
phase) and the whole stream can be silenced or JSON-formatted uniformly:

    log = StructLogger("engine")                  # text lines to print
    log = StructLogger("engine", json_mode=True)  # one JSON object/line
    log = StructLogger("engine", level="off")     # silenced
    log.info("admitted", step=12, rid=3, slot=0)

Text mode renders ``[engine] admitted step=12 rid=3 slot=0``; JSON mode
renders ``{"logger": "engine", "msg": "admitted", "step": 12, ...}``.

``as_logger`` adapts the bare ``log=print``-style callables the existing
APIs accept (tests pass ``log=lambda *_: None``) into a StructLogger
writing through that callable, so ``TrainLoop`` and ``PagedMLAEngine``
route one code path regardless of what the caller handed them.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "off": 100}


class StructLogger:
    def __init__(self, name: str = "repro", *, sink: Callable = print,
                 level: str = "info", json_mode: bool = False,
                 bound: Optional[Dict] = None):
        if level not in _LEVELS:
            raise ValueError(f"unknown level {level!r} "
                             f"(one of {sorted(_LEVELS)})")
        self.name = name
        self.sink = sink
        self.level = level
        self.json_mode = json_mode
        self.bound = dict(bound or {})

    def bind(self, **fields) -> "StructLogger":
        """Child logger with ``fields`` attached to every line."""
        return StructLogger(self.name, sink=self.sink, level=self.level,
                            json_mode=self.json_mode,
                            bound={**self.bound, **fields})

    @property
    def silenced(self) -> bool:
        return _LEVELS[self.level] >= _LEVELS["off"]

    def _emit(self, level: str, msg: str, fields: Dict) -> None:
        if _LEVELS[level] < _LEVELS[self.level]:
            return
        record = {**self.bound, **fields}
        if self.json_mode:
            self.sink(json.dumps({"logger": self.name, "level": level,
                                  "msg": msg, **record}))
            return
        tail = "".join(f" {k}={_fmt(v)}" for k, v in record.items())
        self.sink(f"[{self.name}] {msg}{tail}")

    def debug(self, msg: str, **fields) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, fields)

    def warning(self, msg: str, **fields) -> None:
        self._emit("warning", msg, fields)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def as_logger(log, name: str = "repro") -> StructLogger:
    """Adapt ``log`` into a StructLogger: StructLoggers pass through,
    bare callables (the legacy ``log=print`` API) become the sink, and
    None silences."""
    if isinstance(log, StructLogger):
        return log
    if log is None:
        return StructLogger(name, level="off")
    return StructLogger(name, sink=log)
