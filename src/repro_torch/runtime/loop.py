"""The serving request loop (port of ``repro.runtime.loop.drive``)."""
from __future__ import annotations

from typing import Dict


def drive(engine, requests, *, max_steps: int = 100_000,
          log_every: int = 0, log=print) -> Dict[str, float]:
    """Drive a request stream to completion on a paged engine.

    ``req.arrival`` is the step index at which a request joins the waiting
    queue.  The loop runs until every request is submitted and
    ``engine.idle``; ``log`` gets a one-line status every ``log_every``
    steps."""
    todo = sorted(requests, key=lambda r: r.arrival)
    i = 0
    while not (i >= len(todo) and engine.idle):
        while i < len(todo) and todo[i].arrival <= engine.stats.steps:
            engine.submit(todo[i])
            i += 1
        engine.step()
        if log_every and engine.stats.steps % log_every == 0:
            u = engine.sched.utilization()
            log(f"step={engine.stats.steps} active={engine.sched.n_active} "
                f"waiting={len(engine.sched.waiting)} "
                f"done={len(engine.sched.finished)} "
                f"util={u['valid_frac']:.2f} pool={u['pool_frac']:.2f} "
                f"scheme={engine._last_scheme}")
        if engine.stats.steps >= max_steps:
            raise RuntimeError(f"did not drain in {max_steps} steps")
    return engine.summary()
