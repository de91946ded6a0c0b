"""The loops that run the port (port of ``repro.runtime.loop``): the
serving request loop ``drive`` and the fault-tolerant training loop
``TrainLoop``.

Training-loop behaviours, as in the reference:
  * auto-resume     — on construction, restores the latest complete
    checkpoint (params, optimizer state, data-iterator state) and
    continues from it;
  * async save      — checkpoint serialization overlaps the next steps;
  * keep-k GC       — bounded disk usage;
  * failure drill   — ``fail_at_step`` raises SimulatedFailure;
  * straggler policy — a step slower than ``straggler_factor`` x the
    running median step time is recorded and run again.  The rerun is the
    reference's as it stands: it calls the step on the params the slow
    step already returned, so that batch is applied twice (ROADMAP.md,
    queue 3).

Step times end in ``torch.cuda.synchronize()`` on a CUDA device (the
reference's ``block_until_ready``).  ``log`` is a bare callable taking
one string, an ``obs.StructLogger`` or None (silent); ``TrainLoop``
writes the reference's records through ``as_logger(log, "loop")``.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..checkpoint import CheckpointStore
from ..data import SyntheticLM
from ..obs import as_logger
from ..optim.adamw import tree_leaves, tree_map


def drive(engine, requests, *, max_steps: int = 100_000,
          log_every: int = 0, log=print) -> Dict[str, float]:
    """Drive a request stream to completion on a paged engine.

    ``req.arrival`` is the step index at which a request joins the waiting
    queue.  The loop runs until every request is submitted and
    ``engine.idle``; a one-line status goes out every ``log_every`` steps
    through the engine's telemetry logger if it has one, else through
    ``log`` (a bare callable or an ``obs.StructLogger``)."""
    slog = engine.tel.logger if engine.tel.logger is not None \
        else as_logger(log, "engine")
    todo = sorted(requests, key=lambda r: r.arrival)
    i = 0
    while not (i >= len(todo) and engine.idle):
        while i < len(todo) and todo[i].arrival <= engine.stats.steps:
            engine.submit(todo[i])
            i += 1
        engine.step()
        if log_every and engine.stats.steps % log_every == 0:
            u = engine.sched.utilization()
            slog.info("step", step=engine.stats.steps,
                      active=engine.sched.n_active,
                      waiting=len(engine.sched.waiting),
                      done=len(engine.sched.finished),
                      util=u["valid_frac"], pool=u["pool_frac"],
                      scheme=engine._last_scheme)
        if engine.stats.steps >= max_steps:
            raise RuntimeError(f"did not drain in {max_steps} steps")
    return engine.summary()


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    async_save: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_warmup: int = 8       # steps before the deadline activates
    fail_at_step: Optional[int] = None   # failure drill


class TrainLoop:
    def __init__(self, cfg: LoopConfig, step_fn: Callable, params, opt_state,
                 data: SyntheticLM, *, make_batch: Optional[Callable] = None,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.step_fn = step_fn
        self.data = data
        # ``log`` keeps its bare-callable contract; every line goes
        # through the structured logger, so it can be silenced or
        # JSON-formatted as the engine's
        self.log = log
        self.slog = as_logger(log, "loop")
        self.store = CheckpointStore(cfg.ckpt_dir, keep=cfg.keep)
        self.params, self.opt_state = params, opt_state
        self.device = next(tree_leaves(params)).device
        self.step = 0
        self.step_times: List[float] = []
        self.straggler_events: List[Dict[str, Any]] = []
        # (tokens, labels) numpy -> the step's batch dict (a VLM adds
        # its ``embeds``); default: the two as tensors on the params'
        # device
        self.make_batch = make_batch or (lambda toks, labels: {
            "tokens": torch.as_tensor(toks, device=self.device),
            "labels": torch.as_tensor(labels, device=self.device)})
        self._maybe_resume()

    def _maybe_resume(self):
        latest = self.store.latest_step()
        if latest is None:
            return
        tree = {"params": self.params, "opt": self.opt_state}
        restored, meta = self.store.restore(latest, tree)
        with torch.no_grad():      # into the live tensors, in place
            tree_map(lambda live, new: live.copy_(new), tree, restored)
        self.data.load_state_dict(meta["data_state"])
        self.step = meta["step"]
        self.slog.info("resumed from checkpoint", step=self.step)

    def _deadline(self) -> Optional[float]:
        if len(self.step_times) < self.cfg.straggler_warmup:
            return None
        return self.cfg.straggler_factor * statistics.median(
            self.step_times[-64:])

    def _timed_step(self, batch):
        t0 = time.monotonic()
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return metrics, time.monotonic() - t0

    def _run_step(self, batch) -> Dict[str, Any]:
        metrics, dt = self._timed_step(batch)
        deadline = self._deadline()
        if deadline is not None and dt > deadline:
            self.straggler_events.append(
                {"step": self.step, "time": dt, "deadline": deadline})
            self.slog.warning("straggler re-dispatched", step=self.step,
                              time_s=dt, deadline_s=deadline)
            metrics, dt = self._timed_step(batch)
        self.step_times.append(dt)
        return metrics

    def run(self) -> Dict[str, Any]:
        last_metrics: Dict[str, Any] = {}
        while self.step < self.cfg.total_steps:
            toks, labels = self.data.next_batch()
            last_metrics = self._run_step(self.make_batch(toks, labels))
            self.step += 1
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                self.slog.info("step", step=self.step,
                               loss=float(last_metrics["loss"]),
                               ms=self.step_times[-1] * 1e3)
            if self.step % self.cfg.ckpt_every == 0 or \
                    self.step == self.cfg.total_steps:
                self.store.save(
                    self.step, {"params": self.params, "opt": self.opt_state},
                    data_state=self.data.state_dict(),
                    blocking=not self.cfg.async_save)
            if self.cfg.fail_at_step is not None and \
                    self.step == self.cfg.fail_at_step:
                self.store.wait()
                raise SimulatedFailure(f"injected failure at step "
                                       f"{self.step}")
        self.store.wait()
        return last_metrics
