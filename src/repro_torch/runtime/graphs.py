"""CUDA graphs of the serving engine's steps: the port's counterpart of
``jax.jit`` for the paged decode and prefill-chunk steps.

The JAX package sends a step to the device as one compiled executable.
Run from Python, the same step is a few hundred eager launches, and the
host time they take is most of a full-width tick.  A :class:`StepGraph`
records one step once and replays it as a single launch:

    g = StepGraph(fn, inputs, held=pool_and_params, counters=wrappers)
    g.capture()            # eager warm-up on a side stream, then capture
    ...copy this tick's inputs into g.inputs (same tensors, in place)...
    out = g.replay()       # the step's outputs, in the graph's buffers

What a graph holds fixed from capture to replay:

  * addresses: ``fn`` may read only ``inputs`` and the tensors it holds
    (``held()`` lists them as they are now: the pool's and the
    parameters' leaves), and those must keep their storage.  Every
    replay checks each one's ``data_ptr`` and raises if one moved (a leaf
    replaced in its tree, a buffer reallocated).  The outputs live in the graph's private memory pool and
    are valid until the next replay;
  * shapes and plans: each kernel wrapper in ``counters`` (a function
    with ``.launches`` and ``.last_plan``, kernels K1 and K2 here) plans
    its launch on the host; the plan recorded at capture must equal the
    plan of the eager warm-up on the same inputs, and is kept in
    ``plans``;
  * launch counts: a replay runs no Python, so the wrappers' counters
    would not move.  The graph records how many launches of each wrapper
    it captured (``launches``) and every replay adds them.  Capturing
    launches nothing, so the counts the capture itself added are taken
    back; the warm-up runs do launch, and stay counted.

Warm-ups run on one side stream a device, shared by every graph: cuBLAS
keeps a workspace for each stream it has run on, so a new stream for
each capture would leave one more workspace allocated for every graph
ever captured.

A failure during warm-up, capture or replay raises.  Nothing falls back
to the eager step: a caller that wants eager steps asks for them.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Sequence

import torch

# eager runs of a step before its capture: the libraries' first-call work
# (cuBLAS handles, workspaces) happens in them, not in the graph
WARMUP_RUNS = 2

_WARMUP_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _warmup_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[index] = torch.cuda.Stream(index)
    return _WARMUP_STREAMS[index]


class StepGraph:
    def __init__(self, fn: Callable, inputs: Dict[str, torch.Tensor], *,
                 held: Callable[[], Iterable[torch.Tensor]] = tuple,
                 counters: Sequence = (), name: str = "step"):
        self.device = next(iter(inputs.values())).device
        if self.device.type != "cuda":
            raise ValueError(f"{name}: CUDA graphs need CUDA tensors, got "
                             f"{self.device}")
        self.fn, self.inputs, self.name = fn, inputs, name
        self.counters = tuple(counters)
        self._held = held
        self._ptrs = self._addresses()
        self.graph = None
        self.output = None
        self.launches: Dict[str, int] = {}
        self.plans: Dict[str, dict] = {}
        self._captured: Dict[Callable, int] = {}
        self.capture_s = 0.0

    def capture(self) -> "StepGraph":
        """Run ``fn`` eagerly ``WARMUP_RUNS`` times on a side stream,
        then capture one call.  Raises on any failure."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = _warmup_stream(self.device)
        side.wait_stream(cur)
        seen = {c: c.launches for c in self.counters}
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.fn(**self.inputs)
        cur.wait_stream(side)
        eager = {c: c.last_plan for c in self.counters
                 if c.launches != seen[c]}
        before = {c: c.launches for c in self.counters}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self.fn(**self.inputs)
        finally:
            captured = {c: c.launches - before[c] for c in self.counters}
            for c in self.counters:
                c.launches = before[c]
        for c, n in captured.items():
            if not n:
                continue
            if eager.get(c) != c.last_plan:
                raise RuntimeError(
                    f"{self.name}: {c.__name__} planned {c.last_plan} at "
                    f"capture, {eager.get(c)} eagerly")
            self.launches[c.__name__] = n
            self.plans[c.__name__] = c.last_plan
        self._captured = {c: n for c, n in captured.items() if n}
        self.graph, self.output = graph, out
        self.capture_s = time.perf_counter() - t0
        return self

    def _addresses(self) -> List[int]:
        return [t.data_ptr() for t in list(self.inputs.values())
                + list(self._held())]

    def check_addresses(self) -> None:
        """Raise unless every input and held tensor still has the storage
        it had when the graph was built."""
        now = self._addresses()
        moved = len(now) != len(self._ptrs) \
            or sum(a != b for a, b in zip(now, self._ptrs))
        if moved:
            raise RuntimeError(f"{self.name}: {int(moved)} of "
                               f"{len(self._ptrs)} tensors the graph reads "
                               f"moved since capture")

    def replay(self):
        """Launch the graph on the current stream; returns its outputs
        (valid until the next replay)."""
        if self.graph is None:
            raise RuntimeError(f"{self.name}: replay before capture")
        self.check_addresses()
        self.graph.replay()
        for c, n in self._captured.items():
            c.launches += n
        return self.output
