#!/usr/bin/env python3
"""Where the time goes in ``chip_smoke.py``'s full-width serve (phase 3),
on one CUDA card:

    python3 chip_profile.py

Builds the same model (DeepSeek-V2 widths, 4 layers, random bf16 weights,
the config's MoE capacity) and the same 8 requests, then serves them twice
with ``impl='kernel'``: once untraced (the end-to-end numbers), once under
``torch.profiler`` with a span around each call the engine makes into the
model (``prefill_chunk``, ``decode_tick``).  Prints device time by span
and by kernel, the device busy share of the traced run, and the tracing
cost (traced minus untraced engine seconds).  Spans are added here, around
the calls, not inside the program.
"""
from __future__ import annotations

import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import dataclasses

    import chip_smoke
    from repro_torch import configs, models
    from repro_torch.launch.serve import build_engine
    from repro_torch.nn import module as nnm
    from repro_torch.runtime import Request, SamplingParams
    from repro_torch.runtime import engine as engine_mod

    print(f"[card] {chip_smoke.card_line()}", flush=True)
    cfg = dataclasses.replace(configs.full("deepseek-v2-236b"), n_layers=4)
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    gen = 32

    def serve():
        reqs = chip_smoke.requests_full(cfg, np, Request, SamplingParams, gen)
        engine = build_engine(cfg, params, batch=len(reqs),
                              max_len=max(r.plen for r in reqs) + gen,
                              gen=gen, block_size=chip_smoke.BS,
                              impl="kernel", scheme="auto", platform="h100",
                              prefill_chunk=chip_smoke.C,
                              compute_dtype=torch.bfloat16, device="cuda")
        t0 = time.perf_counter()
        summary = engine.run(reqs)
        return summary, time.perf_counter() - t0

    serve()                                   # warm-up: build, allocator
    summary, wall = serve()
    print(f"[untraced] {summary['decode_tokens']} decode tokens, "
          f"{summary['steps']} steps, {summary['prefill_chunks']} chunks, "
          f"{summary['tokens_per_s']:.1f} tokens/s, engine {wall:.3f} s",
          flush=True)

    def spanned(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    plain_models = engine_mod.models
    engine_mod.models = types.SimpleNamespace(
        init_paged_cache=plain_models.init_paged_cache,
        prefill_chunk_paged=spanned("prefill_chunk",
                                    plain_models.prefill_chunk_paged),
        decode_step=spanned("decode_tick", plain_models.decode_step))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, traced = serve()
            torch.cuda.synchronize()
    finally:
        engine_mod.models = plain_models
    print(f"[traced] engine {traced:.3f} s (tracing cost "
          f"{traced - wall:+.3f} s over the untraced run)", flush=True)

    spans = ("prefill_chunk", "decode_tick")
    events = prof.key_averages()
    # device-side copies of the spans are ranges, not work: keep them out
    dev = [e for e in events
           if e.device_type.name == "CUDA" and e.key not in spans]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    if busy == 0:
        print("chip_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    print(f"[traced] device busy {busy:.3f} s of {traced:.3f} s "
          f"({100 * busy / traced:.1f} %), idle share "
          f"{100 * (1 - busy / traced):.1f} %")
    for e in events:
        if e.key in spans:
            print(f"[span] {e.key} ({e.device_type.name}): {e.count} calls, "
                  f"device {e.device_time_total / 1e6:.3f} s, host "
                  f"{e.cpu_time_total / 1e6:.3f} s")
    print("[kernels] device time by kernel (top 15):")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e6:8.3f} s "
              f"{100 * e.self_device_time_total / 1e6 / busy:5.1f} % "
              f"x{e.count:<6d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
