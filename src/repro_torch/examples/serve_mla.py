"""Continuous-batching MLA serving example on the port (the paper is an
inference paper — this is the headline example): a Poisson stream of
requests with mixed prompt / generation lengths served from the PAGED
latent pool, with mid-generation admission and the execution scheme
re-dispatched every step on the live (batch, max cache_len) point.

    PYTHONPATH=src python -m repro_torch.examples.serve_mla --requests 10 \
        --max-batch 4
    PYTHONPATH=src python -m repro_torch.examples.serve_mla --device cpu \
        --requests 6 --max-batch 2 --num-blocks 9   # preemption shows

The compact latent cache ((D_kvl + D_rope) elements a token vs 2*H*Dh
dense) is what makes a shared block pool pay off, and the paged layout
stops ragged requests from stranding capacity.  Every prompt opens with
the same ``--shared-prefix-len`` system preamble, and the radix prefix
cache maps those leading blocks onto the same ref-counted pool blocks
(copy-on-write at the first partial block), so only each prompt's
un-cached suffix is prefilled, in fixed-size batched chunks straight
into the pool.  On a CUDA device the engine's steps run as CUDA graphs,
captured before the first request.

Flags (all compose):

  flag              default   effect
  --requests        10        number of requests in the Poisson stream
  --arrival-rate    0.4       mean requests per decode step (Poisson)
  --seed            0         weight init + sampling PRNG + workload seed
  --platform        h100      hwmodel point auto_dispatch prices against
  --engine          sync      paged engine: 'sync' | 'async' (the host
                              schedules tick N+1 while the device runs
                              tick N; the same tokens)
  --max-batch       4         decode slots (continuous batching)
  --block-size      8         tokens per pool block
  --num-blocks      48        pool capacity (a small pool queues and
                              preempts: recompute-style)
  --shared-prefix-len 16      common preamble tokens (0: random prompts)
  --no-prefix-cache off       disable radix block sharing
  --prefill-chunk   16        batched prefill chunk (0 = per-request)
  --prefill-impl    auto      chunk attention: 'gather' (the block-table
                              view) | 'pallas' (kernel K2 in place; the
                              reference's name) | 'auto' (follows --impl)
  --impl            ref       attention: 'ref' | 'chunked' (decode and
                              chunks gather; a per-request prefill walks
                              core.chunked_attention) | 'kernel' (K1 /
                              K2; their plain versions on the CPU)
  --cache-dtype     bf16      pool storage: 'bf16' | 'int8' | 'fp8' (1-byte
                              codes with per-slot f32 scales; needs
                              --prefill-chunk > 0)
  --temperature     0.0       0 = greedy; else seeded sampling (keys fold
  --top-k           0         the request id and absolute position, so
                              recompute-preemption replay is
                              deterministic); top-k filter when sampling
  --mesh            ''        'DPxMP' sharded serving: DP x MP ranks
                              spawned here (launch.mesh.launch), batch
                              rows over 'data', heads / vocab / experts
                              over 'model' (policy 'serve'), the pool
                              replicated; the same tokens; rank 0
                              prints.  With --spec-k, --engine async or
                              --prefill-chunk 0 it raises
                              NotImplementedError (ROADMAP.md)
  --spec-k          0         speculative decoding draft window (the
                              tokens are plain decode's)
  --draft           shallow:2 draft under --spec-k: 'shallow:N' (the
                              target's own first N layers) | 'self'
  --trace           ''        Perfetto trace-event JSON output path
  --metrics         ''        metrics-registry JSON output path (either
                              flag also records the roofline drift)
  --n               1         parallel samples per request: one prefill,
                              then an n-way copy-on-write fork
  --admission       cache_aware  'cache_aware' (longest cached prefix
                              first) | 'fcfs' (strict arrival order)
  --admission-age-bound 64    cache-aware admission starvation bound
  --device          cuda      cuda | cpu

The model is the f32 DeepSeek-V2 smoke config, as in the reference
example.  The run ends with ``OK`` once every request (and every fork)
has finished with its full budget.
"""
from __future__ import annotations

import argparse
import builtins
import time
from typing import List, Optional

import numpy as np
import torch

from .. import configs, models
from ..core.cache import bytes_per_token_latent
from ..core.schemes import auto_dispatch, step_time
from ..hwmodel.platforms import PLATFORMS
from ..launch.mesh import launch
from ..launch.serve import parse_mesh
from ..nn import module as nnm
from ..obs import Telemetry
from ..runtime import (AsyncPagedMLAEngine, PagedMLAEngine, Request,
                       SamplingParams, blocks_for, parse_draft_spec)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=48)
    ap.add_argument("--arrival-rate", type=float, default=0.4,
                    help="mean requests per decode step (Poisson)")
    ap.add_argument("--platform", default="h100", choices=sorted(PLATFORMS))
    ap.add_argument("--shared-prefix-len", type=int, default=16)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--prefill-impl", default="auto",
                    choices=("auto", "gather", "pallas"))
    ap.add_argument("--impl", default="ref",
                    choices=("ref", "chunked", "kernel"))
    ap.add_argument("--cache-dtype", default="bf16",
                    choices=("bf16", "int8", "fp8"))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="mesh 'DPxMP' (e.g. '2x2' = data x model) of "
                         "ranks, spawned here")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding draft window (0 = off)")
    ap.add_argument("--draft", default="shallow:2",
                    help="draft under --spec-k: 'shallow:N' | 'self'")
    ap.add_argument("--trace", default="")
    ap.add_argument("--metrics", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="sync", choices=("sync", "async"))
    ap.add_argument("--n", type=int, default=1)
    ap.add_argument("--admission", default="cache_aware",
                    choices=("cache_aware", "fcfs"))
    ap.add_argument("--admission-age-bound", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    shape = parse_mesh(args.mesh)
    if shape is None:
        return _serve(None, args)
    refused = [k for k, v in {"--spec-k": args.spec_k != 0,
                              "--engine async": args.engine != "sync",
                              "--prefill-chunk 0": args.prefill_chunk == 0
                              }.items() if v]
    if refused:
        raise NotImplementedError(
            f"{refused} under --mesh: not ported to repro_torch yet (see "
            f"ROADMAP.md, queue 1)")
    return launch(_serve, shape, args=(args,), device=args.device)[0]


def _serve(mesh, args) -> dict:
    """The example on one device, or as one rank of ``mesh``."""
    print = builtins.print if mesh is None or mesh.rank == 0 \
        else (lambda *a, **k: None)
    device = args.device if mesh is None else mesh.device
    cfg = configs.smoke("deepseek-v2-236b")
    mla = cfg.mla_config()
    plat = PLATFORMS[args.platform]
    bs = args.block_size

    print(f"platform {plat.name}: ridge OI = {plat.ridge_oi:.0f} FLOP/B")
    for L, B in ((64, 1), (64, args.max_batch), (2048, args.max_batch)):
        sch = auto_dispatch(mla, plat, cache_len=L, batch=B, paged_block=bs)
        ts = {s: step_time(s, mla, plat, cache_len=L, batch=B,
                           paged_block=bs) for s in ("seq", "rc", "ru")}
        print(f"  live point (B={B}, L={L}): " + "  ".join(
            f"{s}={t * 1e6:7.2f}us" for s, t in ts.items())
            + f"  -> '{sch}' (cost model)")

    params = nnm.init_params(models.model_defs(cfg), seed=args.seed,
                             dtype=torch.float32, device=device)
    # Poisson arrivals, mixed prompt / generation lengths
    rng = np.random.default_rng(args.seed + 1)
    gaps = rng.exponential(1.0 / args.arrival_rate, args.requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    preamble = rng.integers(0, cfg.vocab,
                            (args.shared_prefix_len,)).astype(np.int32)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.choice([8, 16, 24, 32]))
        gen = int(rng.integers(4, 20))
        prompt = np.concatenate(
            [preamble, rng.integers(0, cfg.vocab, (plen,)).astype(np.int32)])
        # rids spaced by n: fork-group children claim rid+1..rid+n-1
        reqs.append(Request(rid=i * args.n, prompt=prompt,
                            arrival=int(arrivals[i]),
                            sampling=SamplingParams(max_tokens=gen,
                                                    n=args.n)))

    per_req = max(blocks_for(r.plen + r.max_new + 1, bs) for r in reqs)
    draft_cfg = draft_params = None
    if args.spec_k:
        draft_cfg, draft_params = parse_draft_spec(args.draft, cfg, params)
        print(f"speculative decoding: k={args.spec_k}, draft={args.draft} "
              f"({draft_cfg.n_layers} of {cfg.n_layers} layers)")
    tel = None
    if (args.trace or args.metrics) and (mesh is None or mesh.rank == 0):
        tel = Telemetry.on(trace=bool(args.trace),
                           metrics=bool(args.metrics), drift=True)
    engine_cls = AsyncPagedMLAEngine if args.engine == "async" \
        else PagedMLAEngine
    engine = engine_cls(
        cfg, params, num_blocks=args.num_blocks, block_size=bs,
        max_batch=args.max_batch, max_blocks_per_req=per_req,
        compute_dtype=torch.float32, impl=args.impl, scheme="auto",
        platform=plat, enable_prefix_cache=not args.no_prefix_cache,
        prefill_mode="chunked" if args.prefill_chunk else "per_request",
        prefill_impl=args.prefill_impl,
        prefill_chunk=args.prefill_chunk or 32,
        temperature=args.temperature, top_k=args.top_k,
        sample_seed=args.seed, mesh=mesh,
        spec_k=args.spec_k, draft_cfg=draft_cfg, draft_params=draft_params,
        cache_dtype=args.cache_dtype, telemetry=tel,
        admission=args.admission,
        admission_age_bound=args.admission_age_bound, device=device)
    if mesh is not None:
        print(f"mesh {args.mesh}: {mesh.world} ranks, batch over 'data', "
              f"heads over 'model', max_batch {engine.sched.max_batch}")
    total_need = sum(blocks_for(r.plen + r.max_new + 1, bs) for r in reqs)
    print(f"\n{args.requests} requests (prompts 8-32, gen 4-19), pool "
          f"{args.num_blocks - 1} usable blocks x {bs} tokens "
          f"(peak demand {total_need} blocks if all resident)")
    engine.warm_up()          # graphs captured before the first request

    t0 = time.time()
    summary = engine.run(reqs, log_every=10, log=print)
    dt = time.time() - t0

    lat = [r.finished_step - r.arrival for r in engine.sched.finished]
    print(f"\nserved {args.requests} requests in {summary['steps']:.0f} "
          f"steps / {dt:.2f}s wall ({summary['tokens_per_s']:.1f} decode "
          f"tok/s on {args.device})")
    print(f"  mid-generation admissions : "
          f"{summary['mid_gen_admissions']:.0f} / {summary['admissions']:.0f}")
    print(f"  preemptions (recompute)   : {summary['preemptions']:.0f}")
    print(f"  cache utilization         : "
          f"{summary['cache_utilization']:.2f} (valid tokens / allocated "
          f"block slots)")
    print(f"  pool occupancy            : {summary['pool_occupancy']:.2f}")
    print(f"  scheme usage              : {summary['schemes_used']}")
    print(f"  prefix hit rate           : {summary['prefix_hit_rate']:.2f} "
          f"({summary['prefix_hit_tokens']:.0f}/"
          f"{summary['prompt_tokens']:.0f} prompt tokens shared)")
    print(f"  prefilled tokens / chunks : {summary['prefill_tokens']:.0f} / "
          f"{summary['prefill_chunks']:.0f} (graph capture "
          f"{summary['capture_s']:.2f}s)")
    print(f"  cache evictions / CoW     : {summary['prefix_evictions']:.0f} "
          f"/ {summary['prefix_cow_copies']:.0f}")
    if args.n > 1:
        print(f"  fork groups / children    : {summary['fork_groups']:.0f} "
              f"/ {summary['fork_children']:.0f} (one prefill per group)")
    if args.spec_k:
        print(f"  spec accept / emit rate   : "
              f"{summary['spec_accept_rate']:.2f} "
              f"({summary['spec_accepted']:.0f}/"
              f"{summary['spec_drafted']:.0f} drafts), "
              f"{summary['spec_mean_emitted']:.2f} tokens/round over "
              f"{summary['spec_rounds']:.0f} rounds")
    print(f"  latency steps p50/max     : {int(np.median(lat))}/"
          f"{int(max(lat))}")
    first = min(engine.sched.finished, key=lambda r: r.rid)
    print("first request's tokens:", np.asarray(first.output)[:16])

    if tel is not None:
        tel.finalize(engine)
        written = tel.export(trace_path=args.trace or None,
                             metrics_path=args.metrics or None)
        for channel, path in written.items():
            print(f"telemetry: {channel} -> {path}")
        if tel.metrics is not None:
            ttft = tel.metrics.histogram("ttft_ms").summary()
            print(f"  TTFT ms p50/p95           : {ttft.get('p50', 0):.1f}/"
                  f"{ttft.get('p95', 0):.1f}")
            print(tel.metrics.render_table())
        if tel.drift is not None and tel.drift.rows:
            d = tel.drift.report()
            print(f"roofline drift: {d['rows']} rows, time-ratio p50 "
                  f"{d['summary']['time_ratio_p50']:.3g} ({args.device} "
                  f"wall vs {plat.name} prediction), spread "
                  f"{d['summary']['spread']:.2f}")

    # latent-cache footprint vs the dense-KV equivalent (the paper's Fig 3
    # point), at the pool's storage dtype
    lat_b = bytes_per_token_latent(
        mla.kv_lora_rank, mla.qk_rope_dim, 2,
        None if args.cache_dtype == "bf16" else args.cache_dtype)
    dense_b = 2 * cfg.n_heads * mla.qk_dim * 2
    print(f"KV bytes/token/layer: latent {lat_b:.0f} ({args.cache_dtype}) "
          f"vs dense {dense_b} ({dense_b / lat_b:.1f}x smaller -> "
          f"{dense_b / lat_b:.1f}x more requests per pool)")

    outs = {r.rid: list(map(int, r.output)) for r in engine.sched.finished}
    budget = {r.rid: r.sampling.max_tokens for r in reqs}
    assert len(outs) == args.requests * args.n, "every request is served"
    assert all(len(o) == budget[rid - rid % args.n]
               for rid, o in outs.items()), "every request ran its budget"
    print("OK")
    summary["outputs"] = outs
    return summary


if __name__ == "__main__":
    main()
