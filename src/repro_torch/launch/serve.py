"""Serving launcher of the port: a synthetic request batch through the
paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --smoke --paged --impl kernel

``--paged`` serves the batch through ``PagedMLAEngine``: paged latent pool,
per-request block tables, chunked prefill, mid-generation admission, the
radix prefix cache.  It is the only serving path ported so far, and the
flag is required.  ``--scheme auto`` re-runs the rc / ru / seq dispatch
every decode step on the live (batch, max cache_len) point, priced for
``--platform`` (default ``h100``).

  --arch / --smoke    model config (``--smoke``: the tiny CI config)
  --batch N           requests, arriving two steps apart
  --prompt-len N      tokens per prompt
  --gen N             tokens generated per request
  --scheme S          auto | naive | seq | rc | ru
  --platform P        hwmodel platform auto_dispatch prices against
  --impl I            paged attention: 'ref' (gathered view) or 'kernel'
                      (the CUDA kernels; their plain versions on CPU)
  --seed N            weight init and prompts
  --block-size N      tokens per pool block
  --num-blocks N      pool blocks (0 = sized for the batch)
  --no-prefix-cache   disable radix prefix-cache block sharing
  --prefill-chunk N   chunk size of the batched paged prefill
  --n N               parallel samples per request (one prefill, n-way fork)
  --admission A       cache_aware | fcfs admission order
  --admission-age-bound N
                      bypasses of cache-aware admission before a waiting
                      request is served regardless
  --device D          cuda (default) or cpu

Weights are random (``--seed``) and f32, as in the JAX launcher; sampling
is greedy.  Seeded sampling, the int8/fp8 pool, speculative decoding, the
async engine, the HTTP frontend, meshes and telemetry are on ROADMAP.md.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from .. import configs, models
from ..hwmodel.platforms import PLATFORMS
from ..nn import module as nnm
from ..runtime import PagedMLAEngine, Request, SamplingParams, blocks_for


def build_engine(cfg, params, *, batch: int, max_len: int, n: int = 1,
                 gen: int = 0, block_size: int = 16, num_blocks: int = 0,
                 impl: str = "ref", scheme: str = "auto",
                 platform: str = "h100", prefix_cache: bool = True,
                 prefill_chunk: int = 32, admission: str = "cache_aware",
                 admission_age_bound: int = 64,
                 compute_dtype=torch.float32,
                 device="cuda") -> PagedMLAEngine:
    """A paged engine sized for ``batch`` request groups of up to
    ``max_len`` tokens (prompt + generation), each forked ``n`` ways."""
    per_req = blocks_for(max_len + 1, block_size)
    # fork children share the prompt blocks; each needs its own tail run
    per_group = per_req + (n - 1) * blocks_for(gen + 1, block_size)
    return PagedMLAEngine(
        cfg, params, num_blocks=num_blocks or (1 + batch * per_group),
        block_size=block_size, max_batch=max(batch, n),
        max_blocks_per_req=per_req, compute_dtype=compute_dtype, impl=impl,
        scheme=scheme, platform=PLATFORMS[platform],
        enable_prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
        admission=admission, admission_age_bound=admission_age_bound,
        device=device)


def synthetic_requests(cfg, *, batch: int, prompt_len: int, gen: int,
                       n: int = 1, seed: int = 0) -> List[Request]:
    """``batch`` random prompts arriving two steps apart; rids are spaced
    by n (a fork group's children claim rid+1 .. rid+n-1)."""
    rng = np.random.default_rng(seed + 1)
    return [Request(rid=i * n,
                    prompt=rng.integers(0, cfg.vocab,
                                        (prompt_len,)).astype(np.int32),
                    arrival=2 * i,
                    sampling=SamplingParams(max_tokens=gen, n=n))
            for i in range(batch)]


def serve_paged(engine: PagedMLAEngine, requests: List[Request], *,
                log=print, log_every: int = 8) -> dict:
    """Run ``requests`` to completion on ``engine``; log a report and
    return the engine summary (with the run's wall seconds)."""
    t0 = time.perf_counter()
    summary = engine.run(requests, log_every=log_every, log=log)
    summary["run_s"] = time.perf_counter() - t0
    log(f"[serve] paged: {summary['decode_tokens']:.0f} decode tokens in "
        f"{summary['run_s']:.2f}s ({summary['tokens_per_s']:.1f} tok/s), "
        f"{summary['mid_gen_admissions']:.0f} mid-generation admissions, "
        f"cache utilization {summary['cache_utilization']:.2f}, "
        f"schemes {summary['schemes_used']}")
    log(f"[serve] prefix cache: hit rate {summary['prefix_hit_rate']:.2f} "
        f"({summary['prefix_hit_tokens']:.0f}/"
        f"{summary['prompt_tokens']:.0f} prompt tokens), "
        f"{summary['prefill_tokens']:.0f} prefilled in "
        f"{summary['prefill_chunks']:.0f} chunks")
    if summary["fork_groups"]:
        log(f"[serve] parallel sampling: {summary['fork_groups']:.0f} groups "
            f"forked ({summary['fork_children']:.0f} children)")
    first = min(engine.sched.finished, key=lambda r: r.rid)
    log(f"[serve] sample: {np.asarray(first.output[:16])}")
    return summary


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching over the paged latent pool "
                         "(required: the only serving path ported)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--scheme", default="auto",
                    choices=("auto", "naive", "seq", "rc", "ru"))
    ap.add_argument("--platform", default="h100", choices=sorted(PLATFORMS))
    ap.add_argument("--impl", default="ref", choices=("ref", "kernel"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool blocks (0 = sized for the request load)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix prefix-cache block sharing")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="batched paged prefill chunk size")
    ap.add_argument("--n", type=int, default=1,
                    help="parallel samples per request (prefill once, "
                         "fork n ways copy-on-write)")
    ap.add_argument("--admission", default="cache_aware",
                    choices=("cache_aware", "fcfs"))
    ap.add_argument("--admission-age-bound", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if not args.paged:
        raise SystemExit("only --paged serving is ported (the contiguous "
                         "path is on ROADMAP.md)")

    cfg = configs.smoke(args.arch) if args.smoke else configs.full(args.arch)
    params = nnm.init_params(models.model_defs(cfg), seed=args.seed,
                             dtype=torch.float32, device=args.device)
    engine = build_engine(
        cfg, params, batch=args.batch, max_len=args.prompt_len + args.gen,
        n=args.n, gen=args.gen, block_size=args.block_size,
        num_blocks=args.num_blocks, impl=args.impl, scheme=args.scheme,
        platform=args.platform, prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk, admission=args.admission,
        admission_age_bound=args.admission_age_bound, device=args.device)
    serve_paged(engine, synthetic_requests(
        cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        n=args.n, seed=args.seed))


if __name__ == "__main__":
    main()
