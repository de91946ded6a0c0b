"""Serving launcher of the port: prefill a batch of prompts and decode,
over contiguous caches (the default) or through the paged
continuous-batching engine (``--paged``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --smoke --impl kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --smoke --paged --cache-dtype fp8 --impl kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --smoke --paged --n 3 --temperature 0.9 --top-k 8 \
        --trace t.json --metrics m.json --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --smoke --paged --engine async --serve --port 8931
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --smoke --paged --spec-k 4 --draft shallow:1 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --smoke --paged --mesh 2x2 --policy tp --device cpu

Without ``--paged`` the batch prefills together through the contiguous
prefill (``runtime.steps.make_prefill_step``: the flash-attention
forward kernel under ``--impl kernel``; MLA in MHA mode) into one cache
per request of prompt + gen + 1 positions (a VLM's patches on top), then
decodes one token per step for the whole batch (``make_serve_step``:
kernel K3 for MLA under ``--impl kernel``).  ``--scheme auto`` picks rc
/ ru / seq once, for (batch, prompt + gen) on ``--platform``, and prints
its choice; for the attention families (``--arch phi3-mini-3.8b``,
``gemma3-1b``, ...: contiguous only, as in the reference) and the
recurrent ones (``jamba-1.5-large-398b``, Mamba / GQA / MoE;
``xlstm-350m``, mLSTM / sLSTM: their decode state is O(1) a request) it
resolves to 'seq'.  A VLM (``internvl2-26b``) gets random patch
embeddings, and the encoder-decoder (``whisper-medium``) random frames
(B, n_frames, d_model), drawn as the reference draws them:
``runtime.prng``'s normal * 0.02 under the second key of
split(PRNGKey(seed + 1)).  Whisper encodes the frames, fills each
layer's cross-attention cache with their K/V, and decodes at index
prompt_len + i: its self-attention cache holds decoder tokens only.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --smoke --impl kernel --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --smoke --impl chunked --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --smoke --impl kernel --device cpu

``--paged`` (MLA models only; another arch raises ``NotImplementedError:
PagedMLAEngine requires an MLA model``) serves the batch as a request
stream through ``PagedMLAEngine``: paged latent pool, per-request block
tables, chunked prefill, mid-generation admission, the radix prefix
cache; ``--scheme
auto`` re-runs the dispatch every decode step on the live (batch, max
cache_len) point.  On a CUDA device the paged engines run their decode
and prefill-chunk steps as CUDA graphs (``runtime.graphs``), captured
before the first request.

  --arch / --smoke    model config (``--smoke``: the tiny CI config)
  --batch N           requests (paged: arriving two steps apart)
  --prompt-len N      tokens per prompt
  --gen N             tokens generated per request
  --scheme S          auto | naive | seq | rc | ru
  --platform P        hwmodel platform auto_dispatch prices against
  --impl I            attention: 'ref' (dense / gathered view), 'chunked'
                      (a contiguous or per-request prefill in
                      core.chunked_attention's block-pair walk; paged
                      decode and chunks gather, as under 'ref') or
                      'kernel' (the CUDA kernels; their plain versions on
                      CPU)
  --seed N            weight init and prompts
  --device D          cuda (default) or cpu

Paged only (each raises without ``--paged``):

  --block-size N      tokens per pool block
  --num-blocks N      pool blocks (0 = sized for the batch)
  --no-prefix-cache   disable radix prefix-cache block sharing
  --prefill-chunk N   chunk size of the batched paged prefill; 0 prefills
                      each request alone through the contiguous prefill
                      and scatters it into the pool ('per_request'; the
                      prefix cache is then off)
  --prefill-impl I    chunk attention of the batched paged prefill:
                      'gather' attends the gathered block-table view,
                      'kernel' (or the reference's name 'pallas') runs
                      kernel K2 in place; 'auto' (default) follows --impl
  --cache-dtype D     pool storage: bf16 (the compute dtype) | int8 |
                      fp8 (e4m3; 1-byte codes with per-slot f32 scales,
                      dequantized in the kernels' registers; needs
                      --prefill-chunk > 0)
  --n N               parallel samples per request (one prefill, n-way fork)
  --spec-k K          speculative decoding: draft K tokens per tick and
                      verify them in ONE k + 1-query chunk step of the
                      target (kernel K2 under --impl kernel).  Rejected
                      drafts are a host-side length rewind; the tokens
                      are plain decode's, greedy and seeded; draft
                      quality moves throughput only
  --draft SPEC        draft model under --spec-k: 'shallow:N' (the
                      target's own first N layers, sharing its weights)
                      or 'self' (draft == target: every draft accepted)
  --admission A       cache_aware | fcfs admission order
  --admission-age-bound N
                      bypasses of cache-aware admission before a waiting
                      request is served regardless
  --temperature T     0 = greedy; > 0 samples with temperature / top-k
                      under a per-request key folded with the absolute
                      token position (sample seed = --seed), on the
                      engine's device
  --top-k K           top-k cut when sampling (0 = the full vocabulary;
                      ties with the k-th logit pass)
  --trace PATH        write the Chrome/Perfetto trace-event JSON (request
                      lifecycle and step-phase spans) to PATH
  --metrics PATH      write the metrics-registry JSON (counters, gauges,
                      TTFT / TPOT / queue-delay / step-time histograms,
                      the engine summary) to PATH and print the table.
                      Either flag also arms the roofline drift channel:
                      every step records the hwmodel time predicted for
                      the scheme it dispatched beside the measured time
  --engine E          sync (default): each tick steps the device and
                      waits; async (``AsyncPagedMLAEngine``): the host
                      schedules tick N+1 while the device runs tick N,
                      and only the sampled ids come back, a tick later
                      (the same tokens)
  --serve             instead of the synthetic batch, serve HTTP/SSE on
                      --host:--port (``launch.server``): POST
                      /v1/generate, /v1/cancel; GET /v1/health,
                      /v1/metrics.  Ctrl-C stops it
  --host H / --port N frontend bind address (default 127.0.0.1:8000)
  --mesh DPxMP        serve sharded over a (data, model) mesh of DP x MP
                      ranks, which the CLI spawns itself
                      (``launch.mesh.launch``: NCCL when each rank has a
                      card of its own, else gloo; rank r on card r mod
                      the cards); batch rows over 'data', heads, the
                      vocab and experts over 'model', the pool replicated;
                      rank 0 prints.  The same tokens as one device.
                      Each rank draws its own shards of the weights
                      (``weights.init_sharded_params``).  Not ported under
                      a mesh (raise NotImplementedError): the contiguous
                      path (no --paged), --engine async, --spec-k,
                      --serve, --prefill-chunk 0
  --policy P          weight sharding under --mesh: serve (FSDP + TP),
                      serve_2dtp, dp, tp (``nn.sharding.make_rules``)

Weights are random (``--seed``) and f32, as in the JAX launcher; the
contiguous path decodes greedily.  Unlike the JAX launcher, the
contiguous decode ``index`` counts a VLM's cached patches (the JAX
launcher's starts at the prompt length and overwrites text positions,
ROADMAP.md queue 3).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from .. import configs, models
from ..core import mla as mlalib
from ..core.schemes import auto_dispatch
from ..hwmodel.platforms import PLATFORMS
from ..nn import module as nnm
from ..nn.sharding import MODES as SHARD_MODES
from ..obs import Telemetry
from ..runtime import (AsyncPagedMLAEngine, PagedMLAEngine, Request,
                       SamplingParams, blocks_for, make_prefill_step,
                       make_serve_step, parse_draft_spec, prng)

ENGINES = {"sync": PagedMLAEngine, "async": AsyncPagedMLAEngine}


def build_engine(cfg, params, *, batch: int, max_len: int, n: int = 1,
                 gen: int = 0, block_size: int = 16, num_blocks: int = 0,
                 impl: str = "ref", scheme: str = "auto",
                 platform: str = "h100", prefix_cache: bool = True,
                 prefill_chunk: int = 32, admission: str = "cache_aware",
                 admission_age_bound: int = 64, cache_dtype: str = "bf16",
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, telemetry: Optional[Telemetry] = None,
                 compute_dtype=torch.float32, device="cuda",
                 engine: str = "sync", prefill_impl: Optional[str] = None,
                 cuda_graphs: Optional[bool] = None, spec_k: int = 0,
                 draft: str = "", decode_block_reuse: bool = True,
                 partial_match: bool = True, mesh=None,
                 shard_policy: str = "serve") -> PagedMLAEngine:
    """A paged engine (``engine`` 'sync': ``PagedMLAEngine``, 'async':
    ``AsyncPagedMLAEngine``) sized for ``batch`` request groups of up to
    ``max_len`` tokens (prompt + generation), each forked ``n`` ways.
    ``prefill_chunk`` 0 prefills per request (``prefill_mode=
    'per_request'``).  ``cuda_graphs`` None: graphs on a CUDA device.
    ``spec_k`` > 0 decodes speculatively with the draft ``draft`` names
    (``runtime.spec.parse_draft_spec``: 'self' | 'shallow:N').
    ``decode_block_reuse`` / ``partial_match`` False (with ``admission=
    'fcfs'``) build the cold-cache baseline.  ``mesh`` / ``shard_policy``:
    this rank's engine of a sharded serve (``PagedMLAEngine``)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected {ENGINES}")
    draft_cfg = draft_params = None
    if spec_k:
        draft_cfg, draft_params = parse_draft_spec(draft, cfg, params)
    # a verify window is clipped to the request's budget: no wider table
    per_req = blocks_for(max_len + 1, block_size)
    # fork children share the prompt blocks; each needs its own tail run
    per_group = per_req + (n - 1) * blocks_for(gen + 1, block_size)
    return ENGINES[engine](
        cfg, params, num_blocks=num_blocks or (1 + batch * per_group),
        block_size=block_size, max_batch=max(batch, n),
        max_blocks_per_req=per_req, compute_dtype=compute_dtype, impl=impl,
        scheme=scheme, platform=PLATFORMS[platform],
        enable_prefix_cache=prefix_cache,
        prefill_mode="chunked" if prefill_chunk else "per_request",
        prefill_chunk=prefill_chunk or 32, cache_dtype=cache_dtype,
        admission=admission, admission_age_bound=admission_age_bound,
        temperature=temperature, top_k=top_k, sample_seed=sample_seed,
        telemetry=telemetry, device=device, prefill_impl=prefill_impl,
        cuda_graphs=cuda_graphs, spec_k=spec_k, draft_cfg=draft_cfg,
        draft_params=draft_params, decode_block_reuse=decode_block_reuse,
        partial_match=partial_match, mesh=mesh, shard_policy=shard_policy)


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
    if engine.spec_k:
        log(f"[serve] spec decode: {summary['spec_rounds']:.0f} rounds, "
            f"accept rate {summary['spec_accept_rate']:.2f} "
            f"({summary['spec_accepted']:.0f}/"
            f"{summary['spec_drafted']:.0f} drafts), "
            f"{summary['spec_mean_emitted']:.2f} tokens/round, "
            f"{summary['spec_compiles']:.0f} spec step shapes")
    if summary["fork_groups"]:
        log(f"[serve] parallel sampling: {summary['fork_groups']:.0f} groups "
            f"forked ({summary['fork_children']:.0f} children)")
    first = min(engine.sched.finished, key=lambda r: r.rid)
    log(f"[serve] sample: {np.asarray(first.output[:16])}")
    return summary


def report_telemetry(tel: Telemetry, engine: PagedMLAEngine, *,
                     trace_path: str = "", metrics_path: str = "",
                     log=print) -> None:
    """Finalize ``tel`` on the drained ``engine``, write the requested
    artifacts, and log the metrics table and the drift summary."""
    tel.finalize(engine)
    written = tel.export(trace_path=trace_path or None,
                         metrics_path=metrics_path or None)
    for channel, path in written.items():
        log(f"[serve] telemetry: {channel} -> {path}")
    if tel.metrics is not None:
        log(tel.metrics.render_table())
    if tel.drift is not None and tel.drift.rows:
        d = tel.drift.report()["summary"]
        log(f"[serve] roofline drift: time-ratio p50 "
            f"{d['time_ratio_p50']:.3g}, spread {d['spread']:.2f}")


def serve_contiguous(cfg, params, *, batch: int, prompt_len: int, gen: int,
                     scheme: str = "auto", platform: str = "h100",
                     impl: str = "ref", seed: int = 0,
                     compute_dtype=torch.float32, device="cuda",
                     log=print) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens together
    (after ``stub_embeds``' patches for a VLM; over its frames for an
    encoder-decoder, which encodes them first), then decode ``gen - 1``
    greedy steps over contiguous caches; log a report and return {scheme,
    tokens (B, gen), prefill_s, decode_s, decode_steps, last_logits},
    times from the host clock around work that ends in a device
    synchronize.  ``scheme`` 'auto' runs the dispatch for an MLA model
    and resolves to 'seq' for the others."""
    if scheme == "auto" and cfg.attn_kind == "mla":
        cap = prompt_len + gen
        scheme = auto_dispatch(cfg.mla_config(), PLATFORMS[platform],
                               cache_len=cap, batch=batch)
        log(f"[serve] auto_dispatch({platform}, L={cap}, B={batch}) -> "
            f"scheme '{scheme}'")
    elif scheme == "auto":
        scheme = "seq"
    if cfg.attn_kind == "mla":
        params = _prepare_mla(params, cfg, scheme)
    embeds = stub_embeds(cfg, batch, seed, device)
    # cached prefix positions: a VLM's patches; an encoder-decoder's
    # frames go to its cross cache, so its index counts decoder tokens
    n_pre = 0 if cfg.family == "encdec" else cfg.stub_rows
    prefill = make_prefill_step(cfg, capacity=n_pre + prompt_len + gen + 1,
                                compute_dtype=compute_dtype, impl=impl,
                                scheme=scheme)
    step = make_serve_step(cfg, compute_dtype=compute_dtype, impl=impl,
                           scheme=scheme)
    rng = np.random.default_rng(seed + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                           device=device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks, embeds)
    out = [torch.argmax(logits, dim=-1)]
    sync()
    prefill_s = time.perf_counter() - t0
    log(f"[serve] prefill {batch}x{prompt_len}"
        + (f" after {n_pre} patches" if n_pre else "")
        + (f" over {embeds.shape[1]} frames" if cfg.family == "encdec"
           else "")
        + f": {prefill_s:.2f}s")
    t0 = time.perf_counter()
    for i in range(gen - 1):
        # the index counts every cached position, the patches too
        logits, cache = step(params, out[-1], cache, n_pre + prompt_len + i)
        out.append(torch.argmax(logits, dim=-1))
    sync()
    decode_s = time.perf_counter() - t0
    tokens = torch.stack(out, dim=1).cpu().numpy()
    log(f"[serve] decoded {gen - 1} steps in {decode_s:.2f}s "
        f"({(gen - 1) * batch / max(decode_s, 1e-9):.1f} tok/s), "
        f"scheme={scheme}")
    log(f"[serve] sample: {tokens[0][:16]}")
    return {"scheme": scheme, "tokens": tokens, "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_steps": gen - 1,
            "last_logits": logits}


def stub_embeds(cfg, batch: int, seed: int = 0, device="cuda"):
    """A VLM's stub patch prefix (B, n_patches, d_model) or an
    encoder-decoder's stub frames (B, n_frames, d_model), f32, drawn as
    the reference launcher draws them: normal * 0.02 under the second key
    of split(PRNGKey(seed + 1)) (the reference draws its prompts under
    the first); None for other families."""
    n = cfg.stub_rows
    if not n:
        return None
    emb_key = prng.split(prng.PRNGKey(seed + 1, device))[1]
    return prng.normal(emb_key, (batch, n, cfg.d_model)) * 0.02


def _prepare_mla(params, cfg, scheme: str):
    """Attach the absorbed weights 'ru' streams; other schemes skip it."""
    if scheme != "ru":
        return params
    return mlalib.attach_absorbed_tree(params, cfg.mla_config())


def parse_mesh(spec: str):
    """'' -> None; 'DPxMP' (e.g. '2x2') -> (dp, mp)."""
    if not spec:
        return None
    try:
        dp, mp = (int(x) for x in spec.lower().replace(",", "x").split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects 'DPxMP' (e.g. '2x2'), got {spec!r}")
    if dp < 1 or mp < 1:
        raise SystemExit(f"--mesh {spec}: sizes must be >= 1")
    return dp, mp


def _mesh_refusals(args) -> List[str]:
    """The options a mesh serve does not run in the port (ROADMAP.md)."""
    asked = {"--paged (the contiguous path)": not args.paged,
             "--engine async": args.engine != "sync",
             "--spec-k": args.spec_k != 0, "--serve": args.serve,
             "--prefill-chunk 0": args.prefill_chunk == 0}
    return [k for k, v in asked.items() if v]


def _serve_rank(mesh, args) -> dict:
    """One rank of ``--mesh``: its shards of the weights, its engine, the
    synthetic requests; rank 0 prints.  Returns the engine summary."""
    log = print if mesh.rank == 0 else (lambda *a, **k: None)
    cfg = configs.smoke(args.arch) if args.smoke else configs.full(args.arch)
    from ..weights import init_sharded_params
    params = init_sharded_params(cfg, mesh, args.policy, seed=args.seed)
    tel = None
    if mesh.rank == 0 and (args.trace or args.metrics):
        tel = Telemetry.on(trace=bool(args.trace),
                           metrics=bool(args.metrics), drift=True)
    engine = build_engine(
        cfg, params, batch=args.batch, max_len=args.prompt_len + args.gen,
        n=args.n, gen=args.gen, block_size=args.block_size,
        num_blocks=args.num_blocks, impl=args.impl, scheme=args.scheme,
        platform=args.platform, prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk, admission=args.admission,
        admission_age_bound=args.admission_age_bound,
        cache_dtype=args.cache_dtype, temperature=args.temperature,
        top_k=args.top_k, sample_seed=args.seed, telemetry=tel,
        device=mesh.device, prefill_impl=args.prefill_impl, mesh=mesh,
        shard_policy=args.policy)
    log(f"[serve] mesh {'x'.join(map(str, mesh.shape))} "
        f"{mesh.axis_names}, policy {args.policy}: max_batch "
        f"{engine.sched.max_batch}, rank 0 on {mesh.device}")
    summary = serve_paged(engine, synthetic_requests(
        cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        n=args.n, seed=args.seed), log=log)
    if tel is not None:
        report_telemetry(tel, engine, trace_path=args.trace,
                         metrics_path=args.metrics)
    return {k: v for k, v in summary.items()
            if isinstance(v, (int, float, str, dict))}


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching over the paged latent pool "
                         "(default: contiguous caches)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--scheme", default="auto",
                    choices=("auto", "naive", "seq", "rc", "ru"))
    ap.add_argument("--platform", default="h100", choices=sorted(PLATFORMS))
    ap.add_argument("--impl", default="ref",
                    choices=("ref", "chunked", "kernel"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool blocks (0 = sized for the request load)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix prefix-cache block sharing")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="batched paged prefill chunk size (0 = "
                         "per-request contiguous prefill)")
    ap.add_argument("--cache-dtype", default="bf16",
                    choices=("bf16", "int8", "fp8"),
                    help="paged pool storage: int8 / fp8 quantize on "
                         "write with per-slot f32 scales; needs --paged "
                         "and --prefill-chunk > 0")
    ap.add_argument("--n", type=int, default=1,
                    help="parallel samples per request (prefill once, "
                         "fork n ways copy-on-write)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft K tokens per tick "
                         "and verify them in one k+1-query chunk step "
                         "(token-identical to plain decode; requires "
                         "--paged)")
    ap.add_argument("--draft", default="shallow:2",
                    help="draft model under --spec-k: 'shallow:N' = the "
                         "target's own first N layers (self-speculation) "
                         "| 'self' = identity draft (acceptance oracle)")
    ap.add_argument("--admission", default="cache_aware",
                    choices=("cache_aware", "fcfs"))
    ap.add_argument("--admission-age-bound", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with a per-request key "
                         "folded with the absolute token position")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k cut when sampling (0 = full vocab)")
    ap.add_argument("--trace", default="",
                    help="write Chrome/Perfetto trace-event JSON to this "
                         "path")
    ap.add_argument("--metrics", default="",
                    help="write metrics-registry JSON to this path and "
                         "print the table")
    ap.add_argument("--prefill-impl", default="auto",
                    choices=("auto", "gather", "kernel", "pallas"),
                    help="chunked-prefill attention: 'gather' attends the "
                         "block-table view, 'kernel' ('pallas', the "
                         "reference's name) runs K2 in place; 'auto' "
                         "follows --impl")
    ap.add_argument("--engine", default="sync", choices=tuple(ENGINES),
                    help="paged engine: 'sync' steps the device and waits; "
                         "'async' schedules tick N+1 while the device runs "
                         "tick N (the same tokens)")
    ap.add_argument("--serve", action="store_true",
                    help="serve the HTTP/SSE frontend (launch.server) on "
                         "--host:--port instead of the synthetic batch; "
                         "requires --paged")
    ap.add_argument("--host", default="127.0.0.1",
                    help="frontend bind host (with --serve)")
    ap.add_argument("--port", type=int, default=8000,
                    help="frontend bind port (with --serve)")
    ap.add_argument("--mesh", default="",
                    help="'DPxMP' (e.g. '2x2' = data x model): serve over "
                         "that many ranks, spawned here (needs --paged)")
    ap.add_argument("--policy", default="serve", choices=SHARD_MODES[1:],
                    help="weight-sharding rules under --mesh "
                         "(nn.sharding.make_rules mode)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    shape = parse_mesh(args.mesh)
    if shape is not None:
        refused = _mesh_refusals(args)
        if refused:
            raise NotImplementedError(
                f"{refused} under --mesh: not ported to repro_torch yet "
                f"(see ROADMAP.md, queue 1)")
        from .mesh import launch
        return launch(_serve_rank, shape, args=(args,), device=args.device)
    # the contiguous path decodes greedily and has no telemetry hooks
    paged_only = {"--cache-dtype": args.cache_dtype != "bf16",
                  "--n": args.n != 1,
                  "--temperature": args.temperature != 0.0,
                  "--top-k": args.top_k != 0,
                  "--trace": bool(args.trace),
                  "--metrics": bool(args.metrics),
                  "--engine": args.engine != "sync",
                  "--serve": args.serve,
                  "--spec-k": args.spec_k != 0,
                  "--prefill-impl": args.prefill_impl != "auto"}
    if not args.paged and any(paged_only.values()):
        raise SystemExit(f"{[k for k, v in paged_only.items() if v]} "
                         f"require --paged")

    cfg = configs.smoke(args.arch) if args.smoke else configs.full(args.arch)
    params = nnm.init_params(models.model_defs(cfg), seed=args.seed,
                             dtype=torch.float32, device=args.device)
    if not args.paged:
        serve_contiguous(cfg, params, batch=args.batch,
                         prompt_len=args.prompt_len, gen=args.gen,
                         scheme=args.scheme, platform=args.platform,
                         impl=args.impl, seed=args.seed, device=args.device)
        return
    tel = None
    if args.trace or args.metrics:
        tel = Telemetry.on(trace=bool(args.trace),
                           metrics=bool(args.metrics), drift=True)
    engine = build_engine(
        cfg, params, batch=args.batch, max_len=args.prompt_len + args.gen,
        n=args.n, gen=args.gen, block_size=args.block_size,
        num_blocks=args.num_blocks, impl=args.impl, scheme=args.scheme,
        platform=args.platform, prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk, admission=args.admission,
        admission_age_bound=args.admission_age_bound,
        cache_dtype=args.cache_dtype, temperature=args.temperature,
        top_k=args.top_k, sample_seed=args.seed, telemetry=tel,
        device=args.device, engine=args.engine,
        prefill_impl=args.prefill_impl, spec_k=args.spec_k,
        draft=args.draft)
    if args.spec_k:
        print(f"[serve] speculative decoding: k={args.spec_k}, "
              f"draft={args.draft} ({engine.draft_cfg.n_layers} layers)")
    # capture before the first request, so no tick times a capture
    engine.warm_up()
    if args.serve:
        from .server import Frontend
        fe = Frontend(engine, host=args.host, port=args.port)
        print(f"[serve] HTTP/SSE frontend on http://{fe.host}:{fe.port} "
              f"(engine={args.engine}; POST /v1/generate, /v1/cancel; "
              f"GET /v1/health, /v1/metrics; Ctrl-C to stop)", flush=True)
        return fe.serve_forever()
    serve_paged(engine, synthetic_requests(
        cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        n=args.n, seed=args.seed))
    if tel is not None:
        report_telemetry(tel, engine, trace_path=args.trace,
                         metrics_path=args.metrics)


if __name__ == "__main__":
    main()
