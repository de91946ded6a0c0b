#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU (written for an H100):

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

  1. card and build — the card's name and power limit, then the paged MLA
     attention kernels built from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all at once);
  2. kernels against their plain PyTorch versions at the main path's
     shapes (B=8 requests, H=128, Dl=512, Dr=64, block 16, prefill chunk
     32; ragged lengths, an inactive slot, null and stale blocks, unused
     blocks poisoned with 1e4), in bf16 and f32 and both rescale modes,
     with each kernel's time beside its plain version's, the PyTorch
     library call's (SDPA over the gathered view) and its bound;
  3. end to end at full width — DeepSeek-V2 (d_model 5120, 128 heads,
     160 experts top-6 at the config's capacity factor, vocab 102400)
     cut to 4 layers, random bf16 weights on the card; a short warm-up
     serve at the same shapes, then 8 timed requests (two share a
     512-token prefix) through the port's engine with ``impl='kernel'``;
     launch counts checked against layers x decode ticks and layers x
     prefill chunks; kernel-path logits held against the reference path
     (at drop-free MoE capacity, see ``drop_free``);
  4. greedy-token parity of ``impl='kernel'`` and ``impl='ref'`` on the
     f32 smoke config.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 TC / f32
B, H, DL, DR, BS, C = 8, 128, 512, 64, 16, 32   # the main path's shapes
# bf16 output: both sides round an f32 result to bf16 (8 significant
# bits), so they may differ by one bf16 step (<= 2^-6 for |o| < 4) plus
# summation-order noise.  f32: summation order over <= 1,056 positions and
# exp vs exp2 rounding stay near 1e-6; 1e-4 leaves margin.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# full-width logits, bf16, kernel path vs reference path: the two round
# the attention output to bf16 at different points in every layer, and a
# token whose 6th and 7th expert gates tie within that noise may route
# differently; a wiring fault (wrong query, pool, scale or mask) moves a
# row by O(1) of its norm.
LOGITS_REL_L2 = 0.1


def drop_free(cfg):
    """``cfg`` with drop-free MoE capacity (capacity_factor = n_experts /
    top_k, as the JAX package's serving benchmark runs it) for the
    comparisons of two attention paths: at the configs' 1.25 the idle
    rows of a prefill chunk compete with real tokens for expert slots, so
    two paths that differ only in what they return for idle rows would
    route real tokens differently.  Serving and timing use the config's
    own capacity."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing --


def time_ms(torch, fn, flush, reps: int = 15) -> float:
    """Median device time of ``fn`` over ``reps`` launches, CUDA events
    around each; the L2 is flushed before each one (a decode layer finds
    its pool cold: the other layers' weights stream in between)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------ phase 2: kernels --


def paged_inputs(torch, dtype, lengths_needed, seed: int):
    """A pool and block tables at the main path's shapes: each request's
    table maps its blocks to distinct random pool blocks, entries past its
    length point at the null block or at stale blocks of other data, and
    every block no table references is poisoned with 1e4."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    nb = max(-(-n // BS) for n in lengths_needed) + 2
    N = 1 + B * nb + 16
    ckv = torch.randn((N, BS, DL), generator=g, device="cuda").to(dtype)
    krope = torch.randn((N, BS, DR), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(N - 1, generator=g, device="cuda") + 1
    bt = perm[: B * nb].reshape(B, nb).to(torch.int32)
    for b, n in enumerate(lengths_needed):
        used = -(-n // BS)
        bt[b, used::2] = 0                       # null-block tail entries
    poisoned = torch.ones(N, dtype=torch.bool, device="cuda")
    poisoned[bt.reshape(-1).long()] = False
    poisoned[0] = False
    ckv[poisoned] = 1e4
    krope[poisoned] = 1e4
    return ckv, krope, bt


def check_kernels(torch):
    from repro_torch.kernels import mla_decode, mla_prefill, ref

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    indices = [1055, 255, 511, 1023, 300, 767, 15, -1]   # -1: inactive slot
    lengths = [1024, 224, 480, 992, 0, 736, 16, 0]
    n_valid = [32, 32, 32, 31, 32, 20, 1, 0]             # 0: idle row
    scale = (128 + 64) ** -0.5
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        need_dec = [i + 1 for i in indices]
        need_pre = [ln + nv if nv else 0 for ln, nv in zip(lengths, n_valid)]
        ckv, krope, bt = paged_inputs(
            torch, dtype, [max(a, b) for a, b in zip(need_dec, need_pre)], 1)
        g = torch.Generator(device="cuda")
        g.manual_seed(2)
        q1 = torch.randn((B, H, DL + DR), generator=g, device="cuda").to(dtype)
        q2 = torch.randn((B, C, H, DL + DR), generator=g,
                         device="cuda").to(dtype)
        idx = torch.tensor(indices, dtype=torch.int32, device="cuda")
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
        cases = {   # name: (kernel wrapper, plain version, operands)
            "mla_decode_paged": (mla_decode.mla_decode_paged_kernel,
                                 ref.mla_decode_paged_ref,
                                 (q1, ckv, krope, bt, idx)),
            "mla_prefill_paged": (mla_prefill.mla_prefill_paged_kernel,
                                  ref.mla_prefill_paged_ref,
                                  (q2, ckv, krope, bt, ln, nv)),
        }
        for name, (kern, plain, args) in cases.items():
            for rescale in ref.RESCALES:
                got = kern(*args, softmax_scale=scale, rescale=rescale)
                torch.cuda.synchronize()
                want = plain(*args, softmax_scale=scale, rescale=rescale)
                exact = plain(*args, softmax_scale=scale)
                err = (got.float() - want.float()).abs().max().item()
                err_exact = (got.float() - exact.float()).abs().max().item()
                tol = TOL[dtype_name]
                ok = torch.allclose(got.float(), want.float(), atol=tol,
                                    rtol=tol)
                ok_exact = torch.allclose(got.float(), exact.float(),
                                          atol=tol, rtol=tol)
                if name == "mla_decode_paged":
                    zero = bool((got[7] == 0).all())          # index -1
                else:
                    zero = bool((got[7] == 0).all()
                                and (got[6, 1:] == 0).all()
                                and (got[3, 31:] == 0).all())
                log(f"[kernels] {name} {dtype_name} {rescale}: max|kernel - "
                    f"plain| {err:.3g}, vs exact softmax {err_exact:.3g} "
                    f"(tol {tol} abs+rel), dead rows exactly 0: {zero}")
                if not (ok and ok_exact and zero):
                    raise AssertionError(f"{name} {dtype_name} {rescale} "
                                         f"disagrees with its plain version")
                if dtype_name == "bfloat16" and rescale == "exp_add":
                    rows[name] = {"max_abs_err": err}
        if dtype_name != "bfloat16":
            continue
        # timing and bounds at the main path's dtype (bf16) and rescale
        es = 2
        dec_pos = sum(need_dec)
        pre_pos = sum(need_pre)
        pre_rows_pos = sum(ln_ + c + 1 for ln_, nv_ in zip(lengths, n_valid)
                           for c in range(nv_))
        work = {
            "mla_decode_paged": (
                q1.numel() * es + dec_pos * (DL + DR) * es + B * H * DL * es
                + (sum(-(-n // BS) for n in need_dec) + B) * 4,
                2 * H * dec_pos * (DL + DR + DL)),
            "mla_prefill_paged": (
                q2.numel() * es + pre_pos * (DL + DR) * es
                + B * C * H * DL * es
                + (sum(-(-n // BS) for n in need_pre) + 2 * B) * 4,
                2 * H * pre_rows_pos * (DL + DR + DL)),
        }
        lib = library_calls(torch, q1, q2, ckv, krope, bt, idx, ln, nv, scale)
        for name, (kern, plain, args) in cases.items():
            n_bytes, n_ops = work[name]
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / PEAK_OPS[dtype_name] * 1e3
            kw = dict(softmax_scale=scale, rescale="exp_add")
            rows[name].update(
                ms=time_ms(torch, functools.partial(kern, *args, **kw), flush),
                plain_ms=time_ms(torch, functools.partial(plain, *args, **kw),
                                 flush, reps=5),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=time_ms(torch, lib[name], flush, reps=5))
            r = rows[name]
            log(f"[kernels] {name} bf16 time {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: "
                f"{n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.2f} GFLOP)")
    return rows


def library_calls(torch, q1, q2, ckv, krope, bt, idx, ln, nv, scale):
    """One PyTorch call per kernel computing the same attention:
    ``scaled_dot_product_attention`` over the gathered block-table view
    (built beforehand, outside the timed call).  Timed only; the port
    never calls it."""
    import torch.nn.functional as F

    nb = bt.shape[1]
    S = nb * BS
    kv = torch.cat([ckv[bt.long()].reshape(B, S, DL),
                    krope[bt.long()].reshape(B, S, DR)], dim=-1)
    k = kv[:, None].expand(B, H, S, DL + DR)
    v = kv[:, None, :, :DL].expand(B, H, S, DL)
    pos = torch.arange(S, device="cuda")
    m1 = (pos[None, :] <= idx[:, None].long())[:, None, None, :]
    qpos = ln[:, None].long() + torch.arange(C, device="cuda")[None, :]
    m2 = ((pos[None, None, :] <= qpos[:, :, None])
          & (torch.arange(C, device="cuda")[None, :, None]
             < nv[:, None, None].long()))[:, None]
    q1s = q1[:, :, None]                     # (B, H, 1, D)
    q2s = q2.permute(0, 2, 1, 3)             # (B, H, C, D)
    return {
        "mla_decode_paged": lambda: F.scaled_dot_product_attention(
            q1s, k, v, attn_mask=m1, scale=scale),
        "mla_prefill_paged": lambda: F.scaled_dot_product_attention(
            q2s, k, v, attn_mask=m2, scale=scale),
    }


# --------------------------------------------------- phase 3: full width --


def warm_up_requests(cfg, np, Request, SamplingParams):
    """8 requests of 64 prompt tokens and 4 generated: every shape of the
    timed serve (the (8, 32) prefill chunk, the 8-row decode tick, the
    MoE's expert capacity per chunk and per tick) in a few steps."""
    rng = np.random.default_rng(1)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 64)
                    .astype(np.int32), arrival=0,
                    sampling=SamplingParams(max_tokens=4))
            for i in range(8)]


def requests_full(cfg, np, Request, SamplingParams, gen: int):
    """8 requests of 256-1,024 prompt tokens; requests 0 and 1 share a
    512-token prefix (request 1 arrives after request 0's prefill, so its
    prefix comes from the radix cache)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 512)
    lens = [768, 896, 256, 1024, 384, 640, 512, 1000]
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n - 512)])
               if i < 2 else rng.integers(0, cfg.vocab, n)
               for i, n in enumerate(lens)]
    return [Request(rid=i, prompt=p.astype(np.int32), arrival=i,
                    sampling=SamplingParams(max_tokens=gen))
            for i, p in enumerate(prompts)]


def full_width(torch, np):
    from repro_torch import configs, models
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import build_engine, serve_paged
    from repro_torch.nn import module as nnm
    from repro_torch.runtime import Request, SamplingParams

    cfg = dataclasses.replace(configs.full("deepseek-v2-236b"), n_layers=4)
    gen = 32
    t0 = time.perf_counter()
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[e2e] {cfg.name} x{cfg.n_layers} layers (plan "
        f"{[d.ffn for d, _ in models.lm.layers(cfg, params)]}): "
        f"{n_params / 1e9:.2f} B params bf16 "
        f"({n_params * 2 / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f}s")
    reqs = requests_full(cfg, np, Request, SamplingParams, gen)
    engine_kw = dict(batch=len(reqs), max_len=max(r.plen for r in reqs) + gen,
                     gen=gen, block_size=BS, impl="kernel", scheme="auto",
                     platform="h100", prefill_chunk=C,
                     compute_dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    warm = build_engine(cfg, params, **engine_kw)
    warm.run(warm_up_requests(cfg, np, Request, SamplingParams))
    log(f"[e2e] warm-up serve: {warm.stats.steps} steps in "
        f"{time.perf_counter() - t0:.2f}s")
    del warm
    engine = build_engine(cfg, params, **engine_kw)
    torch.cuda.reset_peak_memory_stats()
    mla_decode.mla_decode_paged_kernel.launches = 0
    mla_prefill.mla_prefill_paged_kernel.launches = 0
    summary = serve_paged(engine, reqs, log=log, log_every=0)
    launches = {"mla_decode_paged": mla_decode.mla_decode_paged_kernel.launches,
                "mla_prefill_paged":
                    mla_prefill.mla_prefill_paged_kernel.launches}
    ticks = sum(summary["schemes_used"].values())
    chunks = summary["prefill_chunks"]
    done = engine.sched.finished
    log(f"[e2e] finished {len(done)}/{len(reqs)} requests, "
        f"{summary['decode_tokens']} decode tokens in {summary['steps']} "
        f"steps ({ticks} decode ticks, {chunks} prefill chunks), prefix "
        f"hit tokens {summary['prefix_hit_tokens']:.0f}")
    log(f"[e2e] {summary['tokens_per_s']:.1f} tokens/s, step "
        f"{engine.stats.wall * 1e3 / engine.stats.steps:.2f} ms mean, "
        f"peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}, MoE capacity factor {cfg.capacity_factor}")
    if len(done) != len(reqs) or any(len(r.output) != gen for r in done):
        raise AssertionError("not every request finished with its tokens")
    if summary["prefix_hit_tokens"] < 512:
        raise AssertionError("the shared 512-token prefix did not hit")
    want = {"mla_decode_paged": cfg.n_layers * ticks,
            "mla_prefill_paged": cfg.n_layers * chunks}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    compare_logits(torch, drop_free(cfg), reqs, engine)
    del engine, params
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def compare_logits(torch, cfg, reqs, engine):
    """Prefill every prompt with the kernel path, then run the same last
    prefill chunk and the first decode step on copies of that pool with
    impl='kernel' and impl='ref'; the logits must agree within
    LOGITS_REL_L2 per row."""
    from repro_torch import models
    from repro_torch.runtime import blocks_for

    params = engine.params          # with the absorbed leaves 'ru' reads
    nb = max(blocks_for(r.plen + 1, BS) for r in reqs)
    pool = models.init_paged_cache(cfg, 1 + len(reqs) * nb, BS,
                                   torch.bfloat16, "cuda")
    bt = (1 + torch.arange(len(reqs) * nb, device="cuda", dtype=torch.int32)
          ).reshape(len(reqs), nb)
    plens = [r.plen for r in reqs]
    n_chunks = max(-(-p // C) for p in plens)
    kw = dict(compute_dtype=torch.bfloat16, scheme="seq")

    def chunk(i, pool, impl):
        tokens = torch.zeros((len(reqs), C), dtype=torch.long, device="cuda")
        lens, nvs = [], []
        for b, r in enumerate(reqs):
            start = min(i * C, r.plen)
            take = max(min(r.plen - start, C), 0)
            tokens[b, :take] = torch.as_tensor(r.prompt[start:start + take])
            lens.append(start)
            nvs.append(take)
        as_i32 = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
        logits, _ = models.prefill_chunk_paged(
            params, cfg, tokens, pool, bt, as_i32(lens), as_i32(nvs),
            impl=impl, **kw)
        return logits, [b for b, n in enumerate(nvs) if n]

    for i in range(n_chunks - 1):
        chunk(i, pool, "kernel")
    pool_r = _clone(pool)
    logits_k, live = chunk(n_chunks - 1, pool, "kernel")
    logits_r, _ = chunk(n_chunks - 1, pool_r, "ref")
    # rows whose prompt ended in an earlier chunk are idle here (garbage
    # logits by contract); compare the rows this chunk finishes
    rel_prefill = _row_rel(torch, logits_k[live], logits_r[live])
    tok = torch.argmax(logits_k, dim=-1)
    lengths = torch.tensor(plens, dtype=torch.int32, device="cuda")
    dec_k = models.decode_step(params, cfg, tok, pool, bt, lengths,
                               impl="kernel", **kw)[0]
    dec_r = models.decode_step(params, cfg, tok, pool_r, bt, lengths,
                               impl="ref", **kw)[0]
    rel_decode = _row_rel(torch, dec_k, dec_r)
    log(f"[e2e] logits kernel vs ref, per-row |a-b|/|b| (bound "
        f"{LOGITS_REL_L2}): last prefill chunk max {max(rel_prefill):.4f}, "
        f"first decode step max {max(rel_decode):.4f}; max |a-b| decode "
        f"{(dec_k.float() - dec_r.float()).abs().max().item():.4f}")
    if max(rel_prefill + rel_decode) > LOGITS_REL_L2:
        raise AssertionError("kernel-path logits disagree with the "
                             "reference path")


def _clone(pool):
    if isinstance(pool, dict):
        return {k: _clone(v) for k, v in pool.items()}
    if isinstance(pool, list):
        return [_clone(v) for v in pool]
    return pool.clone()


def _row_rel(torch, a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()


# ------------------------------------------------- phase 4: token parity --


def token_parity(torch):
    from repro_torch import configs, models
    from repro_torch.launch.serve import (build_engine, serve_paged,
                                          synthetic_requests)
    from repro_torch.nn import module as nnm

    cfg = drop_free(configs.smoke("deepseek-v2-236b"))
    # seed 4: on this load its smallest top-1 / top-2 logit margin is 7e-3
    # (CPU run), four orders above f32 noise, so identical tokens test the
    # kernel and not a near-tie
    params = nnm.init_params(models.model_defs(cfg), seed=4,
                             dtype=torch.float32, device="cuda")
    outs = {}
    for impl in ("kernel", "ref"):
        engine = build_engine(cfg, params, batch=4, max_len=48 + 12, n=2,
                              gen=12, impl=impl, scheme="auto",
                              platform="h100", prefill_chunk=8,
                              compute_dtype=torch.float32, device="cuda")
        serve_paged(engine, synthetic_requests(cfg, batch=4, prompt_len=48,
                                               gen=12, n=2, seed=4),
                    log=lambda _: None)
        outs[impl] = {r.rid: list(r.output) for r in engine.sched.finished}
    same = outs["kernel"] == outs["ref"]
    log(f"[parity] smoke f32 greedy tokens, impl kernel vs ref: "
        f"{'identical' if same else 'DIFFERENT'} over {len(outs['ref'])} "
        f"requests")
    if not same:
        raise AssertionError(f"tokens differ: {outs}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {card_line()}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.1f}s: "
        f"{[os.path.basename(p) for p in paths]}")

    rows = check_kernels(torch)
    launches = full_width(torch, np)
    token_parity(torch)

    meta = {"mla_decode_paged": ("src/repro_torch/kernels/csrc/"
                                 "mla_decode_paged.cu",
                                 "src/repro/kernels/mla_decode.py:170"),
            "mla_prefill_paged": ("src/repro_torch/kernels/csrc/"
                                  "mla_prefill_paged.cu",
                                  "src/repro/kernels/mla_prefill.py:106")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **rows[name]}
               for name, (src, replaces) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
