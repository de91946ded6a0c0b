#!/usr/bin/env python3
"""Where the time goes in ``chip_smoke.py``'s full-width paged serve
(phase 3), contiguous serve (phase 4) and training step (phase 6), on
one CUDA card:

    python3 chip_profile.py               # paged serving, bf16 pool
    python3 chip_profile.py fp8           # paged serving, fp8 pool
    python3 chip_profile.py eager         # ... the engine without graphs
    python3 chip_profile.py async         # ... the async engine
    python3 chip_profile.py contiguous    # contiguous serving
    python3 chip_profile.py train         # training
    python3 chip_profile.py flash         # K4-K6's time, by ablation

Builds the same model (DeepSeek-V2 widths, 4 layers, random bf16 weights,
the config's MoE capacity) and the same 8 requests, then serves them twice
with ``impl='kernel'`` on the engine's default (the sync engine, its
steps replayed from CUDA graphs captured before the serve): once
untraced (the end-to-end numbers), once under ``torch.profiler`` with a
span around each step the engine runs (``prefill_chunk``,
``decode_tick``: a graph's replay, or the eager step).  Prints device
time by span and by kernel, the device busy share of the traced run,
and the tracing cost (traced minus untraced engine seconds).  Spans are
added here, around the engine's step calls, not inside the program.
``fp8`` serves from an fp8 pool instead (per-slot scales, quantize on
write, dequantized in K1 / K2); ``eager`` runs the steps without graphs
(``cuda_graphs=False``); ``async`` on ``AsyncPagedMLAEngine``.  The words
combine.

``contiguous`` builds the same model and runs phase 4's load (batch 8
x 2,048 prompt tokens, 32 generated, ``scheme='auto'``, ``impl='kernel'``)
through ``launch.serve.serve_contiguous``: a warm-up, an untraced run,
then one under ``torch.profiler`` with a span around the prefill step
(``prefill``) and each decode step (``decode_step``).

``train`` builds phase 6's model (DeepSeek-V2 widths cut to 2 layers,
bf16 params, f32 Adam moments, batch 2 x 4096, the config's MoE
capacity, ``impl='kernel'``, loss chunk 1024), runs a warm-up step and
an untraced step, then one step under ``torch.profiler`` with spans
around the loss forward (``lm_loss``) and the optimizer
(``adamw_update``); the backward runs on autograd's own threads, outside
any span.  Prints the device busy share of the traced step and device
time by kernel.

Every mode ends with the port's kernels summed by name
(``KERNEL_GROUPS``): MLA decode (K1 / K3) and MLA prefill (K2), each with
its combine kernel, and the flash forward (K4), dQ (K5) and dK,dV (K6)
by route.

``flash`` (``python3 chip_profile.py flash``) asks where the own time of
K4, K5 and K6 goes at the training path's shapes (bf16 q/k
(2,128,4096,192), v (...,128), causal, (B, L, H, D) views): it builds
patched copies of their tensor-core walks (``FLASH_ABLATIONS``: one part
removed, or one design choice undone, each) into ``build/ablate/``
(listed in ``.gitignore``), one ``nvcc`` each, all at once, and times
each beside its sound walk, in turns, twice, with CUDA events (device
time, the L2 flushed, a device sleep first, as ``chip_smoke.time_ms``).
The copies compute wrong results on purpose; only their times are
read.
"""
from __future__ import annotations

import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the port's kernels by name, summed in the report: (label, pattern)
KERNEL_GROUPS = (
    # K1 / K3 (csrc/mla_decode*.cu, csrc/mla_decode_tc.cuh): the walk and,
    # for bf16 q, the combine kernel that merges its splits
    ("MLA decode (walk + combine)",
     re.compile(r"mla::(tc::combine_kernel|decode(_paged)?(_tc)?_kernel)\b")),
    # K2 (csrc/mla_prefill_paged.cu): its walk and its own combine
    ("MLA prefill (walk + combine)",
     re.compile(r"mla::(prefill_combine_kernel|prefill_paged(_tc)?_kernel)"
                r"\b")),
    # K4 (csrc/flash_attention_fwd*.cu*): the tensor-core walk (bf16) and
    # the WMMA kernel
    ("flash forward, tensor-core walk",
     re.compile(r"fa::tc::fwd_tc_kernel\b")),
    ("flash forward, WMMA", re.compile(r"fa::fwd_kernel\b")),
    # K5 / K6 (csrc/flash_attention_bwd_{dq,dkv}.cu,
    # csrc/flash_attention_bwd_tc.cuh): the tensor-core walks (bf16) and
    # the WMMA kernels
    ("flash backward dQ, tensor-core walk",
     re.compile(r"fa::tcb::dq_tc_kernel\b")),
    ("flash backward dQ, WMMA", re.compile(r"fa::dq_kernel\b")),
    ("flash backward dK,dV, tensor-core walk",
     re.compile(r"fa::tcb::dkv_tc_kernel\b")),
    ("flash backward dK,dV, WMMA", re.compile(r"fa::dkv_kernel\b")),
)


# K4's walk: (name, [(text of csrc/flash_attention_fwd_tc.cuh, its
# replacement)])
FWD_ABLATIONS = [
    ("sound", []),
    ("no exp2f", [("exp2f(fmaf(s[mt][n][e], scale2, -ms[e >> 1]))",
                   "(fmaf(s[mt][n][e], scale2, -ms[e >> 1]))")]),
    ("no softmax", [("    for (int mt = 0; mt < kMT; ++mt) {\n"
                     "      // ---- the tile's row maxima",
                     "    for (int mt = 0; mt < 0; ++mt) {\n"
                     "      // ---- the tile's row maxima")]),
    ("no masking", [("    if (edge) {\n", "    if (false) {\n")]),
    ("no S product", [("            mma(s[mt][2 * np], af[mt], bfr[0], "
                       "bfr[1]);\n            mma(s[mt][2 * np + 1], "
                       "af[mt], bfr[2], bfr[3]);", "")]),
    ("no PV product", [("            mma(o[mt][2 * np], pa[mt], bfr[0], "
                        "bfr[1]);\n            mma(o[mt][2 * np + 1], "
                        "pa[mt], bfr[2], bfr[3]);", "")]),
    ("no K / V copies", [("  auto copy_k = [&](int t) {\n",
                          "  auto copy_k = [&](int t) {\n    return;\n"),
                         ("  auto copy_v = [&](int t) {\n",
                          "  auto copy_v = [&](int t) {\n    return;\n")]),
    # the first design's masking: the full mask test on every element of
    # every tile, gated by `edge` inside the element loop
    ("per-element mask test",
     [("    if (edge) {\n#pragma unroll\n      for (int mt = 0;",
       "    {\n#pragma unroll\n      for (int mt = 0;"),
      ("              if (key < lo || key > hi) s[mt][n][2 * i + e] = "
       "-INFINITY;",
       "              if (edge && !mk(r0 + 16 * mt + g + 8 * i, key))\n"
       "                s[mt][n][2 * i + e] = -INFINITY;")]),
    ("score loop fully unrolled",
     [("#pragma unroll 2\n", "#pragma unroll\n")]),
    ("16 rows a warp (8 warps)",
     [("if (a.Dqk <= 192) return launch_fwd<2, 12, 16>(a, B, stream);",
       "if (a.Dqk <= 192) return launch_fwd<1, 12, 16>(a, B, stream);")]),
    ("a row address once a copy", [("copy_tile<", "copy_tile_rows<")]),
]

# K5's and K6's walks: (name, [(text of csrc/flash_attention_bwd_tc.cuh,
# its replacement)]); both walks live in that header, so an edit may touch
# the other walk too, which is not timed.  An edit of three strings names
# the file it edits first.
DQ_ABLATIONS = [
    ("sound", []),
    ("no exp2f", [("exp2f(fmaf(s[n][2 * i + e], c, -lse2[i]))",
                   "(fmaf(s[n][2 * i + e], c, -lse2[i]))"),
                  ("exp2f(fmaf(s[n][e], c, -lse2[e >> 1]))",
                   "(fmaf(s[n][e], c, -lse2[e >> 1]))")]),
    ("no masking", [("    if (edge) {\n#pragma unroll\n      for (int i = 0;",
                     "    if (false) {\n#pragma unroll\n      for (int i = 0;")]),
    ("no S product", [("        mma(s[2 * np], af, bfr[0], bfr[1]);\n"
                       "        mma(s[2 * np + 1], af, bfr[2], bfr[3]);",
                       "")]),
    ("no dP product", [("        mma(dp[2 * np], af, bfr[0], bfr[1]);\n"
                        "        mma(dp[2 * np + 1], af, bfr[2], bfr[3]);",
                        "")]),
    ("no dQ product", [("          mma(dq[2 * np], pa, bfr[0], bfr[1]);\n"
                        "          mma(dq[2 * np + 1], pa, bfr[2], bfr[3]);",
                        "")]),
    ("no K / V copies", [("  auto copy_kv = [&](int t) {\n",
                          "  auto copy_kv = [&](int t) {\n    return;\n")]),
    ("score loops unrolled by two",
     [("#pragma unroll\n    for (int kk", "#pragma unroll 2\n    for (int kk")]),
    ("a row address per 64 columns", [("copy_tile_rows<", "copy_tile<")]),
]
DKV_ABLATIONS = [
    ("sound", []),
    ("no exp2f", [("ok ? exp2f(fmaf(s[n][e], c, -lse_s[j] * kLog2e)) : 0.0f",
                   "ok ? (fmaf(s[n][e], c, -lse_s[j] * kLog2e)) : 0.0f")]),
    ("no masking", [("      const bool edge =\n", "      const bool edge = false &&\n")]),
    ("no phase-1 products",
     [("          mma(s[2 * np], af, bfr[0], bfr[1]);\n"
       "          mma(s[2 * np + 1], af, bfr[2], bfr[3]);", ""),
      ("          mma(dp[2 * np], af, bfr[0], bfr[1]);\n"
       "          mma(dp[2 * np + 1], af, bfr[2], bfr[3]);", "")]),
    ("no phase-2 products",
     [("            mma(dv[mt][2 * np], pa[mt], bfr[0], bfr[1]);\n"
       "            mma(dv[mt][2 * np + 1], pa[mt], bfr[2], bfr[3]);", ""),
      ("            mma(dk[mt][2 * np], da[mt], bfr[0], bfr[1]);\n"
       "            mma(dk[mt][2 * np + 1], da[mt], bfr[2], bfr[3]);", "")]),
    ("no Q / dO copies", [("  auto copy_q = [&](int t) {\n",
                           "  auto copy_q = [&](int t) {\n    return;\n")]),
    ("no barrier between the phases",
     [("    __syncthreads();        // the P^T and dS^T tiles are whole\n",
       "")]),
    ("phase-1 loops unrolled by two",
     [("#pragma unroll\n      for (int kk", "#pragma unroll 2\n      for (int kk")]),
    ("a row address per 64 columns", [("copy_tile_rows<", "copy_tile<")]),
]
# library: (header edited, its variants)
FLASH_ABLATIONS = {
    "flash_attention_fwd": ("flash_attention_fwd_tc.cuh", FWD_ABLATIONS),
    "flash_attention_bwd_dq": ("flash_attention_bwd_tc.cuh", DQ_ABLATIONS),
    "flash_attention_bwd_dkv": ("flash_attention_bwd_tc.cuh", DKV_ABLATIONS),
}
# the instantiation each library runs at the training path's shapes
PATH_KERNELS = {"flash_attention_fwd": "fwd_tc_kernelILi2ELi12ELi16E",
                "flash_attention_bwd_dq": "dq_tc_kernelILi8ELi12ELi8E",
                "flash_attention_bwd_dkv": "dkv_tc_kernelILi12ELi8E"}


def flash_ablation() -> int:
    import ctypes
    import shutil
    import subprocess

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    print(f"[card] {cs.card_line()}", flush=True)
    csrc = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
    procs = []
    try:
        for lib_name, (header, variants) in FLASH_ABLATIONS.items():
            for i, (name, edits) in enumerate(variants):
                root = os.path.join(HERE, "build", "ablate", lib_name, str(i))
                shutil.rmtree(root, ignore_errors=True)
                shutil.copytree(csrc, root)
                for edit in edits:
                    src, old, new = ((header,) + edit)[-3:]
                    with open(os.path.join(root, src)) as fh:
                        text = fh.read()
                    if old not in text:
                        raise AssertionError(f"{lib_name} {name}: "
                                             f"{old[:40]!r} not in {src}")
                    with open(os.path.join(root, src), "w") as fh:
                        fh.write(text.replace(old, new))
                lib = os.path.join(root, "lib.so")
                procs.append((lib_name, name, lib, subprocess.Popen(
                    [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                     lib, os.path.join(root, f"{lib_name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        fns = {lib_name: {} for lib_name in FLASH_ABLATIONS}
        for lib_name, name, lib, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{lib_name} {name}: nvcc failed\n"
                                   f"{log[-3000:]}")
            # ptxas reports every instantiation: keep the path's
            lines = log.splitlines()
            at = [i for i, ln in enumerate(lines)
                  if "Compiling entry function" in ln
                  and PATH_KERNELS[lib_name] in ln]
            report = " ".join(ln.split("ptxas info    : ")[-1].strip()
                              for i in at[:1] for ln in lines[i + 2:i + 4])
            fn = getattr(ctypes.CDLL(lib), lib_name)
            fn.argtypes = build.SIGNATURES[lib_name]
            fn.restype = ctypes.c_int
            fns[lib_name][name] = fn
            print(f"[build] {lib_name} {name}: {report}", flush=True)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    path = (cs.TB, cs.TH, cs.TH, cs.TL, cs.TL, cs.TDQK, cs.TDV, None, 0)
    q, k, v, do = cs.flash_case_inputs(torch, path, torch.bfloat16, 5,
                                       blhd=True)
    scale = cs.TDQK ** -0.5
    out, lse = fa.flash_fwd_kernel(q, k, v, causal=True, scale=scale)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = (fa._empty_like_layout(t, t.shape) for t in (q, k, v))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    dims = lambda *plan: fa._dims(q, k, v, True, None, 0, (q, k, v, do), 1,
                                  *plan)
    args = {   # each library's C arguments on the route 'tc'
        "flash_attention_fwd": (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), fa._strides(q, k, v, out),
            fa._dims(q, k, v, True, None, 0, (q, k, v), 1, 0, 0)),
        "flash_attention_bwd_dq": (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            fa._strides(q, k, v, do, dq), dims(128, 64)),
        "flash_attention_bwd_dkv": (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            fa._strides(q, k, v, do, dk, dv), dims(64, 64)),
    }

    def run(lib_name, fn):
        err = fn(*args[lib_name], scale, fa._stream(q))
        if err:
            raise RuntimeError(f"{lib_name}: launch failed: cudaError_t "
                               f"{err}")

    for lib_name, variants in fns.items():
        times = {name: [] for name in variants}
        for _ in range(2):
            for name, fn in variants.items():
                times[name].append(cs.time_ms(
                    torch, lambda: run(lib_name, fn), flush, reps=5))
        base = min(times["sound"])
        for name, ts in times.items():
            print(f"[ablate] {lib_name} {name}: "
                  f"{', '.join(f'{t:.3f}' for t in ts)} ms (best "
                  f"{min(ts) - base:+.3f} ms against the sound walk)",
                  flush=True)
    return 0


def report(torch, prof, wall, spans) -> int:
    """Device busy share of a traced window of ``wall`` seconds, the
    spans' device and host time, and device time by kernel."""
    events = prof.key_averages()
    # device-side copies of the spans are ranges, not work: keep them out
    dev = [e for e in events
           if e.device_type.name == "CUDA" and e.key not in spans]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    if busy == 0:
        print("chip_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    print(f"[traced] device busy {busy:.3f} s of {wall:.3f} s "
          f"({100 * busy / wall:.1f} %), idle share "
          f"{100 * (1 - busy / wall):.1f} %")
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
    for label, pattern in KERNEL_GROUPS:
        group = [e for e in dev if pattern.search(e.key)]
        t = sum(e.self_device_time_total for e in group) / 1e6
        print(f"[kernels] {label}: {t:.3f} s, {100 * t / busy:.1f} % of "
              f"device time, {sum(e.count for e in group)} launches")
    return 0


def train_profile() -> int:
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from repro_torch import configs, models
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.nn import module as nnm
    from repro_torch.optim import AdamWConfig, adamw_init, cosine
    from repro_torch.runtime import TrainStepConfig, make_train_step
    from repro_torch.runtime import steps as steps_mod

    print(f"[card] {chip_smoke.card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.full("deepseek-v2-236b"),
                              n_layers=chip_smoke.TRAIN_LAYERS)
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    opt_cfg = AdamWConfig(lr=cosine(3e-4, warmup=20, total=100))
    opt = adamw_init(params, opt_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=chip_smoke.TL,
                                  global_batch=chip_smoke.TB, seed=0))

    def spanned(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    plain = (steps_mod.lm_loss, steps_mod.adamw_update)
    steps_mod.lm_loss = spanned("lm_loss", plain[0])
    steps_mod.adamw_update = spanned("adamw_update", plain[1])
    step = make_train_step(cfg, opt_cfg, TrainStepConfig(
        compute_dtype=torch.bfloat16, impl="kernel", loss_chunk=1024))

    def run():
        toks, labels = data.next_batch()
        batch = {"tokens": torch.as_tensor(toks, device="cuda"),
                 "labels": torch.as_tensor(labels, device="cuda")}
        nonlocal params, opt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        return float(m["loss"]), time.perf_counter() - t0

    try:
        run()                                 # warm-up
        loss, wall = run()
        print(f"[untraced] step {wall * 1e3:.1f} ms, loss {loss:.4f}, "
              f"{chip_smoke.TB * chip_smoke.TL / wall:.0f} tokens/s",
              flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss, traced = run()
    finally:
        steps_mod.lm_loss, steps_mod.adamw_update = plain
    print(f"[traced] step {traced * 1e3:.1f} ms (tracing cost "
          f"{(traced - wall) * 1e3:+.1f} ms), loss {loss:.4f}", flush=True)
    return report(torch, prof, traced, ("lm_loss", "adamw_update"))


def contiguous_profile() -> int:
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from repro_torch import configs, models
    from repro_torch.launch import serve as serve_mod
    from repro_torch.nn import module as nnm

    print(f"[card] {chip_smoke.card_line()}", flush=True)
    cfg = dataclasses.replace(configs.full("deepseek-v2-236b"), n_layers=4)
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    kw = dict(batch=chip_smoke.B, prompt_len=chip_smoke.PROMPT,
              gen=chip_smoke.GEN, scheme="auto", platform="h100",
              impl="kernel", compute_dtype=torch.bfloat16, device="cuda",
              log=lambda _: None)

    def run():
        t0 = time.perf_counter()
        res = serve_mod.serve_contiguous(cfg, params, **kw)
        return res, time.perf_counter() - t0

    def spanned(name, make):
        def build(*args, **kwargs):
            fn = make(*args, **kwargs)

            def call(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return call
        return build

    run()                                     # warm-up
    res, wall = run()
    steps = res["decode_steps"]
    print(f"[untraced] scheme '{res['scheme']}', prefill "
          f"{res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{steps * chip_smoke.B / res['decode_s']:.1f} tokens/s "
          f"({res['decode_s'] * 1e3 / steps:.2f} ms a step), whole run "
          f"{wall:.3f} s", flush=True)
    plain = (serve_mod.make_prefill_step, serve_mod.make_serve_step)
    serve_mod.make_prefill_step = spanned("prefill", plain[0])
    serve_mod.make_serve_step = spanned("decode_step", plain[1])
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res, traced = run()
            torch.cuda.synchronize()
    finally:
        serve_mod.make_prefill_step, serve_mod.make_serve_step = plain
    print(f"[traced] whole run {traced:.3f} s (tracing cost "
          f"{traced - wall:+.3f} s), prefill {res['prefill_s'] * 1e3:.1f} ms, "
          f"decode {res['decode_s'] * 1e3 / steps:.2f} ms a step",
          flush=True)
    return report(torch, prof, traced, ("prefill", "decode_step"))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    if sys.argv[1:] == ["train"]:
        return train_profile()
    if sys.argv[1:] == ["contiguous"]:
        return contiguous_profile()
    if sys.argv[1:] == ["flash"]:
        return flash_ablation()
    words = set(sys.argv[1:])
    if not words <= {"fp8", "eager", "async"}:
        print(f"chip_profile: unknown mode {sys.argv[1:]}", file=sys.stderr)
        return 2
    cache_dtype = "fp8" if "fp8" in words else "bf16"
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

    reqs_fn = lambda: chip_smoke.requests_full(cfg, np, Request,
                                               SamplingParams, gen)

    def engine():
        """A fresh engine with its graphs captured (outside any traced
        window)."""
        e = build_engine(cfg, params, batch=8, max_len=1024 + gen, gen=gen,
                         block_size=chip_smoke.BS, impl="kernel",
                         scheme="auto", platform="h100",
                         prefill_chunk=chip_smoke.C, cache_dtype=cache_dtype,
                         compute_dtype=torch.bfloat16, device="cuda",
                         engine="async" if "async" in words else "sync",
                         cuda_graphs="eager" not in words)
        e.warm_up()
        return e

    def serve(e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = e.run(reqs_fn())
        torch.cuda.synchronize()
        return summary, time.perf_counter() - t0

    serve(engine())                           # warm-up: build, allocator
    summary, wall = serve(engine())
    print(f"[untraced] {cache_dtype} pool, {' '.join(sorted(words)) or 'graphs'}"
          f": {summary['decode_tokens']} decode tokens, {summary['steps']} "
          f"steps, {summary['prefill_chunks']} chunks, "
          f"{summary['tokens_per_s']:.1f} tokens/s, engine {wall:.3f} s",
          flush=True)

    cls = engine_mod.PagedMLAEngine
    plain_run_step = cls._run_step

    def spanned(self, kind, scheme, arrays):
        with record_function("prefill_chunk" if kind == "chunk"
                             else "decode_tick"):
            return plain_run_step(self, kind, scheme, arrays)

    traced_engine = engine()
    cls._run_step = spanned
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, traced = serve(traced_engine)
    finally:
        cls._run_step = plain_run_step
    print(f"[traced] engine {traced:.3f} s (tracing cost "
          f"{traced - wall:+.3f} s over the untraced run)", flush=True)

    return report(torch, prof, traced, ("prefill_chunk", "decode_tick"))


if __name__ == "__main__":
    sys.exit(main())
