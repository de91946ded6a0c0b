#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU (written for an H100):

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

  1. card and build — the card's name and power limit, then the six
     kernels built from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
     source, all at once);
  2. kernels against their plain PyTorch versions: the paged MLA kernels
     K1/K2 at the serving path's shapes (B=8 requests, H=128, Dl=512,
     Dr=64, block 16, prefill chunk 32; ragged lengths, an inactive slot,
     null and stale blocks, unused blocks poisoned with 1e4), in bf16 and
     f32 and both rescale modes, on a bf16 / f32 pool and on int8 and fp8
     pools with per-slot scales; the contiguous decode kernel K3 at the
     contiguous path's shapes (B=8, H=128, S = 2048 + 32 + 1 = 2081) at
     index S - 1 and at a mid index with the tail poisoned, held row by
     row (``row_rel``); bf16 K3 and K1 (the tensor-core split walk) at
     indices one short of, on and one past a split boundary of the
     wrapper's plan, on bf16, int8 and fp8 pools for K1, against their
     plain walks and the split walk's model; bf16 K2 on the same walk
     (chunk rows whose limit falls on a 64-position tile edge, n_valid <
     C, idle requests, and a table as wide as the pool; bf16, int8 and
     fp8 pools) against its plain walk and ``ref.mla_prefill_split_ref``;
     bf16 K2 at phase 9's verify width C = k + 1 = 5 (n_valid < C, an
     idle request; bf16, int8 and fp8 pools) the same way, then its time
     beside its plain version, SDPA, the bound with each prefix read once
     and the bound with each chunk row reading its own prefix, and beside
     K2 at C = 1 and K1 on the same prefixes;
     bf16 K4 on its tensor-core walk (a query tile edge, the causal
     diagonal cutting a key tile, a window, a query offset, GQA / MQA,
     rows that attend no key) and bf16 K5 / K6 on theirs at the same
     cases (finite gradients); every bf16 K1 - K6 launch must have taken
     its tensor-core route (``last_plan``); the
     flash-attention kernels K4 (forward), K5 (dQ) and K6 (dK/dV) in f32
     and bf16 at small
     shapes (GQA, MQA, windows, a query offset, ragged lengths, Dqk != Dv
     up to 576) and at the training path's shapes (B=2, H=128, L=4096,
     Dqk=192, Dv=128, causal, (B, L, H, D) tensors passed as transposed
     views), each output held row by row; each kernel's time beside its plain
     version's, the PyTorch library call's (SDPA) and its bound, the
     fraction of the bound reached and the plan (route, split count or
     tiles, grid) each wrapper recorded at launch, their times and SDPA's
     also without the device sleep (the wrapper's host work included),
     and bf16 K1 on a table as wide as the pool;
  3. paged serving at full width — DeepSeek-V2 (d_model 5120, 128 heads,
     160 experts top-6 at the config's capacity factor, vocab 102400)
     cut to 4 layers, random bf16 weights on the card; a short warm-up
     serve at the same shapes, then 8 timed requests (two share a
     512-token prefix) through the port's engine with ``impl='kernel'``
     on its default, CUDA graphs of its steps (captured before the
     serve by ``engine.warm_up()``), on a bf16 and an fp8 pool in turns
     (bf16, fp8, fp8, bf16); launch counts checked against layers x
     decode ticks and layers x prefill chunks (through the graphs'
     replays), and K1 / K2 on their tensor-core walks (the plans the
     graphs captured); kernel-path logits
     held against the reference path on the same pool (at drop-free MoE
     capacity, see ``drop_free``);
  4. contiguous serving at full width — the same model and weights,
     batch 8 x 2,048 prompt tokens, 32 generated, through
     ``make_prefill_step`` (MHA mode, K4 forward) and ``make_serve_step``
     (K3), ``scheme='auto'`` priced for h100, after a warm-up at the same
     shapes; launch counts checked (K3 = layers x 31 steps, K4 = layers),
     and K4 on its tensor-core walk;
     prefill and last-decode-step logits held against the reference path
     at drop-free capacity;
  5. greedy-token parity on the f32 smoke config: paged ``impl='kernel'``
     vs ``'ref'``; the contiguous path's kernel vs ref and across seq /
     rc / ru / naive; the per-request-prefill engine vs the chunked one;
     the int8 and fp8 engines' kernel vs ref;
  6. training at full width — DeepSeek-V2 cut to 2 layers (1 dense +
     1 MoE, depth only; 4.83 B params), bf16 params and compute, f32 Adam
     moments, batch 2 x 4096 tokens, the config's MoE capacity, through
     ``make_train_step`` with ``impl='kernel'``: one warm-up step, then
     timed steps (tokens/s, ms/step, each step's loss, peak memory) with
     K4/K5/K6 launch counts checked against layers x steps and each on
     its tensor-core walk; then the
     MLA call site's attention (the flash Function) in bf16 at the path's
     shapes against the dense oracle under autograd, out and the q/k/v
     gradients each as a whole;
     then the kernel path's loss and per-leaf gradients against the dense
     reference path at 2 x 512 tokens (f32 with 2 layers at drop-free MoE
     capacity; bf16 with the dense first layer alone); then ``TrainLoop``
     with checkpoints, a failure and a resume at smoke size.
     No full-width checkpoint is written (it would be 58 GB);
  7. seeded sampling and telemetry at full width (run after phase 4, on
     phase 3's model): (a) threefry2x32's Random123 known answers on the
     card, a grid of fold(fold(PRNGKey(s), rid), pos) keys and their
     bits bit for bit on the card and the CPU, the sampler (8 rows x
     102,400 logits, temperature 0.7, top-k 0 and 50, 16 draws) on the
     card against the CPU, a token allowed to differ only on a counted
     near-tie row; (b) phase 3's requests, one forked n = 2, sampled at
     temperature 0.7, top-k 50, seed 0, with ``Telemetry.on``: every
     request finishes, the forks diverge, the trace validates, drift
     covers every dispatched scheme, K1 / K2 launches = layers x ticks /
     chunks, each on its tensor-core walk; (c) the same serve with
     telemetry off, in turns with (b) (on, off, off, on): every
     EngineStats counter equal, tokens/s of both and their ratio; (d)
     the drift report, measured / predicted time per (kind x scheme x
     batch bucket), priced on the ``h100`` point;
  8. CUDA graphs, the async engine and the HTTP frontend at full width
     (run after phase 7, on phase 3's model): (a) phase 3's load on a
     bf16 pool, greedy, on the sync engine eagerly, the sync engine on
     graphs and the async engine on graphs, in turns (eager, graphs,
     async, async, graphs, eager), then graphs and eager on an fp8 pool:
     tokens and the pool's bytes identical to the first eager run's,
     every EngineStats counter equal, K1 / K2
     launches = layers x ticks / chunks through replays; tokens/s, the
     mean step, the decode tick's ``device_step`` and the prefill chunk's
     span (medians from a trace), capture time, peak memory and the
     plans captured, for each run; graphs / eager, async / graphs and
     fp8 / bf16 with and without graphs; (b) phase 7's sampled load on
     the sync engine eagerly and the async engine on graphs, then again
     with telemetry on: the same identity and counters, the trace
     valid, and the share of each ``device_step`` on the device track
     that the next tick's ``schedule`` span overlaps; (c)
     ``launch.server.Frontend`` on the async engine (graphs) on
     127.0.0.1 and a free port: two blocking requests, one SSE stream
     and one n = 2 request at once, then a stream cancelled mid-decode;
     every request finishes (that one "cancelled"), the tokens equal a
     direct run of the same requests on the sync engine but for near
     ties counted against ``NEAR_TIE``, /v1/health and
     /v1/metrics answer, K1 / K2 launches = layers x ticks / chunks, and
     the server is shut down;
  9. speculative decoding (run after phase 8, on phase 3's model): (a)
     the f32 smoke config (phase 5's seed and load), ``impl='kernel'`` on
     graphs: plain decode, then the identity draft ('self') at k = 2 and
     4 and the one-layer draft ('shallow:1') at k = 4: tokens identical
     to plain decode's, the identity draft accepting every draft, K1 / K2
     launches = draft layers x draft steps / layers x (chunks + verify
     rounds) + draft layers x chunks through the replays; (b) phase 3's
     load at full width, bf16, drop-free MoE capacity, on the sync engine
     on graphs in turns (plain, shallow:1 k = 4, self k = 2, shallow:1
     k = 4, plain): tokens equal the first plain run's but for near ties
     counted against ``NEAR_TIE`` (the margins of a plain run), every
     identity-draft rejection on a near tie of the verify logits, the
     same launch counts, K2 on its tensor-core route at C = k + 1 in
     every verify graph, the two shallow runs identical; per run
     tokens/s, accept rate, tokens a round, capture time, peak memory and
     the verify and draft spans against the plain tick's device_step
     (trace medians), and the serve's time summed by span (prefill;
     decode: draft + verify, or device_step; host_sample); (c) the async
     engine with shallow:1 k = 4 and
     telemetry on: the sync engine's tokens, the trace valid, verify rows
     in the drift report;
 10. the paper's baseline families: (a) phi3-mini-3.8b, the
     paper's MHA baseline (32 layers, 32 heads = 32 kv heads, head dim
     96), and (b) gemma3-1b (26 layers, MQA at head dim 256, 22 layers
     with a 512-position window and 4 global ones), each at full width
     and full depth, random bf16 weights, served as phase 4 serves
     DeepSeek-V2 (batch 8 x 2,048 prompt tokens, 32 generated,
     ``impl='kernel'``, after a warm-up at the same shapes): prefill ms,
     decode tokens/s, ms a step, peak memory; K4 launched once a layer,
     every launch on route 'tc', K3 never (their decode is
     ``gqa_decode``, plain PyTorch as in the reference); prefill and last
     decode step logits held against ``impl='ref'`` per row, every decode
     step's logits finite; then the KV-cache bytes per cached token of
     each beside DeepSeek-V2's latent bytes at 4 and 60 layers, with
     phase 4's decode tokens/s; K4 alone at each one's prefill shapes
     (one row a window) held against its plain version and timed beside
     it, SDPA (``enable_gqa=True``, an explicit mask for a window) and its
     bound; (c) the f32 smoke configs of all six attention families
     (phi3, starcoder2, granite-34b, gemma3, granite-moe at drop-free
     capacity, internvl2 with its patch prefix): greedy tokens of the
     contiguous serve, ``impl='kernel'`` identical to ``'ref'``, and one
     train step's loss and per-leaf gradients kernel against ref (f32,
     within ``GQA_GRAD_REL``);
 11. the recurrent families: (a) jamba-1.5-large-398b at full
     width cut to its first 4 layers (mamba + dense, mamba + MoE, mamba +
     dense, attention + MoE; ~23 B params) and (b) xlstm-350m at full
     width and depth (21 mLSTM + 3 sLSTM), random bf16 weights, served as
     phase 10 serves its models: prefill ms, decode tokens/s, ms a step,
     peak memory; K4 once an attention layer, on route 'tc', K3 never;
     on one request at drop-free capacity, Jamba's prefill and 16th
     decode step under 'kernel' against 'ref' per row, and each model's
     16th decode step against the teacher-forced forward over the same
     positions (the recurrent states carried on the card); the Mamba scan
     alone at Jamba's prefill shapes (time, bound, its own peak memory)
     and the sLSTM loop alone at xLSTM's; K4 alone at Jamba's prefill
     shapes (64 heads over 8, head dim 128) beside SDPA; each model's
     decode state (bytes a cached token, bytes a request) beside
     DeepSeek-V2's and phi3's KV bytes; (c) both smoke configs in f32:
     greedy tokens identical under 'ref', 'chunked' and 'kernel', one
     train step's gradients of 'chunked' and 'kernel' against 'ref'
     within ``GQA_GRAD_REL`` (xLSTM at 64 positions); (d) phi3-mini-3.8b
     at full width, phase 4's load: the prefill under 'kernel', 'chunked'
     and 'ref' (time, peak memory), 'chunked' within LOGITS_REL_L2 of
     'kernel' per row;
 12. whisper-medium, the encoder-decoder (run last; 24 encoder + 24
     decoder layers, d_model 1,024, 16 heads of 64, 1,500 frames, vocab
     51,865, random bf16 weights): (a) K4 without a mask at the
     encoder's self-attention shape (8, 16, 1,500, 64) and the
     cross-attention shape (256 queries over 1,500 frames), K4 causal at
     the decoder's self-attention shape, K5 and K6 without a mask at the
     encoder's shape, and K4, K5 and K6 at the training step's cross
     (448 queries over 1,500 frames, no mask) and decoder self (448,
     causal) shapes at batch 2, each on route 'tc', held row by row
     against its plain version and timed beside it, SDPA and its
     bound; (b) the
     contiguous serve, batch 8 x 256 prompt tokens over 1,500 frames, 64
     generated, ``impl='kernel'``, after a warm-up: prefill ms (encode +
     prompt), decode tokens/s, K4 once an attention call of the prefill
     (24 + 2 x 24), on route 'tc'; the bf16 prefill logits against
     'ref' per row; at full width cut to 4 + 4 layers in f32, the same
     load's greedy tokens under 'kernel' identical to 'ref'; (c) three
     full-width training steps (batch 2 x 448 tokens over 1,500 frames,
     bf16 params, f32 moments, remat): losses finite, ms a step, K4
     twice an attention call (the backward recomputes each layer), K5 /
     K6 once, the plan of every launch on route 'tc'; at 4 + 4 layers in f32, one step's loss
     and per-leaf gradients 'kernel' against 'ref' within
     ``GQA_GRAD_REL``;
 13. the rest of the single-device surface (run inside phase 3's
     full-width model's life, after phase 9): (a) a conversation tree
     (8 conversations open with one 500-token system prompt ending 4
     tokens into block 31, 100-token user messages, 48-token replies,
     12-token user suffixes, 3 turns; conversation 0 arrives alone, the
     others after its prefill) on the sync engine on graphs, bf16 pool,
     ``impl='kernel'``, drop-free MoE capacity, warm (the defaults) and
     cold (``decode_block_reuse=False, partial_match=False,
     admission='fcfs'``) in turns warm, cold, cold, warm: prefill tokens
     and median TTFT per turn, prefix hits, partial hits and
     decode-inserted blocks, decode tokens/s, K1 / K2 = layers x ticks /
     chunks; warm partial hits and decode-inserted blocks > 0, cold 0 of
     both, warm prefill tokens below cold's in turns 2 and 3, tokens
     equal but for counted near ties; (b) ``impl='chunked'`` on the
     paged engines: the f32 smoke config (phase 5's seed and load), sync
     and async, chunked and per-request prefill, greedy tokens identical
     to 'ref' and 'kernel' with no K1, K2 or K4 launch under 'chunked';
     then phase 3's load at full width under 'chunked', its tokens/s
     beside phase 3's; (c) ``optim.compress`` on the card against the
     CPU bit for bit: the f32 smoke config's whole gradient tree over 3
     carried steps, then a full-width expert ``down`` leaf (160 x 1,536
     x 5,120) and the embedding leaf (102,400 x 5,120) one at a time,
     ms a leaf on the card and ``compression_ratio``; (d) the port's
     three examples at their defaults on cuda, each printing its OK
     line.

 14. the mesh (run after phase 13, once phase 3's model is freed; its
     single-card reference, the eager engine on phase 3's load at
     drop-free capacity, runs on that model first): a (2, 2) mesh of four
     ranks sharing the card (``launch.mesh.launch``: gloo, since NCCL
     takes one rank a card; the collectives hand CUDA tensors to gloo,
     checked first), (a) the f32 smoke config (phase 5's load, n = 2)
     under every policy ('serve', 'serve_2dtp', 'dp', 'tp') x impl
     'kernel' / 'ref': greedy tokens identical to the single card's on
     every rank, pool replicas bitwise equal, K1 / K2 = layers x ticks /
     chunks a rank, every launch's plan recorded (f32: n_split 0); (b)
     phase 3's full-width DeepSeek-V2 (4 layers, bf16, drop-free MoE
     capacity) under 'tp' (each rank draws its ~12.8 GB of shards from
     the seed leaf by leaf, one rank at a time), eager, phase 3's load:
     prefill ms, tokens/s, ms a tick, peak memory, collective bytes a
     tick and a chunk and the time inside the collectives per rank
     ("ranks sharing one card": no multi-GPU speed), tokens equal to the
     single card's but for counted near ties, every decode tick's
     logits rows with the single card's inputs within LOGITS_REL_L2,
     every launch on the tensor-core walk, pool replicas bitwise equal;
     then on each rank K1 and K2 on the operands its path gave them
     (the first layer of the tick and of the chunk with the most live
     rows on the rank: q of its 64 heads and its DP shard's 4 rows, its
     tables, lengths and pool replica), 'kernel' against 'ref' row by
     row within TOL bf16, each launch's plan recorded (K1 split in more
     than one part).
     To run it alone: ``chip_smoke.mesh_alone(torch, np)`` after
     ``build.build_all()``, from a script under ``build/`` (the ranks
     re-import the script's main module: guard it).

The line before the last is the kernel table as JSON (``launches`` sums
the main paths that ran a kernel, ``launches_by_path`` splits them;
``plan`` is the plan each wrapper recorded at the timed launch; K2's row
holds its verify-width timing under ``verify``, K4's its phase 10 rows
under ``baseline`` and its phase 11 row under ``jamba``, K4's, K5's and
K6's their phase 12 rows under ``whisper``; phase 13's K1 / K2 launches
are its ``conversations_*`` paths, its 'chunked' paths count 0; phase
14's are rank 0's, ``mesh_smoke`` and ``mesh_tp``, and K1's and K2's
rows hold rank 0's check at the mesh path's shapes under ``mesh_tp``);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 TC / f32
B, H, DL, DR, BS, C = 8, 128, 512, 64, 16, 32   # the main path's shapes
PROMPT, GEN = 2048, 32                          # the contiguous path's
S_CONTIG = PROMPT + GEN + 1                     # its cache capacity
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
# flash attention, kernel vs plain version given the same lse and delta
# (phase 2), each output (out, dQ, dK, dV) held row by row:
# the largest |a_r - b_r| / |b_r| over its rows (one query's out or dQ,
# one key's dK or dV; see row_rel).  f32 is the same arithmetic in
# another order (~1e-6).  bf16 rounds P and dS to bf16 for the tensor
# cores and the output to bf16, where the plain versions keep f32 until
# the output: a few 2^-9 steps per element; sound kernels read <= 6.7e-3
# on an H100 (small cases and the path's shapes).  A kernel that skips one
# key tile of 32 (or one query tile, for dK/dV) moves each row it touches
# by about sqrt(32 / n) of its norm, n the number of keys (queries) the
# row sees: >= 0.088 at L = 4096; such a kernel read >= 0.84.
FLASH_ROW_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# phase 6, the flash Function vs autograd through the dense oracle, bf16,
# whole-tensor |a - b| / |b| of out, dQ, dK, dV.  Not row by row: the
# reference's backward takes delta = sum(dO * O) from the bf16 output O
# (as the Pallas reference does), autograd from the exact f32 one; on a
# row whose softmax is nearly one-hot (the first queries) dQ is a small
# difference of near-equal terms and that rounding is a large part of it
# (3.44 of one such row's norm at the path's shapes on an H100).  Sound
# kernels read ~2.5e-3 there; a skipped key tile at 2048 reads >= 0.033.
ATTN_REL_L2 = 1e-2
# the f32 log-sum-exp, either dtype: the same f32 scores summed in
# another order (~1e-6 of |lse| <= ~10); one skipped tile of 32 keys moves
# a row's lse by about 32 / n >= 0.0078 at L = 4096.
LSE_ATOL = 1e-4
# (B, H, Hkv, Lq, Lk, Dqk, Dv, window, q_offset) of the small cases
FLASH_SMALL = [(1, 4, 4, 64, 64, 32, 32, None, 0),
               (2, 4, 2, 48, 48, 16, 16, None, 0),
               (1, 8, 1, 33, 70, 16, 24, None, 0),
               (1, 4, 2, 96, 96, 32, 32, 8, 0),
               (1, 2, 2, 32, 64, 16, 16, None, 32),
               (2, 4, 4, 40, 40, 40, 24, None, 0),
               (1, 2, 1, 100, 130, 576, 512, None, 0)]
TB, TL, TH, TDQK, TDV = 2, 4096, 128, 192, 128    # the training path's
TRAIN_LAYERS = 2
# full-width training gradients, kernel path vs dense reference path, per
# leaf |a - b| / |b|.  f32, 2 layers at drop-free MoE capacity: the two
# paths sum in other orders (~1e-6 relative a product); a wiring fault
# (wrong head, mask, scale or layout) moves a leaf by O(1).  The 2-layer
# comparison is f32 because in bf16 a near-tie among a token's top-6
# expert gates routes it differently on the two paths and moves whole
# expert leaves; bf16 is compared on the dense first layer alone (no
# router), where the paths differ by where they round to bf16: a few
# 2^-9 steps of the attention output, carried through one layer and the
# head: 8.1e-3 on an H100, and 0.56 with a kernel that skips a key tile.
TRAIN_GRAD_REL_L2 = {"float32": 1e-3, "bfloat16": 5e-2}


def drop_free(cfg):
    """``cfg`` with drop-free MoE capacity (capacity_factor = n_experts /
    top_k, as the JAX package's serving benchmark runs it; a config
    without experts as it is) for the
    comparisons of two attention paths: at the configs' 1.25 the idle
    rows of a prefill chunk compete with real tokens for expert slots, so
    two paths that differ only in what they return for idle rows would
    route real tokens differently.  Serving and timing use the config's
    own capacity."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing --


# ~1 ms of device clock cycles: queued before each timed call, so the
# host's work in the wrapper (checks, allocation, the launches) is done
# before the start event fires and the events time only the device
SLEEP_CYCLES = 2_000_000


def time_ms(torch, fn, flush, reps: int = 15, sleep: bool = True) -> float:
    """Median device time of ``fn`` over ``reps`` launches, CUDA events
    around each; the L2 is flushed before each one (a decode layer finds
    its pool cold: the other layers' weights stream in between), and the
    device then sleeps while the host enqueues ``fn``'s work.  With
    ``sleep=False`` the device idles while the host works, and the
    events time the wrapper's host work too where it is the longer."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
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


# phase 2's paged load: K1 decode indices (-1: an inactive slot), K2 chunk
# starts and valid rows (0: an idle row)
DEC_INDICES = [1055, 255, 511, 1023, 300, 767, 15, -1]
PRE_LENGTHS = [1024, 224, 480, 992, 0, 736, 16, 0]
PRE_NVALID = [32, 32, 32, 31, 32, 20, 1, 0]
NEED_DEC = [i + 1 for i in DEC_INDICES]
NEED_PRE = [ln + nv if nv else 0 for ln, nv in zip(PRE_LENGTHS, PRE_NVALID)]
SCALE = (128 + 64) ** -0.5          # DeepSeek-V2's qk_nope + qk_rope


def paged_work(q_bytes: int, row_bytes: int):
    """(bytes, operations) of K1 and K2 at phase 2's load: the q rows that
    attend read once (an inactive slot's or a row past n_valid comes out
    0 and needs none), each cached position the row attends read once
    (``row_bytes``: both leaves of one position, scales included), every
    output row written once, the block-table entries and per-request ints
    read once; two products of (Dl + Dr) and Dl per (query row,
    position)."""
    pre_rows_pos = sum(ln + c + 1 for ln, nv in zip(PRE_LENGTHS, PRE_NVALID)
                       for c in range(nv))
    blocks = lambda need: sum(-(-n // BS) for n in need)
    dec_rows = sum(i >= 0 for i in DEC_INDICES)
    return {
        "mla_decode_paged": (
            (dec_rows * (DL + DR) + B * DL) * H * q_bytes
            + sum(NEED_DEC) * row_bytes + (blocks(NEED_DEC) + B) * 4,
            2 * H * sum(NEED_DEC) * (DL + DR + DL)),
        "mla_prefill_paged": (
            (sum(PRE_NVALID) * (DL + DR) + B * C * DL) * H * q_bytes
            + sum(NEED_PRE) * row_bytes + (blocks(NEED_PRE) + 2 * B) * 4,
            2 * H * pre_rows_pos * (DL + DR + DL)),
    }


def bound(n_bytes, n_ops, dtype_name="bfloat16"):
    """(bound ms, 'bytes' or 'operations') against the data sheet."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def paged_cases(torch, dtype, ckv, krope, bt, qkw=None):
    """name: (kernel wrapper, plain version, operands, extra keywords) of
    K1 and K2 at phase 2's load, q drawn in ``dtype``."""
    from repro_torch.kernels import mla_decode, mla_prefill, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    q1 = torch.randn((B, H, DL + DR), generator=g, device="cuda").to(dtype)
    q2 = torch.randn((B, C, H, DL + DR), generator=g, device="cuda").to(dtype)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
    idx, ln, nv = i32(DEC_INDICES), i32(PRE_LENGTHS), i32(PRE_NVALID)
    kw = dict(softmax_scale=SCALE, **(qkw or {}))
    return {
        "mla_decode_paged": (mla_decode.mla_decode_paged_kernel,
                             ref.mla_decode_paged_ref,
                             (q1, ckv, krope, bt, idx), kw),
        "mla_prefill_paged": (mla_prefill.mla_prefill_paged_kernel,
                              ref.mla_prefill_paged_ref,
                              (q2, ckv, krope, bt, ln, nv), kw),
    }


def hold_paged(torch, cases, label):
    """Each case against its plain version (and the exact oracle), both
    rescales, dead rows exactly 0; returns {name: max |kernel - plain|}
    of the exp_add run."""
    from repro_torch.kernels import ref

    errs = {}
    tol = TOL[label.split()[0]]
    for name, (kern, plain, args, kw) in cases.items():
        exact = plain(*args, **kw)
        for rescale in ref.RESCALES:
            got = kern(*args, rescale=rescale, **kw)
            torch.cuda.synchronize()
            if label.startswith("bfloat16"):
                launched_plan(kern)
            want = plain(*args, rescale=rescale, **kw)
            err = (got.float() - want.float()).abs().max().item()
            err_exact = (got.float() - exact.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
            ok_exact = torch.allclose(got.float(), exact.float(), atol=tol,
                                      rtol=tol)
            if name == "mla_decode_paged":
                zero = bool((got[7] == 0).all())          # index -1
            else:
                zero = bool((got[7] == 0).all()
                            and (got[6, 1:] == 0).all()
                            and (got[3, 31:] == 0).all())
            log(f"[kernels] {name} {label} {rescale}: max|kernel - plain| "
                f"{err:.3g}, vs exact softmax {err_exact:.3g} (tol {tol} "
                f"abs+rel), dead rows exactly 0: {zero}")
            if not (ok and ok_exact and zero):
                raise AssertionError(f"{name} {label} {rescale} disagrees "
                                     f"with its plain version")
            if rescale == "exp_add":
                errs[name] = err
    return errs


def launched_plan(kern) -> dict:
    """The plan ``kern`` recorded at its last launch; with bf16 operands
    it must be the tensor-core route's: a split plan (K1, K2, K3;
    ``n_split`` 0 is ``attend_rows``) or route 'tc' (K4, K5, K6; 'wmma'
    is the WMMA kernel)."""
    plan = dict(kern.last_plan, grid=list(kern.last_plan["grid"]))
    if plan.get("route", "tc") != "tc" or plan.get("n_split", 1) <= 0:
        raise AssertionError(f"{kern.__name__} ran bf16 off its tensor-core "
                             f"route: {plan}")
    if "tiles" in plan:
        plan["tiles"] = list(plan["tiles"])
    return plan


def plan_text(r) -> str:
    if "route" in r:
        return (f"route {r['route']}, tiles {tuple(r['tiles'])}, grid "
                f"{tuple(r['grid'])}")
    return (f"n_split {r['n_split']} of {r['split_pos']} positions, grid "
            f"{tuple(r['grid'])}")


def host_text(r) -> str:
    return (f"without the device sleep (host work included): "
            f"{r['ms_with_host']:.4f} ms"
            + (f", SDPA {r['library_ms_with_host']:.4f} ms"
               if "library_ms_with_host" in r else ""))


def time_paged(torch, cases, work, flush, label, lib=None):
    """Times (exp_add) and bounds of K1 and K2 on ``cases``, also without
    the device sleep, beside their library calls, with their plans (the
    tensor-core walk's, bf16 q)."""
    rows = {}
    for name, (kern, plain, args, kw) in cases.items():
        n_bytes, n_ops = work[name]
        kw = dict(kw, rescale="exp_add")
        bound_ms, bound_by = bound(n_bytes, n_ops)
        run = functools.partial(kern, *args, **kw)
        rows[name] = r = dict(ms=time_ms(torch, run, flush))
        r.update(plan=launched_plan(kern),
                 ms_with_host=time_ms(torch, run, flush, sleep=False))
        r.update(plain_ms=time_ms(torch, functools.partial(plain, *args,
                                                           **kw),
                                  flush, reps=5),
                 bound_ms=bound_ms, bound_by=bound_by)
        if lib is not None:
            r["library_ms"] = time_ms(torch, lib[name], flush, reps=5)
            r["library_ms_with_host"] = time_ms(torch, lib[name], flush,
                                                reps=5, sleep=False)
        log(f"[kernels] {name} {label} time {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, "
            + (f"SDPA {r['library_ms']:.4f} ms, " if lib else "")
            + f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: "
            f"{n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.2f} GFLOP; "
            f"{r['bound_ms'] / r['ms']:.4f} of it reached), "
            f"{plan_text(r['plan'])}; {host_text(r)}")
    return rows


def check_kernels(torch):
    """K1 and K2 on a bf16 / f32 pool (q in the pool's dtype), then on
    int8 and fp8 pools (codes and per-slot f32 scales that
    ``core.cache.quantize_latent`` makes from the f32 pool, poisoned
    blocks included; q in bf16 and f32).  Times at the main path's dtype
    (bf16 q) and rescale (exp_add); a quantized row's bytes count 1 byte
    an element plus 4 bytes a slot a leaf for its scales."""
    from repro_torch.core import cache as cachelib

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    need = [max(a, b) for a, b in zip(NEED_DEC, NEED_PRE)]
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        ckv, krope, bt = paged_inputs(torch, getattr(torch, dtype_name),
                                      need, 1)
        cases = paged_cases(torch, getattr(torch, dtype_name), ckv, krope,
                            bt)
        errs = hold_paged(torch, cases, dtype_name)
        if dtype_name != "bfloat16":
            continue
        dec, pre = cases["mla_decode_paged"][2], cases["mla_prefill_paged"][2]
        lib = library_calls(torch, dec[0], pre[0], ckv, krope, bt, dec[4],
                            pre[4], pre[5], SCALE)
        rows = time_paged(torch, cases, paged_work(2, (DL + DR) * 2), flush,
                          "bf16", lib)
        for name in rows:
            rows[name]["max_abs_err"] = errs[name]
        rows["mla_decode_paged"]["pool_wide_table"] = time_pool_wide_table(
            torch, cases["mla_decode_paged"], ckv.shape[0], flush)
    ckv32, krope32, bt = paged_inputs(torch, torch.float32, need, 3)
    for cache_dtype in ("int8", "fp8"):
        qdtype, qmax = cachelib.cache_dtype_info(cache_dtype)
        ckv, cs = cachelib.quantize_latent(ckv32, qmax, qdtype)
        krope, rs = cachelib.quantize_latent(krope32, qmax, qdtype)
        qkw = dict(ckv_scales=cs, krope_scales=rs)
        for dtype_name in ("bfloat16", "float32"):
            cases = paged_cases(torch, getattr(torch, dtype_name), ckv, krope,
                                bt, qkw)
            errs = hold_paged(torch, cases, f"{dtype_name} {cache_dtype}")
            if dtype_name != "bfloat16":
                continue
            timed = time_paged(torch, cases,
                               paged_work(2, (DL + DR) + 2 * 4), flush,
                               f"bf16 {cache_dtype} pool")
            for name, r in timed.items():
                rows[name][cache_dtype] = dict(r, max_abs_err=errs[name])
    return rows


def time_pool_wide_table(torch, case, n_blocks: int, flush) -> dict:
    """bf16 K1 at phase 2's load with each table widened to the whole pool
    (n_blocks - 1 entries, the scheduler's width without
    ``max_blocks_per_req``; the added entries are the null block).  K1
    splits the table's reach, so the live positions fall in the first
    splits: held against the plain walk (``row_rel`` and allclose), its
    time and plan."""
    kern, plain, (q, ckv, krope, bt, idx), kw = case
    wide = torch.zeros((B, n_blocks - 1), dtype=torch.int32, device="cuda")
    wide[:, :bt.shape[1]] = bt
    args, kw = (q, ckv, krope, wide, idx), dict(kw, rescale="exp_add")
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    tol = TOL["bfloat16"]
    err = row_rel(torch, got, want)
    if not (err <= tol and torch.allclose(got.float(), want.float(),
                                          atol=tol, rtol=tol)):
        raise AssertionError("mla_decode_paged on a pool-wide table "
                             "disagrees with its plain version")
    r = dict(ms=time_ms(torch, functools.partial(kern, *args, **kw), flush),
             plan=launched_plan(kern))
    log(f"[kernels] mla_decode_paged bf16 on a pool-wide table "
        f"({n_blocks - 1} blocks, phase 2's indices): time {r['ms']:.4f} "
        f"ms, {plan_text(r['plan'])}; largest per-row |kernel - plain| / "
        f"|plain| {err:.3g} (bound {tol})")
    return r


def check_contiguous_kernel(torch):
    """K3 at the contiguous path's shapes against its plain version and
    the exact oracle, row by row (``row_rel``), in bf16 and f32, both
    rescales, at index S - 1 and at a mid index with the cache's tail
    poisoned with 1e4; then its time at the path's last decode index
    beside the plain version's, SDPA's (the latent as one KV head, as for
    K1) and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import mla_decode, ref

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kern = mla_decode.mla_decode_kernel
    row = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda")
        g.manual_seed(4)
        q, ckv, krope = (torch.randn(shape, generator=g,
                                     device="cuda").to(dtype)
                         for shape in ((B, H, DL + DR), (B, S_CONTIG, DL),
                                       (B, S_CONTIG, DR)))
        for index in (S_CONTIG - 1, S_CONTIG // 2 - 5):
            c, r = ckv, krope
            if index < S_CONTIG - 1:
                c, r = ckv.clone(), krope.clone()
                c[:, index + 1:] = 1e4
                r[:, index + 1:] = 1e4
            exact = ref.mla_decode_ref(q, c, r, index, softmax_scale=SCALE)
            for rescale in ref.RESCALES:
                got = kern(q, c, r, index, softmax_scale=SCALE,
                           rescale=rescale)
                torch.cuda.synchronize()
                want = ref.mla_decode_ref(q, c, r, index, softmax_scale=SCALE,
                                          rescale=rescale)
                err, err_exact = (row_rel(torch, got, w) for w in (want,
                                                                   exact))
                log(f"[kernels] mla_decode {dtype_name} {rescale} index "
                    f"{index} of S={S_CONTIG}"
                    f"{' (tail poisoned)' if c is not ckv else ''}: largest "
                    f"per-row |kernel - plain| / |plain| {err:.3g}, vs exact "
                    f"softmax {err_exact:.3g} (bound {TOL[dtype_name]})")
                if not max(err, err_exact) <= TOL[dtype_name]:
                    raise AssertionError(f"mla_decode {dtype_name} {rescale} "
                                         f"disagrees with its plain version")
                if dtype_name == "bfloat16" and rescale == "exp_add" \
                        and index == S_CONTIG - 1:
                    row["max_abs_err"] = (got.float() - want.float()
                                          ).abs().max().item()
        if dtype_name != "bfloat16":
            continue
        last = PROMPT + GEN - 2          # the path's last decode step
        n_bytes = (B * H * (DL + DR + DL) + B * (last + 1) * (DL + DR)) * 2
        n_ops = 2 * B * H * (last + 1) * (DL + DR + DL)
        kv = torch.cat([ckv, krope], dim=-1)[:, None]
        k = kv.expand(B, H, S_CONTIG, DL + DR)
        v = kv[..., :DL].expand(B, H, S_CONTIG, DL)
        mask = (torch.arange(S_CONTIG, device="cuda") <= last)[None, None,
                                                                None]
        kw = dict(softmax_scale=SCALE, rescale="exp_add")
        bound_ms, bound_by = bound(n_bytes, n_ops)
        run = functools.partial(kern, q, ckv, krope, last, **kw)
        sdpa = lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, scale=SCALE)
        row.update(ms=time_ms(torch, run, flush))
        row.update(plan=launched_plan(kern),
                   ms_with_host=time_ms(torch, run, flush, sleep=False),
                   plain_ms=time_ms(torch, functools.partial(
                       ref.mla_decode_ref, q, ckv, krope, last, **kw), flush,
                       reps=5),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=time_ms(torch, sdpa, flush, reps=5),
                   library_ms_with_host=time_ms(torch, sdpa, flush, reps=5,
                                                sleep=False))
        log(f"[kernels] mla_decode bf16 at index {last} of S={S_CONTIG}: "
            f"time {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA "
            f"{row['library_ms']:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}: {n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.2f} GFLOP; "
            f"{bound_ms / row['ms']:.4f} of it reached), "
            f"{plan_text(row['plan'])}; "
            f"{host_text(row)}")
    return {"mla_decode": row}


def split_pos_for(torch, n_pos: int) -> int:
    """The split length the wrappers' plan (``_launch.decode_plan``) gives
    n_pos positions at the path's B and H: where to look for boundaries.
    Each check then reads the plan its launch recorded."""
    from repro_torch.kernels import _launch

    plan = _launch.decode_plan(n_pos, B, H, torch.device("cuda"))
    return plan["split_pos"]


def check_launched_split(kern, sp: int) -> None:
    plan = launched_plan(kern)
    if plan["split_pos"] != sp:
        raise AssertionError(f"{kern.__name__} launched {plan}, the check "
                             f"expected splits of {sp}")


def split_boundary_indices(torch, S: int) -> dict:
    """The largest indices i < S that end, under their own split plan
    (B, H of the path), one short of a split boundary, on one (the last
    split full) and one past one (the last split holds one position)."""
    found = {}
    for i in range(S - 1, 0, -1):
        sp = split_pos_for(torch, i + 1)
        kind = {sp - 1: "short of", 0: "on", 1: "past"}.get((i + 1) % sp)
        if kind and kind not in found and i + 1 > sp:
            found[kind] = (i, sp)
        if len(found) == 3:
            return found
    raise AssertionError(f"no split boundary below S={S}")


def check_split_boundaries(torch):
    """The bf16 tensor-core walk of K3 and K1 at the paths' shapes, with
    indices one short of, on and one past a split boundary of the
    wrapper's plan (each launch's recorded plan checked), both rescales:
    K3 held row by row (``row_rel``) against its plain walk and the split
    walk's model (``ref.mla_decode_split_ref``); K1 on bf16, int8 and fp8
    pools with a table of 8 requests (the path's longest, three around
    the first boundary, two around the second, a first token, an
    inactive slot) held row by row and with allclose against both, the
    inactive row exactly 0."""
    from repro_torch.core import cache as cachelib
    from repro_torch.kernels import mla_decode, ref

    tol = TOL["bfloat16"]
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    q, ckv, krope = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                     for shape in ((B, H, DL + DR), (B, S_CONTIG, DL),
                                   (B, S_CONTIG, DR)))
    for kind, (index, sp) in split_boundary_indices(torch, S_CONTIG).items():
        for rescale in ref.RESCALES:
            kw = dict(softmax_scale=SCALE, rescale=rescale)
            got = mla_decode.mla_decode_kernel(q, ckv, krope, index, **kw)
            torch.cuda.synchronize()
            check_launched_split(mla_decode.mla_decode_kernel, sp)
            err = row_rel(torch, got, ref.mla_decode_ref(q, ckv, krope,
                                                         index, **kw))
            err_split = row_rel(torch, got, ref.mla_decode_split_ref(
                q, ckv, krope, index, split_pos=sp, **kw))
            log(f"[kernels] mla_decode bf16 {rescale} index {index} "
                f"({kind} a boundary of splits of {sp}): largest per-row "
                f"|kernel - plain| / |plain| {err:.3g}, vs the split walk "
                f"{err_split:.3g} (bound {tol})")
            if not max(err, err_split) <= tol:
                raise AssertionError(f"mla_decode at split boundary index "
                                     f"{index} disagrees")
    nb = max(-(-n // BS) for n in NEED_DEC) + 2
    sp = split_pos_for(torch, nb * BS)
    indices = [NEED_DEC[0] - 1, sp - 1, sp, sp + 1, 2 * sp - 1, 2 * sp, 0,
               -1]
    assert max(indices) < NEED_DEC[0], indices
    ckv, krope, bt = paged_inputs(torch, torch.float32,
                                  [i + 1 for i in indices], 6)
    assert bt.shape[1] == nb
    idx = torch.tensor(indices, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, DL + DR), generator=g, device="cuda").bfloat16()
    for pool in ("bf16", "int8", "fp8"):
        if pool == "bf16":
            args, qkw = (q, ckv.bfloat16(), krope.bfloat16(), bt, idx), {}
        else:
            qdtype, qmax = cachelib.cache_dtype_info(pool)
            c, cs = cachelib.quantize_latent(ckv, qmax, qdtype)
            r, rs = cachelib.quantize_latent(krope, qmax, qdtype)
            args, qkw = (q, c, r, bt, idx), dict(ckv_scales=cs,
                                                 krope_scales=rs)
        for rescale in ref.RESCALES:
            kw = dict(softmax_scale=SCALE, rescale=rescale, **qkw)
            got = mla_decode.mla_decode_paged_kernel(*args, **kw)
            torch.cuda.synchronize()
            check_launched_split(mla_decode.mla_decode_paged_kernel, sp)
            plain = ref.mla_decode_paged_ref(*args, **kw)
            split = ref.mla_decode_split_ref(*args[:3], idx, split_pos=sp,
                                             block_tables=bt, **kw)
            errs = [(got.float() - w.float()).abs().max().item()
                    for w in (plain, split)]
            rels = [row_rel(torch, got, w) for w in (plain, split)]
            ok = max(rels) <= tol and all(
                torch.allclose(got.float(), w.float(), atol=tol, rtol=tol)
                for w in (plain, split))
            zero = bool((got[7] == 0).all())
            log(f"[kernels] mla_decode_paged bf16 {pool} pool {rescale}, "
                f"indices {indices} around splits of {sp}: largest per-row "
                f"|kernel - plain| / |plain| {rels[0]:.3g}, vs the split "
                f"walk {rels[1]:.3g} (bound {tol}); max|kernel - plain| "
                f"{errs[0]:.3g}, vs the split walk {errs[1]:.3g} (tol {tol} "
                f"abs+rel), inactive row exactly 0: {zero}")
            if not (ok and zero):
                raise AssertionError(f"mla_decode_paged {pool} at split "
                                     f"boundaries disagrees")


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


def flash_case_inputs(torch, case, dtype, seed, blhd=False):
    B_, H_, Hkv, Lq, Lk, D, Dv, _, _ = case
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def rn(b, h, n, d):
        if blhd:       # (B, L, H, D) memory, passed as (B, H, L, D) views
            return torch.randn((b, n, h, d), generator=g, device="cuda").to(
                dtype).transpose(1, 2)
        return torch.randn((b, h, n, d), generator=g, device="cuda").to(dtype)

    return rn(B_, H_, Lq, D), rn(B_, Hkv, Lk, D), rn(B_, Hkv, Lk, Dv), \
        rn(B_, H_, Lq, Dv)


def row_rel(torch, got, want) -> float:
    """The largest per-row relative L2 error max_r |a_r - b_r| / |b_r|
    over the rows of the last dimension.  A row whose norm is under 1 % of
    the median row norm is measured against that 1 % instead: dQ of query
    0 is exactly 0 in exact arithmetic and noise on both sides, and so is
    a row that should be 0 (a fully masked query, a key no query sees)."""
    a = got.float().reshape(-1, got.shape[-1])
    b = want.float().reshape(-1, want.shape[-1])
    norm = b.norm(dim=-1)
    floor = (0.01 * norm.median()).clamp_min(1e-30)
    return ((a - b).norm(dim=-1) / torch.maximum(norm, floor)).max().item()


def flash_compare(torch, fa, case, dtype_name, seed, blhd=False):
    """K4, K5, K6 against their plain versions on one case; returns, for
    each kernel, (max |kernel - plain|, the largest per-row relative error
    of its outputs)."""
    q, k, v, do = flash_case_inputs(torch, case, getattr(torch, dtype_name),
                                    seed, blhd)
    _, _, _, _, _, D, _, window, q_offset = case
    kw = dict(causal=True, window=window, q_offset=q_offset, scale=D ** -0.5)
    out, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    lse_err = (lse - lse_p).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"flash_attention_fwd {dtype_name} {case}: lse "
                             f"max |kernel - plain| {lse_err:.3g} > "
                             f"{LSE_ATOL}")
    delta = (do.float() * out_p.float()).sum(-1).contiguous()
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    pairs = {"flash_attention_fwd": [(out, out_p)],
             "flash_attention_bwd_dq": [(dq, fa.flash_bwd_dq_plain(
                 q, k, v, do, lse_p, delta, **kw))],
             "flash_attention_bwd_dkv": list(zip(
                 (dk, dv), fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                                  **kw)))}
    errs = {}
    for name, items in pairs.items():
        worst_abs = worst_row = 0.0
        for got, want in items:
            err = row_rel(torch, got, want)
            if not err <= FLASH_ROW_TOL[dtype_name]:
                raise AssertionError(
                    f"{name} {dtype_name} {case}: a row's |kernel - plain| / "
                    f"|plain| is {err:.3g} > {FLASH_ROW_TOL[dtype_name]}")
            worst_row = max(worst_row, err)
            worst_abs = max(worst_abs,
                            (got.float() - want.float()).abs().max().item())
        errs[name] = (worst_abs, worst_row)
    return errs


def flash_pairs(Lq, Lk, q_offset=0):
    """(query, key) pairs of causal attention (no window)."""
    return sum(max(0, min(Lk, q_offset + i + 1)) for i in range(Lq))


def flash_work(B_, H_, Lq, Lk, Dqk, Dv, causal):
    """{kernel: (bytes, operations)} of K4, K5 and K6 over (B_, H_, Lq,
    Dqk) queries, (B_, H_, Lk, Dqk) keys and (B_, H_, Lk, Dv) values,
    bf16: each input read once, each output written once (lse and delta
    f32); operations over the pairs the mask admits (no window)."""
    pairs = B_ * H_ * (flash_pairs(Lq, Lk) if causal else Lq * Lk)
    q_b, k_b = 2 * B_ * H_ * Lq * Dqk, 2 * B_ * H_ * Lk * Dqk
    o_b, v_b = 2 * B_ * H_ * Lq * Dv, 2 * B_ * H_ * Lk * Dv
    rows_b = 4 * B_ * H_ * Lq
    return {"flash_attention_fwd": (q_b + k_b + v_b + o_b + rows_b,
                                    2 * (Dqk + Dv) * pairs),
            "flash_attention_bwd_dq": (q_b + k_b + v_b + o_b + 2 * rows_b
                                       + q_b, 2 * (2 * Dqk + Dv) * pairs),
            "flash_attention_bwd_dkv": (q_b + k_b + v_b + o_b + 2 * rows_b
                                        + k_b + v_b,
                                        2 * (2 * Dqk + 2 * Dv) * pairs)}


def check_flash(torch):
    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for dtype_name in ("float32", "bfloat16"):
        worst = {}
        for i, case in enumerate(FLASH_SMALL):
            for blhd in (False, True):
                for k_, e in flash_compare(torch, fa, case, dtype_name, i,
                                           blhd).items():
                    worst[k_] = max(worst.get(k_, 0.0), e[1])
        log(f"[flash] {len(FLASH_SMALL)} small cases x 2 layouts, "
            f"{dtype_name}: largest per-row |kernel - plain| / |plain| "
            + ", ".join(f"{k_} {e:.3g}" for k_, e in worst.items())
            + f" (bound {FLASH_ROW_TOL[dtype_name]}; lse within {LSE_ATOL})")
    path = (TB, TH, TH, TL, TL, TDQK, TDV, None, 0)
    errs = {}
    for dtype_name in ("float32", "bfloat16"):
        errs[dtype_name] = flash_compare(torch, fa, path, dtype_name, 99,
                                         blhd=True)
        if dtype_name == "bfloat16":      # the tensor-core walks
            for kern in (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
                         fa.flash_bwd_dkv_kernel):
                launched_plan(kern)
        log(f"[flash] path shapes q/k ({TB},{TH},{TL},{TDQK}), v "
            f"(...,{TDV}), causal, {dtype_name}: max |kernel - plain|, "
            f"largest per-row relative error: "
            + ", ".join(f"{k_} {a:.3g}, {r:.3g}" for k_, (a, r)
                        in errs[dtype_name].items())
            + f" (bound {FLASH_ROW_TOL[dtype_name]})")
        torch.cuda.empty_cache()

    # times and bounds at the path's dtype (bf16)
    q, k, v, do = flash_case_inputs(torch, path, torch.bfloat16, 5,
                                    blhd=True)
    kw = dict(causal=True, window=None, q_offset=0, scale=TDQK ** -0.5)
    out, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    work = flash_work(TB, TH, TL, TL, TDQK, TDV, True)
    calls = {   # name: (wrapper, its call, the plain version's call)
        "flash_attention_fwd": (
            fa.flash_fwd_kernel,
            lambda: fa.flash_fwd_kernel(q, k, v, **kw),
            lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "flash_attention_bwd_dq": (
            fa.flash_bwd_dq_kernel,
            lambda: fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)),
        "flash_attention_bwd_dkv": (
            fa.flash_bwd_dkv_kernel,
            lambda: fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)),
    }
    sdpa_fwd, sdpa_bwd, backend = sdpa_calls(torch, q, k, v, do)
    lib = {"flash_attention_fwd": time_ms(torch, sdpa_fwd, flush, reps=5)}
    lib["flash_attention_bwd_dq"] = lib["flash_attention_bwd_dkv"] = \
        time_ms(torch, sdpa_bwd, flush, reps=5)
    lib_host = {"flash_attention_fwd": time_ms(torch, sdpa_fwd, flush,
                                               reps=5, sleep=False)}
    lib_host["flash_attention_bwd_dq"] = \
        lib_host["flash_attention_bwd_dkv"] = time_ms(torch, sdpa_bwd, flush,
                                                      reps=5, sleep=False)
    log(f"[flash] SDPA at the path's shapes runs on {backend}; its "
        f"backward computes dQ, dK and dV in one call, so K5's and K6's "
        f"library time is that one call")
    rows = {}
    for name, (wrapper, kern, plain) in calls.items():
        n_bytes, n_ops = work[name]
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_OPS["bfloat16"] * 1e3
        rows[name] = r = dict(
            max_abs_err=errs["bfloat16"][name][0],
            ms=time_ms(torch, kern, flush, reps=5))
        r.update(plan=launched_plan(wrapper),
                 ms_with_host=time_ms(torch, kern, flush, reps=5,
                                      sleep=False),
                 plain_ms=time_ms(torch, plain, flush, reps=3),
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=lib[name], library_ms_with_host=lib_host[name])
        log(f"[flash] {name} bf16 time {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {n_bytes / 1e9:.3f} "
            f"GB, {n_ops / 1e12:.3f} TFLOP; {r['bound_ms'] / r['ms']:.4f} "
            f"of it reached), {plan_text(r['plan'])}; {host_text(r)}")
    del q, k, v, do, out, lse, delta, flush
    torch.cuda.empty_cache()
    return rows


# The tensor-core walks of K4, K5 and K6 at their boundaries, bf16, (B,
# H, Hkv, Lq, Lk, Dqk, Dv, window, q_offset): Lq off the 128-row query
# tile and the 64-query tile; the causal diagonal cutting 64-key tiles
# mid-way (offsets 36, 120); a window alone and with an offset; GQA at
# the path's head dims and MQA (K6's loop over query heads); rows that
# attend no key (window 8 behind an offset of 100 over 32 keys).
FLASH_TC_EDGES = [(1, 4, 4, 200, 200, 192, 128, None, 0),
                  (1, 2, 2, 100, 136, 64, 64, None, 36),
                  (1, 2, 2, 130, 250, 128, 128, None, 120),
                  (1, 4, 2, 257, 257, 192, 128, 100, 0),
                  (1, 4, 4, 200, 330, 64, 48, 70, 130),
                  (2, 8, 2, 190, 190, 192, 128, None, 0),
                  (1, 8, 1, 129, 129, 256, 256, None, 0),
                  (1, 2, 2, 64, 32, 32, 32, 8, 100)]


def flash_tc_edge_errors(torch, fa, case, seed, blhd):
    """K4, K5 and K6 in bf16 on one ``FLASH_TC_EDGES`` case against their
    plain versions (the backward given the plain forward's lse and
    delta): the largest per-row relative error of each kernel's outputs,
    K4's lse error, and whether every gradient is finite."""
    q, k, v, do = flash_case_inputs(torch, case, torch.bfloat16, seed, blhd)
    _, _, _, _, _, D, _, window, q_offset = case
    kw = dict(causal=True, window=window, q_offset=q_offset,
              scale=D ** -0.5)
    out, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * out_p.float()).sum(-1).contiguous()
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw)
    errs = {"flash_attention_fwd": row_rel(torch, out, out_p),
            "flash_attention_bwd_dq": row_rel(torch, dq, dq_p),
            "flash_attention_bwd_dkv": max(row_rel(torch, dk, dk_p),
                                           row_rel(torch, dv, dv_p))}
    finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    return errs, (lse - lse_p).abs().max().item(), finite


def check_flash_tc_edges(torch):
    """bf16 K4, K5 and K6 at their tensor-core walks' boundaries
    (``FLASH_TC_EDGES``), both layouts: each launch on route 'tc', every
    output held row by row (``FLASH_ROW_TOL``), lse within ``LSE_ATOL``
    and every gradient finite, against the plain versions."""
    from repro_torch.kernels import flash_attention as fa

    tol = FLASH_ROW_TOL["bfloat16"]
    worst, lse_worst = {}, 0.0
    for i, case in enumerate(FLASH_TC_EDGES):
        for blhd in (False, True):
            errs, lse_err, finite = flash_tc_edge_errors(torch, fa, case,
                                                         50 + i, blhd)
            for kern in (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
                         fa.flash_bwd_dkv_kernel):
                launched_plan(kern)
            if not (max(errs.values()) <= tol and lse_err <= LSE_ATOL
                    and finite):
                raise AssertionError(
                    f"flash attention bf16 {case} blhd={blhd}: largest "
                    f"per-row |kernel - plain| / |plain| {errs}, lse "
                    f"{lse_err:.3g}, gradients finite: {finite}")
            worst = {k_: max(worst.get(k_, 0.0), e) for k_, e in errs.items()}
            lse_worst = max(lse_worst, lse_err)
    log(f"[flash] tensor-core walks at their edges, {len(FLASH_TC_EDGES)} "
        f"cases x 2 layouts, bf16, every launch on route 'tc': largest "
        f"per-row |kernel - plain| / |plain| "
        + ", ".join(f"{k_} {e:.3g}" for k_, e in worst.items())
        + f" (bound {tol}), lse {lse_worst:.3g} (within {LSE_ATOL}), "
        f"gradients finite")


# K2's tensor-core walk at its boundaries, the path's widths (8 requests,
# chunk 32): chunk rows whose limit lengths[b] + c falls on the
# 64-position tile edges 63, 127 and 1023 (n_valid 32, 28 < C, 24), one
# row at 63, rows crossing 511 / 512, a first chunk, two idle requests
EDGE_LENGTHS = [32, 100, 0, 1000, 63, 500, 0, 5]
EDGE_NVALID = [32, 28, 0, 24, 1, 32, 32, 0]


def check_prefill_tc_edges(torch):
    """bf16 K2 on the tensor-core walk at ``EDGE_LENGTHS`` /
    ``EDGE_NVALID`` on bf16, int8 and fp8 pools, on the fitted table and
    on one as wide as the pool, both rescales: each launch's plan is the
    walk's, the output is held row by row (``row_rel``) and with
    allclose against the plain walk and the split walk's model
    (``ref.mla_prefill_split_ref``), rows past n_valid exactly 0."""
    from repro_torch.core import cache as cachelib
    from repro_torch.kernels import mla_prefill, ref

    kern = mla_prefill.mla_prefill_paged_kernel
    tol = TOL["bfloat16"]
    need = [ln + nv for ln, nv in zip(EDGE_LENGTHS, EDGE_NVALID)]
    ckv, krope, bt = paged_inputs(torch, torch.float32, need, 7)
    wide = torch.zeros((B, ckv.shape[0] - 1), dtype=torch.int32,
                       device="cuda")
    wide[:, :bt.shape[1]] = bt
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    q = torch.randn((B, C, H, DL + DR), generator=g,
                    device="cuda").bfloat16()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
    ln, nv = i32(EDGE_LENGTHS), i32(EDGE_NVALID)
    worst = 0.0
    for pool in ("bf16", "int8", "fp8"):
        if pool == "bf16":
            c, r, qkw = ckv.bfloat16(), krope.bfloat16(), {}
        else:
            qdtype, qmax = cachelib.cache_dtype_info(pool)
            c, cs = cachelib.quantize_latent(ckv, qmax, qdtype)
            r, rs = cachelib.quantize_latent(krope, qmax, qdtype)
            qkw = dict(ckv_scales=cs, krope_scales=rs)
        for table, tname in ((bt, "fitted"), (wide, "pool-wide")):
            for rescale in ref.RESCALES:
                kw = dict(softmax_scale=SCALE, rescale=rescale, **qkw)
                got = kern(q, c, r, table, ln, nv, **kw)
                torch.cuda.synchronize()
                plan = launched_plan(kern)
                wants = (ref.mla_prefill_paged_ref(q, c, r, table, ln, nv,
                                                   **kw),
                         ref.mla_prefill_split_ref(
                             q, c, r, table, ln, nv,
                             split_pos=plan["split_pos"], **kw))
                rels = [row_rel(torch, got, w) for w in wants]
                ok = max(rels) <= tol and all(
                    torch.allclose(got.float(), w.float(), atol=tol,
                                   rtol=tol) for w in wants)
                zero = all(bool((got[b, n:] == 0).all())
                           for b, n in enumerate(EDGE_NVALID))
                log(f"[kernels] mla_prefill_paged bf16 {pool} pool, "
                    f"{tname} table ({table.shape[1]} blocks), {rescale}, "
                    f"rows ending on tile edges: largest per-row |kernel - "
                    f"plain| / |plain| {rels[0]:.3g}, vs the split walk "
                    f"{rels[1]:.3g} (bound {tol}), {plan_text(plan)}, "
                    f"dead rows exactly 0: {zero}")
                if not (ok and zero):
                    raise AssertionError(f"mla_prefill_paged {pool} pool, "
                                         f"{tname} table, at tile edges "
                                         f"disagrees")
                worst = max(worst, *rels)
    return worst


# phase 9's verify step on K2: chunk C = k + 1 with k = SPEC_K; each
# request's resident prefix (the decode indices of phase 2's load) and its
# window: n_valid < C on a budget-clipped row, an idle request
SPEC_K = 4
CV = SPEC_K + 1
VERIFY_LENGTHS = [1055, 255, 511, 1023, 300, 767, 15, 0]
VERIFY_NVALID = [5, 5, 5, 3, 5, 1, 2, 0]


def verify_work(cv, lengths, n_valid, q_bytes: int, row_bytes: int):
    """(bytes, operations, bytes with every valid chunk row reading its
    own prefix) of K2 over (B, cv) query rows: the valid rows' q read once
    (a row past n_valid comes out 0 and needs none), each cached position
    a request's rows attend read once, every output row written once, the
    table entries and per-request ints read once; two products of
    (Dl + Dr) and Dl per (query row, position)."""
    need = [ln + nv if nv else 0 for ln, nv in zip(lengths, n_valid)]
    rows_pos = sum(ln + c + 1 for ln, nv in zip(lengths, n_valid)
                   for c in range(nv))
    fixed = (sum(n_valid) * (DL + DR) + B * cv * DL) * H * q_bytes \
        + (sum(-(-n // BS) for n in need) + 2 * B) * 4
    return (fixed + sum(need) * row_bytes,
            2 * H * rows_pos * (DL + DR + DL),
            fixed + rows_pos * row_bytes)


def check_verify_kernel(torch):
    """K2 at the verify width C = k + 1 (phase 9's step): bf16 q on bf16,
    int8 and fp8 pools, both rescales, held row by row and elementwise
    against its plain walk and the split walk's model, on its
    tensor-core route, rows past n_valid exactly 0; then its time on the
    bf16 pool beside its plain version, SDPA and two bounds — the
    prefix read once for all of a request's rows (what the cost model's
    ``mla_verify_cost`` prices) and read once per chunk row (what a CTA
    per (request, chunk row) does) — and beside K2 at C = 1 and K1 on the
    same prefixes.  Returns the row for the kernel table."""
    import torch.nn.functional as F

    from repro_torch.core import cache as cachelib
    from repro_torch.kernels import mla_decode, mla_prefill, ref

    kern = mla_prefill.mla_prefill_paged_kernel
    tol = TOL["bfloat16"]
    need = [ln + nv for ln, nv in zip(VERIFY_LENGTHS, VERIFY_NVALID)]
    ckv, krope, bt = paged_inputs(torch, torch.float32, need, 11)
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    q = torch.randn((B, CV, H, DL + DR), generator=g,
                    device="cuda").bfloat16()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
    ln, nv = i32(VERIFY_LENGTHS), i32(VERIFY_NVALID)
    worst = 0.0
    for pool in ("bf16", "int8", "fp8"):
        if pool == "bf16":
            c, r, qkw = ckv.bfloat16(), krope.bfloat16(), {}
        else:
            qdtype, qmax = cachelib.cache_dtype_info(pool)
            c, cs = cachelib.quantize_latent(ckv, qmax, qdtype)
            r, rs = cachelib.quantize_latent(krope, qmax, qdtype)
            qkw = dict(ckv_scales=cs, krope_scales=rs)
        for rescale in ref.RESCALES:
            kw = dict(softmax_scale=SCALE, rescale=rescale, **qkw)
            got = kern(q, c, r, bt, ln, nv, **kw)
            torch.cuda.synchronize()
            plan = launched_plan(kern)
            wants = (ref.mla_prefill_paged_ref(q, c, r, bt, ln, nv, **kw),
                     ref.mla_prefill_split_ref(
                         q, c, r, bt, ln, nv, split_pos=plan["split_pos"],
                         **kw))
            rels = [row_rel(torch, got, w) for w in wants]
            ok = max(rels) <= tol and all(
                torch.allclose(got.float(), w.float(), atol=tol, rtol=tol)
                for w in wants)
            zero = all(bool((got[b, n:] == 0).all())
                       for b, n in enumerate(VERIFY_NVALID))
            log(f"[kernels] mla_prefill_paged at the verify width C = {CV} "
                f"(k = {SPEC_K}), bf16 {pool} pool, {rescale}: largest "
                f"per-row |kernel - plain| / |plain| {rels[0]:.3g}, vs the "
                f"split walk {rels[1]:.3g} (bound {tol}), "
                f"{plan_text(plan)}, dead rows exactly 0: {zero}")
            if not (ok and zero):
                raise AssertionError(f"mla_prefill_paged at C = {CV} on a "
                                     f"{pool} pool disagrees")
            if plan["grid"][2] != B * CV:
                raise AssertionError(f"K2 at C = {CV} planned {plan}")
            worst = max(worst, *rels)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    c, r = ckv.bfloat16(), krope.bfloat16()
    kw = dict(softmax_scale=SCALE, rescale="exp_add")
    run = functools.partial(kern, q, c, r, bt, ln, nv, **kw)
    row = dict(ms=time_ms(torch, run, flush))
    row["plan"] = launched_plan(kern)
    row["ms_with_host"] = time_ms(torch, run, flush, sleep=False)
    row["plain_ms"] = time_ms(torch, functools.partial(
        ref.mla_prefill_paged_ref, q, c, r, bt, ln, nv, **kw), flush, reps=5)
    S = bt.shape[1] * BS
    kv = torch.cat([c[bt.long()].reshape(B, S, DL),
                    r[bt.long()].reshape(B, S, DR)], dim=-1)
    pos = torch.arange(S, device="cuda")
    qpos = ln[:, None].long() + torch.arange(CV, device="cuda")[None, :]
    mask = ((pos[None, None, :] <= qpos[:, :, None])
            & (torch.arange(CV, device="cuda")[None, :, None]
               < nv[:, None, None].long()))[:, None]
    k_ = kv[:, None].expand(B, H, S, DL + DR)
    v_ = kv[:, None, :, :DL].expand(B, H, S, DL)
    qs = q.permute(0, 2, 1, 3)
    row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, k_, v_, attn_mask=mask, scale=SCALE), flush, reps=5)
    n_bytes, n_ops, per_row_bytes = verify_work(
        CV, VERIFY_LENGTHS, VERIFY_NVALID, 2, (DL + DR) * 2)
    row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
    row["bound_ms_per_row_reads"] = bound(per_row_bytes, n_ops)[0]
    row["max_abs_err"] = (run().float() - ref.mla_prefill_paged_ref(
        q, c, r, bt, ln, nv, **kw).float()).abs().max().item()
    # the same prefixes at C = 1 (K2) and through K1 (index = lengths)
    one = torch.clamp(nv, max=1)
    row["c1_ms"] = time_ms(torch, functools.partial(
        kern, q[:, :1].contiguous(), c, r, bt, ln, one, **kw), flush)
    idx = torch.where(nv > 0, ln, torch.full_like(ln, -1))
    q1 = q[:, 0].contiguous()
    row["k1_ms"] = time_ms(torch, functools.partial(
        mla_decode.mla_decode_paged_kernel, q1, c, r, bt, idx, **kw), flush)
    row["row_rel"] = worst
    log(f"[kernels] mla_prefill_paged at the verify width C = {CV}, bf16: "
        f"time {row['ms']:.4f} ms ({host_text(row)}), plain "
        f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {n_bytes / 1e6:.2f} "
        f"MB with each prefix read once, {n_ops / 1e9:.2f} GFLOP; "
        f"{row['bound_ms'] / row['ms']:.4f} of it reached), "
        f"{row['bound_ms_per_row_reads']:.5f} ms with each valid chunk row "
        f"reading its own prefix ({per_row_bytes / 1e6:.2f} MB); the same "
        f"prefixes at C = 1: K2 {row['c1_ms']:.4f} ms, K1 "
        f"{row['k1_ms']:.4f} ms; C = {CV} / C = 1 "
        f"{row['ms'] / row['c1_ms']:.3f}, / K1 {row['ms'] / row['k1_ms']:.3f}; "
        f"{plan_text(row['plan'])}")
    return row


def sdpa_calls(torch, q, k, v, do, causal=True, scale=TDQK ** -0.5):
    """``scaled_dot_product_attention`` forward, and its backward alone,
    on the same tensors (timed only; the port never calls it), and the
    name of the device kernel that ran the forward."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    kw = dict(is_causal=causal, scale=scale)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, **kw)
        torch.cuda.synchronize()
    names = [e.key for e in sorted(prof.key_averages(),
                                   key=lambda e: -e.self_device_time_total)
             if e.device_type.name == "CUDA"]
    return (lambda: F.scaled_dot_product_attention(q, k, v, **kw),
            lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                        retain_graph=True),
            names[0][:80] if names else "an unnamed kernel")


# ------------------------------------------- phases 3 and 4: full width --


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
    """Phases 3, 4, 7, 8, 9 and 13, on one full-width model: paged
    serving on a bf16 and on an fp8 pool, contiguous serving, sampled
    serving with telemetry, the engines in turns and the frontend,
    speculative decoding (9(a) on the f32 smoke config), then the
    cold-cache options, 'chunked', compression and the examples; then
    phase 14's single-card reference on it, and phase 14 once it is
    freed.  Returns the kernel launch counts of each path."""
    from repro_torch import configs, models
    from repro_torch.nn import module as nnm

    cfg = dataclasses.replace(configs.full("deepseek-v2-236b"), n_layers=4)
    t0 = time.perf_counter()
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[e2e] {cfg.name} x{cfg.n_layers} layers (plan "
        f"{[d.ffn for d, _ in models.lm.layers(cfg, params)]}): "
        f"{n_params / 1e9:.2f} B params bf16 "
        f"({n_params * 2 / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f}s")
    # the two pools in turns (bf16, fp8, fp8, bf16): one call's host and
    # card drift, not the pool, would otherwise decide their ratio
    by_path, tps = {}, {"bf16": [], "fp8": []}
    for i, cd in enumerate(("bf16", "fp8", "fp8", "bf16")):
        launches, tokens_per_s = serve_paged_full(
            torch, np, cfg, params, cd, check_logits=i < 2)
        by_path[f"serve_paged_{cd}_{i + 1}"] = launches
        tps[cd].append(tokens_per_s)
    log(f"[e2e] paged serving in turns bf16, fp8, fp8, bf16: "
        f"{tps['bf16'][0]:.1f}, {tps['fp8'][0]:.1f}, {tps['fp8'][1]:.1f}, "
        f"{tps['bf16'][1]:.1f} tokens/s; fp8 / bf16 = "
        f"{sum(tps['fp8']) / sum(tps['bf16']):.3f}")
    by_path["serve_contiguous"] = serve_contiguous_full(torch, np, cfg,
                                                        params)
    by_path.update(sampled_telemetry(torch, np, cfg, params))
    by_path.update(phase8_turns(torch, np, cfg, params))
    by_path.update(phase8_sampled(torch, np, cfg, params))
    by_path.update(phase8_frontend(torch, np, cfg, params))
    spec_smoke_parity(torch, np)
    by_path.update(spec_full_width(torch, np, cfg, params))
    by_path.update(phase13(torch, np, cfg, params, tps["bf16"]))
    mesh_ref = phase14_reference(torch, np, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # every engine and its graphs are gone: what stays allocated leaked
    log(f"[e2e] after phases 3, 4, 7, 8, 9 and 13: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
    # the mesh's ranks draw their own shards: phase 3's model is freed
    by_path.update(phase14(torch, np, mesh_ref))
    return by_path


def serve_paged_full(torch, np, cfg, params, cache_dtype: str,
                     check_logits: bool = True):
    """Phase 3 on a ``cache_dtype`` pool: a warm-up serve, the timed serve
    of ``requests_full`` with its checks, then (``check_logits``) the
    logit comparison.  Returns the launch counts and tokens/s."""
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import build_engine, serve_paged
    from repro_torch.runtime import Request, SamplingParams

    gen = 32
    reqs = requests_full(cfg, np, Request, SamplingParams, gen)
    engine_kw = dict(batch=len(reqs), max_len=max(r.plen for r in reqs) + gen,
                     gen=gen, block_size=BS, impl="kernel", scheme="auto",
                     platform="h100", prefill_chunk=C,
                     cache_dtype=cache_dtype, compute_dtype=torch.bfloat16,
                     device="cuda")
    t0 = time.perf_counter()
    warm = build_engine(cfg, params, **engine_kw)
    warm.run(warm_up_requests(cfg, np, Request, SamplingParams))
    log(f"[e2e] {cache_dtype} pool: warm-up serve: {warm.stats.steps} steps "
        f"in {time.perf_counter() - t0:.2f}s")
    warm.close()
    del warm
    engine = build_engine(cfg, params, **engine_kw)
    # the engine's default on the card: its steps as CUDA graphs, captured
    # here (each dispatchable decode scheme and the prefill chunk) so the
    # serve below counts the replays' launches alone
    capture_s = engine.warm_up()
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
    log(f"[e2e] {cache_dtype} pool: finished {len(done)}/{len(reqs)} "
        f"requests, {summary['decode_tokens']} decode tokens in "
        f"{summary['steps']} steps ({ticks} decode ticks, {chunks} prefill "
        f"chunks), prefix hit tokens {summary['prefix_hit_tokens']:.0f}")
    log(f"[e2e] {cache_dtype} pool: {summary['tokens_per_s']:.1f} tokens/s, "
        f"step {engine.stats.wall * 1e3 / engine.stats.steps:.2f} ms mean, "
        f"pool {engine.cache_token_bytes / cfg.n_layers:.0f} bytes per token "
        f"a layer, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}, MoE capacity factor {cfg.capacity_factor}, CUDA "
        f"graphs {engine.cuda_graphs} (captured in {capture_s:.3f}s)")
    if not engine.cuda_graphs:
        raise AssertionError("the engine's default on the card is graphs")
    if len(done) != len(reqs) or any(len(r.output) != gen for r in done):
        raise AssertionError("not every request finished with its tokens")
    if summary["prefix_hit_tokens"] < 512:
        raise AssertionError("the shared 512-token prefix did not hit")
    want = {"mla_decode_paged": cfg.n_layers * ticks,
            "mla_prefill_paged": cfg.n_layers * chunks}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_graph_plans(engine)             # bf16: the tensor-core walk
    if check_logits:
        compare_logits(torch, drop_free(cfg), reqs, engine, cache_dtype)
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return launches, summary["tokens_per_s"]


def serve_contiguous_full(torch, np, cfg, params):
    """Phase 4: the contiguous launcher's path at full width, batch 8 x
    2,048 prompt tokens, 32 generated (31 decode steps after the prefill's
    token), after a warm-up at the same shapes; then the logit check."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode
    from repro_torch.launch.serve import serve_contiguous

    kw = dict(batch=B, prompt_len=PROMPT, gen=GEN, scheme="auto",
              platform="h100", impl="kernel", compute_dtype=torch.bfloat16,
              device="cuda")
    t0 = time.perf_counter()
    serve_contiguous(cfg, params, log=lambda _: None, **kw)
    log(f"[contig] warm-up at the same shapes: "
        f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    mla_decode.mla_decode_kernel.launches = 0
    fa.flash_fwd_kernel.launches = 0
    res = serve_contiguous(cfg, params, log=log, **kw)
    launches = {"mla_decode": mla_decode.mla_decode_kernel.launches,
                "flash_attention_fwd": fa.flash_fwd_kernel.launches}
    steps = res["decode_steps"]
    log(f"[contig] {cfg.name} x{cfg.n_layers} layers, batch {B} x {PROMPT} "
        f"prompt tokens, {GEN} generated, scheme '{res['scheme']}' "
        f"(auto_dispatch, h100): prefill {res['prefill_s'] * 1e3:.1f} ms, "
        f"decode {steps * B / res['decode_s']:.1f} tokens/s, step "
        f"{res['decode_s'] * 1e3 / steps:.2f} ms mean, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}, MoE capacity factor {cfg.capacity_factor}")
    MEASURED["contiguous"] = dict(tokens_per_s=steps * B / res["decode_s"],
                                  step_ms=res["decode_s"] * 1e3 / steps)
    tokens = res["tokens"]
    if tokens.shape != (B, GEN) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab \
            or not bool(torch.isfinite(res["last_logits"]).all()):
        raise AssertionError("the contiguous serve returned bad tokens or "
                             "logits")
    want = {"mla_decode": cfg.n_layers * steps,
            "flash_attention_fwd": cfg.n_layers}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for kern in (mla_decode.mla_decode_kernel, fa.flash_fwd_kernel):
        launched_plan(kern)               # bf16: the tensor-core routes
    compare_contiguous(torch, np, drop_free(cfg), params, res["scheme"])
    torch.cuda.empty_cache()
    return launches


def compare_contiguous(torch, np, cfg, params, scheme):
    """The contiguous path's prefill and last decode step, impl='kernel'
    against impl='ref', per row within LOGITS_REL_L2.  The prompts of the
    timed run, prefilled one request at a time (the dense reference
    attention holds a (H, L, L) f32 score tensor; at drop-free capacity a
    request's result does not depend on its batch), the caches joined,
    then GEN - 2 kernel decode steps and the last step on copies of the
    cache with both impls."""
    from repro_torch.launch.serve import _prepare_mla
    from repro_torch.runtime import make_prefill_step, make_serve_step

    params = _prepare_mla(params, cfg, scheme)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PROMPT)), device="cuda")
    kw = dict(compute_dtype=torch.bfloat16, scheme=scheme)
    prefill = {impl: make_prefill_step(cfg, capacity=S_CONTIG, impl=impl,
                                       **kw) for impl in ("kernel", "ref")}
    step = {impl: make_serve_step(cfg, impl=impl, **kw)
            for impl in ("kernel", "ref")}
    rows, caches, rel_prefill = [], [], []
    for b in range(B):
        logits_k, cache = prefill["kernel"](params, toks[b:b + 1])
        logits_r, _ = prefill["ref"](params, toks[b:b + 1])
        rel_prefill += _row_rel(torch, logits_k, logits_r)
        rows.append(logits_k)
        caches.append(cache)
        torch.cuda.empty_cache()
    cache = _cat(torch, caches)
    tok = torch.argmax(torch.cat(rows), dim=-1)
    for i in range(GEN - 2):
        logits, cache = step["kernel"](params, tok, cache, PROMPT + i)
        tok = torch.argmax(logits, dim=-1)
    last = PROMPT + GEN - 2
    dec_r, _ = step["ref"](params, tok, _clone(cache), last)
    dec_k, _ = step["kernel"](params, tok, cache, last)
    rel_decode = _row_rel(torch, dec_k, dec_r)
    log(f"[contig] logits kernel vs ref at drop-free capacity, per-row "
        f"|a-b|/|b| (bound {LOGITS_REL_L2}): prefill max "
        f"{max(rel_prefill):.4f}, last decode step (index {last}) max "
        f"{max(rel_decode):.4f}")
    if max(rel_prefill + rel_decode) > LOGITS_REL_L2:
        raise AssertionError("contiguous kernel-path logits disagree with "
                             "the reference path")


def _cat(torch, trees):
    """Per-request cache trees joined along the batch."""
    if isinstance(trees[0], dict):
        return {k: _cat(torch, [t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_cat(torch, list(ts)) for ts in zip(*trees)]
    return torch.cat(trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def compare_logits(torch, cfg, reqs, engine, cache_dtype):
    """Prefill every prompt with the kernel path into a ``cache_dtype``
    pool, then run the same last prefill chunk and the first decode step
    on copies of that pool with impl='kernel' and impl='ref'; the logits
    must agree within LOGITS_REL_L2 per row."""
    from repro_torch import models
    from repro_torch.runtime import blocks_for

    params = engine.params          # with the absorbed leaves 'ru' reads
    nb = max(blocks_for(r.plen + 1, BS) for r in reqs)
    pool = models.init_paged_cache(cfg, 1 + len(reqs) * nb, BS,
                                   torch.bfloat16, "cuda", cache_dtype)
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
    log(f"[e2e] {cache_dtype} pool: logits kernel vs ref, per-row "
        f"|a-b|/|b| (bound "
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


# ------------------------------------- phase 7: sampling and telemetry --

# Random123's kat_vectors for threefry2x32_20: (key, counter, output)
THREEFRY_KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
                 (0x6b200159, 0x99ba4efe)),
                ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
                 (0x1cb996fc, 0xbb002be7)),
                ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
                 (0xc4923a9c, 0x483df7a0))]
SAMPLE_KW = dict(temperature=0.7, top_k=50, sample_seed=0)
# the sampler on the card against the CPU: a token may differ only on a
# row whose two best CPU scores lie within TIE_ULPS ulps of the larger
# (the Gumbel noise's two logarithms may round differently on the two
# devices, ~1 ulp, and the add rounds once more), and at most
# TIE_DRAWS_MAX of the 8 x 16 draws of a setting may differ
TIE_ULPS = 4
TIE_DRAWS_MAX = 1


def check_prng_on_card(torch):
    """Phase 7(a): the Random123 known answers on the card; a grid of
    fold(fold(PRNGKey(s), rid), pos) keys and their bits / uniforms bit
    for bit on the card and the CPU; the sampler at full vocabulary on
    the card against the CPU, with the counted tie allowance."""
    from repro_torch.runtime import prng
    from repro_torch.runtime.steps import sample_scores, sample_tokens

    for key, ctr, want in THREEFRY_KAT:
        words = [torch.tensor([v], dtype=torch.int64, device="cuda")
                 for v in key + ctr]
        got = tuple(int(w[0]) for w in prng.threefry2x32(*words))
        if got != want:
            raise AssertionError(f"threefry2x32 on the card: {got} != "
                                 f"{want}")
    rids = torch.arange(64).repeat_interleave(16)
    poss = torch.arange(16).repeat(64) * 97 + 5
    n_bits = 0
    for seed in (0, 7, 2**32 - 1):
        keys = {d: prng.fold_in(prng.fold_in(prng.PRNGKey(seed, d),
                                             rids.to(d)), poss.to(d))
                for d in ("cpu", "cuda")}
        same = torch.equal(keys["cuda"].cpu(), keys["cpu"])
        for shape in ((7,), (3, 1000)):
            a = prng.uniform(keys["cuda"], shape).cpu()
            b = prng.uniform(keys["cpu"], shape)
            same &= torch.equal(a.view(torch.int32), b.view(torch.int32))
            same &= torch.equal(prng.random_bits(keys["cuda"], shape).cpu(),
                                prng.random_bits(keys["cpu"], shape))
            n_bits += 2 * a.numel()
        if not same:
            raise AssertionError(f"prng keys / bits differ between the card "
                                 f"and the CPU (seed {seed})")
    log(f"[sample] threefry2x32 known answers on the card; keys, bits and "
        f"uniforms of {len(rids)} (rid, pos) keys x 3 seeds ({n_bits} "
        f"words) bit for bit on the card and the CPU")
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((8, 102400), generator=g) * 4
    for top_k in (0, 50):
        kw = dict(SAMPLE_KW, top_k=top_k)
        bad_rows = near = 0
        for draw in range(16):
            rids = torch.arange(8, dtype=torch.int64) * 3
            poss = torch.full((8,), 100 + draw, dtype=torch.int64)
            scores = sample_scores(logits, rids, poss, **kw)
            want = torch.argmax(scores, dim=-1)
            got = sample_tokens(logits.cuda(), rids.cuda(), poss.cuda(),
                                **kw).cpu()
            top = torch.topk(scores, 2, dim=-1).values
            ulp = torch.finfo(torch.float32).eps \
                * top[:, 0].abs().clamp_min(1.0)
            tie = (top[:, 0] - top[:, 1]) <= TIE_ULPS * ulp
            bad = got != want
            if (bad & ~tie).any():
                raise AssertionError(f"top_k {top_k} draw {draw}: the card "
                                     f"sampled another token off a tie")
            bad_rows += int(bad.sum())
            near += int(tie.sum())
        log(f"[sample] sampler, 8 rows x 102400 logits x 16 draws, "
            f"temperature {kw['temperature']}, top_k {top_k}: {bad_rows} of "
            f"128 tokens differ between the card and the CPU ({near} draws "
            f"within {TIE_ULPS} ulps of a tie; allowed {TIE_DRAWS_MAX})")
        if bad_rows > TIE_DRAWS_MAX:
            raise AssertionError("too many sampled tokens differ")


def requests_sampled(cfg, np, Request, SamplingParams, gen: int):
    """Phase 3's 8 requests with the 256-token one forked n = 2; rids
    are spaced by 2 (a fork child claims rid + 1)."""
    base = requests_full(cfg, np, Request, SamplingParams, gen)
    return [Request(rid=2 * i, prompt=r.prompt, arrival=r.arrival,
                    sampling=SamplingParams(max_tokens=gen,
                                            n=2 if i == 2 else 1))
            for i, r in enumerate(base)]


def check_graph_plans(engine) -> dict:
    """The plans K1 / K2 recorded when the engine's graphs were captured
    (every replay launches exactly those): each on its tensor-core walk
    (bf16).  Returns them by graph."""
    plans = engine.graph_plans()
    launched = [p for g in plans.values() for p in g.values()]
    if not launched or any(p["n_split"] <= 0 for p in launched):
        raise AssertionError(f"a captured launch left the tensor-core "
                             f"walk: {plans}")
    return plans


def serve_counted(torch, cfg, engine, reqs):
    """Serve ``reqs`` on ``engine`` (graphs already captured by
    ``warm_up``, or eager) with the launch counters zeroed: K1 / K2
    launches must equal layers x decode ticks and layers x prefill
    chunks (through replays, with graphs), and every launch must be on
    the tensor-core walk (the captured plans, with graphs; every eager
    launch's plan, without).  Returns the summary and the counts."""
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import serve_paged

    plans = {}
    restore = every_launch_plan(torch, plans)
    mla_decode.mla_decode_paged_kernel.launches = 0
    mla_prefill.mla_prefill_paged_kernel.launches = 0
    try:
        summary = serve_paged(engine, reqs, log=lambda *_: None,
                              log_every=0)
    finally:
        restore()
    launches = {"mla_decode_paged": mla_decode.mla_decode_paged_kernel.launches,
                "mla_prefill_paged":
                    mla_prefill.mla_prefill_paged_kernel.launches}
    ticks = sum(summary["schemes_used"].values())
    want = {"mla_decode_paged": cfg.n_layers * ticks,
            "mla_prefill_paged": cfg.n_layers * summary["prefill_chunks"]}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if engine.cuda_graphs:
        if plans:
            raise AssertionError(f"a graph engine launched eagerly: "
                                 f"{ {k: len(v) for k, v in plans.items()} }")
        check_graph_plans(engine)
    for name, seen in plans.items():
        off = [p for p in seen if p["n_split"] <= 0]
        if len(seen) != launches[name.replace("_kernel", "")] or off:
            raise AssertionError(f"{name}: {len(off)} of {len(seen)} "
                                 f"launches left the tensor-core walk")
    return summary, launches


def every_launch_plan(torch, record):
    """Wrap the paged kernels' wrappers where the model calls them
    (``kernels.ops``) so that ``record[name]`` gets the plan of every
    launch; returns a function that restores them."""
    from repro_torch.kernels import ops

    saved = {}
    for name in ("mla_decode_paged_kernel", "mla_prefill_paged_kernel"):
        real = saved[name] = getattr(ops, name)

        def rec(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            record.setdefault(_name, []).append(_real.last_plan)
            return out
        setattr(ops, name, rec)

    def restore():
        for name, real in saved.items():
            setattr(ops, name, real)
    return restore


def serve_sampled(torch, np, cfg, params, telemetry, **engine_kw):
    """One sampled serve of ``requests_sampled`` (temperature 0.7, top-k
    50, seed 0) on a bf16 pool through the kernels, with ``telemetry``
    (or none), on the engine ``engine_kw`` picks (default: the sync
    engine on graphs, captured first).  Returns the engine, its summary
    and the launch counts, checked against layers x ticks / chunks with
    every launch on the tensor-core walk."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.runtime import Request, SamplingParams

    gen = 32
    reqs = requests_sampled(cfg, np, Request, SamplingParams, gen)
    engine = build_engine(
        cfg, params, batch=len(reqs) + 1, n=2,
        max_len=max(r.plen for r in reqs) + gen, gen=gen, block_size=BS,
        impl="kernel", scheme="auto", platform="h100", prefill_chunk=C,
        cache_dtype="bf16", compute_dtype=torch.bfloat16, device="cuda",
        telemetry=telemetry, **SAMPLE_KW, **engine_kw)
    engine.warm_up()
    summary, launches = serve_counted(torch, cfg, engine, reqs)
    done = engine.sched.finished
    if len(done) != len(reqs) + 1 or any(len(r.output) != gen
                                         for r in done):
        raise AssertionError("not every sampled request finished")
    return engine, summary, launches


STATS_KEYS = ("steps", "decode_tokens", "prefill_tokens", "prompt_tokens",
              "prefill_chunks", "admissions", "mid_gen_admissions",
              "preemptions", "scheme_switches", "schemes_used",
              "prefix_hit_tokens", "fork_groups", "fork_children")


def sampled_telemetry(torch, np, cfg, params):
    """Phase 7 (b)-(d): the sampled serve with telemetry on and off in
    turns (on, off, off, on): every request finishes, the fork diverges,
    the trace validates, drift covers every dispatched scheme, the
    EngineStats counters agree across the four, tokens/s of both and
    their ratio, the drift report.  Returns the launch counts."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.obs import RooflineDrift, Telemetry, validate_trace
    from repro_torch.runtime import Request, SamplingParams

    check_prng_on_card(torch)
    t0 = time.perf_counter()
    warm = build_engine(cfg, params, batch=9, n=2, max_len=1024 + 32,
                        gen=32, block_size=BS, impl="kernel", scheme="auto",
                        platform="h100", prefill_chunk=C,
                        compute_dtype=torch.bfloat16, device="cuda",
                        **SAMPLE_KW)
    warm.run(warm_up_requests(cfg, np, Request, SamplingParams))
    log(f"[sample] warm-up serve: {warm.stats.steps} steps in "
        f"{time.perf_counter() - t0:.2f}s")
    warm.close()
    del warm
    by_path, tps, stats = {}, {"on": [], "off": []}, []
    drift = RooflineDrift()
    for i, mode in enumerate(("on", "off", "off", "on")):
        tel = Telemetry.on(trace=True, metrics=True, drift=True) \
            if mode == "on" else None
        engine, summary, launches = serve_sampled(torch, np, cfg, params,
                                                  tel)
        by_path[f"serve_sampled_telemetry_{mode}_{i + 1}"] = launches
        tps[mode].append(summary["tokens_per_s"])
        stats.append({k: summary[k] for k in STATS_KEYS})
        outs = {r.rid: list(r.output) for r in engine.sched.finished}
        if outs[4] == outs[5]:
            raise AssertionError("the n = 2 fork did not diverge")
        if tel is not None:
            tel.finalize(engine)
            trace = tel.tracer.to_dict()
            problems = validate_trace(trace)
            if problems:
                raise AssertionError(f"trace: {problems[:3]}")
            uncovered = tel.drift.check_coverage(summary["schemes_used"],
                                                 kinds=("decode",))
            if uncovered:
                raise AssertionError(f"drift: {uncovered}")
            text = json.dumps(trace) + json.dumps(tel.metrics.to_dict())
            phases = sorted({e["name"] for e in trace["traceEvents"]
                             if e["ph"] == "X" and e["pid"] == 1})
            log(f"[sample] telemetry on: {len(trace['traceEvents'])} trace "
                f"events ({len(text) / 1e6:.2f} MB as JSON), step phases "
                f"{phases}, trace valid, drift rows "
                f"{len(tel.drift.rows)} covering {tel.drift.schemes_covered()}")
            if drift.mla is None:
                drift.bind(mla=tel.drift.mla, platform=tel.drift.platform,
                           paged_block=tel.drift.paged_block,
                           cache_dtype=tel.drift.cache_dtype)
            drift.rows += tel.drift.rows
        log(f"[sample] telemetry {mode}: {len(outs)} requests finished, "
            f"{summary['decode_tokens']} decode tokens in {summary['steps']} "
            f"steps, {summary['tokens_per_s']:.1f} tokens/s, launches "
            f"{launches}, every launch on the tensor-core walk, forks "
            f"diverge")
        engine.close()
        del engine
        torch.cuda.empty_cache()
    if any(s != stats[0] for s in stats):
        raise AssertionError(f"EngineStats differ with telemetry on and "
                             f"off: {stats}")
    on, off = sum(tps["on"]) / 2, sum(tps["off"]) / 2
    log(f"[sample] in turns on, off, off, on: {tps['on'][0]:.1f}, "
        f"{tps['off'][0]:.1f}, {tps['off'][1]:.1f}, {tps['on'][1]:.1f} "
        f"tokens/s; on / off = {on / off:.3f}; EngineStats identical "
        f"({stats[0]})")
    rep = drift.report()
    log(f"[drift] measured / predicted, {rep['platform']} point, block "
        f"{rep['paged_block']}, {rep['cache_dtype']} pool, {rep['rows']} "
        f"rows of the two traced serves (the whole {cfg.n_layers}-layer "
        f"model step against one MLA layer's attention):")
    for key, b in rep["buckets"].items():
        log(f"[drift]   {key}: n {b['n']}, p50 {b['time_ratio_p50']:.1f}, "
            f"p95 / p50 {b['spread']:.3f}; mean predicted "
            f"{b['pred_time_s'] / b['n'] * 1e3:.4g} ms, measured "
            f"{b['meas_time_s'] / b['n'] * 1e3:.4g} ms, predicted bytes "
            f"{b['pred_bytes_per_step'] / 1e6:.4g} MB a row")
    s = rep["summary"]
    log(f"[drift]   all: p50 {s['time_ratio_p50']:.1f}, p95 / p50 "
        f"{s['spread']:.3f}")
    return by_path


# --------------- phase 8: CUDA graphs, the async engine, the frontend --


# Phase 8(a) and (b) serve one request stream on engines that queue the
# same device steps in the same order, and each step is a fixed function
# of its inputs (the MoE combines without atomics, rows that write one
# pool slot write the same values: models/moe.py, core/cache.py), so
# there the tokens and the pool's bytes must be identical.  The
# frontend's batches form as requests arrive, so a row shares its steps
# with other rows than in the direct run: a token may differ from the
# direct run's only where the scores that decided it lay within a near
# tie, two bf16 steps of a logit (2^-4 for |logit| in [4, 8)).  Sampled
# scores (logits / temperature + Gumbel noise) have steps scaled by
# 1 / temperature.  After a request's first difference its tokens follow
# another context, so only the first counts.
NEAR_TIE = 0.125
# phase 8(a): the paged engines in turns on phase 3's load, bf16 pool
PHASE8_TURNS = (("eager", "sync", False), ("graphs", "sync", True),
                ("async", "async", True), ("async", "async", True),
                ("graphs", "sync", True), ("eager", "sync", False))
PHASE8_FP8 = (("graphs", "sync", True), ("eager", "sync", False))


def outputs(engine) -> dict:
    return {r.rid: [int(t) for t in r.output] for r in engine.sched.finished}


def pool_bytes(torch, engine) -> list:
    """The bytes of every leaf of ``engine``'s pool, null block included,
    on the host."""
    from repro_torch.core.cache import pool_leaves
    return [t.contiguous().view(torch.uint8).cpu() for t in
            pool_leaves(engine.pool)]


def check_identical(torch, base: tuple, engine, label: str) -> None:
    """Raise unless ``engine`` finished with the outputs and the pool bytes
    of ``base`` = (outputs, pool_bytes) of the reference run."""
    want, pool0 = base
    have = outputs(engine)
    if set(have) != set(want):
        raise AssertionError(f"{label}: requests {sorted(have)} finished, "
                             f"not {sorted(want)}")
    for rid, toks in want.items():
        if have[rid] != toks:
            i = next((i for i, (a, b) in enumerate(zip(toks, have[rid]))
                      if a != b), min(len(toks), len(have[rid])))
            raise AssertionError(f"{label}: request {rid} differs from the "
                                 f"reference run at token {i}")
    pool = pool_bytes(torch, engine)
    bad = [i for i, (a, b) in enumerate(zip(pool0, pool))
           if not torch.equal(a, b)]
    if len(pool) != len(pool0) or bad:
        raise AssertionError(f"{label}: pool leaves {bad} differ from the "
                             f"reference run's")


def record_margins(torch, engine, store):
    """Wrap the sync ``engine``'s host sampler so that store[(rid, i)]
    holds the margin between the two best scores that decided output
    token i of request rid (logits when greedy, the perturbed scores
    when sampling)."""
    from repro_torch.runtime.steps import sample_scores

    real = engine._sample_tokens

    def rec(rows, slots):
        reqs = [engine.sched.slots[s] for s in slots]
        scores = rows.float()
        if engine.temperature > 0:
            ids = lambda v: torch.tensor(v, dtype=torch.long,
                                         device=rows.device)
            scores = sample_scores(
                rows, ids([r.rid for r in reqs]),
                ids([r.plen + len(r.tokens) for r in reqs]),
                temperature=engine.temperature, top_k=engine.top_k,
                sample_seed=engine._sample_seed)
        top = torch.topk(scores, 2, dim=-1).values
        for r, m in zip(reqs, (top[:, 0] - top[:, 1]).tolist()):
            store[(r.rid, len(r.tokens))] = m
        return real(rows, slots)
    engine._sample_tokens = rec


def tie_count(base: dict, got: dict, margins, label: str) -> int:
    """The requests whose tokens differ from ``base``, each at a near
    tie of the margins ``margins()`` records (computed only when a
    difference shows); raises on any other difference."""
    first = {}
    for rid, want in base.items():
        have = got.get(rid)
        if have is None or len(have) != len(want):
            raise AssertionError(f"{label}: request {rid} ended with "
                                 f"{None if have is None else len(have)} "
                                 f"tokens, not {len(want)}")
        i = next((i for i, (a, b) in enumerate(zip(want, have)) if a != b),
                 None)
        if i is not None:
            first[rid] = i
    if not first:
        return 0
    m = margins()
    for rid, i in first.items():
        bound = NEAR_TIE / m["temperature"]
        if m["store"].get((rid, i), math.inf) >= bound:
            raise AssertionError(
                f"{label}: request {rid} token {i} differs off a near tie "
                f"(margin {m['store'].get((rid, i))}, bound {bound})")
    return len(first)


def span_durs(trace, name, tid=None):
    """Durations (ms) of the engine track's ``name`` spans."""
    from repro_torch.obs.trace import PID_ENGINE
    return [e["dur"] / 1e3 for e in trace["traceEvents"]
            if e["ph"] == "X" and e["pid"] == PID_ENGINE
            and e["name"] == name and (tid is None or e["tid"] == tid)]


def span_ms(trace, name, tid=None):
    """Median duration (ms) of the engine track's ``name`` spans."""
    d = span_durs(trace, name, tid)
    return statistics.median(d) if d else float("nan")


def phase8_turns(torch, np, cfg, params):
    """Phase 8(a): sync eager, sync graphs and async graphs in turns on
    phase 3's load (bf16 pool, greedy), then graphs and eager on an fp8
    pool.  Tokens and pool bytes identical to the first run's on that
    pool, EngineStats counters equal, K1 / K2 launches = layers x ticks /
    chunks through replays.
    Returns the launch counts by run."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.obs import Telemetry
    from repro_torch.runtime import Request, SamplingParams

    gen = 32
    reqs_fn = lambda: requests_full(cfg, np, Request, SamplingParams, gen)
    kw = dict(batch=8, max_len=1024 + gen, gen=gen, block_size=BS,
              impl="kernel", scheme="auto", platform="h100", prefill_chunk=C,
              compute_dtype=torch.bfloat16, device="cuda")
    by_path, tps, base, stats0 = {}, {}, {}, {}
    in_turns = []
    turns = [t + ("bf16",) for t in PHASE8_TURNS] \
        + [t + ("fp8",) for t in PHASE8_FP8]
    for i, (label, kind, graphs, cd) in enumerate(turns):
        tel = Telemetry.on(trace=True, metrics=False, drift=False)
        engine = build_engine(cfg, params, cache_dtype=cd, engine=kind,
                              cuda_graphs=graphs, telemetry=tel, **kw)
        capture_s = engine.warm_up()
        torch.cuda.reset_peak_memory_stats()
        summary, launches = serve_counted(torch, cfg, engine, reqs_fn())
        peak = torch.cuda.max_memory_allocated() / 2**30
        trace = tel.tracer.to_dict()
        dev_tid = 1 if kind == "async" else 0
        plans = {g: {k.replace("_kernel", ""): (p["n_split"],
                                                 tuple(p["grid"]))
                     for k, p in kp.items()}
                 for g, kp in engine.graph_plans().items()}
        by_path[f"graphs_{label}_{cd}_{i + 1}"] = launches
        tps.setdefault((label, cd), []).append(summary["tokens_per_s"])
        if cd == "bf16":
            in_turns.append(f"{summary['tokens_per_s']:.1f}")
        stats = {k: summary[k] for k in STATS_KEYS}
        if cd not in base:
            base[cd] = outputs(engine), pool_bytes(torch, engine)
            stats0[cd] = stats
        check_identical(torch, base[cd], engine, f"{label} {cd}")
        if stats != stats0[cd]:
            raise AssertionError(f"EngineStats differ: {stats} vs "
                                 f"{stats0[cd]}")
        log(f"[graphs] {i + 1} {label} ({kind}, graphs {graphs}), {cd} "
            f"pool: {summary['tokens_per_s']:.1f} tokens/s, step "
            f"{engine.stats.wall * 1e3 / engine.stats.steps:.2f} ms mean, "
            f"decode tick device_step {span_ms(trace, 'device_step', dev_tid):.3f} "
            f"ms median{' (dispatch to ready)' if kind == 'async' else ''}, "
            f"prefill_chunk span {span_ms(trace, 'prefill_chunk'):.3f} ms "
            f"median, capture {capture_s:.3f}s, peak {peak:.2f} GiB, "
            f"launches {launches}, tokens and pool bytes as the first "
            f"{cd} run's, "
            f"plans at capture {plans}")
        engine.close()
        del engine
        torch.cuda.empty_cache()
    mean = lambda k: sum(tps[k]) / len(tps[k])
    log(f"[graphs] bf16 tokens/s in turns "
        f"{', '.join(t[0] for t in PHASE8_TURNS)}: {', '.join(in_turns)}; "
        f"graphs / eager {mean(('graphs', 'bf16')) / mean(('eager', 'bf16')):.3f}, "
        f"async / graphs {mean(('async', 'bf16')) / mean(('graphs', 'bf16')):.3f}; "
        f"fp8 / bf16 eager {mean(('eager', 'fp8')) / mean(('eager', 'bf16')):.3f}, "
        f"graphs {mean(('graphs', 'fp8')) / mean(('graphs', 'bf16')):.3f}; "
        f"EngineStats counters identical ({stats0['bf16']})")
    return by_path


def phase8_sampled(torch, np, cfg, params):
    """Phase 8(b): phase 7's load (sampled, one request forked n = 2) on
    the sync eager engine and the async engine on graphs, then the async
    engine with telemetry on: tokens and pool bytes identical,
    EngineStats counters equal, the trace valid, and the share of each
    device_step (device track) that the next tick's schedule overlaps."""
    from repro_torch.obs import Telemetry, validate_trace
    from repro_torch.obs.trace import PID_ENGINE
    from repro_torch.runtime.engine import TID_DEVICE

    by_path, base = {}, None
    for kind, graphs, on in (("sync", False, False), ("async", True, False),
                             ("async", True, True)):
        tel = Telemetry.on(trace=True, metrics=True, drift=True) if on \
            else None
        engine, summary, launches = serve_sampled(
            torch, np, cfg, params, tel, engine=kind, cuda_graphs=graphs)
        by_path[f"sampled_{kind}_{'graphs' if graphs else 'eager'}"
                f"{'_telemetry' if on else ''}"] = launches
        stats = {k: summary[k] for k in STATS_KEYS}
        if base is None:
            base, stats0 = (outputs(engine), pool_bytes(torch, engine)), stats
        check_identical(torch, base, engine, f"sampled {kind}")
        if stats != stats0:
            raise AssertionError(f"EngineStats differ: {stats} vs {stats0}")
        line = (f"[async] phase 7's load, {kind} engine, graphs {graphs}"
                f"{', telemetry on' if on else ''}: "
                f"{summary['tokens_per_s']:.1f} tokens/s, launches "
                f"{launches}, tokens and pool bytes as the sync eager "
                f"run's, EngineStats identical")
        if on:
            tel.finalize(engine)
            trace = tel.tracer.to_dict()
            problems = validate_trace(trace)
            if problems:
                raise AssertionError(f"async trace: {problems[:3]}")
            evs = [e for e in trace["traceEvents"]
                   if e["ph"] == "X" and e["pid"] == PID_ENGINE]
            dev = [e for e in evs if e["tid"] == TID_DEVICE
                   and e["name"] == "device_step"]
            sched = [e for e in evs if e["tid"] == 0
                     and e["name"] == "schedule"]
            share = [sum(max(0.0, min(d["ts"] + d["dur"], s["ts"] + s["dur"])
                             - max(d["ts"], s["ts"])) for s in sched)
                     / d["dur"] for d in dev if d["dur"] > 0]
            if not share:
                raise AssertionError("no device_step span on the device "
                                     "track")
            line += (f"; trace valid, {len(dev)} device_step spans on the "
                     f"device track (median {span_ms(trace, 'device_step', TID_DEVICE):.3f} "
                     f"ms, dispatch to ready), overlapped by the next "
                     f"tick's schedule: median {statistics.median(share):.3f}, "
                     f"mean {statistics.mean(share):.3f}, min "
                     f"{min(share):.3f}, max {max(share):.3f} of the span")
        log(line)
        engine.close()
        del engine
        torch.cuda.empty_cache()
    return by_path


def http_call(host, port, path, payload=None, timeout=300):
    """(status, body bytes) of a POST with a JSON body, or a GET."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://{host}:{port}{path}", data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def sse_events(lines):
    """[(event, payload)] of an SSE body's lines."""
    out, ev = [], None
    for line in lines:
        line = line.decode().strip() if isinstance(line, bytes) else line
        if line.startswith("event: "):
            ev = line[len("event: "):]
        elif line.startswith("data: "):
            out.append((ev, json.loads(line[len("data: "):])))
    return out


def phase8_frontend(torch, np, cfg, params):
    """Phase 8(c): ``launch.server.Frontend`` on the async engine (graphs)
    at full width, on 127.0.0.1 and a free port, driven from this
    process: two blocking requests, one SSE stream and one n = 2
    request at once, then a stream cancelled mid-decode; every request
    finishes (the cancelled one "cancelled"), their tokens equal a
    direct run of the sync engine on the same requests, /v1/health and
    /v1/metrics answer, and the server is shut down.  Drop-free MoE
    capacity: the frontend's batches form as requests arrive, and only
    then is each row's result independent of the others."""
    import threading
    import urllib.request

    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import build_engine
    from repro_torch.launch.server import Frontend
    from repro_torch.runtime import Request, SamplingParams

    cfg = drop_free(cfg)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (200, 300, 150, 250, 120)]
    gen = 24
    kw = dict(batch=4, n=2, max_len=300 + 200, gen=200, block_size=BS,
              impl="kernel", scheme="auto", platform="h100", prefill_chunk=C,
              compute_dtype=torch.bfloat16, device="cuda")
    engine = build_engine(cfg, params, engine="async", **kw)
    capture_s = engine.warm_up()
    k1, k2 = mla_decode.mla_decode_paged_kernel, \
        mla_prefill.mla_prefill_paged_kernel
    k1.launches = k2.launches = 0
    fe = Frontend(engine, host="127.0.0.1", port=0).start()
    host, port = fe.host, fe.port
    got = {}
    try:
        def blocking(i):
            got[i] = json.loads(http_call(host, port, "/v1/generate", {
                "prompt": prompts[i], "max_tokens": gen})[1])

        def streamed(i):
            got[i] = sse_events(http_call(host, port, "/v1/generate", {
                "prompt": prompts[i], "max_tokens": gen,
                "stream": True})[1].splitlines())

        def forked(i):
            got[i] = json.loads(http_call(host, port, "/v1/generate", {
                "prompt": prompts[i], "max_tokens": gen, "n": 2})[1])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=f, args=(i,), daemon=True)
                   for i, f in enumerate((blocking, blocking, streamed,
                                          forked))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or len(got) != 4:
            raise AssertionError("a frontend request did not finish")
        served_s = time.perf_counter() - t0
        # a stream cancelled after its second token
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/generate",
            json.dumps({"prompt": prompts[4], "max_tokens": 200,
                        "stream": True}).encode(),
            {"Content-Type": "application/json"})
        resp = urllib.request.urlopen(req, timeout=300)
        seen, rid, ev = 0, None, None
        for line in resp:
            line = line.decode().strip()
            if line.startswith("event: "):
                ev = line[len("event: "):]
            elif line.startswith("data: "):
                d = json.loads(line[len("data: "):])
                if ev == "start":
                    rid = d["rid"]
                elif ev == "token":
                    seen += 1
                    if seen == 2:
                        break
        http_call(host, port, "/v1/cancel", {"rid": rid})
        cancelled = sse_events(resp)
        resp.close()
        health = json.loads(http_call(host, port, "/v1/health")[1])
        metrics = json.loads(http_call(host, port, "/v1/metrics")[1])
    finally:
        fe.stop()
    alive = fe.worker.is_alive()
    summary = engine.summary()
    launches = {"mla_decode_paged": k1.launches,
                "mla_prefill_paged": k2.launches}
    want_launches = {
        "mla_decode_paged": cfg.n_layers * sum(
            summary["schemes_used"].values()),
        "mla_prefill_paged": cfg.n_layers * summary["prefill_chunks"]}
    engine.close()
    del engine
    if alive:
        raise AssertionError("the frontend's worker did not stop")
    if not cancelled or cancelled[-1][0] != "done" \
            or cancelled[-1][1]["finish_reason"] != "cancelled":
        raise AssertionError(f"the cancel did not finish the stream: "
                             f"{cancelled[-1:]}")
    n_cancel = len(cancelled[-1][1]["output"])
    if not health.get("ok") or "summary" not in metrics:
        raise AssertionError("/v1/health or /v1/metrics did not answer")
    if launches != want_launches:
        raise AssertionError(f"frontend kernel launches {launches} != "
                             f"{want_launches}")
    # the same four requests served directly by the sync engine
    direct = build_engine(cfg, params, cuda_graphs=False, **kw)
    store = {}
    record_margins(torch, direct, store)
    direct.run([Request(rid=10 * i, prompt=np.asarray(p, np.int32),
                        sampling=SamplingParams(max_tokens=gen,
                                                n=2 if i == 3 else 1))
                for i, p in enumerate(prompts[:4])])
    want = outputs(direct)
    del direct
    torch.cuda.empty_cache()
    have = {0: got[0]["output"], 10: got[1]["output"],
            20: [d["token"] for e, d in got[2] if e == "token"],
            30: got[3]["choices"][0]["tokens"],
            31: got[3]["choices"][1]["tokens"]}
    if got[2][-1][1]["output"] != have[20] \
            or any(c["finish_reason"] != "length"
                   for c in got[3]["choices"]) \
            or got[0]["finish_reason"] != "length":
        raise AssertionError("a frontend response is inconsistent")
    ties = tie_count(want, have, lambda: {"store": store,
                                          "temperature": 1.0},
                     "frontend")
    log(f"[frontend] Frontend on the async engine (graphs, captured in "
        f"{capture_s:.3f}s) at http://{host}:{port}, drop-free MoE "
        f"capacity: 2 blocking, 1 SSE and 1 n = 2 request ({gen} tokens "
        f"each, prompts 150-300) served at once in {served_s:.2f}s, tokens "
        f"as the sync engine's direct run but {ties} near ties; a stream "
        f"cancelled after {n_cancel} tokens finished 'cancelled'; "
        f"/v1/health {health}; /v1/metrics answered; server stopped; "
        f"launches {launches}")
    return {"frontend_async": launches}


# ------------------------------------------ phase 9: speculative decoding --


# phase 9(b): the spec engines in turns on phase 3's load: (label, k, draft)
SPEC_TURNS = (("plain", 0, ""), ("shallow:1 k=4", 4, "shallow:1"),
              ("self k=2", 2, "self"), ("shallow:1 k=4", 4, "shallow:1"),
              ("plain", 0, ""))


def spec_launches_wanted(cfg, engine, summary) -> dict:
    """K1 / K2 launches a serve on ``engine`` must have made: K1 = target
    layers x plain ticks + draft layers x draft steps; K2 = target layers
    x (prefill chunks + verify rounds) + draft layers x prefill chunks."""
    rounds = summary["spec_rounds"]
    ticks = sum(summary["schemes_used"].values()) - rounds
    chunks = summary["prefill_chunks"]
    dl = engine.draft_cfg.n_layers if engine.spec_k else 0
    return {"mla_decode_paged": cfg.n_layers * ticks
            + dl * engine.stats.spec_draft_steps,
            "mla_prefill_paged": cfg.n_layers * (chunks + rounds)
            + dl * chunks}


def record_rejections(torch, engine, store):
    """Wrap ``engine._verify`` so that ``store`` gets, for every row of a
    round whose drafts were not all accepted, the margin by which the
    target's verify logits preferred its own token over the first
    rejected draft (greedy)."""
    real = engine._verify

    def rec(scheme, arrays):
        target, logits = real(scheme, arrays)
        toks, nv = arrays["tokens"], arrays["n_valid"]
        for s_ in range(toks.shape[0]):
            n = int(nv[s_])
            bad = [j for j in range(n - 1) if toks[s_, j + 1] != target[s_, j]]
            if bad:
                j = bad[0]
                row = logits[s_, j].float()
                store.append(float(row[int(target[s_, j])]
                                   - row[int(toks[s_, j + 1])]))
        return target, logits
    engine._verify = rec


def spec_smoke_parity(torch, np):
    """Phase 9(a): the f32 smoke config (phase 5's seed and load, drop-free
    MoE capacity), ``impl='kernel'`` on graphs: plain paged decode, then
    spec decoding with the identity draft at k = 2 and 4 and the
    one-layer draft at k = 4: tokens identical to plain decode's, the
    identity draft accepting every draft, K1 / K2 launches as
    ``spec_launches_wanted`` through the replays."""
    from repro_torch import configs, models
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import (build_engine, serve_paged,
                                          synthetic_requests)
    from repro_torch.nn import module as nnm

    cfg = drop_free(configs.smoke("deepseek-v2-236b"))
    params = nnm.init_params(models.model_defs(cfg), seed=4,
                             dtype=torch.float32, device="cuda")
    k1, k2 = mla_decode.mla_decode_paged_kernel, \
        mla_prefill.mla_prefill_paged_kernel
    base = None
    for spec_k, draft in ((0, ""), (2, "self"), (4, "self"),
                          (4, "shallow:1")):
        engine = build_engine(cfg, params, batch=4, max_len=48 + 12, gen=12,
                              impl="kernel", scheme="auto", platform="h100",
                              prefill_chunk=8, compute_dtype=torch.float32,
                              device="cuda", spec_k=spec_k, draft=draft)
        if not engine.cuda_graphs:
            raise AssertionError("the engine's default on the card is graphs")
        engine.warm_up()
        k1.launches = k2.launches = 0
        s = serve_paged(engine, synthetic_requests(cfg, batch=4,
                                                   prompt_len=48, gen=12,
                                                   seed=4),
                        log=lambda *_: None, log_every=0)
        launches = {"mla_decode_paged": k1.launches,
                    "mla_prefill_paged": k2.launches}
        want = spec_launches_wanted(cfg, engine, s)
        got = outputs(engine)
        if base is None:
            base = got
        label = f"k = {spec_k}, draft {draft!r}" if spec_k else "plain"
        log(f"[spec] smoke f32, impl kernel on graphs, {label}: tokens "
            f"{'identical to' if got == base else 'DIFFERENT from'} plain "
            f"decode's over {len(got)} requests, "
            f"{s['spec_rounds']} rounds, accept rate "
            f"{s['spec_accept_rate']:.3f} ({s['spec_accepted']}/"
            f"{s['spec_drafted']}), launches {launches}")
        if got != base or len(got) != 4:
            raise AssertionError(f"spec tokens differ ({label}): {got} vs "
                                 f"{base}")
        if launches != want:
            raise AssertionError(f"spec launches {launches} != {want}")
        if draft == "self" and s["spec_accepted"] != s["spec_drafted"]:
            raise AssertionError("the identity draft was rejected in f32")
        engine.close()
        del engine
    del params
    torch.cuda.empty_cache()


def spec_full_width(torch, np, cfg, params):
    """Phase 9(b) and (c): phase 3's load (bf16 pool, greedy) at drop-free
    MoE capacity on the sync engine on graphs, in turns plain, shallow:1
    k = 4, self k = 2, shallow:1 k = 4, plain, then the async engine with
    shallow:1 k = 4 and telemetry on.  Returns the launch counts by run."""
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import build_engine, serve_paged
    from repro_torch.obs import Telemetry, validate_trace
    from repro_torch.runtime import Request, SamplingParams

    cfg = drop_free(cfg)
    gen = 32
    reqs_fn = lambda: requests_full(cfg, np, Request, SamplingParams, gen)
    kw = dict(batch=8, max_len=1024 + gen, gen=gen, block_size=BS,
              impl="kernel", scheme="auto", platform="h100", prefill_chunk=C,
              compute_dtype=torch.bfloat16, device="cuda")
    k1, k2 = mla_decode.mla_decode_paged_kernel, \
        mla_prefill.mla_prefill_paged_kernel
    margins = {}

    def plain_margins():
        # a plain serve recording the margin of every token it sampled;
        # run only when a spec run's tokens differ from the first plain run
        if not margins:
            eng = build_engine(cfg, params, **kw)
            record_margins(torch, eng, margins)
            eng.run(reqs_fn())
            eng.close()
        return {"store": margins, "temperature": 1.0}

    by_path, base, tps, shallow, spans = {}, None, [], [], []
    for i, (label, spec_k, draft) in enumerate(SPEC_TURNS):
        tel = Telemetry.on(trace=True, metrics=False, drift=False)
        engine = build_engine(cfg, params, spec_k=spec_k, draft=draft,
                              telemetry=tel, **kw)
        capture_s = engine.warm_up()
        rejections = []
        if draft == "self":
            record_rejections(torch, engine, rejections)
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k2.launches = 0
        summary = serve_paged(engine, reqs_fn(), log=lambda *_: None,
                              log_every=0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {"mla_decode_paged": k1.launches,
                    "mla_prefill_paged": k2.launches}
        want = spec_launches_wanted(cfg, engine, summary)
        if launches != want:
            raise AssertionError(f"{label}: kernel launches {launches} != "
                                 f"{want}")
        plans = check_graph_plans(engine)
        if spec_k:
            vplans = [p["mla_prefill_paged_kernel"] for g, p in plans.items()
                      if g.startswith("verify/")]
            if not vplans or any(p["grid"][2] != 8 * (spec_k + 1)
                                 for p in vplans):
                raise AssertionError(f"{label}: the verify graphs' K2 plans "
                                     f"{vplans}")
        got = outputs(engine)
        if base is None:
            base = got
        ties = tie_count(base, got, plain_margins, label)
        if spec_k == 4:
            shallow.append((got, {k: summary[k] for k in STATS_KEYS
                                  + ("spec_rounds", "spec_accepted")}))
        off_tie = [m for m in rejections if m >= NEAR_TIE]
        if off_tie:
            raise AssertionError(f"{label}: identity-draft rejections off a "
                                 f"near tie: margins {off_tie}")
        trace = tel.tracer.to_dict()
        key = label.replace(" ", "_").replace(":", "").replace("=", "")
        by_path[f"spec_{key}_{i + 1}"] = launches
        tps.append(summary["tokens_per_s"])
        # the serve's time by span, summed over the trace (each of these
        # spans ends on a wait for the device): prefill (its chunks, the
        # draft's too), decode (a spec run's draft + verify spans, a plain
        # run's device_step), and the host_sample spans after decode
        total = {n: sum(span_durs(trace, n)) / 1e3
                 for n in ("step", "prefill", "draft", "verify",
                           "device_step", "host_sample")}
        dec = (total["draft"] + total["verify"] if spec_k
               else total["device_step"])
        step = (f"verify span {span_ms(trace, 'verify'):.3f} ms median, "
                f"draft span {span_ms(trace, 'draft'):.3f} ms median"
                if spec_k else
                f"decode tick device_step {span_ms(trace, 'device_step'):.3f}"
                f" ms median")
        step += (f"; summed spans: step {total['step']:.4f} s, "
                 f"prefill {total['prefill']:.4f} s, decode "
                 + (f"(draft {total['draft']:.4f} + verify "
                    f"{total['verify']:.4f}) " if spec_k else
                    "(device_step) ")
                 + f"{dec:.4f} s, host_sample {total['host_sample']:.4f} s")
        spans.append((dec, total["prefill"]))
        log(f"[spec] {i + 1} {label}: {summary['tokens_per_s']:.1f} tokens/s, "
            f"{summary['decode_tokens']} decode tokens in {summary['steps']} "
            f"steps ({summary['spec_rounds']} rounds, accept rate "
            f"{summary['spec_accept_rate']:.3f}, "
            f"{summary['spec_mean_emitted']:.3f} tokens a round a request, "
            f"{engine.stats.spec_draft_steps} draft steps), {step}, "
            f"prefill_chunk span {span_ms(trace, 'prefill_chunk'):.3f} ms "
            f"median, capture {capture_s:.3f}s, peak {peak:.2f} GiB, "
            f"launches {launches} (as wanted), tokens as the first plain "
            f"run's but {ties} near ties"
            + (f", {len(rejections)} identity-draft rejections, each on a "
               f"near tie (margins {[round(m, 4) for m in rejections]})"
               if draft == "self" else ""))
        engine.close()
        del engine
        torch.cuda.empty_cache()
    if shallow[0] != shallow[1]:
        raise AssertionError("the two shallow:1 k = 4 runs differ")
    log(f"[spec] tokens/s in turns {', '.join(t[0] for t in SPEC_TURNS)}: "
        f"{', '.join(f'{t:.1f}' for t in tps)}; shallow:1 k = 4 / plain "
        f"{(tps[1] + tps[3]) / (tps[0] + tps[4]):.3f}, self k = 2 / plain "
        f"{2 * tps[2] / (tps[0] + tps[4]):.3f}; summed decode spans "
        f"(s) {', '.join(f'{d:.4f}' for d, _ in spans)}, summed "
        f"prefill spans (s) {', '.join(f'{p:.4f}' for _, p in spans)};"
        f" the two shallow:1 runs identical (tokens, EngineStats)")
    # (c) the async engine on the same spec load, telemetry on
    tel = Telemetry.on(trace=True, metrics=True, drift=True)
    engine = build_engine(cfg, params, engine="async", spec_k=4,
                          draft="shallow:1", telemetry=tel, **kw)
    engine.warm_up()
    k1.launches = k2.launches = 0
    summary = serve_paged(engine, reqs_fn(), log=lambda *_: None,
                          log_every=0)
    launches = {"mla_decode_paged": k1.launches,
                "mla_prefill_paged": k2.launches}
    if launches != spec_launches_wanted(cfg, engine, summary):
        raise AssertionError(f"async spec launches {launches}")
    if outputs(engine) != shallow[0][0]:
        raise AssertionError("the async spec engine's tokens differ from "
                             "the sync engine's")
    tel.finalize(engine)
    trace = tel.tracer.to_dict()
    problems = validate_trace(trace)
    if problems:
        raise AssertionError(f"async spec trace: {problems[:3]}")
    rep = tel.drift.report()
    verify = {k: b for k, b in rep["buckets"].items()
              if k.startswith("verify/")}
    if not verify or tel.drift.check_coverage(summary["schemes_used"],
                                              kinds=("verify",)):
        raise AssertionError(f"no verify drift rows: {rep['kinds']}")
    by_path["spec_async_telemetry"] = launches
    log(f"[spec] async engine, shallow:1 k = 4, telemetry on: "
        f"{summary['tokens_per_s']:.1f} tokens/s, tokens as the sync "
        f"engine's, launches {launches}, trace valid "
        f"({len(trace['traceEvents'])} events), drift verify rows "
        + "; ".join(f"{k}: n {b['n']}, p50 {b['time_ratio_p50']:.1f}, "
                    f"measured {b['meas_time_s'] / b['n'] * 1e3:.3f} ms, "
                    f"predicted {b['pred_time_s'] / b['n'] * 1e3:.4g} ms"
                    for k, b in verify.items()))
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return by_path


# ------------------------------------------------- phase 5: token parity --


def token_parity(torch, np):
    from repro_torch import configs, models
    from repro_torch.launch.serve import (build_engine, serve_contiguous,
                                          serve_paged, synthetic_requests)
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

    # the contiguous path: both impls, every scheme
    contig = {(scheme, impl): serve_contiguous(
        cfg, params, batch=4, prompt_len=48, gen=12, scheme=scheme,
        impl=impl, seed=4, compute_dtype=torch.float32, device="cuda",
        log=lambda _: None)["tokens"]
        for scheme in ("seq", "rc", "ru", "naive")
        for impl in ("kernel", "ref")}
    first = contig[("seq", "kernel")]
    same = all(np.array_equal(t, first) for t in contig.values())
    log(f"[parity] contiguous path, f32 greedy tokens of 4 requests x 12, "
        f"impl kernel and ref x schemes seq / rc / ru / naive: "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError(f"contiguous tokens differ: {contig}")

    def engine_tokens(**kw):
        engine = build_engine(cfg, params, batch=4, max_len=48 + 12, gen=12,
                              scheme="auto", platform="h100",
                              compute_dtype=torch.float32, device="cuda",
                              **kw)
        serve_paged(engine, synthetic_requests(cfg, batch=4, prompt_len=48,
                                               gen=12, seed=4),
                    log=lambda _: None)
        return {r.rid: list(r.output) for r in engine.sched.finished}

    chunked = engine_tokens(impl="kernel", prefill_chunk=8)
    per_request = engine_tokens(impl="kernel", prefill_chunk=0)
    same = per_request == chunked and len(chunked) == 4
    log(f"[parity] per-request prefill engine vs chunked, impl kernel: "
        f"{'identical' if same else 'DIFFERENT'} tokens")
    if not same:
        raise AssertionError(f"per-request tokens differ: {per_request} vs "
                             f"{chunked}")
    for cache_dtype in ("int8", "fp8"):
        got = {impl: engine_tokens(impl=impl, prefill_chunk=8,
                                   cache_dtype=cache_dtype)
               for impl in ("kernel", "ref")}
        same = got["kernel"] == got["ref"] and len(got["ref"]) == 4
        log(f"[parity] {cache_dtype} pool engine, impl kernel vs ref: "
            f"{'identical' if same else 'DIFFERENT'} tokens")
        if not same:
            raise AssertionError(f"{cache_dtype} tokens differ: {got}")


# ------------------------------------------------------ phase 6: training --


def train_full_width(torch):

    from repro_torch import configs, models
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn import module as nnm
    from repro_torch.optim import AdamWConfig, adamw_init, cosine
    from repro_torch.runtime import TrainStepConfig, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(configs.full("deepseek-v2-236b"),
                              n_layers=TRAIN_LAYERS)
    warm, timed, loss_chunk = 1, 3, 1024
    t0 = time.perf_counter()
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    # the training launcher's schedule at its default length
    opt_cfg = AdamWConfig(lr=cosine(3e-4, warmup=20, total=100))
    opt = adamw_init(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[train] {cfg.name} cut to {cfg.n_layers} layers (depth only; "
        f"plan {[d.ffn for d, _ in models.lm.layers(cfg, params)]}): "
        f"{n_params / 1e9:.3f} B params, bf16 params "
        f"{n_params * 2 / 1e9:.2f} GB + f32 moments "
        f"{n_params * 8 / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t0:.1f}s; batch {TB} x {TL} (not cut), "
        f"MoE capacity factor {cfg.capacity_factor}, impl 'kernel', "
        f"vocab-chunked loss {loss_chunk}")
    step = make_train_step(cfg, opt_cfg, TrainStepConfig(
        compute_dtype=torch.bfloat16, impl="kernel", loss_chunk=loss_chunk))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TL,
                                  global_batch=TB, seed=0))

    def batch():
        toks, labels = data.next_batch()
        return {"tokens": torch.as_tensor(toks, device="cuda"),
                "labels": torch.as_tensor(labels, device="cuda")}

    losses, times = [], []
    for i in range(warm + timed):
        b = batch()
        if i == warm:
            for kern in (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
                         fa.flash_bwd_dkv_kernel):
                kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss = float(m["loss"])
        log(f"[train] step {i + 1}{' (warm-up)' if i < warm else ''}: loss "
            f"{loss:.4f}, ce {float(m['ce']):.4f}, grad norm "
            f"{float(m['grad_norm']):.4f}, lr {float(m['lr']):.3g}, "
            f"dropped {float(m['dropped_frac']):.4f}, {dt * 1e3:.1f} ms")
        if not math.isfinite(loss):
            raise AssertionError(f"step {i + 1}: loss {loss} is not finite")
        losses.append(loss)
        if i >= warm:
            times.append(dt)
    launches = {"flash_attention_fwd": fa.flash_fwd_kernel.launches,
                "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel.launches,
                "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel.launches}
    ms = 1e3 * sum(times) / len(times)
    log(f"[train] {timed} timed steps: {ms:.1f} ms/step mean "
        f"({', '.join(f'{t * 1e3:.1f}' for t in times)}), "
        f"{TB * TL / (ms / 1e3):.0f} tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}")
    # remat does not apply: a 2-layer plan has no scanned period
    want = {k_: TRAIN_LAYERS * timed for k_ in launches}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for kern in (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
                 fa.flash_bwd_dkv_kernel):    # bf16: the tensor-core walks
        launched_plan(kern)
    del params, opt, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_attention_check(torch):
    """The MLA call site's attention in bf16 at the training path's
    shapes: ``ops.attention(impl='kernel')`` (the autograd Function over
    K4, K5 and K6) on (B, L, H, D) tensors passed as transposed views, as
    ``_mla_seq`` passes them, against autograd through the dense oracle
    ``flash_attention_ref`` (f32 softmax; run 32 heads of one sequence at
    a time to bound its memory).  Out and the q, k, v gradients are each
    held as a whole (ATTN_REL_L2; phase 2 holds the kernels row by row).
    No router is involved, so the comparison is in the path's own
    dtype."""

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda")
    g.manual_seed(7)

    def rn(d):
        return torch.randn((TB, TL, TH, d), generator=g,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = rn(TDQK), rn(TDQK), rn(TDV), rn(TDV)
    scale = TDQK ** -0.5
    leaves = [t.requires_grad_() for t in (q, k, v)]

    def attend(impl, q_, k_, v_):
        return ops.attention(q_.transpose(1, 2), k_.transpose(1, 2),
                             v_.transpose(1, 2), impl=impl, causal=True,
                             softmax_scale=scale).transpose(1, 2)

    out = attend("kernel", *leaves)
    got = [out.detach()] + list(torch.autograd.grad(out, leaves, do))
    want = [torch.empty_like(t) for t in got]
    for b in range(TB):
        for h0 in range(0, TH, 32):
            sl = (slice(b, b + 1), slice(None), slice(h0, h0 + 32))
            part = [t.detach()[sl].requires_grad_() for t in leaves]
            o = attend("ref", *part)
            for w, t in zip(want, [o.detach()] + list(
                    torch.autograd.grad(o, part, do[sl]))):
                w[sl] = t
    errs = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
            for n, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    rows = {n: row_rel(torch, a, b) for n, a, b in zip(
        ("out", "dq", "dk", "dv"), got, want)}
    log(f"[train] MLA attention at the path's shapes, bf16, kernel "
        f"Function vs dense oracle under autograd: |a - b| / |b| "
        + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
        + f" (bound {ATTN_REL_L2}); largest per-row, not bounded: "
        + ", ".join(f"{n} {e:.3g}" for n, e in rows.items()))
    if max(errs.values()) > ATTN_REL_L2:
        raise AssertionError("the flash-attention Function disagrees with "
                             "the dense oracle in bf16")
    del q, k, v, do, leaves, out, got, want
    gc.collect()
    torch.cuda.empty_cache()


def train_grad_check(torch):
    """Full-width loss and per-leaf gradients, impl='kernel' against
    impl='ref' (the dense attention): in f32 with 2 layers at drop-free
    MoE capacity, and in bf16 with the dense first layer alone, each at
    2 x 512 tokens."""

    from repro_torch import configs, models
    from repro_torch.nn import module as nnm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import lm_loss

    full = configs.full("deepseek-v2-236b")
    for dtype_name, cfg, what in (
            ("float32", drop_free(dataclasses.replace(
                full, n_layers=TRAIN_LAYERS)), "2 layers, drop-free MoE"),
            ("bfloat16", dataclasses.replace(full, n_layers=1),
             "the dense layer 0 alone")):
        dtype = getattr(torch, dtype_name)
        params = nnm.init_params(models.model_defs(cfg), seed=1, dtype=dtype,
                                 device="cuda")
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        toks = torch.randint(0, cfg.vocab, (2, 513), generator=g,
                             device="cuda")
        leaves = list(tree_leaves(params))

        def grads(impl):
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = lm_loss(params, cfg, toks[:, :-1], toks[:, 1:],
                              compute_dtype=dtype, impl=impl)
            out = torch.autograd.grad(loss, leaves)
            for t in leaves:
                t.requires_grad_(False)
            return loss.item(), out

        loss_r, g_r = grads("ref")
        loss_k, g_k = grads("kernel")
        rel = [((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()
               for a, b in zip(g_k, g_r)]
        loss_rel = abs(loss_k - loss_r) / abs(loss_r)
        tol = TRAIN_GRAD_REL_L2[dtype_name]
        log(f"[train] kernel vs ref at 2 x 512 tokens, {dtype_name}, {what}: "
            f"loss {loss_k:.6f} vs {loss_r:.6f} (rel {loss_rel:.2e}), "
            f"per-leaf gradient |a-b|/|b| max {max(rel):.2e} over "
            f"{len(rel)} leaves (bound {tol})")
        if max(rel) > tol or loss_rel > tol:
            raise AssertionError(f"kernel-path gradients disagree with the "
                                 f"reference path in {dtype_name}")
        del params, leaves, g_r, g_k
        gc.collect()
        torch.cuda.empty_cache()


def train_loop_resume(torch):
    """TrainLoop at smoke size on the card with impl='kernel': checkpoints
    every 2 steps, an injected failure after step 4, a relaunch that
    resumes from the step-4 checkpoint with exactly the state the failed
    run saved, and runs to step 6 alongside an uninterrupted run."""
    import tempfile

    from repro_torch import configs, models
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.nn import module as nnm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import (LoopConfig, SimulatedFailure, TrainLoop,
                                     TrainStepConfig, make_train_step)

    cfg = drop_free(configs.smoke("deepseek-v2-236b"))
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt_cfg, TrainStepConfig(
        compute_dtype=torch.float32, impl="kernel"))

    def fresh():
        p = nnm.init_params(models.model_defs(cfg), seed=0,
                            dtype=torch.float32, device="cuda")
        return p, adamw_init(p, opt_cfg)

    def data():
        return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                      global_batch=4))

    quiet = dict(log=lambda *_: None)
    with tempfile.TemporaryDirectory() as d:
        kw = dict(total_steps=6, ckpt_every=2, log_every=0)
        whole = TrainLoop(LoopConfig(ckpt_dir=os.path.join(d, "a"), **kw),
                          step, *fresh(), data(), **quiet)
        m_whole = whole.run()
        failed = TrainLoop(LoopConfig(ckpt_dir=os.path.join(d, "b"),
                                      fail_at_step=4, **kw),
                           step, *fresh(), data(), **quiet)
        try:
            failed.run()
            raise AssertionError("the failure drill did not fire")
        except SimulatedFailure:
            pass
        resumed = TrainLoop(LoopConfig(ckpt_dir=os.path.join(d, "b"), **kw),
                            step, *fresh(), data(), **quiet)
        start = resumed.step
        exact = start == 4 and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves([resumed.params, resumed.opt_state]),
                tree_leaves([failed.params, failed.opt_state])))
        m_resumed = resumed.run()
        steps = resumed.store.steps()
    diff = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(whole.params), tree_leaves(resumed.params)))
    log(f"[train] TrainLoop smoke on the card: failure after step 4, "
        f"resumed at step {start} with the saved state "
        f"{'exactly' if exact else 'NOT exactly'}, checkpoints {steps}, "
        f"final loss {float(m_resumed['loss']):.4f} vs uninterrupted "
        f"{float(m_whole['loss']):.4f}, max |param diff| {diff:.2e} "
        f"(the backward's scatter-adds sum in no fixed order on the "
        f"card: bound 1e-4)")
    if not (exact and steps == [2, 4, 6] and diff <= 1e-4):
        raise AssertionError("the training loop did not resume correctly")


# ------------------------------ phase 10: the paper's baseline families --


# (a) the paper's MHA baseline and (b) MQA with 5:1 local:global sliding
# windows, each at full width and full depth, served as phase 4 serves
# DeepSeek-V2 (batch 8 x 2,048 prompt tokens, 32 generated)
BASELINE_ARCHS = ("phi3-mini-3.8b", "gemma3-1b")
# (c) the f32 smoke configs of the six attention families.  Seed 5: on
# their load (4 requests x 48 prompt tokens, 12 generated) the smallest
# top-1 / top-2 logit margin of any of them is 1.1e-3 (CPU run), three
# orders above f32 noise, so identical tokens test the kernel and not a
# near tie
GQA_ARCHS = ("phi3-mini-3.8b", "starcoder2-7b", "granite-34b", "gemma3-1b",
             "granite-moe-1b-a400m", "internvl2-26b")
GQA_SEED = 5
# (c)'s smoke train step, kernel path vs ref path, f32, per leaf |a-b|/|b|:
# the same arithmetic in other orders (~1e-6); a wrong head, mask, window
# or scale moves a leaf by O(1)
GQA_GRAD_REL = 1e-3
# phase 4's numbers, kept for phase 10's comparison of cache bytes
MEASURED = {}


def record_k4_plans(plans, bwd_plans=None):
    """Wrap the flash Function's forward so that ``plans`` gets K4's plan
    at every launch a model makes and, given ``bwd_plans``, its backward
    so that ``bwd_plans`` gets K5's and K6's, a pair a backward; returns
    a function that restores them."""
    from repro_torch.kernels import flash_attention as fa

    real, real_bwd = fa._FlashAttention.forward, fa._FlashAttention.backward

    def forward(ctx, *args):
        out = real(ctx, *args)
        plans.append(fa.flash_fwd_kernel.last_plan)
        return out

    def backward(ctx, *args):
        grads = real_bwd(ctx, *args)
        bwd_plans.append((fa.flash_bwd_dq_kernel.last_plan,
                          fa.flash_bwd_dkv_kernel.last_plan))
        return grads
    fa._FlashAttention.forward = staticmethod(forward)
    if bwd_plans is not None:
        fa._FlashAttention.backward = staticmethod(backward)

    def restore():
        fa._FlashAttention.forward = staticmethod(real)
        fa._FlashAttention.backward = staticmethod(real_bwd)
    return restore


def baseline_families(torch, np):
    """Phase 10: (a) and (b) served at full width and full depth, K4
    timed at their prefill shapes, then (c).  Returns (K4's rows at those
    shapes, the kernel launches of each path)."""
    from repro_torch import configs, models
    from repro_torch.core import cache as cachelib
    from repro_torch.nn import module as nnm

    gc.collect()
    torch.cuda.empty_cache()
    rows, by_path, kv = {}, {}, {}
    for arch in BASELINE_ARCHS:
        cfg = configs.full(arch)
        t0 = time.perf_counter()
        params = nnm.init_params(models.model_defs(cfg), seed=0,
                                 dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        windows = sorted({str(d.window) for d, _ in
                          models.lm.layers(cfg, params)})
        log(f"[base] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
            f"head dim {cfg.resolved_head_dim}, windows {windows}, vocab "
            f"{cfg.vocab}: {n_params / 1e9:.3f} B params bf16 "
            f"({n_params * 2 / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f}s")
        by_path[f"serve_{arch}"], res = serve_baseline(torch, np, cfg,
                                                       params)
        kv[arch] = (cfg.n_layers * cachelib.bytes_per_token_dense(
            cfg.n_kv_heads, cfg.resolved_head_dim), res)
        compare_baseline(torch, np, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rows.update(time_k4_baseline(torch, cfg))
    latent = cachelib.bytes_per_token_latent(DL, DR)
    contig = MEASURED["contiguous"]
    log("[base] KV-cache bytes per cached token (bf16), the paper's "
        "comparison: "
        + "; ".join(f"{a} {b:,} B ({res['tokens_per_s']:.1f} decode "
                    f"tokens/s, {res['step_ms']:.2f} ms a step)"
                    for a, (b, res) in kv.items())
        + f"; DeepSeek-V2's latent cache {latent * 4:,} B at phase 4's 4 "
        f"layers ({contig['tokens_per_s']:.1f} decode tokens/s, "
        f"{contig['step_ms']:.2f} ms a step), {latent * 60:,} B at its "
        f"60; phi3 / DeepSeek-V2 x60 = "
        f"{kv['phi3-mini-3.8b'][0] / (latent * 60):.2f}")
    by_path.update(gqa_smoke_parity(torch, np))
    return rows, by_path


def serve_baseline(torch, np, cfg, params):
    """(a) / (b): the contiguous launcher's path, batch 8 x 2,048 prompt
    tokens, 32 generated, ``impl='kernel'``, after a warm-up at the same
    shapes: K4 launched once a layer, every launch on route 'tc', K3 not
    at all (decode is ``gqa_decode``, as in the reference)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode
    from repro_torch.launch.serve import serve_contiguous

    kw = dict(batch=B, prompt_len=PROMPT, gen=GEN, scheme="auto",
              platform="h100", impl="kernel", compute_dtype=torch.bfloat16,
              device="cuda")
    t0 = time.perf_counter()
    serve_contiguous(cfg, params, log=lambda _: None, **kw)
    log(f"[base] warm-up at the same shapes: "
        f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_kernel.launches = 0
    mla_decode.mla_decode_kernel.launches = 0
    plans = []
    restore = record_k4_plans(plans)
    try:
        res = serve_contiguous(cfg, params, log=log, **kw)
    finally:
        restore()
    launches = {"flash_attention_fwd": fa.flash_fwd_kernel.launches}
    steps = res["decode_steps"]
    out = dict(tokens_per_s=steps * B / res["decode_s"],
               step_ms=res["decode_s"] * 1e3 / steps,
               prefill_ms=res["prefill_s"] * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    routes = sorted({p["route"] for p in plans})
    log(f"[base] {cfg.name}, batch {B} x {PROMPT} prompt tokens, {GEN} "
        f"generated, scheme '{res['scheme']}': prefill "
        f"{out['prefill_ms']:.1f} ms, decode {out['tokens_per_s']:.1f} "
        f"tokens/s, step {out['step_ms']:.2f} ms mean, peak memory "
        f"{out['peak_gib']:.2f} GiB, launches {launches}, K4 routes "
        f"{routes}, K4 plan {plans[-1] if plans else None}")
    tokens = res["tokens"]
    if tokens.shape != (B, GEN) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab \
            or not bool(torch.isfinite(res["last_logits"]).all()):
        raise AssertionError(f"{cfg.name}: the contiguous serve returned "
                             f"bad tokens or logits")
    if launches["flash_attention_fwd"] != cfg.n_layers \
            or len(plans) != cfg.n_layers \
            or mla_decode.mla_decode_kernel.launches:
        raise AssertionError(f"{cfg.name}: K4 launches {launches} "
                             f"(recorded {len(plans)}), K3 "
                             f"{mla_decode.mla_decode_kernel.launches}; want "
                             f"K4 = {cfg.n_layers} layers, K3 none")
    if routes != ["tc"]:
        raise AssertionError(f"{cfg.name}: a bf16 K4 launch left its "
                             f"tensor-core route: {plans}")
    torch.cuda.empty_cache()
    return launches, out


def compare_baseline(torch, np, cfg, params):
    """(a) / (b): prefill logits, impl='kernel' against impl='ref', per
    row within LOGITS_REL_L2 (each request prefilled alone: the dense
    reference attention holds (Hkv, G, L, L) f32 scores a layer), then
    GEN - 1 decode steps from each impl's caches on the kernel path's
    greedy tokens: every step's logits finite, the last step's within
    LOGITS_REL_L2.  Decode itself is ``gqa_decode`` under both impls, so
    the decode comparison holds the caches the two prefills wrote."""
    from repro_torch.runtime import make_prefill_step, make_serve_step

    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PROMPT)), device="cuda")
    kw = dict(compute_dtype=torch.bfloat16, scheme="seq")
    prefill = {impl: make_prefill_step(cfg, capacity=S_CONTIG, impl=impl,
                                       **kw) for impl in ("kernel", "ref")}
    step = make_serve_step(cfg, **kw)
    first, caches, rel_prefill = [], {"kernel": [], "ref": []}, []
    for b in range(B):
        logits = {}
        for impl in ("kernel", "ref"):
            logits[impl], cache = prefill[impl](params, toks[b:b + 1])
            caches[impl].append(cache)
        rel_prefill += _row_rel(torch, logits["kernel"], logits["ref"])
        first.append(logits["kernel"])
    cache = {impl: _cat(torch, c) for impl, c in caches.items()}
    del caches
    tok = torch.argmax(torch.cat(first), dim=-1)
    finite = True
    for i in range(GEN - 1):
        dec = {}
        for impl in ("kernel", "ref"):
            dec[impl], cache[impl] = step(params, tok, cache[impl],
                                          PROMPT + i)
            finite &= bool(torch.isfinite(dec[impl]).all())
        tok = torch.argmax(dec["kernel"], dim=-1)
    rel_decode = _row_rel(torch, dec["kernel"], dec["ref"])
    log(f"[base] {cfg.name} logits kernel vs ref, per-row |a-b|/|b| (bound "
        f"{LOGITS_REL_L2}): prefill max {max(rel_prefill):.4f}, decode "
        f"step {GEN - 1} (index {PROMPT + GEN - 2}) max "
        f"{max(rel_decode):.4f}; every decode step's logits finite: "
        f"{finite}")
    if max(rel_prefill + rel_decode) > LOGITS_REL_L2 or not finite:
        raise AssertionError(f"{cfg.name}: kernel-path logits disagree "
                             f"with the reference path")
    del cache
    torch.cuda.empty_cache()


def window_pairs(L: int, window):
    """(query, key) pairs of causal attention over L positions, each
    query seeing at most ``window`` keys."""
    if window is None:
        return L * (L + 1) // 2
    return sum(min(i + 1, window) for i in range(L))


def time_k4_baseline(torch, cfg):
    """K4 alone at a model's prefill shapes, one row for each window its
    attention layers use: q (B, H, 2048, D) and k, v (B, Hkv, 2048, D)
    bf16 as transposed (B, L, H, D) views (the layout the GQA path hands
    over), causal.  Held row by row against the plain version; timed (L2
    flushed, CUDA events) beside the plain version and SDPA with
    ``enable_gqa=True`` (an explicit mask for a window)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    prefix, period, n_periods, suffix = cfg.layer_plan()
    descs = [d for d in prefix + period * n_periods + suffix
             if d.mixer == "attn"]
    rows = {}
    for window in sorted({d.window for d in descs},
                         key=lambda w: (w is None, w)):
        n_layers = sum(d.window == window for d in descs)
        g = torch.Generator(device="cuda")
        g.manual_seed(11)

        def rn(h):
            return torch.randn((B, PROMPT, h, D), generator=g,
                               device="cuda").to(torch.bfloat16).transpose(
                                   1, 2)
        q, k, v = rn(H), rn(Hkv), rn(Hkv)
        kw = dict(causal=True, window=window, q_offset=0, scale=D ** -0.5)
        out, lse = fa.flash_fwd_kernel(q, k, v, **kw)
        plan = launched_plan(fa.flash_fwd_kernel)
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
        row_err = row_rel(torch, out, out_p)
        lse_err = (lse - lse_p).abs().max().item()
        max_abs = (out.float() - out_p.float()).abs().max().item()
        del out_p, lse_p
        skw = dict(scale=D ** -0.5, enable_gqa=True)
        if window is None:
            skw["is_causal"] = True
        else:
            i = torch.arange(PROMPT, device="cuda")
            skw["attn_mask"] = (i[None, :] <= i[:, None]) \
                & (i[None, :] > i[:, None] - window)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, **skw)
        sdpa_err = row_rel(torch, sdpa(), out)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sdpa()
            torch.cuda.synchronize()
        names = [e.key for e in sorted(
            prof.key_averages(), key=lambda e: -e.self_device_time_total)
            if e.device_type.name == "CUDA"]
        label = f"{cfg.name} prefill" + (f", window {window}" if window
                                         else ", global")
        # SDPA must compute the same function (a wrong mask or window is
        # O(1) off); it rounds elsewhere than the plain version
        if not (row_err <= FLASH_ROW_TOL["bfloat16"] and lse_err <= LSE_ATOL
                and sdpa_err <= LOGITS_REL_L2):
            raise AssertionError(
                f"K4 at {label}: a row's |kernel - plain| / |plain| "
                f"{row_err:.3g}, lse {lse_err:.3g}, SDPA against the kernel "
                f"{sdpa_err:.3g}")
        pairs = B * H * window_pairs(PROMPT, window)
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
            + 4 * lse.numel()
        n_ops = 2 * (D + D) * pairs
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_OPS["bfloat16"] * 1e3
        r = rows[label] = dict(
            launches=n_layers, max_abs_err=max_abs, row_rel=row_err,
            ms=time_ms(torch, lambda: fa.flash_fwd_kernel(q, k, v, **kw),
                       flush, reps=7),
            plain_ms=time_ms(torch, lambda: fa.flash_fwd_plain(q, k, v,
                                                               **kw),
                             flush, reps=3),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=time_ms(torch, sdpa, flush, reps=7),
            library=names[0][:80] if names else "an unnamed kernel",
            plan=plan, shapes=dict(q=list(q.shape), kv=list(k.shape),
                                   window=window))
        log(f"[base] K4 at {label}: q {tuple(q.shape)}, k/v "
            f"{tuple(k.shape)}, bf16: time {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.3f} ms "
            f"({r['library']}), K4 / SDPA {r['ms'] / r['library_ms']:.2f}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{n_bytes / 1e9:.3f} GB, {n_ops / 1e12:.3f} TFLOP over "
            f"{pairs:,} pairs; {r['bound_ms'] / r['ms']:.4f} of it "
            f"reached), {plan_text(plan)}; per-row error {row_err:.4f}, "
            f"lse {lse_err:.2e}, SDPA vs kernel {sdpa_err:.4f}; "
            f"{n_layers} launches a prefill")
        del q, k, v, out, lse, skw
        torch.cuda.empty_cache()
    return rows


def gqa_smoke_parity(torch, np):
    """(c): for each of the six attention families' f32 smoke configs (MoE
    at drop-free capacity), greedy tokens of the contiguous serve,
    impl='kernel' against 'ref' (identical), and one train step's loss
    and per-leaf gradients kernel against ref (within GQA_GRAD_REL), the
    VLM's batch with its patch prefix.  Returns the launches of each
    path."""
    from repro_torch import configs, models
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve_contiguous
    from repro_torch.launch.train import batch_maker
    from repro_torch.nn import module as nnm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import lm_loss

    kernels = (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
               fa.flash_bwd_dkv_kernel)
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    serve_n, train_n = {names[0]: 0}, dict.fromkeys(names, 0)
    for arch in GQA_ARCHS:
        cfg = drop_free(configs.smoke(arch))
        params = nnm.init_params(models.model_defs(cfg), seed=GQA_SEED,
                                 dtype=torch.float32, device="cuda")
        toks = {}
        for impl in ("ref", "kernel"):
            before = kernels[0].launches
            toks[impl] = serve_contiguous(
                cfg, params, batch=4, prompt_len=48, gen=12, scheme="auto",
                impl=impl, seed=GQA_SEED, compute_dtype=torch.float32,
                device="cuda", log=lambda _: None)["tokens"]
            fwd = kernels[0].launches - before
            if fwd != (cfg.n_layers if impl == "kernel" else 0):
                raise AssertionError(f"{arch} smoke serve, impl {impl}: "
                                     f"{fwd} K4 launches")
            serve_n[names[0]] += fwd
        same = np.array_equal(toks["kernel"], toks["ref"])

        leaves = list(tree_leaves(params))
        data = np.random.default_rng(GQA_SEED).integers(0, cfg.vocab,
                                                        (2, 257))
        batch = batch_maker(cfg, "cuda", torch.float32)(data[:, :-1],
                                                        data[:, 1:])
        out = {}
        for impl in ("ref", "kernel"):
            before = [kern.launches for kern in kernels]
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = lm_loss(params, cfg, batch["tokens"], batch["labels"],
                              embeds=batch.get("embeds"),
                              compute_dtype=torch.float32, impl=impl)
            out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
            for t in leaves:
                t.requires_grad_(False)
            n = [kern.launches - b for kern, b in zip(kernels, before)]
            if n != [cfg.n_layers if impl == "kernel" else 0] * 3:
                raise AssertionError(f"{arch} smoke train step, impl "
                                     f"{impl}: K4 / K5 / K6 launches {n}")
            for name, c in zip(names, n):
                train_n[name] += c
        rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
               for a, b in zip(out["kernel"][1], out["ref"][1])]
        loss_rel = abs(out["kernel"][0] - out["ref"][0]) / abs(out["ref"][0])
        log(f"[base] {arch} smoke f32: greedy tokens of 4 requests x 12, "
            f"impl kernel vs ref: {'identical' if same else 'DIFFERENT'}; "
            f"one train step at 2 x 256 tokens: loss {out['kernel'][0]:.6f} "
            f"vs {out['ref'][0]:.6f} (rel {loss_rel:.2e}), per-leaf "
            f"gradient |a-b|/|b| max {max(rel):.2e} over {len(rel)} leaves "
            f"(bound {GQA_GRAD_REL})")
        if not same:
            raise AssertionError(f"{arch}: smoke tokens differ: {toks}")
        if max(rel) > GQA_GRAD_REL or loss_rel > GQA_GRAD_REL:
            raise AssertionError(f"{arch}: kernel-path gradients disagree "
                                 f"with the reference path")
        del params, leaves, out
        torch.cuda.empty_cache()
    return {"serve_gqa_smoke": serve_n, "train_gqa_smoke": train_n}


# ------------------------------------------ phase 11: the recurrent families --


# (a) Jamba at full width, cut to the first 4 layers of its plan: mamba +
# dense, mamba + MoE, mamba + dense, attention + MoE, one layer of each
# kind (any MoE layer holds 9.66 B params, so 8 layers do not fit); (b)
# xLSTM at full width and depth (21 mLSTM + 3 sLSTM).  Both at phase 4's
# load, random bf16 weights, the config's MoE capacity.
JAMBA = "jamba-1.5-large-398b"
XLSTM = "xlstm-350m"
JAMBA_LAYERS = 4
# the checks of (a) and (b) on one request: the prefill, then TF_STEPS
# greedy decode steps, against the teacher-forced forward over the
# PROMPT + TF_STEPS positions (a length both chunked scans take: Mamba's
# 8 chunks of 258, mLSTM's 16 of 129)
TF_STEPS = 16
# (c)'s smoke train step: xLSTM's mLSTM gradients are not finite at 128
# positions a chunk (a fault of the reference, ROADMAP.md queue 3)
SMOKE_TRAIN_L = {JAMBA: 256, XLSTM: 64}
# (c)'s seed: on its load (4 requests x 48 prompt tokens, 12 generated)
# the smallest top-1 / top-2 logit margin is 3.3e-3 (Jamba) and 5.4e-4
# (xLSTM) on the CPU, far above f32 noise, so identical tokens test the
# paths and not a near tie
RECURRENT_SEED = 5


def state_bytes(torch, cfg):
    """Decode-state bytes of one request (bf16 cache dtype), by mixer:
    (bytes a cached token of an attention layer, bytes a request of a
    recurrent layer) summed over the stack, from the cache trees
    ``init_cache`` builds at two capacities."""
    from repro_torch import models

    def per_kind(cap):
        tree = models.init_cache(cfg, 1, cap, torch.bfloat16, "meta")
        out = {}
        for desc, c in models.lm.layers(cfg, tree):
            n = sum(t.numel() * t.element_size() for t in c.values())
            out[desc.mixer] = out.get(desc.mixer, 0) + n
        return out

    a, b = per_kind(1), per_kind(2)
    per_token = {k: b[k] - a[k] for k in a if b[k] != a[k]}
    per_request = {k: a[k] for k in a if b[k] == a[k]}
    return per_token, per_request


def serve_recurrent(torch, np, cfg, params, n_attn: int):
    """(a) / (b): the contiguous launcher's path at phase 4's load,
    ``impl='kernel'``, after a warm-up at the same shapes: K4 launched
    once an attention layer, every launch on route 'tc', K3 never.
    Returns (launches, the numbers)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode
    from repro_torch.launch.serve import serve_contiguous

    kw = dict(batch=B, prompt_len=PROMPT, gen=GEN, scheme="auto",
              platform="h100", impl="kernel", compute_dtype=torch.bfloat16,
              device="cuda")
    t0 = time.perf_counter()
    serve_contiguous(cfg, params, log=lambda _: None, **kw)
    log(f"[rec] warm-up at the same shapes: "
        f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_kernel.launches = 0
    mla_decode.mla_decode_kernel.launches = 0
    plans = []
    restore = record_k4_plans(plans)
    try:
        res = serve_contiguous(cfg, params, log=log, **kw)
    finally:
        restore()
    launches = {"flash_attention_fwd": fa.flash_fwd_kernel.launches}
    steps = res["decode_steps"]
    out = dict(tokens_per_s=steps * B / res["decode_s"],
               step_ms=res["decode_s"] * 1e3 / steps,
               prefill_ms=res["prefill_s"] * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    routes = sorted({p["route"] for p in plans})
    log(f"[rec] {cfg.name}, batch {B} x {PROMPT} prompt tokens, {GEN} "
        f"generated: prefill {out['prefill_ms']:.1f} ms, decode "
        f"{out['tokens_per_s']:.1f} tokens/s, step {out['step_ms']:.2f} ms "
        f"mean, peak memory {out['peak_gib']:.2f} GiB, launches "
        f"{launches}, K4 routes {routes}")
    tokens = res["tokens"]
    if tokens.shape != (B, GEN) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab \
            or not bool(torch.isfinite(res["last_logits"]).all()):
        raise AssertionError(f"{cfg.name}: the contiguous serve returned "
                             f"bad tokens or logits")
    if launches["flash_attention_fwd"] != n_attn or len(plans) != n_attn \
            or mla_decode.mla_decode_kernel.launches:
        raise AssertionError(f"{cfg.name}: K4 launches {launches} "
                             f"(recorded {len(plans)}), K3 "
                             f"{mla_decode.mla_decode_kernel.launches}; want "
                             f"K4 = {n_attn} attention layers, K3 none")
    if n_attn and routes != ["tc"]:
        raise AssertionError(f"{cfg.name}: a bf16 K4 launch left its "
                             f"tensor-core route: {plans}")
    torch.cuda.empty_cache()
    return launches, out


def check_recurrent(torch, np, cfg, params, impls):
    """(a) / (b) on one request at drop-free MoE capacity: the prefill
    under each of ``impls`` (the first is the kernel path) and TF_STEPS
    greedy decode steps from each one's cache on the first's tokens,
    logits held against the first's per row within LOGITS_REL_L2 (prefill
    and last step); then the first's last step against the teacher-forced
    forward over the same PROMPT + TF_STEPS positions: the recurrent
    states carried across prefill and decode on the card."""
    from repro_torch import models
    from repro_torch.runtime import make_prefill_step, make_serve_step

    cfg = drop_free(cfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, PROMPT)), device="cuda")
    kw = dict(compute_dtype=torch.bfloat16, scheme="seq")
    step = make_serve_step(cfg, **kw)
    logits, cache = {}, {}
    for impl in impls:
        logits[impl], cache[impl] = make_prefill_step(
            cfg, capacity=PROMPT + TF_STEPS, impl=impl, **kw)(params, toks)
    rel = {impl: _row_rel(torch, logits[impl], logits[impls[0]])
           for impl in impls[1:]}
    seq = [toks]
    for i in range(TF_STEPS):
        tok = torch.argmax(logits[impls[0]], dim=-1)
        seq.append(tok[:, None])
        for impl in impls:
            logits[impl], cache[impl] = step(params, tok, cache[impl],
                                             PROMPT + i)
    for impl in impls[1:]:
        rel[impl] += _row_rel(torch, logits[impl], logits[impls[0]])
    del cache
    with torch.inference_mode():
        full, _ = models.forward(params, cfg, torch.cat(seq, dim=1),
                                 compute_dtype=torch.bfloat16,
                                 impl=impls[0])
    rel_tf = _row_rel(torch, logits[impls[0]], full[:, -1])
    log(f"[rec] {cfg.name}, one request of {PROMPT} tokens at drop-free "
        f"capacity, per-row |a-b|/|b| (bound {LOGITS_REL_L2}): "
        + "".join(f"{impl} vs {impls[0]} prefill {r[0]:.4f}, decode step "
                  f"{TF_STEPS} {r[1]:.4f}; " for impl, r in rel.items())
        + f"{impls[0]}'s decode step {TF_STEPS} vs the teacher-forced "
        f"forward over {PROMPT + TF_STEPS} positions {rel_tf[0]:.4f}")
    worst = max([max(r) for r in rel.values()] + rel_tf)
    if worst > LOGITS_REL_L2 or not bool(torch.isfinite(full).all()):
        raise AssertionError(f"{cfg.name}: the paths disagree ({rel}, "
                             f"teacher-forced {rel_tf})")
    del full
    torch.cuda.empty_cache()


def time_mamba_scan(torch, cfg):
    """The Mamba scan alone (``models.mamba._chunked_ssm``, the chunked
    log-step scan and the host loop around it) at (a)'s prefill shapes:
    dt, x (B, 2048, d_inner) f32 / bf16, B_t, C_t (B, 2048, N) f32, A
    (d_inner, N).  Its peak memory above its inputs, its time (CUDA
    events) and its bound: the inputs read once and y written once, or
    its ~10 f32 operations an (position, channel, state) element at the
    f32 rate, whichever is longer."""
    from repro_torch.models import mamba
    from repro_torch.models.common import chunk_len

    dI, N = cfg.d_inner, cfg.d_state
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    dt = torch.rand((B, PROMPT, dI), generator=g, device="cuda") * 0.7
    x = torch.randn((B, PROMPT, dI), generator=g, device="cuda").to(
        torch.bfloat16)
    Bs, Cs = (torch.randn((B, PROMPT, N), generator=g, device="cuda")
              for _ in range(2))
    A = -torch.exp(torch.ones((dI, N), device="cuda"))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def run():
        with torch.inference_mode():
            return mamba._chunked_ssm(dt, Bs, Cs, x, A, remat=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, h = run()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())):
        raise AssertionError("the Mamba scan returned non-finite values")
    del y, h
    ms = time_ms(torch, run, flush, reps=3)
    n = B * PROMPT * dI
    n_bytes = n * (4 + 2 + 4) + 2 * B * PROMPT * N * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * n * N / PEAK_OPS["float32"] * 1e3
    c = chunk_len(PROMPT, mamba.CHUNK)
    width = max(1, min(dI, mamba.SCAN_SLICE_BYTES // (B * c * N * 4)))
    r = dict(ms=ms, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             peak_gib=peak, slices=-(-dI // width),
             shapes=dict(x=[B, PROMPT, dI], state=[B, dI, N]))
    log(f"[rec] Mamba scan alone at ({B}, {PROMPT}, {dI}) x N {N}: "
        f"{ms:.2f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
        f"{r['bound_ms'] / ms:.4f} of it reached; {PROMPT // c} chunks x "
        f"{r['slices']} slices of d_inner, its own peak {peak:.2f} GiB (a "
        f"whole chunk's (B, c, d_inner, N) f32 tensor: "
        f"{B * c * dI * N * 4 / 2**30:.2f} GiB)")
    del dt, x, Bs, Cs, flush
    torch.cuda.empty_cache()


def time_slstm_loop(torch, cfg, params):
    """The sLSTM loop alone (``models.xlstm.slstm_forward``: one cell step
    a position) at (b)'s prefill shapes, on (b)'s first sLSTM layer:
    its time and its bound (the (B, L, D) input and output and the
    weights moved once, or its products: 2 x 4D x D an input position
    and a recurrent step, f32 for the recurrent one)."""
    from repro_torch import models
    from repro_torch.models import xlstm

    layer = next(p for d, p in models.lm.layers(cfg, params)
                 if d.mixer == "slstm")["attn"]
    D = cfg.d_model
    x = torch.randn((B, PROMPT, D), device="cuda").to(torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def run():
        with torch.inference_mode():
            return xlstm.slstm_forward(layer, cfg, x)[0]
    ms = time_ms(torch, run, flush, reps=2)
    n_bytes = 2 * (2 * B * PROMPT * D) + 2 * (4 * D * D * 2 + D * D)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * B * PROMPT * D * 4 * D) * (
        1 / PEAK_OPS["bfloat16"] + 1 / PEAK_OPS["float32"]) * 1e3
    r = dict(ms=ms, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             steps=PROMPT, shapes=dict(x=[B, PROMPT, D]))
    log(f"[rec] sLSTM loop alone at ({B}, {PROMPT}, {D}): {ms:.2f} ms, "
        f"{ms * 1e3 / PROMPT:.1f} us a position, bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']}), "
        f"{r['bound_ms'] / ms:.5f} of it reached")
    del x, flush
    torch.cuda.empty_cache()


def recurrent_smoke_parity(torch, np):
    """(c): the two smoke configs in f32 at drop-free capacity: greedy
    tokens of the contiguous serve identical under 'ref', 'chunked' and
    'kernel', K4 launched once an attention layer under 'kernel'; one
    train step's loss and per-leaf gradients of 'kernel' and 'chunked'
    against 'ref' within GQA_GRAD_REL (xLSTM at 64 positions), K4 / K5 /
    K6 once an attention layer under 'kernel'.  Returns the launches."""
    from repro_torch import configs, models
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve_contiguous
    from repro_torch.launch.train import batch_maker
    from repro_torch.nn import module as nnm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import lm_loss

    kernels = (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
               fa.flash_bwd_dkv_kernel)
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    serve_n, train_n = {names[0]: 0}, dict.fromkeys(names, 0)
    for arch in (JAMBA, XLSTM):
        cfg = drop_free(configs.smoke(arch))
        n_attn = sum(d.mixer == "attn" for d, _ in models.lm.layers(
            cfg, models.model_defs(cfg)))
        params = nnm.init_params(models.model_defs(cfg),
                                 seed=RECURRENT_SEED, dtype=torch.float32,
                                 device="cuda")
        toks = {}
        for impl in ("ref", "chunked", "kernel"):
            before = kernels[0].launches
            toks[impl] = serve_contiguous(
                cfg, params, batch=4, prompt_len=48, gen=12, scheme="auto",
                impl=impl, seed=RECURRENT_SEED, compute_dtype=torch.float32,
                device="cuda", log=lambda _: None)["tokens"]
            fwd = kernels[0].launches - before
            if fwd != (n_attn if impl == "kernel" else 0):
                raise AssertionError(f"{arch} smoke serve, impl {impl}: "
                                     f"{fwd} K4 launches")
            serve_n[names[0]] += fwd
        same = all(np.array_equal(toks[i], toks["ref"])
                   for i in ("chunked", "kernel"))

        leaves = list(tree_leaves(params))
        L = SMOKE_TRAIN_L[arch]
        data = np.random.default_rng(RECURRENT_SEED).integers(
            0, cfg.vocab, (2, L + 1))
        batch = batch_maker(cfg, "cuda", torch.float32)(data[:, :-1],
                                                        data[:, 1:])
        out = {}
        for impl in ("ref", "chunked", "kernel"):
            before = [kern.launches for kern in kernels]
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = lm_loss(params, cfg, batch["tokens"], batch["labels"],
                              compute_dtype=torch.float32, impl=impl)
            out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
            for t in leaves:
                t.requires_grad_(False)
            n = [kern.launches - b for kern, b in zip(kernels, before)]
            if n != [n_attn if impl == "kernel" else 0] * 3:
                raise AssertionError(f"{arch} smoke train step, impl "
                                     f"{impl}: K4 / K5 / K6 launches {n}")
            for name, c in zip(names, n):
                train_n[name] += c
        rel, finite = {}, True
        for impl in ("chunked", "kernel"):
            rel[impl] = max(
                ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                for a, b in zip(out[impl][1], out["ref"][1]))
            rel[impl] = max(rel[impl], abs(out[impl][0] - out["ref"][0])
                            / abs(out["ref"][0]))
            finite &= all(bool(torch.isfinite(g).all())
                          for g in out[impl][1])
        log(f"[rec] {arch} smoke f32: greedy tokens of 4 requests x 12, "
            f"impl ref / chunked / kernel: "
            f"{'identical' if same else 'DIFFERENT'}; one train step at "
            f"2 x {L} tokens: loss {out['kernel'][0]:.6f}, per-leaf "
            f"gradient |a-b|/|b| max against ref: chunked "
            f"{rel['chunked']:.2e}, kernel {rel['kernel']:.2e} over "
            f"{len(leaves)} leaves (bound {GQA_GRAD_REL}); {n_attn} "
            f"attention layers")
        if not same:
            raise AssertionError(f"{arch}: smoke tokens differ: {toks}")
        if max(rel.values()) > GQA_GRAD_REL or not finite:
            raise AssertionError(f"{arch}: gradients disagree with the "
                                 f"reference path: {rel}")
        del params, leaves, out
        torch.cuda.empty_cache()
    return {"serve_recurrent_smoke": serve_n,
            "train_recurrent_smoke": train_n}


def chunked_full_width(torch, np):
    """(d): phi3-mini-3.8b at full width and depth, phase 4's load (batch
    8 x 2,048), bf16: the prefill under 'kernel', 'chunked' and 'ref',
    each one's time (host clock around a synchronize, after a warm-up of
    its own) and peak memory; 'chunked' against 'kernel' within
    LOGITS_REL_L2 per row.  Returns the kernel prefill's launches."""
    from repro_torch import configs, models
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn import module as nnm
    from repro_torch.runtime import make_prefill_step

    cfg = configs.full("phi3-mini-3.8b")
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PROMPT)), device="cuda")
    logits, res = {}, {}
    for impl in ("kernel", "chunked", "ref"):
        pre = make_prefill_step(cfg, capacity=PROMPT, impl=impl,
                                compute_dtype=torch.bfloat16, scheme="seq")
        pre(params, toks)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = fa.flash_fwd_kernel.launches
        t0 = time.perf_counter()
        logits[impl], cache = pre(params, toks)
        torch.cuda.synchronize()
        res[impl] = dict(ms=(time.perf_counter() - t0) * 1e3,
                         peak_gib=(torch.cuda.max_memory_allocated()
                                   - base) / 2**30,
                         k4=fa.flash_fwd_kernel.launches - before)
        del cache
    rel = _row_rel(torch, logits["chunked"], logits["kernel"])
    rel_ref = _row_rel(torch, logits["ref"], logits["kernel"])
    log(f"[rec] phi3-mini-3.8b prefill, batch {B} x {PROMPT}, bf16: "
        + "; ".join(f"{impl} {r['ms']:.1f} ms, peak {r['peak_gib']:.2f} "
                    f"GiB above the weights, K4 launches {r['k4']}"
                    for impl, r in res.items())
        + f"; per-row |a-b|/|b| against kernel: chunked max {max(rel):.4f}"
        f", ref max {max(rel_ref):.4f} (bound {LOGITS_REL_L2})")
    if max(rel) > LOGITS_REL_L2 or res["chunked"]["k4"] \
            or res["kernel"]["k4"] != cfg.n_layers:
        raise AssertionError("phi3: the 'chunked' prefill disagrees with "
                             "the kernel path")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": res["kernel"]["k4"]}


def recurrent_families(torch, np):
    """Phase 11: (a) Jamba cut to 4 layers and (b) xLSTM at full width
    served, checked and timed, with the Mamba scan and the sLSTM loop
    alone; (c) the smoke configs; (d) 'chunked' at full width.  Returns
    (K4's row at Jamba's prefill shapes, the kernel launches of each
    path)."""
    from repro_torch import configs, models
    from repro_torch.nn import module as nnm

    gc.collect()
    torch.cuda.empty_cache()
    by_path, numbers = {}, {}
    for arch in (JAMBA, XLSTM):
        cfg = configs.full(arch)
        if arch == JAMBA:
            cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS)
        t0 = time.perf_counter()
        params = nnm.init_params(models.model_defs(cfg), seed=0,
                                 dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        plan = [(d.mixer, d.ffn) for d, _ in models.lm.layers(cfg, params)]
        n_attn = sum(m == "attn" for m, _ in plan)
        log(f"[rec] {cfg.name}: {cfg.n_layers} layers "
            f"{sorted(set(plan))}, d_model {cfg.d_model}, d_inner "
            f"{cfg.d_inner}, vocab {cfg.vocab}: {n_params / 1e9:.3f} B "
            f"params bf16 ({n_params * 2 / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f}s")
        by_path[f"serve_{arch}"], numbers[arch] = serve_recurrent(
            torch, np, cfg, params, n_attn)
        check_recurrent(torch, np, cfg, params,
                        ("kernel", "ref") if n_attn else ("kernel",))
        if arch == JAMBA:
            time_mamba_scan(torch, cfg)
            k4 = time_k4_baseline(torch, cfg)
        else:
            time_slstm_loop(torch, cfg, params)
        numbers[arch]["state"] = state_bytes(torch, cfg)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    from repro_torch.core import cache as cachelib
    latent = cachelib.bytes_per_token_latent(DL, DR)
    phi3 = 32 * cachelib.bytes_per_token_dense(32, 96)
    sizes = lambda d: ", ".join(f"{k} {v:,} B" for k, v in d.items()) \
        or "none"
    log("[rec] decode state of one request (bf16 caches), the paper's "
        "comparison: " + "; ".join(
            f"{a} ({'4 layers' if a == JAMBA else '24 layers'}): a cached "
            f"token {sizes(r['state'][0])}; a request {sizes(r['state'][1])}"
            f" ({r['tokens_per_s']:.1f} decode tokens/s, {r['step_ms']:.2f} "
            f"ms a step, prefill {r['prefill_ms']:.1f} ms, peak "
            f"{r['peak_gib']:.2f} GiB)" for a, r in numbers.items())
        + f"; DeepSeek-V2's latent cache {latent * 60:,} B a token at its "
        f"60 layers, phi3-mini-3.8b's KV cache {phi3:,} B a token")
    by_path.update(recurrent_smoke_parity(torch, np))
    by_path["prefill_chunked_check_phi3"] = chunked_full_width(torch, np)
    return k4, by_path


# ----------------------------- phase 12: whisper-medium, the encoder-decoder --


WHISPER = "whisper-medium"
# (b): a contiguous serve of batch 8, 256 prompt tokens, 64 generated
# (inside whisper's 448 trained decoder positions), over 1,500 frames
WB, WPROMPT, WGEN = 8, 256, 64
# (c): training at batch 2 x 448 tokens over 1,500 frames
WTB, WTL = 2, 448
# the f32 parity checks of (b) and (c) run full width cut to this many
# encoder and decoder layers: the dense reference attention holds (B, 16,
# 1,500, 1,500) f32 scores an encoder layer
WHISPER_CUT = 4
WHISPER_SEED = 5


def whisper_kernels(torch, cfg):
    """(a): K4 without a mask at the encoder's self-attention shape and at
    the serve's cross-attention shape (256 decoder queries over 1,500
    frames), K4 causal at the serve's decoder self-attention shape, K5
    and K6 without a mask at the encoder's shape; K4, K5 and K6 at the
    training step's cross (448 queries over 1,500 frames, no mask) and
    decoder self-attention (448 causal) shapes, batch 2.  bf16 (B, L, H,
    D) views as whisper hands them over, each output held row by row
    against its plain version (lse within LSE_ATOL), every launch on
    route 'tc', and each timed beside its plain version, SDPA (its
    backward computes dQ, dK and dV in one call) and its bound.  Returns
    {kernel: {label: row}}."""
    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    Hh, D, F_ = cfg.n_heads, cfg.resolved_head_dim, cfg.n_frames
    scale = D ** -0.5
    g = torch.Generator(device="cuda")
    g.manual_seed(12)

    def rn(b, n):
        return torch.randn((b, n, Hh, D), generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    rows = {name: {} for name in ("flash_attention_fwd",
                                  "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")}
    # (label, batch, Lq, Lk, causal, backward)
    cases = (("encoder self, no mask", WB, F_, F_, False, True),
             ("cross, no mask", WB, WPROMPT, F_, False, False),
             ("decoder self, causal", WB, WPROMPT, WPROMPT, True, False),
             ("training cross, no mask", WTB, WTL, F_, False, True),
             ("training decoder self, causal", WTB, WTL, WTL, True, True))
    for label, Bq, Lq, Lk, causal, backward in cases:
        q, k, v, do = rn(Bq, Lq), rn(Bq, Lk), rn(Bq, Lk), rn(Bq, Lq)
        kw = dict(causal=causal, window=None, q_offset=0, scale=scale)
        out, lse = fa.flash_fwd_kernel(q, k, v, **kw)
        torch.cuda.synchronize()
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
        delta = (do.float() * out_p.float()).sum(-1).contiguous()
        checks = {"flash_attention_fwd": (
            fa.flash_fwd_kernel, [(out, out_p)],
            lambda: fa.flash_fwd_kernel(q, k, v, **kw),
            lambda: fa.flash_fwd_plain(q, k, v, **kw))}
        lse_err = (lse - lse_p).abs().max().item()
        if backward:
            dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse_p, delta, **kw)
            dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta, **kw)
            torch.cuda.synchronize()
            checks["flash_attention_bwd_dq"] = (
                fa.flash_bwd_dq_kernel,
                [(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                            **kw))],
                lambda: fa.flash_bwd_dq_kernel(q, k, v, do, lse_p, delta,
                                               **kw),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                              **kw))
            checks["flash_attention_bwd_dkv"] = (
                fa.flash_bwd_dkv_kernel,
                list(zip((dk, dv), fa.flash_bwd_dkv_plain(
                    q, k, v, do, lse_p, delta, **kw))),
                lambda: fa.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta,
                                                **kw),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                               **kw))
        plans = {name: launched_plan(c[0]) for name, c in checks.items()}
        sdpa_fwd, sdpa_bwd, backend = sdpa_calls(torch, q, k, v, do,
                                                 causal=causal, scale=scale)
        sdpa_err = row_rel(torch, sdpa_fwd(), out)
        lib = {"flash_attention_fwd": time_ms(torch, sdpa_fwd, flush,
                                              reps=7)}
        if backward:
            lib["flash_attention_bwd_dq"] = \
                lib["flash_attention_bwd_dkv"] = time_ms(torch, sdpa_bwd,
                                                         flush, reps=7)
        work = flash_work(Bq, Hh, Lq, Lk, D, D, causal)
        for name, (_, pairs, kern, plain) in checks.items():
            row_err = max(row_rel(torch, a, b) for a, b in pairs)
            max_abs = max((a.float() - b.float()).abs().max().item()
                          for a, b in pairs)
            if not (row_err <= FLASH_ROW_TOL["bfloat16"]
                    and lse_err <= LSE_ATOL and sdpa_err <= LOGITS_REL_L2):
                raise AssertionError(
                    f"{name} at whisper's {label}: a row's |kernel - "
                    f"plain| / |plain| {row_err:.3g}, lse {lse_err:.3g}, "
                    f"SDPA against the kernel {sdpa_err:.3g}")
            n_bytes, n_ops = work[name]
            b_ms, b_by = bound(n_bytes, n_ops)
            r = rows[name][label] = dict(
                max_abs_err=max_abs, row_rel=row_err,
                ms=time_ms(torch, kern, flush, reps=7),
                plain_ms=time_ms(torch, plain, flush, reps=3),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib[name],
                library=backend, plan=plans[name],
                shapes=dict(q=list(q.shape), kv=list(k.shape),
                            causal=causal))
            log(f"[whisper] {name} at the {label} shape: q "
                f"{tuple(q.shape)}, k/v {tuple(k.shape)}, bf16: time "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, SDPA "
                f"{r['library_ms']:.4f} ms ({backend}), kernel / SDPA "
                f"{r['ms'] / r['library_ms']:.2f}, bound {b_ms:.4f} ms "
                f"({b_by}: {n_bytes / 1e9:.4f} GB, {n_ops / 1e9:.2f} "
                f"GFLOP; {b_ms / r['ms']:.4f} of it reached), "
                f"{plan_text(plans[name])}; per-row error {row_err:.4f}, "
                f"lse {lse_err:.2e}, SDPA vs kernel {sdpa_err:.4f}")
        del q, k, v, do, out, lse, out_p, lse_p, delta, checks
        torch.cuda.empty_cache()
    return rows


def serve_whisper(torch, np, cfg, params):
    """(b): the contiguous launcher's path, batch 8 x 256 prompt tokens
    over 1,500 frames, 64 generated, ``impl='kernel'``, after a warm-up
    at the same shapes: K4 launched once an attention call of the
    prefill (encoder self, decoder self and cross: n_enc_layers + 2 x
    n_layers), every launch on route 'tc', K3 never.  Returns
    (launches, the numbers)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode
    from repro_torch.launch.serve import serve_contiguous

    kw = dict(batch=WB, prompt_len=WPROMPT, gen=WGEN, scheme="auto",
              platform="h100", impl="kernel", compute_dtype=torch.bfloat16,
              device="cuda")
    t0 = time.perf_counter()
    serve_contiguous(cfg, params, log=lambda _: None, **kw)
    log(f"[whisper] warm-up at the same shapes: "
        f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_kernel.launches = 0
    mla_decode.mla_decode_kernel.launches = 0
    plans = []
    restore = record_k4_plans(plans)
    try:
        res = serve_contiguous(cfg, params, log=log, **kw)
    finally:
        restore()
    launches = {"flash_attention_fwd": fa.flash_fwd_kernel.launches}
    steps = res["decode_steps"]
    out = dict(tokens_per_s=steps * WB / res["decode_s"],
               step_ms=res["decode_s"] * 1e3 / steps,
               prefill_ms=res["prefill_s"] * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    routes = sorted({p["route"] for p in plans})
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    log(f"[whisper] {cfg.name}, batch {WB} x {WPROMPT} prompt tokens over "
        f"{cfg.n_frames} frames, {WGEN} generated: prefill (encode + "
        f"prompt) {out['prefill_ms']:.1f} ms, decode "
        f"{out['tokens_per_s']:.1f} tokens/s, step {out['step_ms']:.2f} ms "
        f"mean, peak memory {out['peak_gib']:.2f} GiB, launches "
        f"{launches}, K4 routes {routes}")
    tokens = res["tokens"]
    if tokens.shape != (WB, WGEN) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab \
            or not bool(torch.isfinite(res["last_logits"]).all()):
        raise AssertionError(f"{cfg.name}: the contiguous serve returned "
                             f"bad tokens or logits")
    if launches["flash_attention_fwd"] != n_attn or len(plans) != n_attn \
            or mla_decode.mla_decode_kernel.launches:
        raise AssertionError(f"{cfg.name}: K4 launches {launches} "
                             f"(recorded {len(plans)}), K3 "
                             f"{mla_decode.mla_decode_kernel.launches}; want "
                             f"K4 = {n_attn}, K3 none")
    if routes != ["tc"]:
        raise AssertionError(f"{cfg.name}: a bf16 K4 launch left its "
                             f"tensor-core route: {plans}")
    torch.cuda.empty_cache()
    return launches, out


def compare_whisper(torch, np, cfg, params):
    """(b), bf16 at full depth: the prefill's last-token logits,
    ``impl='kernel'`` against ``impl='ref'`` per row within
    LOGITS_REL_L2, on the serve's prompts and frames."""
    from repro_torch.launch.serve import stub_embeds
    from repro_torch.runtime import make_prefill_step

    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (WB, WPROMPT)), device="cuda")
    frames = stub_embeds(cfg, WB, 1, "cuda")
    logits = {impl: make_prefill_step(
        cfg, capacity=WPROMPT + WGEN + 1, compute_dtype=torch.bfloat16,
        impl=impl)(params, toks, frames)[0] for impl in ("kernel", "ref")}
    rel = _row_rel(torch, logits["kernel"], logits["ref"])
    log(f"[whisper] {cfg.name} bf16 prefill logits kernel vs ref, per-row "
        f"|a-b|/|b| max {max(rel):.4f} (bound {LOGITS_REL_L2})")
    if max(rel) > LOGITS_REL_L2:
        raise AssertionError(f"{cfg.name}: kernel-path logits disagree "
                             f"with the reference path")
    torch.cuda.empty_cache()


def whisper_cut(torch):
    """Full width cut to WHISPER_CUT encoder and decoder layers, f32
    weights from WHISPER_SEED."""
    from repro_torch import configs, models
    from repro_torch.nn import module as nnm

    cfg = dataclasses.replace(configs.full(WHISPER), n_layers=WHISPER_CUT,
                              n_enc_layers=WHISPER_CUT)
    return cfg, nnm.init_params(models.model_defs(cfg), seed=WHISPER_SEED,
                                dtype=torch.float32, device="cuda")


def whisper_token_parity(torch, np):
    """(b), f32 at full width cut to WHISPER_CUT + WHISPER_CUT layers: the
    greedy tokens of the contiguous serve's load, ``impl='kernel'`` (K4 on
    its f32 route) identical to ``impl='ref'``.  Returns the K4 launches
    of the kernel path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve_contiguous

    cfg, params = whisper_cut(torch)
    toks, last = {}, {}
    for impl in ("ref", "kernel"):
        before = fa.flash_fwd_kernel.launches
        res = serve_contiguous(
            cfg, params, batch=WB, prompt_len=WPROMPT, gen=WGEN,
            scheme="auto", impl=impl, seed=WHISPER_SEED,
            compute_dtype=torch.float32, device="cuda", log=lambda _: None)
        toks[impl], last[impl] = res["tokens"], res["last_logits"]
        n = fa.flash_fwd_kernel.launches - before
        if n != (3 * WHISPER_CUT if impl == "kernel" else 0):
            raise AssertionError(f"whisper cut serve, impl {impl}: {n} K4 "
                                 f"launches")
    same = np.array_equal(toks["kernel"], toks["ref"])
    top2 = torch.topk(last["ref"].float(), 2, dim=-1).values
    log(f"[whisper] f32, {WHISPER_CUT} + {WHISPER_CUT} layers at full "
        f"width, batch {WB} x {WPROMPT} over {cfg.n_frames} frames, "
        f"{WGEN} generated: greedy tokens kernel vs ref "
        f"{'identical' if same else 'DIFFERENT'}; last step's logits "
        f"per-row |a-b|/|b| max "
        f"{max(_row_rel(torch, last['kernel'], last['ref'])):.2e}, smallest "
        f"top-1 / top-2 margin {(top2[:, 0] - top2[:, 1]).min().item():.3e}")
    if not same:
        raise AssertionError(f"whisper: f32 kernel-path tokens differ from "
                             f"the reference path's: {toks}")
    del params
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": 3 * WHISPER_CUT}


def train_whisper(torch, cfg):
    """(c): full-width training, bf16 params and f32 moments, batch 2 x
    448 tokens over 1,500 frames (drawn as the training launcher draws
    them), ``impl='kernel'``, one warm-up and three timed steps: losses
    finite, K4 once an attention call (twice under the config's remat: the
    backward recomputes each layer's forward), K5 and K6 once, the plan
    of every launch recorded and on route 'tc'.  Returns the timed
    steps' launches and ms a step."""
    from repro_torch import models
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import batch_maker
    from repro_torch.nn import module as nnm
    from repro_torch.optim import AdamWConfig, adamw_init, cosine
    from repro_torch.runtime import TrainStepConfig, make_train_step

    kernels = (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
               fa.flash_bwd_dkv_kernel)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    opt_cfg = AdamWConfig(lr=cosine(3e-4, warmup=20, total=100))
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, TrainStepConfig(
        compute_dtype=torch.bfloat16, impl="kernel"))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=WTL,
                                  global_batch=WTB, seed=0))
    make = batch_maker(cfg, "cuda", torch.bfloat16)
    warm, timed, times = 1, 3, []
    plans, bwd_plans = [], []
    restore = record_k4_plans(plans, bwd_plans)
    try:
        for i in range(warm + timed):
            b = make(*data.next_batch())
            if i == warm:
                for kern in kernels:
                    kern.launches = 0
                plans.clear()
                bwd_plans.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            loss = float(m["loss"])
            log(f"[whisper] train step {i + 1}"
                f"{' (warm-up)' if i < warm else ''}: loss {loss:.4f}, grad "
                f"norm {float(m['grad_norm']):.4f}, {dt * 1e3:.1f} ms")
            if not math.isfinite(loss):
                raise AssertionError(f"whisper step {i + 1}: loss {loss} is "
                                     f"not finite")
            if i >= warm:
                times.append(dt)
    finally:
        restore()
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    launches = {n: kern.launches for n, kern in zip(names, kernels)}
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    want = {n: timed * n_attn * (2 if cfg.remat and n == names[0] else 1)
            for n in names}
    ms = 1e3 * sum(times) / len(times)
    log(f"[whisper] {timed} timed training steps, batch {WTB} x {WTL} over "
        f"{cfg.n_frames} frames: {ms:.1f} ms/step mean "
        f"({', '.join(f'{t * 1e3:.1f}' for t in times)}), "
        f"{WTB * WTL / (ms / 1e3):.0f} decoder tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}")
    if launches != want:
        raise AssertionError(f"whisper training launches {launches} != "
                             f"{want}")
    seen = {names[0]: plans, names[1]: [p for p, _ in bwd_plans],
            names[2]: [p for _, p in bwd_plans]}
    for n, ps in seen.items():
        off = [p for p in ps if p["route"] != "tc"]
        if len(ps) != launches[n] or off:
            raise AssertionError(f"whisper training {n}: {len(ps)} plans "
                                 f"recorded of {launches[n]} launches, "
                                 f"{len(off)} off route 'tc': {off[:2]}")
    del params, opt, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ms


def whisper_grad_check(torch, np):
    """(c), f32 at full width cut to WHISPER_CUT + WHISPER_CUT layers, one
    batch of 2 x 448 tokens over 1,500 frames: the loss and each leaf's
    gradient, ``impl='kernel'`` against ``impl='ref'``, within
    GQA_GRAD_REL per leaf.  Returns the kernel path's launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import batch_maker
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import lm_loss

    cfg, params = whisper_cut(torch)
    kernels = (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
               fa.flash_bwd_dkv_kernel)
    data = np.random.default_rng(WHISPER_SEED).integers(0, cfg.vocab,
                                                        (WTB, WTL + 1))
    batch = batch_maker(cfg, "cuda", torch.float32)(data[:, :-1],
                                                    data[:, 1:])
    leaves = list(tree_leaves(params))
    out, n_kernel = {}, None
    for impl in ("ref", "kernel"):
        before = [kern.launches for kern in kernels]
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = lm_loss(params, cfg, batch["tokens"], batch["labels"],
                          embeds=batch["embeds"],
                          compute_dtype=torch.float32, impl=impl)
        out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
        for t in leaves:
            t.requires_grad_(False)
        n = [kern.launches - b for kern, b in zip(kernels, before)]
        want = 3 * WHISPER_CUT if impl == "kernel" else 0
        if n != [want * (2 if cfg.remat else 1), want, want]:
            raise AssertionError(f"whisper cut train step, impl {impl}: K4 "
                                 f"/ K5 / K6 launches {n}")
        if impl == "kernel":
            n_kernel = dict(zip(("flash_attention_fwd",
                                 "flash_attention_bwd_dq",
                                 "flash_attention_bwd_dkv"), n))
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(out["kernel"][1], out["ref"][1])]
    loss_rel = abs(out["kernel"][0] - out["ref"][0]) / abs(out["ref"][0])
    log(f"[whisper] f32 train step, {WHISPER_CUT} + {WHISPER_CUT} layers "
        f"at full width, batch {WTB} x {WTL}: loss {out['kernel'][0]:.6f} vs "
        f"{out['ref'][0]:.6f} (rel {loss_rel:.2e}), per-leaf gradient "
        f"|a-b|/|b| max {max(rel):.2e} over {len(rel)} leaves (bound "
        f"{GQA_GRAD_REL})")
    if max(rel) > GQA_GRAD_REL or loss_rel > GQA_GRAD_REL:
        raise AssertionError("whisper: kernel-path gradients disagree with "
                             "the reference path")
    del params, leaves, out
    torch.cuda.empty_cache()
    return n_kernel


def whisper_family(torch, np):
    """Phase 12: (a) K4-K6 at whisper's shapes, (b) the full-width serve
    with its checks, (c) full-width training with its check.  Returns
    (K4-K6's rows at whisper's shapes, the kernel launches of each
    path)."""
    from repro_torch import configs, models
    from repro_torch.nn import module as nnm

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.full(WHISPER)
    t0 = time.perf_counter()
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[whisper] {cfg.name}: {cfg.n_enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, {cfg.n_frames} "
        f"frames, vocab {cfg.vocab}: {n_params / 1e9:.3f} B params bf16 "
        f"({n_params * 2 / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f}s")
    rows = whisper_kernels(torch, cfg)
    serve_n, numbers = serve_whisper(torch, np, cfg, params)
    compare_whisper(torch, np, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    train_n, numbers["train_ms"] = train_whisper(torch, cfg)
    cross = 2 * cfg.n_layers * WB * cfg.n_frames * cfg.n_heads \
        * cfg.resolved_head_dim * 2
    log(f"[whisper] decode: {numbers['tokens_per_s']:.1f} tokens/s "
        f"({numbers['step_ms']:.2f} ms a step); every step reads the cross "
        f"cache of {cross / 1e9:.3f} GB (bf16 K/V of {cfg.n_frames} frames, "
        f"{cfg.n_layers} layers, batch {WB}) through gqa_decode")
    parity = {"flash_attention_fwd": whisper_token_parity(torch, np)[
        "flash_attention_fwd"]}
    grads = whisper_grad_check(torch, np)
    parity = {k: parity.get(k, 0) + v for k, v in grads.items()}
    whisper = {k: serve_n.get(k, 0) + v for k, v in train_n.items()}
    return rows, {"whisper": whisper, "whisper_cut_parity": parity}

# ------------------ phase 13: cold-cache options, 'chunked', compression ---


# 13(a): a conversation tree.  Every conversation opens with one system
# prompt of CONV_SYSTEM tokens (it ends 4 tokens into block 31 at block
# size 16) and its own user message; each turn appends the reply and a
# user suffix.  Turn 1's conversation 0 arrives alone, the others once its
# prefill has finished, so they hit its blocks, the last one partially.
CONV_N, CONV_SYSTEM, CONV_USER = 8, 500, 100
CONV_REPLY, CONV_SUFFIX, CONV_TURNS = 48, 12, 3
CONV_MAX_LEN = CONV_SYSTEM + CONV_USER \
    + (CONV_TURNS - 1) * (CONV_REPLY + CONV_SUFFIX) + CONV_REPLY
# the serving benchmark's cold-cache emulation
COLD = dict(decode_block_reuse=False, partial_match=False, admission="fcfs")
PHASE13_RUNS = (("warm", {}), ("cold", COLD), ("cold", COLD), ("warm", {}))
# 13(c): error-feedback top-k at its default fraction, 0.01
COMPRESS_STEPS = 3
COMPRESS_REPS = 3


def conversation_openers(cfg, np):
    """The first turn's prompts and every later turn's user suffixes."""
    rng = np.random.default_rng(13)
    system = rng.integers(0, cfg.vocab, CONV_SYSTEM)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab, CONV_USER)])
               .astype(np.int32) for _ in range(CONV_N)]
    suffixes = [[rng.integers(0, cfg.vocab, CONV_SUFFIX).astype(np.int32)
                 for _ in range(CONV_N)] for _ in range(CONV_TURNS - 1)]
    return prompts, suffixes


def serve_conversations(engine, cfg, np, replies=None):
    """Serve the conversation tree on ``engine`` turn by turn (request rid
    100 t + i is conversation i's turn t + 1).  The next turn's prompts
    append ``replies`` (the first run's outputs by rid, so every run
    serves the same prompts) or, None, this run's own.  Returns the
    outputs by rid and, a turn, the prefill tokens and the median TTFT
    (ms, host clock: submit to first token)."""
    from repro_torch.runtime import Request, SamplingParams

    prompts, suffixes = conversation_openers(cfg, np)
    outs, turns = {}, []
    for t in range(CONV_TURNS):
        start, pre = engine.stats.steps, engine.stats.prefill_tokens
        reqs = [Request(rid=100 * t + i, prompt=p,
                        arrival=start + (1 if t == 0 and i else 0),
                        sampling=SamplingParams(max_tokens=CONV_REPLY))
                for i, p in enumerate(prompts)]
        todo = list(reqs)
        while todo or not engine.idle:
            while todo and todo[0].arrival <= engine.stats.steps:
                engine.submit(todo.pop(0))
            engine.step()
            if engine.stats.steps > start + 1000:
                raise AssertionError(f"turn {t + 1} did not drain")
        for r in reqs:
            if len(r.output) != CONV_REPLY:
                raise AssertionError(f"request {r.rid} ended with "
                                     f"{len(r.output)} tokens")
            outs[r.rid] = [int(x) for x in r.output]
        turns.append({"prefill_tokens": engine.stats.prefill_tokens - pre,
                      "ttft_ms": statistics.median(
                          (r.first_tok_t - r.submit_t) * 1e3 for r in reqs)})
        src = outs if replies is None else replies
        if t + 1 < CONV_TURNS:
            prompts = [np.concatenate([p, np.asarray(src[100 * t + i],
                                                     np.int32),
                                       suffixes[t][i]])
                       for i, p in enumerate(prompts)]
    return outs, turns


def phase13_conversations(torch, np, cfg, params):
    """Phase 13(a): the conversation tree on the sync engine on graphs,
    bf16 pool, ``impl='kernel'``, at drop-free MoE capacity, warm (the
    defaults) and cold (``COLD``) in turns warm, cold, cold, warm.
    Returns the launch counts by run."""
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import build_engine

    cfg = drop_free(cfg)
    kw = dict(batch=CONV_N, max_len=CONV_MAX_LEN, gen=CONV_REPLY,
              block_size=BS, impl="kernel", scheme="auto", platform="h100",
              prefill_chunk=C, compute_dtype=torch.bfloat16, device="cuda")
    k1, k2 = mla_decode.mla_decode_paged_kernel, \
        mla_prefill.mla_prefill_paged_kernel
    margins, base = {}, None

    def warm_margins():
        # a warm serve recording the margin of every token it sampled;
        # run only when a run's tokens differ from the first run's
        if not margins:
            eng = build_engine(cfg, params, **kw)
            record_margins(torch, eng, margins)
            serve_conversations(eng, cfg, np, base)
            eng.close()
        return {"store": margins, "temperature": 1.0}

    by_path, runs = {}, []
    for i, (label, opts) in enumerate(PHASE13_RUNS):
        engine = build_engine(cfg, params, **kw, **opts)
        capture_s = engine.warm_up()
        k1.launches = k2.launches = 0
        outs, turns = serve_conversations(engine, cfg, np, base)
        s = engine.summary()
        launches = {"mla_decode_paged": k1.launches,
                    "mla_prefill_paged": k2.launches}
        ticks = sum(s["schemes_used"].values())
        want = {"mla_decode_paged": cfg.n_layers * ticks,
                "mla_prefill_paged": cfg.n_layers * s["prefill_chunks"]}
        if launches != want:
            raise AssertionError(f"{label}: kernel launches {launches} != "
                                 f"{want}")
        check_graph_plans(engine)
        if base is None:
            base = outs
        ties = tie_count(base, outs, warm_margins, f"13(a) {label} {i + 1}")
        hits = {k: s[k] for k in ("prefix_hit_tokens", "prefix_partial_hits",
                                  "prefix_decode_inserted_blocks")}
        warm = label == "warm"
        if warm and not (hits["prefix_partial_hits"] > 0
                         and hits["prefix_decode_inserted_blocks"] > 0):
            raise AssertionError(f"warm run {i + 1} made no partial hit or "
                                 f"cached no decode block: {hits}")
        if not warm and (hits["prefix_partial_hits"]
                         or hits["prefix_decode_inserted_blocks"]):
            raise AssertionError(f"cold run {i + 1} hit partially or cached "
                                 f"a decode block: {hits}")
        runs.append((label, turns))
        by_path[f"conversations_{label}_{i + 1}"] = launches
        log(f"[cold] {i + 1} {label}: prefill tokens by turn "
            f"{[t['prefill_tokens'] for t in turns]}, median TTFT by turn "
            f"{[round(t['ttft_ms'], 2) for t in turns]} ms, {hits}, "
            f"{s['tokens_per_s']:.1f} decode tokens/s, step "
            f"{engine.stats.wall * 1e3 / engine.stats.steps:.2f} ms mean, "
            f"capture {capture_s:.3f}s, launches {launches} = layers x "
            f"{ticks} ticks / {s['prefill_chunks']:.0f} chunks, "
            f"{ties} requests on near ties")
        engine.close()
        del engine
        torch.cuda.empty_cache()
    for t in range(1, CONV_TURNS):
        warm = [r[1][t]["prefill_tokens"] for r in runs if r[0] == "warm"]
        cold = [r[1][t]["prefill_tokens"] for r in runs if r[0] == "cold"]
        if max(warm) >= min(cold):
            raise AssertionError(f"turn {t + 1}: warm prefill tokens {warm} "
                                 f"not below cold {cold}")
    return by_path


def phase13_chunked_smoke(torch, np):
    """Phase 13(b), smoke: ``impl='chunked'`` on the paged engines (sync
    and async; chunked and per-request prefill) on the f32 smoke config
    (phase 5's seed and load), on graphs: greedy tokens identical to
    'ref' and 'kernel', and under 'chunked' no launch of K1, K2 or K4.
    Returns the launch counts of the 'chunked' runs."""
    from repro_torch import configs, models
    from repro_torch.kernels import flash_attention, mla_decode, mla_prefill
    from repro_torch.launch.serve import (build_engine, serve_paged,
                                          synthetic_requests)
    from repro_torch.nn import module as nnm

    cfg = drop_free(configs.smoke("deepseek-v2-236b"))
    params = nnm.init_params(models.model_defs(cfg), seed=4,
                             dtype=torch.float32, device="cuda")
    counters = {"mla_decode_paged": mla_decode.mla_decode_paged_kernel,
                "mla_prefill_paged": mla_prefill.mla_prefill_paged_kernel,
                "flash_attention_fwd": flash_attention.flash_fwd_kernel}
    by_path, want = {}, None
    for kind in ("sync", "async"):
        for chunk in (8, 0):
            for impl in ("ref", "chunked", "kernel"):
                engine = build_engine(
                    cfg, params, batch=4, max_len=48 + 12, gen=12, impl=impl,
                    scheme="auto", platform="h100", prefill_chunk=chunk,
                    compute_dtype=torch.float32, device="cuda", engine=kind)
                engine.warm_up()
                for k in counters.values():
                    k.launches = 0
                serve_paged(engine, synthetic_requests(
                    cfg, batch=4, prompt_len=48, gen=12, seed=4),
                    log=lambda *_: None)
                got = {r.rid: list(r.output) for r in engine.sched.finished}
                n = {name: k.launches for name, k in counters.items()}
                engine.close()
                if want is None:
                    want = got
                mode = "chunked" if chunk else "per_request"
                if got != want or len(got) != 4:
                    raise AssertionError(f"{kind} {mode} {impl}: tokens "
                                         f"{got} != {want}")
                if impl == "chunked":
                    if any(n.values()):
                        raise AssertionError(f"impl='chunked' launched "
                                             f"kernels: {n}")
                    by_path[f"chunked_smoke_{kind}_{mode}"] = n
    log("[chunked] f32 smoke, sync and async engines, chunked and "
        "per-request prefill: greedy tokens identical under 'ref', "
        "'chunked' and 'kernel'; 'chunked' launched no K1, K2 or K4")
    return by_path


def phase13_chunked_full(torch, np, cfg, params, phase3_tps):
    """Phase 13(b), full width: phase 3's load (bf16 pool, the config's
    MoE capacity, graphs) under ``impl='chunked'``: every request
    finishes, no K1 / K2 launch; tokens/s beside phase 3's."""
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import build_engine, serve_paged
    from repro_torch.runtime import Request, SamplingParams

    gen = 32
    reqs = requests_full(cfg, np, Request, SamplingParams, gen)
    engine = build_engine(cfg, params, batch=8, max_len=1024 + gen, gen=gen,
                          block_size=BS, impl="chunked", scheme="auto",
                          platform="h100", prefill_chunk=C,
                          compute_dtype=torch.bfloat16, device="cuda")
    capture_s = engine.warm_up()
    k1, k2 = mla_decode.mla_decode_paged_kernel, \
        mla_prefill.mla_prefill_paged_kernel
    k1.launches = k2.launches = 0
    torch.cuda.reset_peak_memory_stats()
    summary = serve_paged(engine, reqs, log=lambda *_: None, log_every=0)
    launches = {"mla_decode_paged": k1.launches,
                "mla_prefill_paged": k2.launches}
    done = engine.sched.finished
    if len(done) != len(reqs) or any(len(r.output) != gen for r in done):
        raise AssertionError("'chunked': not every request finished")
    if any(launches.values()):
        raise AssertionError(f"impl='chunked' launched {launches}")
    log(f"[chunked] phase 3's load under impl='chunked' (graphs, captured "
        f"in {capture_s:.3f}s): {summary['tokens_per_s']:.1f} tokens/s "
        f"against phase 3's bf16 {', '.join(f'{t:.1f}' for t in phase3_tps)}"
        f" (impl='kernel', this run), step "
        f"{engine.stats.wall * 1e3 / engine.stats.steps:.2f} ms mean, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}")
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return {"chunked_full_width": launches}


def _same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def phase13_compression(torch, np, cfg, params):
    """Phase 13(c): ``optim.compress`` on the card against the CPU, bit
    for bit (sent and error): the f32 smoke config's whole gradient tree
    over COMPRESS_STEPS carried steps, then a full-width expert ``down``
    leaf and the embedding leaf one at a time (a drawn gradient and a
    drawn carried error); ms a leaf on the card, and the ratio."""
    from repro_torch import configs, models
    from repro_torch.nn import module as nnm
    from repro_torch.optim import (TopKConfig, compress, compression_ratio,
                                   init_error)
    from repro_torch.optim.adamw import tree_leaves, tree_map

    topk = TopKConfig()
    smoke = nnm.init_params(models.model_defs(configs.smoke(
        "deepseek-v2-236b")), seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(13)
    err_c, err_g = init_error(smoke), init_error(tree_map(
        lambda p: p.cuda(), smoke))
    for step in range(COMPRESS_STEPS):
        g = tree_map(lambda p: torch.from_numpy(rng.standard_normal(
            tuple(p.shape)).astype(np.float32)), smoke)
        sent_c, err_c = compress(topk, g, err_c)
        sent_g, err_g = compress(topk, tree_map(lambda t: t.cuda(), g),
                                 err_g)
        for what, a, b in (("sent", sent_g, sent_c), ("error", err_g, err_c)):
            for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
                if not _same_bits(torch, x.cpu(), y):
                    raise AssertionError(f"compress step {step}: {what} "
                                         f"leaf {i} differs card vs CPU")
    n_leaves = len(list(tree_leaves(smoke)))
    log(f"[compress] f32 smoke tree ({n_leaves} leaves), {COMPRESS_STEPS} "
        f"carried steps: sent and error bitwise equal on the card and the "
        f"CPU; compression_ratio {compression_ratio(topk, smoke):.4f}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    shapes = {"moe down": (cfg.n_experts, cfg.moe_d_ff, cfg.d_model),
              "embed": (cfg.vocab, cfg.d_model)}
    for name, shape in shapes.items():
        g = torch.randn(shape, generator=gen, device="cuda")
        e = torch.randn(shape, generator=gen, device="cuda").mul_(0.1)
        times, sent, err = [], None, None
        torch.cuda.reset_peak_memory_stats()
        for _ in range(COMPRESS_REPS):
            sent = err = None
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            sent, err = compress(topk, [g], [e])
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        peak = torch.cuda.max_memory_allocated() / 2**30
        g_c, e_c = g.cpu(), e.cpu()
        del g, e
        t_cpu = time.perf_counter()
        sent_c, err_c = compress(topk, [g_c], [e_c])
        t_cpu = time.perf_counter() - t_cpu
        same = _same_bits(torch, sent[0].cpu(), sent_c[0]) and \
            _same_bits(torch, err[0].cpu(), err_c[0])
        kept = int((sent_c[0] != 0).sum())
        n = sent_c[0].numel()
        del sent, err, sent_c, err_c, g_c, e_c
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[compress] {name} {shape} ({n / 1e9:.3f} G f32 elements): "
            f"card {statistics.median(times):.3f} ms median of "
            f"{[round(t, 3) for t in times]}, CPU {t_cpu:.2f} s; "
            f"{'bitwise equal' if same else 'DIFFERENT'}; kept {kept} "
            f"(k = {max(1, int(n * topk.fraction))}), ratio "
            f"{compression_ratio(topk, [torch.empty(shape, device="meta")]):.4f}; peak "
            f"{peak:.2f} GiB")
        if not same:
            raise AssertionError(f"compress {name}: card and CPU differ")
    log(f"[compress] compression_ratio of the {cfg.n_layers}-layer "
        f"full-width params: {compression_ratio(topk, params):.4f}")


def phase13_examples(torch):
    """Phase 13(d): the port's three examples at their defaults on cuda
    (``train_mla`` in a fresh checkpoint directory): each prints its OK
    line; wall time each."""
    import contextlib
    import io
    import tempfile

    from repro_torch.examples import quickstart, serve_mla, train_mla

    with tempfile.TemporaryDirectory() as d:
        runs = (("quickstart", quickstart, []),
                ("train_mla", train_mla, ["--ckpt-dir", d]),
                ("serve_mla", serve_mla, []))
        for name, mod, argv in runs:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mod.main(argv)
            wall = time.perf_counter() - t0
            lines = out.getvalue().splitlines()
            ok = [x for x in lines if x.startswith("OK")]
            if not ok:
                raise AssertionError(f"{name} printed no OK line: "
                                     f"{lines[-5:]}")
            tail = [x for x in lines if x.startswith(("final loss",
                                                      "served "))]
            log(f"[examples] {name} on cuda: {wall:.1f}s, "
                f"{' '.join(tail)} {ok[-1]!r}")


def phase13(torch, np, cfg, params, phase3_tps):
    """Phase 13 (after phase 9, on its full-width model).  Returns the
    launch counts of each path."""
    t0 = time.perf_counter()
    by_path = phase13_conversations(torch, np, cfg, params)
    by_path.update(phase13_chunked_smoke(torch, np))
    by_path.update(phase13_chunked_full(torch, np, cfg, params, phase3_tps))
    phase13_compression(torch, np, cfg, params)
    phase13_examples(torch)
    log(f"[phase 13] {time.perf_counter() - t0:.1f}s")
    return by_path



# ------------------------------------------------------ phase 14: the mesh --

MESH = (2, 2)
MESH_POLICIES = ("serve", "serve_2dtp", "dp", "tp")
# phase 5's f32 smoke load (seed 4: smallest top-1 / top-2 margin 7e-3)
MESH_SMOKE = dict(batch=4, prompt_len=48, gen=12, n=2, seed=4)
MESH_GEN = 32                     # phase 3's load


def mesh_smoke_run(torch, cfg, params, impl, device, mesh=None,
                   policy="serve"):
    """Phase 5's load on the f32 smoke config: returns the engine (its
    summary in ``engine.summary()``) and the K1 / K2 launches and plans
    of the serve."""
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import (build_engine, serve_paged,
                                          synthetic_requests)

    s = MESH_SMOKE
    engine = build_engine(cfg, params, batch=s["batch"],
                          max_len=s["prompt_len"] + s["gen"], n=s["n"],
                          gen=s["gen"], impl=impl, scheme="auto",
                          platform="h100", prefill_chunk=8,
                          compute_dtype=torch.float32, device=device,
                          mesh=mesh, shard_policy=policy)
    engine.warm_up()
    plans = {}
    restore = every_launch_plan(torch, plans)
    mla_decode.mla_decode_paged_kernel.launches = 0
    mla_prefill.mla_prefill_paged_kernel.launches = 0
    try:
        serve_paged(engine, synthetic_requests(
            cfg, batch=s["batch"], prompt_len=s["prompt_len"], gen=s["gen"],
            n=s["n"], seed=s["seed"]), log=lambda *_: None, log_every=0)
    finally:
        restore()
    launches = {"mla_decode_paged": mla_decode.mla_decode_paged_kernel.launches,
                "mla_prefill_paged":
                    mla_prefill.mla_prefill_paged_kernel.launches}
    return engine, launches, plans


def pool_digest(torch, pool) -> str:
    """sha256 of every byte of a pool (null block included)."""
    import hashlib
    from repro_torch.core.cache import pool_leaves
    h = hashlib.sha256()
    for t in pool_leaves(pool):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


# the paged entry point of ``kernels.ops`` each engine step kind runs
STEP_KERNEL = {"decode": "mla_decode_paged", "chunk": "mla_prefill_paged"}


def capture_paged_calls(torch, calls):
    """Wrap the paged MLA entry points of ``kernels.ops`` (``core.mla``
    calls them through the module).  Returns (arm, unwrap): after
    ``arm(name)`` the next call of ``name`` keeps a copy of its operands
    in ``calls[name]`` (in the place of the last)."""
    from repro_torch.kernels import ops as kops

    def copy(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    armed, undo = set(), []
    for name in STEP_KERNEL.values():
        real = getattr(kops, f"{name}_attention")

        def call(*a, _real=real, _name=name, **k):
            if _name in armed:
                armed.discard(_name)
                calls[_name] = (tuple(copy(v) for v in a),
                                {key: copy(v) for key, v in k.items()})
            return _real(*a, **k)
        setattr(kops, f"{name}_attention", call)
        undo.append(lambda n=name, r=real: setattr(kops, f"{n}_attention",
                                                   r))
    return armed.add, lambda: [fn() for fn in undo]


def hold_captured(torch, calls, live) -> dict:
    """K1 and K2 on operands a rank's main path gave them (its heads, its
    DP shard's rows, its pool replica: the first layer of the step with
    the most live rows on the rank, then the longest prefix; ``live``
    {name: (rows, prefix)}): 'kernel' against 'ref', row by row
    (``row_rel``, bound TOL bf16), with the plan each launch recorded
    (the tensor-core walk; K1 split in more than one part at these
    shapes).  Returns {name: result}."""
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.kernels import ops as kops

    kerns = {"mla_decode_paged": mla_decode.mla_decode_paged_kernel,
             "mla_prefill_paged": mla_prefill.mla_prefill_paged_kernel}
    tol = TOL["bfloat16"]
    held = {}
    for name, kern in kerns.items():
        if name not in calls or live[name][0] == 0:
            raise AssertionError(f"{name}: no step of the main path had a "
                                 f"live row on this rank")
        args, kw = calls[name]
        fn = getattr(kops, f"{name}_attention")
        got = fn(*args, **dict(kw, impl="kernel"))
        torch.cuda.synchronize()
        plan = launched_plan(kern)
        want = fn(*args, **dict(kw, impl="ref"))
        rel = row_rel(torch, got, want)
        held[name] = dict(q_shape=list(args[0].shape), live_rows=live[name][0],
                          longest_prefix=live[name][1], row_rel=rel,
                          max_abs_err=(got.float() - want.float()).abs()
                          .max().item(), plan=plan)
        if not rel <= tol:
            raise AssertionError(f"{name} at the mesh path's shapes "
                                 f"{tuple(args[0].shape)}: row_rel {rel} > "
                                 f"{tol}")
    if held["mla_decode_paged"]["plan"]["n_split"] <= 1:
        raise AssertionError(f"K1 at the mesh path's shapes ran unsplit: "
                             f"{held['mla_decode_paged']['plan']}")
    return held


def mesh_full_serve(torch, np, cfg, params, log_fn, mesh=None,
                    keep_rows=True, capture=False):
    """Phase 3's load (8 requests of 256-1,024 tokens, 32 generated) on
    the eager engine, block 16, chunk 32, scheme 'seq', impl 'kernel',
    after a warm-up serve, on one card or as a rank of ``mesh`` ('tp').
    Times the prefill walks and every decode tick between device
    synchronizations, counts the collective bytes of each and times the
    collectives in them (``dist.all_reduce`` / ``broadcast`` wrapped,
    the device synchronized before and after each), keeps every decode
    tick's logits rows by (rid, output index) where ``keep_rows`` and,
    on one card, the margins of every greedy choice.  With ``capture``
    it keeps in ``got["captured"]`` the first layer's K1 and K2 operands
    of the decode tick and the chunk with the most live rows of this
    rank's DP shard (then the longest prefix), chosen on the host
    (:func:`capture_paged_calls`), and their counts in ``got["live"]``.
    Returns what the phase compares and prints."""
    from repro_torch.kernels import mla_decode, mla_prefill
    from repro_torch.launch.serve import build_engine, serve_paged
    from repro_torch.runtime import Request, SamplingParams

    reqs = requests_full(cfg, np, Request, SamplingParams, MESH_GEN)
    kw = dict(batch=len(reqs), max_len=max(r.plen for r in reqs) + MESH_GEN,
              gen=MESH_GEN, block_size=BS, impl="kernel", scheme="seq",
              platform="h100", prefill_chunk=C, cuda_graphs=False,
              compute_dtype=torch.bfloat16,
              device="cuda" if mesh is None else mesh.device, mesh=mesh,
              shard_policy="tp")
    warm = build_engine(cfg, params, **kw)
    warm.run(warm_up_requests(cfg, np, Request, SamplingParams))
    del warm
    engine = build_engine(cfg, params, **kw)
    got = {"prefill_s": 0.0, "tick_s": [], "tick_bytes": [],
           "prefill_bytes": 0, "rows": {} if keep_rows else None,
           "margins": {}, "prefill_coll_s": 0.0, "tick_coll_s": [],
           "tick_calls": []}
    coll = {"s": 0.0, "n": 0}
    nbytes = (lambda: 0) if mesh is None else \
        (lambda: mesh.collective_bytes)

    real_prefill, real_step = engine._run_chunked_prefill, engine._run_step

    def prefill(admitted, step_i):
        torch.cuda.synchronize()
        t, b, c = time.perf_counter(), nbytes(), coll["s"]
        real_prefill(admitted, step_i)
        torch.cuda.synchronize()
        got["prefill_s"] += time.perf_counter() - t
        got["prefill_bytes"] += nbytes() - b
        got["prefill_coll_s"] += coll["s"] - c

    def run_step(kind, scheme, arrays=None):
        if capture and kind in STEP_KERNEL:
            lo, hi = engine.shard.rows(len(arrays["lengths"]))
            if kind == "chunk":
                live = arrays["n_valid"][lo:hi] > 0
            else:
                live = np.isin(np.arange(lo, hi), engine.sched.active_slots)
            score = (int(live.sum()),
                     int(arrays["lengths"][lo:hi][live].max(initial=0)))
            if score > got["live"][STEP_KERNEL[kind]]:
                got["live"][STEP_KERNEL[kind]] = score
                arm(STEP_KERNEL[kind])
        if kind != "decode":
            return real_step(kind, scheme, arrays)
        torch.cuda.synchronize()
        t, b, c, n = time.perf_counter(), nbytes(), coll["s"], coll["n"]
        logits = real_step(kind, scheme, arrays)
        torch.cuda.synchronize()
        got["tick_s"].append(time.perf_counter() - t)
        got["tick_bytes"].append(nbytes() - b)
        got["tick_coll_s"].append(coll["s"] - c)
        got["tick_calls"].append(coll["n"] - n)
        if keep_rows:
            active = engine.sched.active_slots
            host = logits[active].float().cpu()
            for i, s in enumerate(active):
                r = engine.sched.slots[s]
                got["rows"][(r.rid, len(r.output))] = host[i]
        return logits

    engine._run_chunked_prefill, engine._run_step = prefill, run_step
    undo = []
    if mesh is not None:
        import torch.distributed as dist

        def timed(name):
            real = getattr(dist, name)

            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
                coll["s"] += time.perf_counter() - t
                coll["n"] += 1
                return out
            setattr(dist, name, call)
            undo.append(lambda: setattr(dist, name, real))
        timed("all_reduce")
        timed("broadcast")
    if mesh is None:
        record_margins(torch, engine, got["margins"])
    if capture:
        got["captured"] = {}
        got["live"] = {name: (0, 0) for name in STEP_KERNEL.values()}
        arm, unwrap = capture_paged_calls(torch, got["captured"])
        undo.append(unwrap)
    plans = {}
    restore = every_launch_plan(torch, plans)
    mla_decode.mla_decode_paged_kernel.launches = 0
    mla_prefill.mla_prefill_paged_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        summary = serve_paged(engine, reqs, log=log_fn, log_every=0)
    finally:
        restore()
        for fn in undo:
            fn()
    launches = {"mla_decode_paged": mla_decode.mla_decode_paged_kernel.launches,
                "mla_prefill_paged":
                    mla_prefill.mla_prefill_paged_kernel.launches}
    ticks = sum(summary["schemes_used"].values())
    want = {"mla_decode_paged": cfg.n_layers * ticks,
            "mla_prefill_paged": cfg.n_layers * summary["prefill_chunks"]}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for name, seen in plans.items():
        off = [p for p in seen if p["n_split"] <= 0]
        if len(seen) != launches[name.replace("_kernel", "")] or off:
            raise AssertionError(f"{name}: {len(off)} of {len(seen)} "
                                 f"launches left the tensor-core walk")
    done = engine.sched.finished
    if len(done) != len(reqs) or any(len(r.output) != MESH_GEN
                                     for r in done):
        raise AssertionError("not every request finished with its tokens")
    got.update(tokens=outputs(engine), launches=launches, ticks=ticks,
               chunks=summary["prefill_chunks"],
               tokens_per_s=summary["tokens_per_s"],
               wall_s=engine.stats.wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               pool=pool_digest(torch, engine.pool))
    return got


def phase14_reference(torch, np, cfg, params):
    """The single-card side of phase 14(b), on phase 3's model while it
    lives: the eager engine on phase 3's load at drop-free capacity."""
    ref = mesh_full_serve(torch, np, drop_free(cfg), params,
                          lambda *_: None)
    log(f"[mesh] reference, one card, eager: prefill "
        f"{ref['prefill_s'] * 1e3:.1f} ms, {ref['tokens_per_s']:.1f} "
        f"tokens/s, {statistics.median(ref['tick_s']) * 1e3:.2f} ms a tick "
        f"(median of {ref['ticks']}), peak {ref['peak_gib']:.2f} GiB")
    return ref


def phase14_rank(mesh):
    """One rank of phase 14 (spawned by ``launch.mesh.launch``): the
    collectives on CUDA tensors, (a) the f32 smoke config under every
    policy and impl, (b) full-width DeepSeek-V2 under 'tp'.  Returns its
    tokens, pool digests, launches and numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.nn import collectives as coll
    from repro_torch.weights import init_sharded_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say = log if mesh.rank == 0 else (lambda *_: None)
    out = {"backend": dist.get_backend(), "device": str(mesh.device)}
    # the backend takes CUDA tensors for both calls the collectives use
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((3,), mesh.rank + 1.0, dtype=dtype, device=mesh.device)
        if coll.all_reduce_sum(x, mesh, None).tolist() != [10.0] * 3 \
                or coll.all_gather(x[:1], mesh, "model", 0).tolist() \
                != [2.0 * mesh.index("data") + 1, 2.0 * mesh.index("data")
                    + 2]:
            raise AssertionError(f"all_reduce on {dtype} CUDA tensors")
    b = torch.full((2,), mesh.rank, dtype=torch.long, device=mesh.device)
    if coll.broadcast(b, mesh, 0).tolist() != [0, 0]:
        raise AssertionError("broadcast on CUDA tensors")
    say(f"[mesh] {out['backend']} takes CUDA tensors for all_reduce (f32, "
        f"bf16) and broadcast: no staging")

    # (a) the f32 smoke config, every policy x impl
    cfg = drop_free(configs.smoke("deepseek-v2-236b"))
    t0 = time.perf_counter()
    for policy in MESH_POLICIES:
        params = init_sharded_params(cfg, mesh, policy, seed=4,
                                     dtype=torch.float32)
        for impl in ("kernel", "ref"):
            engine, launches, plans = mesh_smoke_run(
                torch, cfg, params, impl, mesh.device, mesh, policy)
            s = engine.stats
            ticks = sum(s.schemes_used.values())
            want = {"mla_decode_paged": cfg.n_layers * ticks,
                    "mla_prefill_paged": cfg.n_layers * s.prefill_chunks} \
                if impl == "kernel" else {"mla_decode_paged": 0,
                                          "mla_prefill_paged": 0}
            if launches != want:
                raise AssertionError(f"{policy} {impl}: launches "
                                     f"{launches} != {want}")
            # f32 q runs the CUDA-core walk: n_split 0 on every plan
            for name, seen in plans.items():
                if len(seen) != launches[name.replace("_kernel", "")] \
                        or any(p["n_split"] != 0 for p in seen):
                    raise AssertionError(f"{policy} {name}: plans {seen}")
            key = f"{policy}_{impl}"
            out[f"smoke_{key}"] = outputs(engine)
            out[f"pool_smoke_{key}"] = pool_digest(torch, engine.pool)
            out[f"launches_smoke_{key}"] = launches
        del params, engine
    out["smoke_s"] = time.perf_counter() - t0

    # (b) full width under 'tp': each rank draws its shards leaf by leaf,
    # one rank at a time (one full leaf at a time: at most ~5 GB over the
    # ranks' shards)
    cfg = drop_free(dataclasses.replace(configs.full("deepseek-v2-236b"),
                                        n_layers=4))
    t0 = time.perf_counter()
    params = None
    for r in range(mesh.world):
        if r == mesh.rank:
            params = init_sharded_params(cfg, mesh, "tp", seed=0,
                                         dtype=torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier(group=mesh.group(None))
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in _leaves(params))
    # rank 0's logits rows stand for all; K1 / K2 operands kept for the
    # check below (all of a DP shard's rows of a chunk may be idle)
    out["full"] = mesh_full_serve(torch, np, cfg, params, say, mesh,
                                  keep_rows=mesh.rank == 0, capture=True)
    # K1 / K2 on this rank's own operands of the path, against 'ref'
    out["held"] = hold_captured(torch, out["full"].pop("captured"),
                                out["full"]["live"])
    return out


def phase14(torch, np, full_ref):
    """Phase 14: (a) and (b) on a (2, 2) mesh of ranks sharing the card,
    against the single card (phase 5's f32 load here, ``full_ref`` from
    :func:`phase14_reference`).  Returns the launch counts of rank 0's
    paths."""
    from repro_torch import configs, models
    from repro_torch.launch.mesh import launch
    from repro_torch.nn import module as nnm

    t0 = time.perf_counter()
    cfg = drop_free(configs.smoke("deepseek-v2-236b"))
    params = nnm.init_params(models.model_defs(cfg), seed=4,
                             dtype=torch.float32, device="cuda")
    smoke_ref = {impl: outputs(mesh_smoke_run(torch, cfg, params, impl,
                                              "cuda")[0])
                 for impl in ("kernel", "ref")}
    if smoke_ref["kernel"] != smoke_ref["ref"]:
        raise AssertionError("one card: f32 smoke tokens kernel != ref")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ranks = launch(phase14_rank, MESH, device="cuda", log=log)
    r0 = ranks[0]
    log(f"[mesh] {len(ranks)} ranks over {r0['backend']} on "
        f"{sorted({r['device'] for r in ranks})}, {time.perf_counter() - t0:.1f}s "
        f"with the launch")

    # (a)
    for policy in MESH_POLICIES:
        for impl in ("kernel", "ref"):
            key = f"{policy}_{impl}"
            for rank in ranks:
                if rank[f"smoke_{key}"] != smoke_ref["kernel"]:
                    raise AssertionError(f"(a) {key}: tokens differ from "
                                         f"the single card's")
            if len({rank[f"pool_smoke_{key}"] for rank in ranks}) != 1:
                raise AssertionError(f"(a) {key}: pool replicas differ")
    log(f"[mesh] (a) f32 smoke, {MESH[0]}x{MESH[1]}, policies "
        f"{MESH_POLICIES} x impl kernel / ref: greedy tokens of "
        f"{len(smoke_ref['kernel'])} requests identical to the single "
        f"card's on every rank; pool replicas bitwise equal; K1 / K2 = "
        f"layers x ticks / chunks a rank ({r0['launches_smoke_serve_kernel']}"
        f" under 'serve'), every launch on its plan (f32: n_split 0); "
        f"{r0['smoke_s']:.1f}s")

    # (b)
    full = [r["full"] for r in ranks]
    if len({f["pool"] for f in full}) != 1:
        raise AssertionError("(b) pool replicas differ")
    if any(f["tokens"] != full[0]["tokens"] for f in full):
        raise AssertionError("(b) ranks' tokens differ")
    ties = tie_count(full_ref["tokens"], full[0]["tokens"],
                     lambda: {"store": full_ref["margins"],
                              "temperature": 1.0}, "(b) mesh vs one card")
    # every decode tick's rows whose request has so far emitted the
    # single card's tokens (the same inputs)
    want_rows, rows = full_ref["rows"], full[0]["rows"]
    want_toks, toks = full_ref["tokens"], full[0]["tokens"]
    same = [k for k in want_rows if k in rows
            and toks[k[0]][:k[1]] == want_toks[k[0]][:k[1]]]
    if 2 * len(same) < len(want_rows):
        raise AssertionError(f"(b) {len(same)} of {len(want_rows)} decode "
                             f"rows have the single card's inputs")
    rel = _row_rel(torch, torch.stack([rows[k] for k in same]),
                   torch.stack([want_rows[k] for k in same]))
    if max(rel) > LOGITS_REL_L2:
        raise AssertionError(f"(b) decode ticks' logits rows: "
                             f"{max(rel)} > {LOGITS_REL_L2}")
    for i, (r, f) in enumerate(zip(ranks, full)):
        log(f"[mesh] (b) rank {i} ({MESH[0]}x{MESH[1]}, 'tp', ranks sharing "
            f"one card): prefill {f['prefill_s'] * 1e3:.1f} ms, "
            f"{f['tokens_per_s']:.1f} tokens/s, "
            f"{statistics.median(f['tick_s']) * 1e3:.2f} ms a tick (median "
            f"of {f['ticks']}), peak {f['peak_gib']:.2f} GiB "
            f"({r['param_bytes'] / 1e9:.2f} GB of weights), collectives "
            f"{statistics.mean(f['tick_bytes']) / 1e6:.3f} MB a tick and "
            f"{f['prefill_bytes'] / max(f['chunks'], 1) / 1e6:.3f} MB a "
            f"chunk, in them {statistics.median(f['tick_coll_s']) * 1e3:.2f}"
            f" ms a tick (median, {statistics.median(f['tick_calls'])} "
            f"calls) and {f['prefill_coll_s'] * 1e3:.1f} ms of the prefill "
            f"(device synchronized around each), K1 / K2 "
            f"{f['launches']}, shards drawn in {r['init_s']:.1f}s")
    for name in ("mla_decode_paged", "mla_prefill_paged"):
        held = [r["held"][name] for r in ranks]
        log(f"[mesh] (b) {name} on each rank's own operands of the path "
            f"(q {tuple(held[0]['q_shape'])}: its heads, its DP shard's "
            f"rows, its pool replica; live rows "
            f"{[h['live_rows'] for h in held]}, longest prefix "
            f"{[h['longest_prefix'] for h in held]}), kernel vs ref: "
            f"largest per-row "
            f"|kernel - plain| / |plain| {[h['row_rel'] for h in held]} "
            f"(bound {TOL['bfloat16']}), max|kernel - plain| "
            f"{[h['max_abs_err'] for h in held]}; "
            f"{plan_text(held[0]['plan'])}")
    MEASURED["mesh_held"] = ranks[0]["held"]
    log(f"[mesh] (b) tokens: {len(full_ref['tokens'])} requests x "
        f"{MESH_GEN} equal to the single card's eager engine but for "
        f"{ties} on counted near ties (NEAR_TIE {NEAR_TIE}); decode "
        f"ticks' logits, {len(same)} of {len(want_rows)} rows, |a-b|/|b| "
        f"max {max(rel):.4f} (bound {LOGITS_REL_L2}); pool replicas bitwise equal; one card: "
        f"prefill {full_ref['prefill_s'] * 1e3:.1f} ms, "
        f"{full_ref['tokens_per_s']:.1f} tokens/s")
    log(f"[phase 14] {time.perf_counter() - t0:.1f}s")
    return {"mesh_smoke": r0["launches_smoke_serve_kernel"],
            "mesh_tp": full[0]["launches"]}


def mesh_alone(torch, np):
    """Phase 14 on its own (after ``build.build_all()``): phase 3's
    model for the single-card reference, freed, then the mesh."""
    from repro_torch import configs, models
    from repro_torch.nn import module as nnm

    cfg = dataclasses.replace(configs.full("deepseek-v2-236b"), n_layers=4)
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device="cuda")
    ref = phase14_reference(torch, np, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return phase14(torch, np, ref)


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
    rows.update(check_contiguous_kernel(torch))
    check_split_boundaries(torch)
    check_prefill_tc_edges(torch)
    rows["mla_prefill_paged"]["verify"] = check_verify_kernel(torch)
    check_flash_tc_edges(torch)
    rows.update(check_flash(torch))
    by_path = full_width(torch, np)
    token_parity(torch, np)
    by_path["train"] = train_full_width(torch)
    train_attention_check(torch)
    train_grad_check(torch)
    train_loop_resume(torch)
    rows["flash_attention_fwd"]["baseline"], base_paths = \
        baseline_families(torch, np)
    by_path.update(base_paths)
    rows["flash_attention_fwd"]["jamba"], rec_paths = \
        recurrent_families(torch, np)
    by_path.update(rec_paths)
    whisper_rows, whisper_paths = whisper_family(torch, np)
    for name, r in whisper_rows.items():
        rows[name]["whisper"] = r
    by_path.update(whisper_paths)

    csrc = "src/repro_torch/kernels/csrc/"
    meta = {"mla_decode_paged": (csrc + "mla_decode_paged.cu",
                                 "src/repro/kernels/mla_decode.py:170"),
            "mla_prefill_paged": (csrc + "mla_prefill_paged.cu",
                                  "src/repro/kernels/mla_prefill.py:106"),
            "mla_decode": (csrc + "mla_decode.cu",
                           "src/repro/kernels/mla_decode.py:245"),
            "flash_attention_fwd": (csrc + "flash_attention_fwd.cu",
                                    "src/repro/kernels/flash_attention.py:76"),
            "flash_attention_bwd_dq": (
                csrc + "flash_attention_bwd_dq.cu",
                "src/repro/kernels/flash_attention.py:233"),
            "flash_attention_bwd_dkv": (
                csrc + "flash_attention_bwd_dkv.cu",
                "src/repro/kernels/flash_attention.py:253")}
    kernels = []
    for name, (src, replaces) in meta.items():
        paths = {p: n[name] for p, n in by_path.items() if name in n}
        # the contract's keys last: a row's own keys never override them
        if name in MEASURED.get("mesh_held", {}):
            rows[name]["mesh_tp"] = MEASURED["mesh_held"][name]
        kernels.append({**rows[name], "name": name, "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": sum(paths.values()),
                        "launches_by_path": paths})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
