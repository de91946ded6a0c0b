"""Training launcher of the port (the counterpart of
``repro.launch.train``, one device, no mesh).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-236b \\
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-26b \\
        --smoke --steps 20 --impl kernel --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --smoke --steps 20 --seq 64 --impl chunked --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \\
        --smoke --steps 20 --impl kernel --device cpu

  --arch / --smoke    model config (``--smoke``: the tiny CI config); any
                      registered config (``repro_torch.configs.ARCHS``)
  --steps N           training steps (the cosine schedule's length)
  --batch N / --seq N global batch and sequence length
  --lr X              peak learning rate (cosine, 20 warm-up steps)
  --ckpt-dir D        checkpoint directory (auto-resume from it; default
                      under the temporary directory, per config)
  --ckpt-every N      steps between checkpoints
  --impl I            attention: 'ref' (dense), 'chunked' (the block-pair
                      walk of core.chunked_attention) or 'kernel' (the
                      flash attention CUDA kernels; their plain versions
                      on CPU)
  --scheme S          MLA execution scheme: only 'seq' (training runs MLA
                      in MHA mode)
  --microbatches N    gradient accumulation
  --fail-at N         failure drill: raise after step N
  --seed N            weight init and data
  --device D          cuda (default) or cpu

Weights are random (``--seed``); the data is the synthetic stream of
``repro_torch.data``.  A VLM's batch also carries its stub patch prefix,
and an encoder-decoder's (``whisper-medium``) its stub frames, as in the
reference: normal * 0.02 (f32, then the compute dtype) under
PRNGKey(the batch's first token), through ``runtime.prng``.  Params and
compute are bf16 on the card (the reference launcher's choice on an
accelerator mesh) and f32 on the CPU (its choice without a mesh); Adam
moments are f32.  Relaunching with the same ``--ckpt-dir`` continues
from the last complete checkpoint.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from .. import configs, models
from ..data import DataConfig, SyntheticLM
from ..nn import module as nnm
from ..optim import AdamWConfig, adamw_init, cosine
from ..runtime import (LoopConfig, TrainLoop, TrainStepConfig,
                       make_train_step, prng)


def batch_maker(cfg, device, dtype):
    """(tokens, labels) numpy -> the step's batch dict; a VLM's carries
    ``embeds`` (B, n_patches, d_model), an encoder-decoder's (B, n_frames,
    d_model), drawn as the reference launcher draws them."""
    n_pre = cfg.stub_rows

    def make_batch(toks, labels):
        b = {"tokens": torch.as_tensor(toks, device=device),
             "labels": torch.as_tensor(labels, device=device)}
        if n_pre:
            key = prng.PRNGKey(int(toks[0, 0]), device)
            b["embeds"] = (prng.normal(
                key, (toks.shape[0], n_pre, cfg.d_model)) * 0.02).to(dtype)
        return b
    return make_batch


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--impl", default="ref",
                    choices=("ref", "chunked", "kernel"))
    ap.add_argument("--scheme", default="seq", choices=("seq",))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.full(args.arch)
    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    params = nnm.init_params(models.model_defs(cfg), seed=args.seed,
                             dtype=dtype, device=args.device)
    opt_cfg = AdamWConfig(lr=cosine(args.lr, warmup=20, total=args.steps))
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(
        cfg, opt_cfg,
        TrainStepConfig(microbatches=args.microbatches, compute_dtype=dtype,
                        impl=args.impl, scheme=args.scheme))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train", cfg.name)
    loop = TrainLoop(
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   ckpt_dir=ckpt_dir, fail_at_step=args.fail_at),
        step_fn, params, opt, data,
        make_batch=batch_maker(cfg, args.device, dtype))
    metrics = loop.run()
    print(f"[train] done at step {loop.step}: "
          f"loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
