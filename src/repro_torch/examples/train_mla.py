"""End-to-end training example on the port: a narrow MLA + MoE model
(DeepSeek-V2 family) trained for a few dozen steps on the deterministic
synthetic pipeline, with checkpoints and auto-resume.  Loss drops from
~ln(vocab) to well below it, through the whole substrate (data -> model
-> optimizer -> loop -> checkpoint).

    PYTHONPATH=src python -m repro_torch.examples.train_mla
    PYTHONPATH=src python -m repro_torch.examples.train_mla --steps 300 \
        --d-model 512
    PYTHONPATH=src python -m repro_torch.examples.train_mla --device cpu

  --steps N      training steps (default 60)
  --d-model N    model width (default 256; 512 with --layers 6 gives
                 ~100M+ params)
  --layers N     layers (default 4)
  --batch N      sequences a step (default 8)
  --seq N        tokens a sequence (default 64)
  --vocab N      vocabulary (default 4096)
  --ckpt-dir D   checkpoints (default ``$TMPDIR/repro_torch_train_mla``);
                 a run resumes from the latest one found there
  --device D     cuda (default) or cpu

The model trains in f32 on either device, as the reference example
does.  A checkpoint directory that already holds step ``--steps`` leaves
no step to run: pass a fresh ``--ckpt-dir`` or more ``--steps``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
from typing import List, Optional

import torch

from .. import models
from ..configs import deepseek_v2_236b
from ..data import DataConfig, SyntheticLM
from ..nn import module as nnm
from ..optim import AdamWConfig, adamw_init, cosine
from ..runtime import LoopConfig, TrainLoop, TrainStepConfig, \
    make_train_step


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_mla"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        deepseek_v2_236b.SMOKE, name="mla-100m",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=8, q_lora_rank=args.d_model // 2,
        kv_lora_rank=args.d_model // 4,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        d_ff=args.d_model * 2, vocab=args.vocab,
        n_experts=8, top_k=2, moe_d_ff=args.d_model * 2, n_shared_experts=1,
        first_dense_layers=1, first_dense_d_ff=args.d_model * 4,
        max_seq=args.seq * 2)
    print(f"{cfg.name}: {models.lm.param_count(cfg) / 1e6:.1f}M params "
          f"(--d-model 512 --layers 6 gives ~100M+)")

    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.float32, device=args.device)
    opt_cfg = AdamWConfig(lr=cosine(3e-3, warmup=20, total=args.steps))
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg,
                           TrainStepConfig(compute_dtype=torch.float32))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    loop = TrainLoop(LoopConfig(total_steps=args.steps, ckpt_every=25,
                                ckpt_dir=args.ckpt_dir, log_every=10),
                     step, params, opt, data)
    metrics = loop.run()
    loss = float(metrics["loss"])
    print(f"final loss {loss:.3f} "
          f"(uniform = ln({cfg.vocab}) = {math.log(cfg.vocab):.3f})")
    assert loss < math.log(cfg.vocab) * 0.9, \
        "loss should drop well below uniform"
    print("OK")
    return {"loss": loss, "step": loop.step}


if __name__ == "__main__":
    main()
