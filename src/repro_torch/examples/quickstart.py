"""Quickstart: the paper's technique in 60 lines, on the port.

Builds a small MLA model (DeepSeek-V2-style, reduced dims), trains a few
steps on the synthetic pipeline, then serves tokens under ALL FOUR MLA
execution schemes, verifying they emit identical tokens — the paper's
central observation ("both implement the same algorithm with identical
weights; the choice between them can be made dynamically").

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

  --device D   cuda (default) or cpu

The model runs in f32 on either device, as the reference example does.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from .. import configs, models
from ..core import mla as mlalib
from ..core.schemes import auto_dispatch
from ..data import DataConfig, SyntheticLM
from ..hwmodel.platforms import PLATFORMS
from ..nn import module as nnm
from ..optim import AdamWConfig, adamw_init
from ..runtime import (TrainStepConfig, make_prefill_step, make_serve_step,
                       make_train_step)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = args.device

    cfg = configs.smoke("deepseek-v2-236b")      # MLA + MoE, reduced dims
    print(f"model: {cfg.name}  ({models.lm.param_count(cfg) / 1e6:.2f}M "
          f"params)")

    # --- train a few steps --------------------------------------------------
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.float32, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg,
                           TrainStepConfig(compute_dtype=torch.float32))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8))
    for i in range(10):
        toks, labels = data.next_batch()
        params, opt, m = step(params, opt, {
            "tokens": torch.as_tensor(toks, device=dev),
            "labels": torch.as_tensor(labels, device=dev)})
        if i % 3 == 0:
            print(f"  step {i}: loss {float(m['loss']):.4f}")

    # --- the paper's co-design insight, executable ---------------------------
    for plat in ("edge_tpu", "a17_pro", "tpu_v5e", "h100"):
        s = auto_dispatch(cfg.mla_config(), PLATFORMS[plat], cache_len=4096)
        print(f"auto_dispatch({plat:10s}) -> MLA scheme '{s}'")

    # --- serve under every scheme: identical tokens --------------------------
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)), device=dev)
    outs = {}
    with torch.no_grad():
        absorbed = mlalib.attach_absorbed_tree(params, cfg.mla_config())
        for scheme in ("naive", "seq", "rc", "ru"):
            p = absorbed if scheme == "ru" else params
            prefill = make_prefill_step(cfg, capacity=24,
                                        compute_dtype=torch.float32,
                                        scheme=scheme)
            decode = make_serve_step(cfg, compute_dtype=torch.float32,
                                     scheme=scheme)
            logits, cache = prefill(p, prompt)
            toks = [int(torch.argmax(logits[0]))]
            for t in range(6):
                nxt = torch.argmax(logits, -1)
                logits, cache = decode(p, nxt, cache, 12 + t)
                toks.append(int(torch.argmax(logits[0])))
            outs[scheme] = toks
            print(f"  scheme {scheme:6s}: {toks}")
    assert all(v == outs["naive"] for v in outs.values()), \
        "schemes must emit identical tokens"
    print("OK — all four execution schemes emit identical tokens.")
    return outs


if __name__ == "__main__":
    main()
