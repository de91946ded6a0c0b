"""Speculative-decoding support for the paged engines (port of
``repro.runtime.spec``): draft-model construction and host-side
acceptance.

MLA's compact latent cache pushes decode toward the compute-bound
regime, which is where speculative decoding pays: verifying k draft
tokens re-uses the latent-cache read a one-token step already pays for
(the k + 1-query verify step is the chunked-prefill path at chunk
k + 1, ``models.verify_chunk_paged``).

  * :func:`shallow_draft` — self-speculation: the draft is the target's
    own first ``n_layers`` layers.  Embedding, final norm and the layer
    dicts are shared by reference: the port keeps one dict per layer
    (``models.lm.layers``), so a period layer of the target becomes a
    layer of the draft's own plan without a copy or a stack.
  * :func:`identity_draft` — draft == target.  Every proposal matches
    the target's choice, so the engine must accept all k each round: the
    oracle for the accept / rewind machinery.
  * :func:`parse_draft_spec` — the CLI surface: 'self' | 'shallow:N'.
  * :func:`accept_length` — the token-exact acceptance rule.  The target
    samples its own token at every verify position under the same
    fold(rid, absolute position) keys plain decode uses, and a draft token
    is accepted iff it EQUALS that token, so the emitted tokens are plain
    decode's under greedy and seeded sampling: draft quality moves
    throughput, never tokens.

Rejecting drafts is a host-side length rewind: stale pool entries sit
past ``lengths``, no attention path reads them, and the next writes at
those positions overwrite them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..models.common import ModelConfig


def accept_length(drafts: np.ndarray, targets: np.ndarray) -> int:
    """Number of leading draft tokens equal to the target's own choices.

    drafts: (k,) proposed tokens d_1..d_k; targets: (nv,) the target's
    sampled token at each verify position (nv <= k + 1).  The round emits
    ``targets[:accept_length + 1]``: the accepted drafts are the target's
    tokens, plus one bonus / correction token."""
    n = 0
    for j in range(min(len(drafts), len(targets) - 1)):
        if int(drafts[j]) != int(targets[j]):
            break
        n += 1
    return n


def identity_draft(cfg: ModelConfig, params) -> Tuple[ModelConfig, object]:
    """Draft == target: acceptance is exactly k every round."""
    return cfg, params


def shallow_draft(cfg: ModelConfig, params, n_layers: int
                  ) -> Tuple[ModelConfig, object]:
    """Self-speculation draft: the target's first ``n_layers`` layers.

    Returns (draft_cfg, draft_params); draft_params holds the target's
    own ``embed`` / ``ln_f`` dicts and layer dicts (the same objects),
    laid out for ``lm_defs(draft_cfg)``'s plan.  Requires a decoder-only
    target."""
    if not 1 <= n_layers < cfg.n_layers:
        raise ValueError(
            f"shallow draft needs 1 <= n_layers < {cfg.n_layers}, "
            f"got {n_layers}")
    if cfg.family == "encdec":
        raise NotImplementedError("shallow drafts target decoder-only LMs")
    draft_cfg = dataclasses.replace(
        cfg, name=f"{cfg.name}-draft{n_layers}", n_layers=n_layers)
    layers = _flat_layer_params(params, cfg)[:n_layers]
    draft_params = {"embed": params["embed"], "ln_f": params["ln_f"]}
    draft_params.update(_assemble_layer_params(layers, draft_cfg))
    return draft_cfg, draft_params


def _flat_layer_params(params, cfg: ModelConfig) -> List[dict]:
    """The per-layer param dicts of an lm tree, in layer order."""
    prefix, period, n_periods, suffix = cfg.layer_plan()
    out = [params["prefix"][f"l{i}"] for i in range(len(prefix))]
    for p in range(n_periods):
        out.extend(params["period"][p][f"s{i}"] for i in range(len(period)))
    out.extend(params["suffix"][f"l{i}"] for i in range(len(suffix)))
    return out


def _assemble_layer_params(layers: List[dict], cfg: ModelConfig) -> dict:
    """Inverse of :func:`_flat_layer_params` for ``cfg``'s own plan."""
    prefix, period, n_periods, suffix = cfg.layer_plan()
    it = iter(layers)
    out = {"prefix": {f"l{i}": next(it) for i in range(len(prefix))},
           "period": [{f"s{i}": next(it) for i in range(len(period))}
                      for _ in range(n_periods)],
           "suffix": {f"l{i}": next(it) for i in range(len(suffix))}}
    try:
        next(it)
    except StopIteration:
        return out
    raise ValueError(f"{len(layers)} layer param dicts for a "
                     f"{cfg.n_layers}-layer plan")


def parse_draft_spec(spec: str, cfg: ModelConfig, params
                     ) -> Tuple[ModelConfig, object]:
    """CLI draft spec: 'self' (identity oracle) or 'shallow:N' (the first
    N layers of the target)."""
    if spec == "self":
        return identity_draft(cfg, params)
    if spec.startswith("shallow:"):
        try:
            n = int(spec.split(":", 1)[1])
        except ValueError:
            raise SystemExit(f"--draft shallow:N needs an int, got {spec!r}")
        return shallow_draft(cfg, params, n)
    raise SystemExit(f"unknown --draft spec {spec!r} "
                     "(expected 'self' or 'shallow:N')")
