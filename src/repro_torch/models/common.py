"""Unified model configuration + per-layer descriptors (port of
``repro.models.common``).

Every architecture is expressed as a ``ModelConfig`` whose layer stack is
a repeating *period* of sublayer descriptors (``Sub``).  The JAX package
scans each period over stacked weights; the port keeps the same
``layer_plan`` (so the parameter trees map one to one, see
``repro_torch.weights``) but runs the stack as a Python loop over
per-layer parameter dicts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..core.mla import MLAConfig


@dataclasses.dataclass(frozen=True)
class Sub:
    """Static sublayer descriptor."""
    mixer: str = "attn"          # attn | mamba | mlstm | slstm
    ffn: str = "dense"           # dense | moe | none
    window: Optional[int] = None  # sliding-window size for local attention
    rope_base: float = 10000.0
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp_kind: str = "swiglu"     # swiglu | gelu
    rope_base: float = 10000.0
    norm_eps: float = 1e-6
    embed_scale: bool = False    # gemma-style sqrt(d_model) embedding scale
    # -- attention ------------------------------------------------------
    attn_kind: str = "gqa"       # gqa | mla
    window: Optional[int] = None
    local_global_period: int = 0  # N>0: every Nth layer global, rest local
    global_rope_base: float = 1_000_000.0
    # -- MLA (attn_kind='mla') -----------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # -- MoE -------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # -- hybrid (jamba) ---------------------------------------------------
    attn_period: int = 0         # 1 attention layer per N (rest mamba)
    attn_offset: int = 3         # position of the attn layer in the period
    moe_period: int = 0          # MoE every Nth layer
    d_state: int = 16
    conv_width: int = 4
    expand: int = 2
    # -- ssm (xlstm) ------------------------------------------------------
    slstm_every: int = 0         # alternate mLSTM/sLSTM every Nth layer
    # -- encoder-decoder (whisper) ---------------------------------------
    n_enc_layers: int = 0
    n_frames: int = 1500         # stub conv-frontend output length
    # -- vlm ---------------------------------------------------------------
    n_patches: int = 0           # stub ViT patch embeddings prepended
    # -- runtime -----------------------------------------------------------
    max_seq: int = 8192
    remat: bool = True
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def stub_rows(self) -> int:
        """Rows of the stub prefix ``embeds`` (B, rows, d_model) a batch
        carries: a VLM's patches, an encoder-decoder's frames; 0 for the
        other families."""
        return {"vlm": self.n_patches,
                "encdec": self.n_frames}.get(self.family, 0)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, (self.d_model + 15) // 16)

    def mla_config(self) -> MLAConfig:
        return MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            q_lora_rank=self.q_lora_rank, kv_lora_rank=self.kv_lora_rank,
            qk_nope_dim=self.qk_nope_dim, qk_rope_dim=self.qk_rope_dim,
            v_head_dim=self.v_head_dim, rope_base=self.rope_base)

    # ------------------------------------------------ layer structure ----

    def layer_plan(self) -> Tuple[List[Sub], List[Sub], int, List[Sub]]:
        """Returns (prefix, period, n_periods, suffix)."""
        subs: List[Sub] = []
        for i in range(self.n_layers):
            mixer = "attn"
            if self.attn_period:
                mixer = "attn" if i % self.attn_period == self.attn_offset else "mamba"
            elif self.slstm_every:
                mixer = "slstm" if i % self.slstm_every == self.slstm_every - 1 else "mlstm"
            ffn = "dense"
            if self.d_ff == 0:
                ffn = "none"
            if self.n_experts and i >= self.first_dense_layers:
                if self.moe_period == 0 or i % self.moe_period == self.moe_period - 1:
                    ffn = "moe"
            window, base = None, self.rope_base
            if self.local_global_period:
                if i % self.local_global_period == self.local_global_period - 1:
                    window, base = None, self.global_rope_base   # global layer
                else:
                    window, base = self.window, self.rope_base    # local layer
            elif self.window:
                window = self.window
            subs.append(Sub(mixer=mixer, ffn=ffn, window=window, rope_base=base))

        prefix = subs[: self.first_dense_layers]
        rest = subs[self.first_dense_layers:]
        # find the shortest repeating period among candidate lengths
        plen = 1
        for cand in (self.local_global_period or 0, self.attn_period or 0,
                     self.slstm_every or 0, self.moe_period or 0, 1):
            if cand:
                plen = max(plen, cand)
        if self.attn_period and self.moe_period:
            import math
            plen = self.attn_period * self.moe_period // math.gcd(
                self.attn_period, self.moe_period)
        # NOTE: the unrolled fallbacks return prefix + rest — dropping the
        # first_dense prefix here silently shed layers for short stacks
        # (e.g. the shallow self-speculation drafts of runtime.spec, which
        # truncate deepseek's 1-dense + N-MoE plan below one full period).
        if not self.scan_layers:
            return prefix + rest, [], 0, []
        n_periods = len(rest) // plen
        period = rest[:plen] if n_periods > 0 else []
        # verify periodicity; if broken, fall back to unrolled
        for p in range(n_periods):
            if rest[p * plen:(p + 1) * plen] != period:
                return prefix + rest, [], 0, []
        suffix = rest[n_periods * plen:]
        if n_periods <= 1:
            return prefix + rest, [], 0, []
        return prefix, period, n_periods, suffix


def chunk_len(L: int, chunk: int) -> int:
    """The reference's chunking of a recurrent scan over L positions:
    n = max(1, L // chunk) chunks of c = L // n positions.  Where n * c
    != L the reference's reshape fails (ROADMAP.md queue 3); raise there
    as it does instead of padding.  Returns c."""
    n = max(1, L // chunk)
    c = L // n
    if n * c != L:
        raise ValueError(f"a scan over {L} positions does not split into "
                         f"{n} chunks of {c} (chunk {chunk}): the "
                         f"reference cannot reshape it either")
    return c
