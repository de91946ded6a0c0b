"""Roofline throughput / latency / energy model — the paper's Figs 4, 5, 6.

Copied from ``repro.hwmodel.roofline``.  Also holds the three-term
roofline (compute, memory, collective) of a whole program:

    t_compute    = FLOPs       / (chips * peak)
    t_memory     = bytes       / (chips * hbm_bw)
    t_collective = coll_bytes  / ici_bw
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.mla import MLAConfig
from ..core.schemes import PlatformPoint
from . import attention_costs as ac
from .attention_costs import Cost
from .platforms import EnergyModel


def attainable_time(cost: Cost, platform: PlatformPoint) -> float:
    """Single-chip two-term roofline latency (s)."""
    return max(cost.flops / platform.peak_flops, cost.bytes / platform.hbm_bw)


def throughput(cost: Cost, platform: PlatformPoint) -> float:
    """Layers (or steps) per second."""
    return 1.0 / attainable_time(cost, platform)


def energy_pj(cost: Cost, em: EnergyModel) -> float:
    return em.energy_pj(cost.flops, cost.bytes)


def decode_cost(method: str, *, cache_len: int, batch: int = 1,
                mla_cfg: Optional[MLAConfig] = None,
                dtype_bytes: int = 2, rope: bool = False,
                with_softmax: bool = True) -> Cost:
    """Uniform access to the paper's four methods (+ 'mla_seq', 'mla_naive')."""
    mla_cfg = mla_cfg or ac.DSV3_MLA
    if method.startswith("mla_"):
        c = ac.mla_decode_cost(mla_cfg, scheme=method[4:], cache_len=cache_len,
                               batch=batch, dtype_bytes=dtype_bytes, rope=rope)
        n_h = mla_cfg.n_heads
    elif method == "mha_l":
        c = ac.mha_decode_cost(ac.MHA_L, cache_len=cache_len, batch=batch,
                               dtype_bytes=dtype_bytes)
        n_h = ac.MHA_L.n_heads
    elif method == "mha_s":
        c = ac.mha_decode_cost(ac.MHA_S, cache_len=cache_len, batch=batch,
                               dtype_bytes=dtype_bytes)
        n_h = ac.MHA_S.n_heads
    else:
        raise ValueError(method)
    if with_softmax:
        sm = ac.softmax_flops(n_h, cache_len, batch)
        c = Cost(c.flops + sm, c.bytes, {**c.breakdown, "softmax": sm})
    return c


def prefill_cost(method: str, *, seq_len: int, batch: int = 1,
                 mla_cfg: Optional[MLAConfig] = None, dtype_bytes: int = 2,
                 rope: bool = False) -> Cost:
    mla_cfg = mla_cfg or ac.DSV3_MLA
    if method.startswith("mla"):
        return ac.mla_prefill_cost(mla_cfg, seq_len=seq_len, batch=batch,
                                   dtype_bytes=dtype_bytes, rope=rope)
    cfg = ac.MHA_L if method == "mha_l" else ac.MHA_S
    return ac.mha_prefill_cost(cfg, seq_len=seq_len, batch=batch,
                               dtype_bytes=dtype_bytes)


# ---------------------------------------------------------- three-term ----


@dataclasses.dataclass
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:  # perfectly-overlapped lower bound
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term time that is compute: how close the
        program is to being compute-bound at the roofline."""
        return self.t_compute / max(self.t_total, 1e-30)


def three_term(hlo_flops: float, hlo_bytes: float, coll_bytes: float,
               chips: int, peak: float, hbm_bw: float, ici_bw: float) -> RooflineTerms:
    """All inputs are *global* (whole-program) quantities; per-chip division
    happens here.  coll_bytes should already be summed over the program's
    collectives (per-chip shard sizes), so it is divided by ici_bw only."""
    return RooflineTerms(
        t_compute=hlo_flops / (chips * peak),
        t_memory=hlo_bytes / (chips * hbm_bw),
        t_collective=coll_bytes / ici_bw,
    )
