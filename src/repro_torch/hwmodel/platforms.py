"""Hardware design points (copied from ``repro.hwmodel.platforms``).

The dotted-line platforms from the paper's Figs 4-5 plus other common
accelerators.  Numbers are public datasheet peaks, inputs to the cost
model and not measurements; the ridge OI (peak_flops / hbm_bw) is what the
paper calls the "roofline corner".  The port serves on ``h100`` by
default.  The reference's TPU v5e chip and pod constants are left out:
only its TPU dry-run report reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..core.schemes import PlatformPoint


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """E_op derived from TOPS/W; E_DRAM,bit is a DRAM-technology constant."""
    tops_per_w: float            # on-chip efficiency
    e_dram_bit_pj: float = 8.0   # paper's constant (pJ/bit)

    @property
    def e_op_pj(self) -> float:  # pJ per operation
        return 1.0 / self.tops_per_w

    def energy_pj(self, flops: float, dram_bytes: float) -> float:
        return flops * self.e_op_pj + dram_bytes * 8.0 * self.e_dram_bit_pj


PLATFORMS: Dict[str, PlatformPoint] = {
    # name                      peak FLOP/s     DRAM B/s
    "edge_tpu": PlatformPoint("edge_tpu", 4.0e12, 8.0e9),          # Coral: 4 TOPS, LPDDR4
    "a17_pro": PlatformPoint("a17_pro", 35.0e12, 51.2e9),          # ANE 35 TOPS, LPDDR5
    "jetson_orin": PlatformPoint("jetson_orin", 170.0e12, 204.8e9),
    "tpu_v5e": PlatformPoint("tpu_v5e", 197.0e12, 819.0e9),
    "tpu_v4": PlatformPoint("tpu_v4", 275.0e12, 1228.0e9),
    "a100": PlatformPoint("a100", 312.0e12, 2039.0e9),
    "h100": PlatformPoint("h100", 989.0e12, 3352.0e9),
}
