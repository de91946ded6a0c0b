"""Hardware design points (copied from ``repro.hwmodel.platforms``).

The dotted-line platforms from the paper's Figs 4-5 plus other common
accelerators.  Numbers are public datasheet peaks, inputs to the cost
model and not measurements; the ridge OI (peak_flops / hbm_bw) is what the
paper calls the "roofline corner".  The port serves on ``h100`` by
default.
"""
from __future__ import annotations

from typing import Dict

from ..core.schemes import PlatformPoint


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
