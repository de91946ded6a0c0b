from . import attention_costs, platforms, roofline
from .attention_costs import Cost, DSV3_MLA, MHA_L, MHA_S, MHAConfig
from .platforms import PLATFORMS, EnergyModel
from .roofline import RooflineTerms, three_term

__all__ = [
    "attention_costs", "platforms", "roofline",
    "Cost", "DSV3_MLA", "MHA_L", "MHA_S", "MHAConfig",
    "PLATFORMS", "EnergyModel", "RooflineTerms", "three_term",
]
